"""Device ms per step of PyTorch's own kernels: BatchNorm, SiLU,
concatenation, the SPPF pools, preprocessing, decode, and the tracker's
tensor ops and smoothing replay."""
from portbench import tracelib


def read(rec):
    return tracelib.per_step_ms(rec['trace'],
                                lambda e: tracelib.kind(e) == 'torch')
