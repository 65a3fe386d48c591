"""Device ms per step of cuDNN's and cuBLAS's kernels (the convolutions of
stage 4, the PAFPN and the head; the tracker's small matrix products)."""
from portbench import tracelib


def read(rec):
    return tracelib.per_step_ms(rec['trace'],
                                lambda e: tracelib.kind(e) == 'library')
