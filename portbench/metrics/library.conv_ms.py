"""Device ms per step of cuDNN's and cuBLAS's kernels (the convolutions of
the stages that run on the modules, the PAFPN and the head, FFT ones
included; the tracker's small matrix products)."""
from portbench import tracelib


def read(rec):
    return tracelib.per_step_ms(rec['trace'],
                                lambda e: tracelib.kind(e) == 'library')
