"""Device ms per step of the NMS, depth and assignment kernels."""
from portbench import tracelib


def read(rec):
    return tracelib.per_step_ms(rec['trace'],
                                lambda e: tracelib.kind(e) == 'track')
