"""Device ms per step of the stem and stage 1-3 kernels."""
from portbench import tracelib


def read(rec):
    return tracelib.per_step_ms(rec['trace'],
                                lambda e: tracelib.kind(e) == 'stage')
