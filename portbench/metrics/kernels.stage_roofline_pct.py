"""The stem and stage 1-3 kernels' bounds (the larger of their operations
over the bf16 peak and their bytes over HBM bandwidth, portbench/flops.py)
over their device time, per step, in %."""
from portbench import tracelib


def read(rec):
    ms = tracelib.per_step_ms(rec['trace'],
                              lambda e: tracelib.kind(e) == 'stage')
    if not ms:
        return None
    return 100.0 * rec['stage_bound_s'] * 1e3 / ms
