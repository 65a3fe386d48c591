"""The bounds of the stem and stage kernels that the program runs (the
larger of their operations over the bf16 peak and their bytes over HBM
bandwidth, portbench/flops.py; only the stages whose backend the run
records as 'cuda') over those kernels' device time, per step, in %."""
from portbench import tracelib


def read(rec):
    ms = tracelib.per_step_ms(rec['trace'],
                              lambda e: tracelib.kind(e) == 'stage')
    if not ms:
        return None
    return 100.0 * rec['stage_bound_s'] * 1e3 / ms
