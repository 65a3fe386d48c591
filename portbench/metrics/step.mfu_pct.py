"""The detector's operations per step (counted from the configuration's
shapes, portbench/flops.py), times the window's steps, over the window's
seconds times the bf16 tensor-core peak, in %."""
from portbench import flops


def read(rec):
    if rec['device'] != 'cuda':
        return None
    return 100.0 * rec['flops_per_step'] * rec['steps'] / (
        rec['window_s'] * flops.PEAK_BF16)
