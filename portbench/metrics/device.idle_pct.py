"""Share of the window in which the device has none of the step's work,
in %: one less the device's busy time per step, as the traced stretch
reads it (its kernels and copies merged), over the untraced window's step
period (the window's seconds over its steps).  The traced stretch itself
reads more idle: the profiler slows the host's call, not the device's
work."""
from portbench import tracelib


def read(rec):
    tr = rec['trace']
    if tr is None or not tr.device:
        return None
    busy_per_step = tracelib.busy_s(tr) / tr.steps
    return 100.0 * (1.0 - busy_per_step * rec['steps'] / rec['window_s'])
