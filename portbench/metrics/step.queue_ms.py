"""Ms from the start of a step's ``replay`` span on the host to its start
mark on the device (the device stamp on the host's clock: the tracer's
measured offset): how long a launched step waits for the device, median
over the window's steps (the untraced window of the traced run: the rows
just before the traced stretch's and the following steps'), from the
phase ring of stereotracking_tpu_torch/utils/trace.py, device stamps on
the card's timer."""
from portbench.harness import FOLLOW_STEPS, TRACE_STEPS


def read(rec):
    try:
        from stereotracking_tpu_torch.utils import trace
    except ImportError:         # a program without the tracer
        return None
    table = trace.window(rec['steps'], TRACE_STEPS + FOLLOW_STEPS)
    if table is None:
        return None
    return trace.median(table['step.queue_ms'])
