"""95th percentile over the window's steps of the device ms from a step's
start mark to its finish mark (one replay of the captured step,
models/captured_step), from the phase ring of
stereotracking_tpu_torch/utils/trace.py."""
from portbench.harness import FOLLOW_STEPS, TRACE_STEPS


def read(rec):
    try:
        from stereotracking_tpu_torch.utils import trace
    except ImportError:         # a program without the tracer
        return None
    table = trace.window(rec['steps'], TRACE_STEPS + FOLLOW_STEPS)
    if table is None:
        return None
    return trace.percentile(table['step.device_ms'], 95)
