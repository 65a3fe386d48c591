"""Host ms a step of the ``frames`` span: the frames' copies to the card in
track_raw (utils/devices.to_device), median over the window's steps,
from the span ring of stereotracking_tpu_torch/utils/trace.py (host
perf_counter)."""
from portbench.harness import FOLLOW_STEPS, TRACE_STEPS


def read(rec):
    try:
        from stereotracking_tpu_torch.utils import trace
    except ImportError:         # a program without the tracer
        return None
    table = trace.window(rec['steps'], TRACE_STEPS + FOLLOW_STEPS)
    if table is None:
        return None
    return trace.median(table['host.frames_ms'])
