"""Device ms a step from the tracker mark to the step's finish mark: the
boxes' un-inflation, the depth re-extraction and the state's write-back,
median over the window's steps (the untraced window of the traced run:
the rows just before the traced stretch's and the following steps'),
from the phase ring of stereotracking_tpu_torch/utils/trace.py, device
stamps on the card's timer."""
from portbench.harness import FOLLOW_STEPS, TRACE_STEPS


def read(rec):
    try:
        from stereotracking_tpu_torch.utils import trace
    except ImportError:         # a program without the tracer
        return None
    table = trace.window(rec['steps'], TRACE_STEPS + FOLLOW_STEPS)
    if table is None:
        return None
    return trace.median(table['phase.finish_ms'])
