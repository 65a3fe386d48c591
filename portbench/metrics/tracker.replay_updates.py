"""Kalman updates the smoothing replay applied a tracker step (all
streams): the slot-update kernel (stereotracking_tpu_torch/ops/
slot_update_cuda.py) adds them and the step to the tracer's counter
(utils/trace.py) on the card; read once, after the run, as the mean over
every counted step (the warm-up's, the window's, the traced stretch's and
those after it; not the capture's warm-up, whose state is put back).  A
count of how often the data-dependent part of the tracker runs, not a
speed.  A program without the counter reports nothing."""


def read(rec):
    try:
        from stereotracking_tpu_torch.utils import trace
    except ImportError:         # a program without the tracer
        return None
    per_step = getattr(trace, 'replay_updates_per_step', None)
    return None if per_step is None else per_step()
