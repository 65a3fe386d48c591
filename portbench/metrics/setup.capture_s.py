"""Seconds of every ``capture`` span: CapturedStep's new graphs (the input
buffers, the eager warm-up, the capture), summed over the run."""


def read(rec):
    try:
        from stereotracking_tpu_torch.utils import trace
    except ImportError:         # a program without the tracer
        return None
    return trace.span_total_s('capture')
