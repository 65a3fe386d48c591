"""Seconds of the ``library`` span: the kernel library's build (nvcc) or
load in stereotracking_tpu_torch/_kernels.library, once a process."""


def read(rec):
    try:
        from stereotracking_tpu_torch.utils import trace
    except ImportError:         # a program without the tracer
        return None
    return trace.span_total_s('library')
