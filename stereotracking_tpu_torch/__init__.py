"""stereotracking_tpu_torch: the stereo-tracking system in PyTorch + CUDA.

A port of ``stereotracking_tpu`` (JAX/Flax/Pallas) to PyTorch on an NVIDIA
Hopper GPU.  The flagship path — raw BGR frame + fixed-point disparity ->
dual-branch YOLOX detector -> NMS -> per-box depth -> OC-SORT — runs through
``apis.builder.build_model(cfg).track_raw``, and for S streams at once
through ``parallel.multistream.MultiStreamTracker``.  Every Pallas kernel
of the JAX package has a hand-written CUDA C++ counterpart under ``csrc/``
(built at first use by ``_kernels``), and beside each kernel a plain
PyTorch version of the same function that CPU tensors run.  The
detector trains through ``train`` and ``tools.train`` on the float32
modules, as the JAX package trains outside its Pallas kernels.

This package never imports ``jax`` or ``flax``.
"""

__version__ = '0.1.0'
