"""The benchmark of the PyTorch port (``stereotracking_tpu_torch``): see
``run.py`` and ``harness.py``."""
