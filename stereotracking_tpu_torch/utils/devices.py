"""Where the port runs, and host-to-device copies that do not stall it."""
from __future__ import annotations

import numpy as np
import torch


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  The entry points run on the card
    unless the caller asks for the CPU, and never fall back: a CUDA device
    that torch cannot see raises."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {str(device)!r}: torch sees no CUDA device.  The port '
            f'runs on an NVIDIA GPU; pass device="cpu" to run its plain '
            f'PyTorch versions on the CPU')
    return dev


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``.  To a CUDA device through pinned
    memory, asynchronously on the current stream: a copy from pageable
    memory would wait for the stream to drain, one host sync per call."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)
