"""AFLink training on synthetic motion tracklets.

Port of ``stereotracking_tpu/train/train_aflink.py``.  AFLink is
appearance-free, so a checkpoint for the eval CLI's ``--aflink`` can be
trained from synthetic trajectories: positives are the two halves of one
noisy linear walk split by a random gap, negatives pair halves of
different walks.  Cross-entropy of the softmax probabilities (clipped at
1e-8 before the log, as the JAX loss) over (B, 30, 5) window pairs, Adam
with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 added outside the square
root, which is also how ``torch.optim.Adam`` adds it).  The batches are
the JAX trainer's numpy draws (``synthesize_batch``, the same from the
same seed); the initial weights come from a ``torch.Generator`` seeded
with ``seed`` (or are given), so a run is fixed by its arguments.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..evaluation.aflink import AFLinkModel, normalize_pair, window
from ..utils.devices import checked_device


def _walk(rng: np.random.RandomState, n_frames: int, t0: int) -> np.ndarray:
    """One noisy linear trajectory: rows (frame, cx, cy, w, h)."""
    x0, y0 = rng.uniform(50, 1800), rng.uniform(50, 1000)
    vx, vy = rng.uniform(-8, 8), rng.uniform(-6, 6)
    w = rng.uniform(15, 80)
    h = rng.uniform(12, 60)
    t = np.arange(n_frames, dtype=np.float32)
    rows = np.stack([
        t0 + t,
        x0 + vx * t + rng.normal(0, 1.5, n_frames),
        y0 + vy * t + rng.normal(0, 1.5, n_frames),
        w * (1 + rng.normal(0, 0.02, n_frames)),
        h * (1 + rng.normal(0, 0.02, n_frames)),
    ], axis=1).astype(np.float32)
    return rows


def synthesize_batch(rng: np.random.RandomState, batch: int,
                     size: int = 30
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x1, x2, labels): label 1 = same object, 0 = different."""
    x1 = np.zeros((batch, size, 5), np.float32)
    x2 = np.zeros((batch, size, 5), np.float32)
    y = np.zeros(batch, np.int32)
    for i in range(batch):
        positive = rng.rand() < 0.5
        n = rng.randint(20, 80)
        a = _walk(rng, n, t0=rng.randint(0, 200))
        if positive:
            cut = rng.randint(5, n - 5)
            gap = rng.randint(1, 25)
            head, tail = a[:cut], a[cut:].copy()
            tail[:, 0] += gap           # temporal gap between the halves
            w1 = window(head, True, size)
            w2 = window(tail, False, size)
            y[i] = 1
        else:
            b = _walk(rng, rng.randint(20, 80), t0=rng.randint(0, 200))
            w1 = window(a, True, size)
            w2 = window(b, False, size)
        x1[i], x2[i] = normalize_pair(w1, w2)
    return x1, x2, y


def aflink_loss(probs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log of the true class's probability, clipped at 1e-8."""
    logp = torch.log(probs.clamp_min(1e-8))
    return -logp.gather(1, y[:, None].long())[:, 0].mean()


def train_aflink(seed: int = 0, steps: int = 300, batch: int = 128,
                 lr: float = 1e-3, size: int = 30, log_every: int = 50,
                 device='cuda', init: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[dict, float]:
    """Train ``AFLinkModel`` on synthetic tracklets on ``device`` (the card
    unless the caller asks for the CPU).  ``init``: a state dict to start
    from; otherwise weights drawn from ``generator`` (default: a CPU
    generator seeded with ``seed``).  Batches are drawn from
    ``np.random.RandomState(seed)``.  Returns (state dict on the CPU,
    accuracy on a held-out batch of 512 from seed + 1)."""
    dev = checked_device(device)
    gen = generator or torch.Generator().manual_seed(seed)
    model = AFLinkModel()
    if init is not None:
        model.load_state_dict(init)
    else:
        with torch.no_grad():
            for p in model.parameters():
                # uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default
                # bound, drawn from the given generator
                fan_in = p[0].numel() if p.dim() > 1 else p.shape[0]
                bound = fan_in ** -0.5
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                      generator=gen))
    model = model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    rng = np.random.RandomState(seed)
    for it in range(steps):
        x1, x2, y = (torch.from_numpy(a).to(dev)
                     for a in synthesize_batch(rng, batch, size))
        probs = model(x1, x2)
        loss = aflink_loss(probs, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and it % log_every == 0:
            acc = (probs.argmax(-1) == y).float().mean()
            print(f'[aflink] step {it}/{steps} loss '
                  f'{float(loss.detach()):.4f} acc {float(acc):.3f}',
                  flush=True)
    model.eval()
    x1, x2, y = synthesize_batch(np.random.RandomState(seed + 1), 512, size)
    with torch.no_grad():
        probs = model(torch.from_numpy(x1).to(dev),
                      torch.from_numpy(x2).to(dev)).cpu()
    acc = float((probs.argmax(-1).numpy() == y).mean())
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}, acc


def save_aflink(path: str, state_dict: dict, **meta) -> None:
    """Write an AFLink ``.pt`` that ``evaluation.aflink.load_aflink`` (and
    so ``tools.test --aflink``) reads."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({'format': 'aflink', 'state_dict': state_dict, **meta}, path)
