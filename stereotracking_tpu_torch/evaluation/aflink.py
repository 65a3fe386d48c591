"""Appearance-Free Link (AFLink): the eval CLI's ``--aflink`` post-linker.

Port of ``stereotracking_tpu/evaluation/aflink.py`` (the reference's
``AppearanceFreeLink``): a small temporal-conv network scores whether two
tracklets belong to the same object from their (t, x, y, w, h) motion
windows alone; pairs that are close in time and space and score above the
threshold are merged by a cost-threshold Hungarian pass
(``scipy.optimize.linear_sum_assignment``) on the host.  The network is an
``nn.Module`` that runs on the card unless the caller asks for the CPU;
the linking logic is numpy, as in the JAX package.  Flax weights carry
over by ``utils/convert.aflink_to_state_dict``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from scipy.optimize import linear_sum_assignment

from ..utils.devices import checked_device


class TemporalEncoder(nn.Module):
    """Per-tracklet encoder over the (B, T, 5) window: four temporal convs
    ((7, 1), then (3, 1) x 3; no bias; ReLU), a (1, 3) fusion conv over the
    five measures (ReLU), and the mean over time and measures -> (B, 256).
    """

    def __init__(self):
        super().__init__()
        chans = (1, 32, 64, 128, 256)
        for i in range(4):
            self.add_module(f'tconv{i}', nn.Conv2d(
                chans[i], chans[i + 1], (7 if i == 0 else 3, 1), bias=False))
        self.fusion = nn.Conv2d(256, 256, (1, 3), bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None]                                  # (B, 1, T, 5)
        for i in range(4):
            x = torch.relu(getattr(self, f'tconv{i}')(x))
        x = torch.relu(self.fusion(x))
        return x.mean((2, 3))


class AFLinkModel(nn.Module):
    """(B, T, 5) window pairs -> (B, 2) softmax probabilities (column 1:
    the same object)."""

    def __init__(self):
        super().__init__()
        self.encoder = TemporalEncoder()
        self.fc1 = nn.Linear(512, 128)
        self.fc2 = nn.Linear(128, 2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.encoder(x1), self.encoder(x2)], -1)
        logits = self.fc2(torch.relu(self.fc1(h)))
        return torch.softmax(logits, -1)


def normalize_pair(w1: np.ndarray, w2: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Joint min-max normalization of a (padded) window pair, the
    reference's ``data_transform``: per channel over the concatenation,
    map to [-1, 1] via (max+min)/2 and (max-min)/2.  Padding rows take part
    in the min/max, as the reference's padded output does."""
    both = np.concatenate([w1, w2], axis=0)
    lo, hi = both.min(0), both.max(0)
    sub = (hi + lo) / 2
    div = (hi - lo) / 2 + 1e-5
    return (w1 - sub) / div, (w2 - sub) / div


def window(rows: np.ndarray, tail: bool, size: int = 30) -> np.ndarray:
    """rows: (n, 5) = (frame, x, y, w, h) sorted by frame -> the
    zero-padded ``size``-frame window from the end (tail) or start
    (head)."""
    w = np.zeros((size, 5), np.float32)
    seg = rows[-size:] if tail else rows[:size]
    if tail:
        w[-len(seg):] = seg
    else:
        w[:len(seg)] = seg
    return w


def load_aflink(path: str) -> dict:
    """An AFLink state dict from a ``.pt`` / ``.pth`` file this package's
    trainer wrote (``train/train_aflink.py``); JAX-native (msgpack / orbax)
    checkpoints need flax to read and are refused."""
    if not str(path).endswith(('.pt', '.pth')):
        raise NotImplementedError(
            f'AFLink checkpoint {path!r}: only PyTorch checkpoints (.pt / '
            f'.pth) load here; a JAX-native checkpoint needs the converter '
            f'of ROADMAP.md Queue 1 item 3 (utils/convert.'
            f'aflink_to_state_dict run beside the JAX package)')
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    return ckpt.get('state_dict', ckpt)


class AppearanceFreeLink:
    """Merge tracklets whose AFLink score exceeds the threshold.

    Args mirror the reference: the temporal window [t_min, t_max] between
    the end of one tracklet and the start of the next (inclusive), the
    spatial distance limit, the link-probability threshold.  ``state_dict``
    holds the network's weights (without one: random weights from seed 0,
    as the JAX linker's PRNGKey(0)); the network runs on ``device``, the
    card unless the caller asks for the CPU."""

    def __init__(self, state_dict: Optional[dict] = None,
                 temporal_threshold=(0, 30), spatial_threshold: float = 75.0,
                 confidence_threshold: float = 0.95, window: int = 30,
                 device='cuda'):
        self.device = checked_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.model = AFLinkModel()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model = self.model.to(self.device).eval()
        self.window = window
        self.t_min, self.t_max = temporal_threshold
        self.spatial_threshold = spatial_threshold
        self.confidence_threshold = confidence_threshold

    @torch.no_grad()
    def probabilities(self, w1: np.ndarray, w2: np.ndarray) -> np.ndarray:
        """(B, T, 5) normalized window pairs -> (B,) link probabilities."""
        x1 = torch.from_numpy(np.ascontiguousarray(w1, np.float32))
        x2 = torch.from_numpy(np.ascontiguousarray(w2, np.float32))
        probs = self.model(x1.to(self.device), x2.to(self.device))
        return probs[:, 1].cpu().numpy()

    def link(self, frames: Dict[int, Tuple[np.ndarray, np.ndarray]]
             ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """frames: {frame -> (ids, boxes xyxy)} -> same with merged ids."""
        tracks: Dict[int, list] = {}
        for f in sorted(frames):
            ids, boxes = frames[f]
            for i, b in zip(np.asarray(ids, int), np.asarray(boxes)):
                cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
                tracks.setdefault(int(i), []).append(
                    [f, cx, cy, b[2] - b[0], b[3] - b[1]])
        tids = sorted(tracks)
        info = {t: np.asarray(sorted(tracks[t]), np.float32) for t in tids}

        pairs = []
        for a in tids:
            for b in tids:
                if a == b:
                    continue
                gap = info[b][0, 0] - info[a][-1, 0]
                if not (self.t_min <= gap <= self.t_max):
                    continue
                dist = np.hypot(info[a][-1, 1] - info[b][0, 1],
                                info[a][-1, 2] - info[b][0, 2])
                if dist > self.spatial_threshold:
                    continue
                pairs.append((a, b))
        if not pairs:
            return frames

        w1s, w2s = [], []
        for a, b in pairs:
            w1, w2 = normalize_pair(window(info[a], True, self.window),
                                    window(info[b], False, self.window))
            w1s.append(w1)
            w2s.append(w2)
        probs = self.probabilities(np.stack(w1s), np.stack(w2s))

        # cost-threshold Hungarian over (ending tracklet, starting tracklet)
        ends = sorted({a for a, _ in pairs})
        starts = sorted({b for _, b in pairs})
        cost = np.ones((len(ends), len(starts)))
        for (a, b), p in zip(pairs, probs):
            cost[ends.index(a), starts.index(b)] = 1.0 - p
        rows, cols = linear_sum_assignment(cost)
        remap = {}
        for r, c in zip(rows, cols):
            if cost[r, c] <= 1.0 - self.confidence_threshold:
                remap[starts[c]] = ends[r]

        def resolve(i):
            while i in remap:
                i = remap[i]
            return i

        return {f: (np.asarray([resolve(int(i)) for i in ids], int), boxes)
                for f, (ids, boxes) in frames.items()}
