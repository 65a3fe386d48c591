"""Faults planted underneath the timed path, for showing that ``correct``
catches them (the benchmark's tests on the CPU, ``calibrate.py --fault``
on the card).  A run never plants one by itself.

- ``Broken(system, fault)`` wraps the program behind the loop's interface:
  ``state_unchanged`` (the step leaves the track state as it was),
  ``half_batch`` (the second half of the streams' results zeroed),
  ``answer_altered`` (one track id changed where it is produced);
- ``nms_fault(fault)`` patches the program's NMS while the program is
  built and its step captured: ``nms_none`` (nothing suppressed),
  ``nms_iou_0.65`` (the threshold 0.65 for the configuration's),
  ``nms_class_agnostic`` (one pass over all classes, no class offset).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

SYSTEM_FAULTS = ('state_unchanged', 'half_batch', 'answer_altered')
NMS_FAULTS = ('nms_none', 'nms_iou_0.65', 'nms_class_agnostic')


class Broken:
    """The program with one of ``SYSTEM_FAULTS`` underneath its
    interface."""

    def __init__(self, system, fault):
        self.system, self.fault = system, fault

    @property
    def states(self):
        return self.system.states

    @property
    def captures(self):
        return self.system.captures

    def reset(self):
        self.system.reset()

    def submit(self, imgs, disps, fids, sf):
        if self.fault == 'state_unchanged':
            before = [t.clone() for t in self.system.states]
            wait = self.system.submit(imgs, disps, fids, sf)
            out = wait()
            for t, b in zip(self.system.states, before):
                t.copy_(b)
            return lambda: out
        wait = self.system.submit(imgs, disps, fids, sf)

        def broken():
            out = {k: v.copy() for k, v in wait().items()}
            if self.fault == 'half_batch':
                half = out['det_valid'].shape[0] // 2
                for k in out:
                    out[k][half:] = 0
            elif self.fault == 'answer_altered':
                out['track_ids'][0, 0] += 1000
            return out
        return broken


@contextlib.contextmanager
def nms_fault(fault: str) -> Iterator[None]:
    """The program's NMS broken by ``fault`` (one of ``NMS_FAULTS``) inside
    the block."""
    from stereotracking_tpu_torch.models import detector
    from stereotracking_tpu_torch.ops import nms
    keep, predict_nms = nms.nms_keep, detector.batched_nms

    def keep_all(boxes, finite, thr, max_keep=None):
        if max_keep is None:
            return finite
        return finite & (torch.cumsum(finite.to(torch.int32), 1) <= max_keep)

    def keep_065(boxes, finite, thr, max_keep=None):
        return keep(boxes, finite, 0.65, max_keep)

    def agnostic(boxes, scores, labels, *args, **kw):
        res = predict_nms(boxes, scores, torch.zeros_like(labels), *args,
                          **kw)
        # each kept candidate's label: the candidate of that exact score
        hit = scores[..., None, :] == res.scores[..., :, None]
        idx = hit.to(torch.int8).argmax(-1)
        lab = labels.expand_as(scores).gather(-1, idx).to(torch.int32)
        return res._replace(labels=torch.where(res.valid, lab, 0))

    patches = {'nms_none': (nms, 'nms_keep', keep_all),
               'nms_iou_0.65': (nms, 'nms_keep', keep_065),
               'nms_class_agnostic': (detector, 'batched_nms', agnostic)}
    mod, name, fn = patches[fault]
    old = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, old)
