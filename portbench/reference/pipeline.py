"""One tracker step of S streams in the reference: preprocess, detect,
per-box depth, the tracker, and the ``FrameResult`` fields.

``Reference.detect`` gives every candidate and what NMS keeps;
``Reference.track`` runs the tracker on given detection rows (the first
``num_dets`` of a step's detections) from a given state and returns the
track fields a ``FrameResult`` carries.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from . import depth as dp
from . import model as md
from . import tracker as tk


class TrackFields(NamedTuple):
    track_bboxes: torch.Tensor
    track_scores: torch.Tensor
    track_labels: torch.Tensor
    track_scales: torch.Tensor
    track_depths: torch.Tensor
    track_ids: torch.Tensor
    track_valid: torch.Tensor


class Reference:
    """The reference of one configuration (its ``model`` dict), with the
    weights of ``state_dict``, on ``device``.  ``round_tracker``, when
    given, is applied to the detections the tracker takes and to the
    state it leaves (the control's lower precision)."""

    def __init__(self, model_cfg: dict, state_dict: Dict[str, torch.Tensor],
                 device, round_tracker=None):
        self.det_cfg = md.detector_config(model_cfg)
        self.trk_cfg = tk.tracker_config(model_cfg.get('tracker', {}))
        self.bf = float(model_cfg.get('baseline', 0.25)) * float(
            model_cfg.get('focal_length', 640))
        self.crop = int(model_cfg.get('depth_crop', 96))
        self.reuse_det_depth = bool(model_cfg.get('reuse_det_depth', True))
        self.device = torch.device(device)
        with torch.device(self.device):
            self.module = md.YOLOXDetector(self.det_cfg)
        self.module.load_state_dict(state_dict)
        self.round_tracker = round_tracker

    def init_state(self, n_streams: int) -> tk.TrackState:
        return tk.init_state(self.trk_cfg, self.device, n_streams)

    def disparity(self, disp_u16: torch.Tensor) -> torch.Tensor:
        """The padded (S, H', W') disparity map the depth reads."""
        img = torch.zeros(disp_u16.shape + (3,), dtype=torch.uint8,
                          device=disp_u16.device)
        return md.preprocess(img, disp_u16)['disp_postp'][..., 0].contiguous()

    @torch.no_grad()
    def detect(self, img_u8: torch.Tensor, disp_u16: torch.Tensor,
               scale_factor):
        return md.detect(self.module, md.preprocess(img_u8, disp_u16),
                         scale_factor)

    @torch.no_grad()
    def track(self, state: tk.TrackState, boxes, scores, labels, valid,
              disp: torch.Tensor, fid: torch.Tensor):
        """One tracker step on the (S, Nd) detection rows -> (new state,
        TrackFields)."""
        d_vals, scales = dp.box_depths(disp, boxes, valid, self.crop, self.bf)
        dets = tk.Detections(tk.scale_bbox(boxes, scales), scores,
                             labels.to(torch.int32), scales, d_vals, valid)
        if self.round_tracker is not None:
            dets = self.round_tracker(dets)
        state, ids, tvalid = tk.step(state, dets, fid, self.trk_cfg)
        if self.round_tracker is not None:
            state = self.round_tracker(state)
        unscaled = tk.scale_bbox(dets.bboxes, 1.0 / dets.scales)
        if self.reuse_det_depth:
            t_depths = dets.depths
        else:
            t_depths, _ = dp.box_depths(disp, unscaled, tvalid, self.crop,
                                        self.bf)
        return state, TrackFields(unscaled, dets.scores, dets.labels,
                                  dets.scales, t_depths, ids, tvalid)


def state_from(tensors, device: Optional[torch.device] = None
               ) -> tk.TrackState:
    """A ``TrackState`` from the program's state tensors (same fields, same
    order), copied."""
    return tk.TrackState(*(t.detach().clone().to(device or t.device)
                           for t in tensors))
