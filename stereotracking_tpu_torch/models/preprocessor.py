"""Device-side frame preparation: cast, invalid-pixel mask, /16, pad.

Port of ``stereotracking_tpu/models/preprocessor.py``.  Raw decoded frames
(uint8 BGR image, uint16 fixed-point disparity, 65535 = invalid) become the
padded NHWC float tensors the detector and the depth extraction consume.
No mean/std normalisation or channel swap (the model reads raw 0-255 BGR).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

PAD_DIVISOR = 32


def padded_shape(h: int, w: int,
                 divisor: int = PAD_DIVISOR) -> Tuple[int, int]:
    return (-(-h // divisor) * divisor, -(-w // divisor) * divisor)


def preprocess_frame_pure(img_u8: torch.Tensor, disp_u16: torch.Tensor,
                          out_h: int, out_w: int,
                          depth_raw: Optional[torch.Tensor] = None,
                          ) -> Dict[str, torch.Tensor]:
    """(H, W, 3) uint8 + (H, W) uint16 -> dict of (1, H', W', C) float32:
    'img', 'disp_postp' (disparity repeated to 3 channels), 'disp_mask',
    and 'depth_postp' when ``depth_raw`` is given.  S frames at once:
    (S, H, W, 3) + (S, H, W) [+ (S, H, W)] -> (S, H', W', C)."""
    if img_u8.dim() == 3:
        img_u8, disp_u16 = img_u8[None], disp_u16[None]
        depth_raw = None if depth_raw is None else depth_raw[None]
    n, h, w = img_u8.shape[:3]
    ph, pw = out_h - h, out_w - w

    img = F.pad(img_u8.to(torch.float32), (0, 0, 0, pw, 0, ph))
    disp = disp_u16.to(torch.int32)
    mask = (disp < 65535).to(torch.float32)
    disp_postp = torch.where(disp == 65535, 0, disp).to(torch.float32) / 16.0
    disp_postp = F.pad(disp_postp, (0, pw, 0, ph))
    mask = F.pad(mask, (0, pw, 0, ph))

    out = {
        'img': img,
        'disp_postp': disp_postp[..., None].expand(n, out_h, out_w, 3),
        'disp_mask': mask[..., None],
    }
    if depth_raw is not None:
        depth = F.pad(depth_raw.to(torch.float32), (0, pw, 0, ph))
        out['depth_postp'] = depth[..., None]
    return out
