"""Host-side data transforms of the eval path, disparity-consistent.

A copy of the loading and resize functions of
``stereotracking_tpu/data/transforms.py`` (the reference mmtrack
``datasets/transforms/loading_disparity.py`` and
``transforms_disparity.py`` without mmcv/cv2): PIL decodes PNGs (including
16-bit disparity), numpy does the geometry.  Conventions preserved: images
are BGR uint8, disparity resizes use nearest interpolation, disparity
post-processing is ``(disp == 65535 -> 0) / 16``.  Pillow is imported by
the functions that read or resize, so the module imports without it (a
caller that hands frames in memory at their own size needs none).  The
training augmentations are not ported.

A sample is a plain dict: img (H,W,3) uint8 BGR, disp (H,W) uint16,
disp_postp (H,W) f32, disp_mask (H,W) f32, optional depth_postp (H,W) f32,
gt_bboxes (N,4) f32 xyxy, gt_labels (N,) i64, gt_ignore (N,) bool, meta.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_image(path: str) -> np.ndarray:
    """RGB file -> BGR uint8 (mmcv channel convention)."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert('RGB'))
    return img[:, :, ::-1].copy()


def load_disparity(path: str) -> np.ndarray:
    """uint16 PNG -> (H, W) uint16 raw disparity (SGBM /16 fixed point)."""
    from PIL import Image
    img = Image.open(path)
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return arr.astype(np.uint16)


def disparity_postprocess(disp: np.ndarray) -> dict:
    """loading_disparity.py:82,129-134 semantics."""
    mask = (disp < 65535).astype(np.float32)
    postp = np.where(disp == 65535, 0, disp).astype(np.float32) / 16.0
    return dict(disp_postp=postp, disp_mask=mask)


def load_depth(path: str, mode: str = 'airsim',
               scale: float = 1.0 / 100) -> np.ndarray:
    """GT depth PNG -> meters.

    ``mode='airsim'``: uint16 centimeters -> /100 (loading_disparity.py:237).
    ``mode='selma'``: 24-bit packed normalized inverse depth
    (loading_disparity.py:215-219): the three 8-bit channels are combined as
    ``B*65535 + G*256 + R`` (the reference reads BGR via cv2 and dots
    ``[65535, 256, 1]``; we read RGB via PIL, so the weight vector reverses),
    normalized by ``2^24 - 1``, then inverted ``1/(d + 1e-6)``.
    """
    from PIL import Image
    if mode == 'selma':
        arr = np.asarray(Image.open(path).convert('RGB'))
        norm = arr.astype(np.float32) @ np.array(
            [1.0, 256.0, 65535.0], np.float32)
        norm = norm / float(256 ** 3 - 1)
        return 1.0 / (norm + 1e-6)
    arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return arr.astype(np.float32) * scale


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _pil_resize(arr: np.ndarray, w: int, h: int, nearest: bool) -> np.ndarray:
    from PIL import Image
    mode = Image.NEAREST if nearest else Image.BILINEAR
    if arr.dtype in (np.float32, np.float64):
        im = Image.fromarray(arr.astype(np.float32), mode='F')
        return np.asarray(im.resize((w, h), mode), dtype=np.float32)
    return np.asarray(Image.fromarray(arr).resize((w, h), mode))


def rescale_factor(h: int, w: int, scale: tuple) -> float:
    """mmcv.imrescale semantics: fit long side to max(scale), short side to
    min(scale)."""
    long_s, short_s = max(scale), min(scale)
    return min(long_s / max(h, w), short_s / min(h, w))


def resize_keep_ratio(sample: dict, scale: tuple) -> dict:
    """Resize all modalities + boxes by the keep-ratio factor
    (transforms_disparity.py:23-137: bilinear img, nearest disp/mask)."""
    h, w = sample['img'].shape[:2]
    f = rescale_factor(h, w, scale)
    nw, nh = int(w * f + 0.5), int(h * f + 0.5)
    out = dict(sample)
    out['img'] = _pil_resize(sample['img'], nw, nh, nearest=False)
    for key in ('disp_postp', 'disp_mask', 'depth_postp'):
        if key in sample and sample[key] is not None:
            out[key] = _pil_resize(sample[key], nw, nh, nearest=True)
    if 'gt_bboxes' in sample and len(sample['gt_bboxes']):
        out['gt_bboxes'] = sample['gt_bboxes'] * f
    out['scale_factor'] = (nw / w, nh / h)
    out['img_shape'] = (nh, nw)
    return out
