"""Host-side data transforms of the eval and train paths,
disparity-consistent.

A copy of the loading, geometry and augmentation functions of
``stereotracking_tpu/data/transforms.py`` (the reference mmtrack
``datasets/transforms/loading_disparity.py``, ``transforms_disparity.py``
and ``mix_img_transforms_mmyolo_disparity.py`` without mmcv/cv2): PIL
decodes PNGs (including 16-bit disparity), numpy does the geometry.
Conventions preserved: images are BGR uint8, disparity resizes use nearest
interpolation, disparity post-processing is ``(disp == 65535 -> 0) / 16``.
Pillow is imported by the functions that read or resize (among them
``yolox_mixup``), so the module imports without it (a caller that hands
frames in memory at their own size needs none).  The train pipeline's
functions are those ``tools/train.make_batch`` calls; ``yolox_mosaic``,
``rand_cutout`` and ``disp_to_color_img``, which no entry point uses, are
not ported.

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


def pad_to_divisor(sample: dict, divisor: int = 32,
                   pad_val_img: float = 114.0) -> dict:
    """Bottom/right pad: img 114, disp/mask/depth 0
    (config pad_val, transforms_disparity.py:140-251)."""
    h, w = sample['img'].shape[:2]
    nh = -(-h // divisor) * divisor
    nw = -(-w // divisor) * divisor
    out = dict(sample)
    out['img'] = np.pad(sample['img'], ((0, nh - h), (0, nw - w), (0, 0)),
                        constant_values=pad_val_img).astype(np.uint8)
    for key in ('disp_postp', 'disp_mask', 'depth_postp'):
        if key in sample and sample[key] is not None:
            out[key] = np.pad(sample[key], ((0, nh - h), (0, nw - w)))
    out['pad_shape'] = (nh, nw)
    return out


def random_flip(sample: dict, rng: np.random.RandomState,
                prob: float = 0.5) -> dict:
    """Horizontal flip of all modalities + boxes
    (transforms_disparity.py:253-313)."""
    if rng.rand() >= prob:
        return sample
    out = dict(sample)
    w = sample['img'].shape[1]
    out['img'] = sample['img'][:, ::-1].copy()
    for key in ('disp_postp', 'disp_mask', 'depth_postp'):
        if key in sample and sample[key] is not None:
            out[key] = sample[key][:, ::-1].copy()
    if 'gt_bboxes' in sample and len(sample['gt_bboxes']):
        b = sample['gt_bboxes'].copy()
        b[:, [0, 2]] = w - sample['gt_bboxes'][:, [2, 0]]
        out['gt_bboxes'] = b
    out['flip'] = True
    return out


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

def hsv_random_aug(img_bgr: np.ndarray, rng: np.random.RandomState,
                   hue_delta: int = 5, saturation_delta: int = 30,
                   value_delta: int = 30) -> np.ndarray:
    """mmdet YOLOXHSVRandomAug behavior: integer HSV jitter."""
    dh = rng.uniform(-hue_delta, hue_delta)
    ds = rng.uniform(-saturation_delta, saturation_delta)
    dv = rng.uniform(-value_delta, value_delta)

    img = img_bgr.astype(np.float32) / 255.0
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    mx = np.max(img, axis=-1)
    mn = np.min(img, axis=-1)
    diff = mx - mn + 1e-10
    hx = np.zeros_like(mx)
    sel = mx == r
    hx[sel] = (60 * (g - b) / diff)[sel] % 360
    sel = mx == g
    hx[sel] = (60 * (b - r) / diff + 120)[sel]
    sel = mx == b
    hx[sel] = (60 * (r - g) / diff + 240)[sel]
    s = np.where(mx > 0, diff / (mx + 1e-10), 0.0)
    v = mx

    # opencv-style ranges: h/2 in [0,180), s,v in [0,255]
    h2 = (hx / 2.0 + dh) % 180
    s2 = np.clip(s * 255.0 + ds, 0, 255) / 255.0
    v2 = np.clip(v * 255.0 + dv, 0, 255) / 255.0

    hp = (h2 * 2.0) / 60.0
    i = np.floor(hp).astype(int) % 6
    f = hp - np.floor(hp)
    p = v2 * (1 - s2)
    q = v2 * (1 - f * s2)
    t = v2 * (1 - (1 - f) * s2)
    r2 = np.choose(i, [v2, q, p, p, t, v2])
    g2 = np.choose(i, [t, v2, v2, q, p, p])
    b2 = np.choose(i, [p, p, t, v2, v2, q])
    out = np.stack([b2, g2, r2], axis=-1)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# mixed-image augmentation and annotation filtering
# ---------------------------------------------------------------------------

def yolox_mixup(sample: dict, other: dict, rng: np.random.RandomState,
                img_scale: tuple = (720, 1280),
                ratio_range: tuple = (0.8, 1.6), flip_ratio: float = 0.5,
                pad_val: float = 114.0) -> dict:
    """Disparity-consistent YOLOX MixUp
    (mix_img_transforms_mmyolo_disparity.py:161-348)."""
    if len(other.get('gt_bboxes', [])) == 0:
        return sample

    jit = rng.uniform(*ratio_range)
    do_flip = rng.uniform(0, 1) > flip_ratio

    oh, ow = other['img'].shape[:2]
    sh, sw = img_scale
    ratio = min(sh / oh, sw / ow)
    rw, rh = int(ow * ratio), int(oh * ratio)

    canvas = np.full((sh, sw, 3), pad_val, np.float32)
    canvas_d = np.zeros((sh, sw), np.float32)
    canvas_m = np.zeros((sh, sw), np.float32)
    canvas[:rh, :rw] = _pil_resize(other['img'], rw, rh, nearest=False)
    canvas_d[:rh, :rw] = _pil_resize(other['disp_postp'], rw, rh, True)
    canvas_m[:rh, :rw] = _pil_resize(other['disp_mask'], rw, rh, True)

    jw, jh = int(sw * jit), int(sh * jit)
    canvas = _pil_resize(canvas.astype(np.uint8), jw, jh, False)
    canvas_d = _pil_resize(canvas_d, jw, jh, True)
    canvas_m = _pil_resize(canvas_m, jw, jh, True)
    scale_total = ratio * jit

    if do_flip:
        canvas = canvas[:, ::-1]
        canvas_d = canvas_d[:, ::-1]
        canvas_m = canvas_m[:, ::-1]

    th, tw = sample['img'].shape[:2]
    ph, pw = max(jh, th), max(jw, tw)
    padded = np.full((ph, pw, 3), pad_val, np.float32)
    padded_d = np.zeros((ph, pw), np.float32)
    padded_m = np.zeros((ph, pw), np.float32)
    padded[:jh, :jw] = canvas
    padded_d[:jh, :jw] = canvas_d
    padded_m[:jh, :jw] = canvas_m

    y_off = rng.randint(0, ph - th + 1)
    x_off = rng.randint(0, pw - tw + 1)
    crop = padded[y_off:y_off + th, x_off:x_off + tw]
    crop_d = padded_d[y_off:y_off + th, x_off:x_off + tw]
    crop_m = padded_m[y_off:y_off + th, x_off:x_off + tw]

    boxes = other['gt_bboxes'] * scale_total
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, jw)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, jh)
    if do_flip:
        boxes[:, [0, 2]] = jw - boxes[:, [2, 0]]
    boxes[:, 0::2] -= x_off
    boxes[:, 1::2] -= y_off
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, tw)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, th)

    out = dict(sample)
    out['img'] = (0.5 * sample['img'] + 0.5 * crop).astype(np.uint8)
    out['disp_postp'] = 0.5 * sample['disp_postp'] + 0.5 * crop_d
    out['disp_mask'] = np.maximum(sample['disp_mask'], crop_m)
    out['gt_bboxes'] = np.concatenate(
        [sample['gt_bboxes'].reshape(-1, 4), boxes], axis=0)
    out['gt_labels'] = np.concatenate(
        [sample['gt_labels'], other['gt_labels']], axis=0)
    out['gt_ignore'] = np.concatenate(
        [sample.get('gt_ignore', np.zeros(len(sample['gt_labels']), bool)),
         other.get('gt_ignore', np.zeros(len(other['gt_labels']), bool))])
    return out


def filter_annotations(sample: dict, min_wh: tuple = (1, 1)) -> dict:
    """mmdet FilterAnnotations(min_gt_bbox_wh, keep_empty=False)."""
    if 'gt_bboxes' not in sample or len(sample['gt_bboxes']) == 0:
        return sample
    b = sample['gt_bboxes']
    keep = ((b[:, 2] - b[:, 0]) > min_wh[0]) & \
           ((b[:, 3] - b[:, 1]) > min_wh[1])
    out = dict(sample)
    out['gt_bboxes'] = b[keep]
    out['gt_labels'] = sample['gt_labels'][keep]
    if 'gt_ignore' in sample:
        out['gt_ignore'] = sample['gt_ignore'][keep]
    return out
