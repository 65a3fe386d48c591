"""The YOLOX detector in float32 on plain modules: the dual-branch backbone
(an RGB and a disparity Focus stem and stage 1, averaged, then the shared
stages 2-4), PAFPN, the decoupled head, decode, class-aware greedy NMS and
the rescale to the source frame.

Module and parameter names are mmyolo's, the same as the port's, so one
state dict loads into both.  BatchNorm is folded into a per-channel scale
and bias after each convolution (eval semantics).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 0.001
# in_ch, out_ch, num_blocks, add_identity, use_spp
P5_ARCH = [(64, 128, 3, True, False), (128, 256, 9, True, False),
           (256, 512, 9, True, False), (512, 1024, 3, False, True)]
PAD_DIVISOR = 32


class DetectorConfig(NamedTuple):
    num_classes: int = 1
    deepen_factor: float = 0.33
    widen_factor: float = 0.5
    strides: Tuple[int, ...] = (8, 16, 32)
    backbone: str = 'dual'
    score_thr: float = 0.01
    nms_iou_thr: float = 0.5
    max_per_img: int = 300
    pre_nms_top_k: int = 2048


def widen(channels: int, widen_factor: float, divisor: int = 8) -> int:
    return math.ceil(channels * widen_factor / divisor) * divisor


def make_round(x: float, deepen_factor: float) -> int:
    return max(round(x * deepen_factor), 1) if x > 1 else int(x)


def padded_shape(h: int, w: int) -> Tuple[int, int]:
    return (-(-h // PAD_DIVISOR) * PAD_DIVISOR,
            -(-w // PAD_DIVISOR) * PAD_DIVISOR)


class ConvBNAct(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.eval()

    def forward(self, x):
        bn = self.bn
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        bias = bn.bias - bn.running_mean * scale
        return F.silu(self.conv(x) * scale[:, None, None]
                      + bias[:, None, None])


class Focus(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBNAct(4 * cin, cout, 3)

    def forward(self, x):
        return self.conv(torch.cat((x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]),
                                   dim=1))


class DarknetBottleneck(nn.Module):
    def __init__(self, c, add_identity=True):
        super().__init__()
        self.conv1 = ConvBNAct(c, c, 1)
        self.conv2 = ConvBNAct(c, c, 3)
        self.add_identity = add_identity

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + x if self.add_identity else out


class CSPLayer(nn.Module):
    def __init__(self, cin, cout, num_blocks=1, add_identity=True):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvBNAct(cin, mid, 1)
        self.short_conv = ConvBNAct(cin, mid, 1)
        self.blocks = nn.Sequential(*[DarknetBottleneck(mid, add_identity)
                                      for _ in range(num_blocks)])
        self.final_conv = ConvBNAct(2 * mid, cout, 1)

    def forward(self, x):
        main = self.blocks(self.main_conv(x))
        return self.final_conv(torch.cat((main, self.short_conv(x)), dim=1))


class SPPFBottleneck(nn.Module):
    def __init__(self, cin, cout, kernel_sizes=(5, 9, 13)):
        super().__init__()
        mid = cin // 2
        self.conv1 = ConvBNAct(cin, mid, 1)
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv2 = ConvBNAct(mid * (len(self.kernel_sizes) + 1), cout, 1)

    def forward(self, x):
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in self.kernel_sizes]
        return self.conv2(torch.cat([x] + pools, dim=1))


def _stage(cin, cout, n, add_identity, use_spp):
    layers = [ConvBNAct(cin, cout, 3, 2)]
    if use_spp:
        layers.append(SPPFBottleneck(cout, cout))
    layers.append(CSPLayer(cout, cout, n, add_identity))
    return nn.Sequential(*layers)


def _stage_args(deepen, widen_f):
    stem_ch = widen(64, widen_f)
    args, cin = [], stem_ch
    for _, out, n, ident, spp in P5_ARCH:
        cout = widen(out, widen_f)
        args.append((cin, cout, make_round(n, deepen), ident, spp))
        cin = cout
    return stem_ch, args


class CSPDarknetDual(nn.Module):
    def __init__(self, deepen, widen_f):
        super().__init__()
        stem_ch, args = _stage_args(deepen, widen_f)
        self.stem = Focus(3, stem_ch)
        self.disp_stem = Focus(3, stem_ch)
        for i, a in enumerate(args):
            setattr(self, f'stage{i + 1}', _stage(*a))
            if i == 0:
                self.disp_stage1 = _stage(*a)

    def forward(self, inputs):
        rgb = self.stem(inputs['img'].permute(0, 3, 1, 2))
        dsp = self.disp_stem(inputs['disp_postp'].permute(0, 3, 1, 2))
        y = (self.stage1(rgb) + self.disp_stage1(dsp)) / 2.0
        y2 = self.stage2(y)
        y3 = self.stage3(y2)
        return y2, y3, self.stage4(y3)


class YOLOXPAFPN(nn.Module):
    def __init__(self, deepen, widen_f, in_channels=(256, 512, 1024),
                 out_channels=256):
        super().__init__()
        ch = [widen(c, widen_f) for c in in_channels]
        n = len(ch)
        num_csp = make_round(3, deepen)
        self.reduce_layers = nn.ModuleList(
            ConvBNAct(ch[i], ch[i - 1], 1) for i in range(n - 1, 0, -1))
        self.top_down_blocks = nn.ModuleList(
            CSPLayer(2 * ch[i - 1], ch[i - 1], num_csp, False)
            for i in range(n - 1, 0, -1))
        self.downsamples = nn.ModuleList(ConvBNAct(ch[i], ch[i], 3, 2)
                                         for i in range(n - 1))
        self.bottom_up_blocks = nn.ModuleList(
            CSPLayer(2 * ch[i], ch[i + 1], num_csp, False)
            for i in range(n - 1))
        out_ch = widen(out_channels, widen_f)
        self.out_convs = nn.ModuleList(ConvBNAct(c, out_ch, 1) for c in ch)

    def forward(self, feats):
        n = len(feats)
        inner = [feats[-1]]
        for idx in range(n - 1, 0, -1):
            j = n - 1 - idx
            high = self.reduce_layers[j](inner[0])
            inner[0] = high
            up = F.interpolate(high, scale_factor=2, mode='nearest')
            inner.insert(0, self.top_down_blocks[j](
                torch.cat([up, feats[idx - 1]], 1)))
        outs = [inner[0]]
        for idx in range(n - 1):
            low = self.downsamples[idx](outs[-1])
            outs.append(self.bottom_up_blocks[idx](
                torch.cat([low, inner[idx + 1]], 1)))
        return [conv(o) for conv, o in zip(self.out_convs, outs)]


class YOLOXHeadModule(nn.Module):
    def __init__(self, num_classes, widen_f, strides, in_channels=256,
                 feat_channels=256, stacked_convs=2):
        super().__init__()
        cin, feat = widen(in_channels, widen_f), widen(feat_channels, widen_f)

        def stack():
            return nn.Sequential(*[ConvBNAct(cin if i == 0 else feat, feat, 3)
                                   for i in range(stacked_convs)])

        n = len(strides)
        self.multi_level_cls_convs = nn.ModuleList(stack() for _ in range(n))
        self.multi_level_reg_convs = nn.ModuleList(stack() for _ in range(n))
        self.multi_level_conv_cls = nn.ModuleList(
            nn.Conv2d(feat, num_classes, 1) for _ in range(n))
        self.multi_level_conv_reg = nn.ModuleList(
            nn.Conv2d(feat, 4, 1) for _ in range(n))
        self.multi_level_conv_obj = nn.ModuleList(
            nn.Conv2d(feat, 1, 1) for _ in range(n))

    def forward(self, feats):
        cls, reg, obj = [], [], []
        for lvl, x in enumerate(feats):
            c = self.multi_level_cls_convs[lvl](x)
            r = self.multi_level_reg_convs[lvl](x)
            cls.append(self.multi_level_conv_cls[lvl](c).permute(0, 2, 3, 1))
            reg.append(self.multi_level_conv_reg[lvl](r).permute(0, 2, 3, 1))
            obj.append(self.multi_level_conv_obj[lvl](r).permute(0, 2, 3, 1))
        return cls, reg, obj


class YOLOXHead(nn.Module):
    def __init__(self, **kwargs):
        super().__init__()
        self.head_module = YOLOXHeadModule(**kwargs)

    def forward(self, feats):
        return self.head_module(feats)


class YOLOXDetector(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.backbone != 'dual':
            raise ValueError(f'the reference has the dual backbone only, '
                             f'not {cfg.backbone!r}')
        self.backbone = CSPDarknetDual(cfg.deepen_factor, cfg.widen_factor)
        self.neck = YOLOXPAFPN(cfg.deepen_factor, cfg.widen_factor)
        self.bbox_head = YOLOXHead(num_classes=cfg.num_classes,
                                   widen_f=cfg.widen_factor,
                                   strides=cfg.strides)
        self.eval()

    def forward(self, inputs):
        return self.bbox_head(self.neck(self.backbone(inputs)))


def preprocess(img_u8, disp_u16):
    """(S, H, W, 3) uint8 + (S, H, W) uint16 -> the padded float32 NHWC
    'img' and 'disp_postp' (disparity / 16, 65535 -> 0, three channels)."""
    n, h, w = img_u8.shape[:3]
    oh, ow = padded_shape(h, w)
    img = F.pad(img_u8.to(torch.float32), (0, 0, 0, ow - w, 0, oh - h))
    disp = disp_u16.to(torch.int32)
    dp = torch.where(disp == 65535, 0, disp).to(torch.float32) / 16.0
    dp = F.pad(dp, (0, ow - w, 0, oh - h))
    return {'img': img, 'disp_postp': dp[..., None].expand(n, oh, ow, 3)}


def level_priors(h, w, stride, device):
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    return torch.stack([gx, gy], -1).reshape(-1, 2)


def decode(cls_maps, reg_maps, obj_maps, strides):
    """-> boxes (S, A, 4) xyxy and scores (S, A, C) float32."""
    boxes, scores = [], []
    for cls, reg, obj, stride in zip(cls_maps, reg_maps, obj_maps, strides):
        n, h, w, nc = cls.shape
        pri = level_priors(h, w, stride, cls.device)
        reg = reg.reshape(n, h * w, 4).float()
        xy = reg[..., :2] * stride + pri[None]
        wh = torch.exp(reg[..., 2:]) * stride
        boxes.append(torch.cat([xy - wh / 2.0, xy + wh / 2.0], -1))
        scores.append(torch.sigmoid(cls.reshape(n, h * w, nc).float())
                      * torch.sigmoid(obj.reshape(n, h * w, 1).float()))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def iou_matrix(b1, b2, eps=1e-6):
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lt = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    rb = torch.minimum(b1[..., :, None, 2:], b2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (a1[..., :, None] + a2[..., None, :] - inter).clamp(min=eps)
    return inter / union


def greedy_keep(boxes, finite, thr, max_keep):
    """Greedy NMS keep set of score-sorted (S, k, 4) boxes (suppress IoU
    strictly above ``thr``), cut after ``max_keep`` kept boxes."""
    k = boxes.shape[1]
    iou = iou_matrix(boxes, boxes)
    rows = torch.arange(k, device=boxes.device)
    sup = ((iou > thr) & (rows[:, None] < rows[None, :])
           & finite[:, :, None] & finite[:, None, :])
    keep = finite
    while True:
        prev, keep = keep, ~(sup & keep[:, :, None]).any(1) & finite
        if bool((prev == keep).all()):
            break
    return keep & (torch.cumsum(keep.to(torch.int32), 1) <= max_keep)


class Candidates(NamedTuple):
    """Every class-aware candidate of each stream, in the source frame:
    boxes (S, A*C, 4), scores and labels (S, A*C)."""
    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor


class Kept(NamedTuple):
    """What NMS keeps, score-sorted: boxes (S, M, 4), scores, labels and
    valid (S, M)."""
    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


@torch.no_grad()
def detect(module: YOLOXDetector, inputs: dict, scale_factor
           ) -> Tuple[Candidates, Kept]:
    """All candidates and the NMS result of the frames in ``inputs``; boxes
    divided by ``scale_factor`` (sf_x, sf_y) to the source frame."""
    cfg = module.cfg
    boxes, scores = decode(*module(inputs), cfg.strides)
    s, a, c = scores.shape
    flat = scores.reshape(s, a * c)
    labels = torch.arange(c, dtype=torch.int32,
                          device=flat.device).repeat(a).expand_as(flat)
    fb = boxes.repeat_interleave(c, dim=1) if c > 1 else boxes
    flat = torch.where(flat > cfg.score_thr, flat, 0.0)
    k = min(cfg.pre_nms_top_k, a * c)
    masked = torch.where(flat > cfg.score_thr, flat, float('-inf'))
    top_s, top_i = torch.sort(masked, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    top_b = fb.gather(1, top_i[..., None].expand(-1, -1, 4))
    top_l = labels.gather(1, top_i)
    finite = torch.isfinite(top_s)
    span = torch.where(torch.isfinite(top_b), top_b, 0.0).amax(
        dim=(1, 2), keepdim=True) + 1.0
    keep = greedy_keep(top_b + top_l.to(torch.float32)[..., None] * span,
                       finite, cfg.nms_iou_thr, cfg.max_per_img)
    order = torch.sort((~keep).to(torch.int8), dim=1,
                       stable=True).indices[:, :min(cfg.max_per_img, k)]
    valid = keep.gather(1, order)
    sf = torch.tensor([scale_factor[0], scale_factor[1]] * 2,
                      dtype=torch.float32, device=fb.device)
    kept = Kept(
        torch.where(valid[..., None], top_b.gather(
            1, order[..., None].expand(-1, -1, 4)), 0.0) / sf,
        torch.where(valid, top_s.gather(1, order), 0.0),
        torch.where(valid, top_l.gather(1, order), 0).to(torch.int32),
        valid)
    return Candidates(fb / sf, flat, labels), kept


def detector_config(model_cfg: dict) -> DetectorConfig:
    """The detector's settings from a config's ``model`` dict (mm keys)."""
    det = model_cfg.get('detector', {})
    backbone = det.get('backbone', {})
    head = det.get('bbox_head', {}).get('head_module', {})
    test = det.get('test_cfg', {})
    return DetectorConfig(
        num_classes=head.get('num_classes', 1),
        deepen_factor=backbone.get('deepen_factor', 0.33),
        widen_factor=backbone.get('widen_factor', 0.5),
        backbone=('dual' if backbone.get('type', '').endswith(
            'Disparity_V1_MMYOLO') else backbone.get('type', '')),
        score_thr=test.get('score_thr', 0.01),
        nms_iou_thr=test.get('nms', {}).get('iou_threshold', 0.65),
        max_per_img=test.get('max_per_img', 300))

