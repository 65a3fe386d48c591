"""Weight bridge: the JAX package's Flax ``variables`` -> the port's weights.

Takes ``{'params': ..., 'batch_stats': ...}`` of the JAX ``YOLOXDetector``
(nested dicts of arrays; numpy or anything ``np.asarray`` accepts) and
returns a ``state_dict`` for ``models.detector.YOLOXDetector``:

- conv kernels HWIO -> OIHW;
- BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var (plus ``num_batches_tracked``);
- module paths renamed to the mmdet / mmyolo keys the port uses, the same
  mapping as ``stereotracking_tpu/utils/torch_convert.py:10-19``.

Branch weights are carried as they are: the disparity branch keeps its own
stem and stage 1.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_RENAMES = [
    (re.compile(r'^blocks_(\d+)$'), r'blocks.\1'),
    (re.compile(r'^reduce_(\d+)$'), r'reduce_layers.\1'),
    (re.compile(r'^top_down_(\d+)$'), r'top_down_blocks.\1'),
    (re.compile(r'^downsample_(\d+)$'), r'downsamples.\1'),
    (re.compile(r'^bottom_up_(\d+)$'), r'bottom_up_blocks.\1'),
    (re.compile(r'^out_(\d+)$'), r'out_convs.\1'),
    (re.compile(r'^cls_convs_(\d+)_(\d+)$'), r'multi_level_cls_convs.\1.\2'),
    (re.compile(r'^reg_convs_(\d+)_(\d+)$'), r'multi_level_reg_convs.\1.\2'),
    (re.compile(r'^conv_(cls|reg|obj)_(\d+)$'), r'multi_level_conv_\1.\2'),
]
_LEAVES = {('params', 'kernel'): 'weight', ('params', 'bias'): 'bias',
           ('params', 'scale'): 'weight', ('batch_stats', 'mean'):
           'running_mean', ('batch_stats', 'var'): 'running_var'}


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(path) -> str:
    out = []
    for i, seg in enumerate(path):
        if i == 0 and seg == 'bbox_head':
            out.append('bbox_head.head_module')
            continue
        m = re.match(r'^(disp_)?stage(\d)$', seg)
        if m and i == 1 and path[0] == 'backbone':
            nxt = path[i + 1]
            idx = {'conv': 0, 'spp': 1, 'csp': 2 if seg == 'stage4' else 1}
            out.append(f'{seg}.{idx[nxt]}')
            continue
        if i >= 2 and path[0] == 'backbone' and re.match(
                r'^(disp_)?stage\d$', path[1]) and i == 2:
            continue          # consumed by the stage index above
        for pat, rep in _RENAMES:
            if pat.match(seg):
                seg = pat.sub(rep, seg)
                break
        out.append(seg)
    return '.'.join(out)


def flax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax YOLOXDetector variables -> the port detector's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ('params', 'batch_stats'):
        for path, value in _flatten(variables[coll]):
            key = f'{_module_path(path[:-1])}.{_LEAVES[(coll, path[-1])]}'
            arr = np.asarray(value, dtype=np.float32)
            if path[-1] == 'kernel':
                arr = arr.transpose(3, 2, 0, 1)
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for key in [k for k in sd if k.endswith('.running_var')]:
        sd[key[:-len('running_var')] + 'num_batches_tracked'] = \
            torch.zeros((), dtype=torch.int64)
    return sd
