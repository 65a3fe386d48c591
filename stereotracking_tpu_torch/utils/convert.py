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
stem and stage 1.  The single-branch tree (``backbone/stem``,
``backbone/stageN``) and the concatenated one (``backbone/trunk/...``)
map by the same rules, to ``backbone.stem`` / ``backbone.trunk.stem`` and
so on.  ``train_state_to_torch`` carries a whole JAX
``TrainState`` (weights, momentum trace, EMA and step) to the port's
``TrainState.load_state_dict``; ``aflink_to_state_dict`` the JAX AFLink
linker's weights to ``evaluation.aflink.AFLinkModel``.
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
    # a backbone stage sits at backbone/<stage>, or at backbone/trunk/<stage>
    # in the concatenated backbone; its conv / spp / csp become indices
    at = 2 if tuple(path[:2]) == ('backbone', 'trunk') else 1
    is_stage = (path[0] == 'backbone' and len(path) > at
                and re.match(r'^(disp_)?stage\d$', path[at]))
    out = []
    for i, seg in enumerate(path):
        if i == 0 and seg == 'bbox_head':
            out.append('bbox_head.head_module')
            continue
        if is_stage and i == at:
            idx = {'conv': 0, 'spp': 1, 'csp': 2 if seg == 'stage4' else 1}
            out.append(f'{seg}.{idx[path[i + 1]]}')
            continue
        if is_stage and i == at + 1:
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


def _momentum_trace(opt_state: Any) -> Any:
    """The momentum trace inside an optax state (the ``trace`` field of
    the ``TraceState`` of ``optax.sgd(momentum=...)``), found by walking
    its (named) tuples, so that neither optax nor flax is imported."""
    if 'trace' in getattr(opt_state, '_fields', ()):
        return opt_state.trace
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _momentum_trace(sub)
            if found is not None:
                return found
    return None


def train_state_to_torch(state: Any) -> Dict[str, Any]:
    """A JAX ``TrainState`` (``stereotracking_tpu/train/train_state.py``:
    step, params, batch_stats, opt_state, ema_params, ema_batch_stats) ->
    the port's ``TrainState.state_dict()``: the module and EMA state dicts
    (``flax_to_state_dict``), the momentum trace of ``opt_state`` by
    parameter name (it has the tree of ``params``, so the same mapping
    applies) and ``step``."""
    from ..train.train_state import TRAIN_FORMAT
    trace = _momentum_trace(state.opt_state)
    if trace is None:
        raise ValueError('no momentum trace in the optimizer state')
    return dict(
        format=TRAIN_FORMAT, step=int(np.asarray(state.step)),
        model=flax_to_state_dict({'params': state.params,
                                  'batch_stats': state.batch_stats}),
        ema=flax_to_state_dict({'params': state.ema_params,
                                'batch_stats': state.ema_batch_stats}),
        momentum=flax_to_state_dict({'params': trace,
                                     'batch_stats': {}}))


def aflink_to_state_dict(variables: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """The JAX ``AFLinkModel``'s Flax ``variables`` (``{'params': ...}``,
    numpy or anything ``np.asarray`` accepts) -> a ``state_dict`` for
    ``evaluation.aflink.AFLinkModel``: conv kernels HWIO -> OIHW, ``Dense``
    kernels (in, out) transposed to (out, in), biases as they are."""
    params = variables.get('params', variables)
    out = {}
    enc = params['encoder']
    for name in ('tconv0', 'tconv1', 'tconv2', 'tconv3', 'fusion'):
        k = np.asarray(enc[name]['kernel'], np.float32)
        out[f'encoder.{name}.weight'] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    for name in ('fc1', 'fc2'):
        out[f'{name}.weight'] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(params[name]['kernel'], np.float32).T))
        out[f'{name}.bias'] = torch.from_numpy(
            np.array(params[name]['bias'], np.float32))
    return out
