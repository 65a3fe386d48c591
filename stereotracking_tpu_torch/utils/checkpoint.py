"""Reference PyTorch checkpoints -> the port detector's weights.

The ``'mot'`` route of the JAX package's ``init_model``
(``stereotracking_tpu/utils/torch_convert.py``: ``load_torch_checkpoint``
then ``convert_yolox_state_dict``), for the port: the port's module names
are the mmdet / mmyolo keys already, so the conversion is a key filter, not
a re-layout.

- ``torch.load(map_location='cpu')``, then ``ckpt.get('state_dict', ckpt)``;
- the ``detector.`` prefix stripped;
- the RGB ``backbone.stem`` and ``backbone.stage1`` weights copied into the
  disparity branch (``disp_stem``, ``disp_stage1``), as the JAX converter
  does (the reference's ColorPretrained duplication), so that both packages
  load a reference checkpoint to the same weights;
- a key the detector needs that the checkpoint lacks, or holds at another
  shape, raises: the JAX path fails there too, and random weights are
  never kept silently.  Keys the detector does not read are ignored.

A checkpoint whose ``meta`` says ``format: DETECTOR_FORMAT`` is this
package's own export (``train/checkpoint.extract_detector_variables``):
``detector_state_dict`` loads it as it is, the disparity branch's own stem
and stage 1 included, with the same checks.  JAX-native checkpoints
(orbax / msgpack) need flax to read and are not handled here.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

# ``meta['format']`` of a detector checkpoint that this package exported
DETECTOR_FORMAT = 'stereotracking_tpu_torch.detector'
_BRANCH_COPIES = (('backbone.disp_stem.', 'backbone.stem.'),
                  ('backbone.disp_stage1.', 'backbone.stage1.'))


def detector_state_dict(path: str, module: nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """The state dict of ``module`` (a ``YOLOXDetector``) read from the
    ``.pth`` at ``path``: this package's export as it is, anything else by
    the reference route (``mot_state_dict``)."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    meta = ckpt.get('meta') if isinstance(ckpt, dict) else None
    if isinstance(meta, dict) and meta.get('format') == DETECTOR_FORMAT:
        return mot_state_dict(ckpt['state_dict'], module, branch_copy=False)
    sd = ckpt.get('state_dict', ckpt)
    return mot_state_dict(
        {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}, module)


def mot_state_dict(src: Dict[str, torch.Tensor], module: nn.Module,
                   branch_copy: bool = True) -> Dict[str, torch.Tensor]:
    """The state dict of ``module`` (a ``YOLOXDetector``) read from the
    checkpoint ``src``; every tensor float32, BatchNorm's
    ``num_batches_tracked`` zero.  ``branch_copy``: the disparity branch
    read from the RGB keys (a reference checkpoint), else from its own."""
    src = {k[len('detector.'):] if k.startswith('detector.') else k: v
           for k, v in src.items()}
    out, missing, wrong = {}, [], []
    for key, ref in module.state_dict().items():
        if key.endswith('num_batches_tracked'):
            out[key] = torch.zeros_like(ref)
            continue
        name = key
        for mine, theirs in _BRANCH_COPIES if branch_copy else ():
            if key.startswith(mine):
                name = theirs + key[len(mine):]
        val = src.get(name)
        if val is None:
            missing.append(name)
        elif tuple(val.shape) != tuple(ref.shape):
            wrong.append(f'{name} {tuple(val.shape)} vs {tuple(ref.shape)}')
        else:
            out[key] = val.detach().to(torch.float32).clone()
    if missing or wrong:
        raise ValueError(
            f'checkpoint does not fit the detector: {len(missing)} keys '
            f'missing {missing[:5]}, {len(wrong)} of another shape '
            f'{wrong[:5]}')
    return out

