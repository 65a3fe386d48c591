"""Python-file configs with ``_base_`` inheritance and dotted CLI overrides.

A copy of ``stereotracking_tpu/config.py`` (pure Python): a config file is
plain python executed in an empty namespace; a ``_base_`` list names parent
files (relative to the file) merged depth-first with child-overrides-parent
dict semantics.  Copied rather than imported because importing the JAX
package can import ``jax``.
"""
from __future__ import annotations

import copy
import os.path as osp
from typing import Any, Dict, List, Optional


def _merge_dict(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k == '_delete_':
            continue
        if isinstance(v, dict) and v.get('_delete_', False):
            v = {kk: vv for kk, vv in v.items() if kk != '_delete_'}
            out[k] = copy.deepcopy(v)
        elif k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge_dict(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> Dict[str, Any]:
    """Execute a python config file and merge its ``_base_`` chain."""
    path = osp.abspath(path)
    ns: Dict[str, Any] = {}
    with open(path) as f:
        code = compile(f.read(), path, 'exec')
    exec(code, ns)
    cfg = {k: v for k, v in ns.items() if not k.startswith('__')}
    bases = cfg.pop('_base_', [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        parent = load_config(osp.join(osp.dirname(path), b))
        merged = _merge_dict(merged, parent)
    return _merge_dict(merged, cfg)


def apply_overrides(cfg: dict, options: Optional[List[str]]) -> dict:
    """Apply ``key.sub=value`` CLI overrides (values parsed as python
    literals when possible)."""
    import ast
    if not options:
        return cfg
    cfg = copy.deepcopy(cfg)
    for opt in options:
        key, _, raw = opt.partition('=')
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        parts = key.split('.')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg
