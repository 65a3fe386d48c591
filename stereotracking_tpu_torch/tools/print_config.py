"""Print a config with its bases merged and ``--cfg-options`` applied: the
port of ``tools/misc/print_config.py``.

    python -m stereotracking_tpu_torch.tools.print_config CONFIG
        [--cfg-options K=V ...]
"""
from __future__ import annotations

import argparse
import pprint
from typing import List, Optional

from ..config import apply_overrides, load_config


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='*', default=None)
    args = p.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    pprint.pprint(cfg, width=100, sort_dicts=False)
    return cfg


if __name__ == '__main__':
    main()
