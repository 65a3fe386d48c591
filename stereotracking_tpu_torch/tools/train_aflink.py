"""Train the AFLink tracklet linker on synthetic motion windows: the port
of ``tools/utils/train_aflink.py``.

    python -m stereotracking_tpu_torch.tools.train_aflink [--out PT]
        [--steps N] [--batch N] [--lr LR] [--seed S] [--device cuda|cpu]

Writes a ``.pt`` checkpoint that ``stereotracking_tpu_torch.tools.test
--aflink PT`` loads, and prints the held-out accuracy.  Runs on the card
unless ``--device cpu``; without a card ``--device cuda`` raises.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..train.train_aflink import save_aflink, train_aflink


def main(argv: Optional[List[str]] = None) -> float:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--out', default='work_dirs/aflink/aflink.pt')
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--batch', type=int, default=128)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if not args.out.endswith(('.pt', '.pth')):
        raise ValueError(f'--out {args.out!r}: the checkpoint is a .pt')
    state_dict, acc = train_aflink(seed=args.seed, steps=args.steps,
                                   batch=args.batch, lr=args.lr,
                                   device=args.device)
    save_aflink(args.out, state_dict, steps=args.steps, seed=args.seed,
                heldout_accuracy=acc)
    print(f'held-out accuracy {acc:.3f}; saved to {args.out}')
    return acc


if __name__ == '__main__':
    main()
