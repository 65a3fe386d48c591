"""Extract the detector's weights from a train checkpoint: the port of
``tools/utils/extract_det_model.py``.

    python -m stereotracking_tpu_torch.tools.extract_det_model CHECKPOINT
        OUTPUT [--no-ema]

Reads a train checkpoint of this package (``epoch_<n>.pth`` of
``stereotracking_tpu_torch.tools.train``: the module, its EMA, the
momentum buffers, the step) and writes the detector export that
``apis.inference.init_model`` and ``tools.test --checkpoint`` load: the
EMA weights and BatchNorm statistics, or with ``--no-ema`` the trained
module's own (``train.checkpoint.extract_detector_variables``).  The JAX
package's train checkpoints (orbax directories, msgpack files) need flax
to read and are refused.  Runs on the host.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..train.checkpoint import (extract_detector_variables, load_checkpoint,
                                save_checkpoint)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('checkpoint')
    p.add_argument('output')
    p.add_argument('--no-ema', action='store_true',
                   help='export the trained weights instead of the EMA')
    args = p.parse_args(argv)
    for path in (args.checkpoint, args.output):
        if os.path.isdir(path) or not path.endswith(('.pth', '.pt')):
            raise NotImplementedError(
                f'{path!r}: only PyTorch checkpoints (.pth / .pt) of this '
                f'package are read and written here; the JAX package\'s '
                f'orbax or msgpack checkpoints need flax to read '
                f'(ROADMAP.md Queue 1 item 3)')
    out = extract_detector_variables(load_checkpoint(args.checkpoint),
                                     ema=not args.no_ema)
    save_checkpoint(args.output, out)
    print(f'wrote the detector weights ({"trained" if args.no_ema else "EMA"}'
          f', step {out["meta"]["step"]}) to {args.output}')
    return out


if __name__ == '__main__':
    main()
