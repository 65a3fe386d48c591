"""Tracking demo: the port of ``tools/demo_track.py``.

    python -m stereotracking_tpu_torch.tools.demo_track CONFIG FRAMES_DIR
        [--checkpoint PTH] [--out-dir DIR] [--max-frames N]
        [--device cuda|cpu]

Runs ``init_model`` -> ``inference_mot`` frame by frame over
``FRAMES_DIR/left/*.png`` (uint8 BGR frames) and the matching
``FRAMES_DIR/disparity/*.png`` (uint16 SGBM /16 fixed-point disparity,
the file name with ``left`` replaced by ``disparity``), prints each
frame's track ids and writes each frame with its tracked boxes to
``OUT_DIR/<frame:06d>.jpg``.  Runs on the card unless ``--device cpu``;
without a card ``--device cuda`` raises.  Returns the ids per frame.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('frames_dir', help='directory with left/*.png and '
                                      'disparity/*.png')
    p.add_argument('--checkpoint', default=None,
                   help='PyTorch checkpoint (.pth / .pt)')
    p.add_argument('--out-dir', default='demo_out')
    p.add_argument('--max-frames', type=int, default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from PIL import Image

    from ..apis.inference import inference_mot, init_model
    from ..data import transforms as T
    from ..visualization import TrackVisualizer

    left_dir = os.path.join(args.frames_dir, 'left')
    disp_dir = os.path.join(args.frames_dir, 'disparity')
    frames = sorted(os.listdir(left_dir))
    if args.max_frames:
        frames = frames[:args.max_frames]

    model = init_model(args.config, args.checkpoint, device=args.device)
    vis = TrackVisualizer()
    os.makedirs(args.out_dir, exist_ok=True)
    ids = []
    for t, fname in enumerate(frames):
        img = T.load_image(os.path.join(left_dir, fname))
        disp = T.load_disparity(os.path.join(
            disp_dir, fname.replace('left', 'disparity')))
        ti = inference_mot(model, img, disp, frame_id=t)['track_instances']
        frame_vis = vis.draw(img, ti['bboxes'], ti['instances_id'],
                             ti['scores'])
        Image.fromarray(frame_vis).save(
            os.path.join(args.out_dir, f'{t:06d}.jpg'))
        ids.append(ti['instances_id'].tolist())
        print(f'frame {t}: {len(ids[-1])} tracks ids={ids[-1]}', flush=True)
    print(f'wrote visualizations to {args.out_dir}')
    return ids


if __name__ == '__main__':
    main()
