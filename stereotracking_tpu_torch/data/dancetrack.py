"""The DanceTrack reader: the port's copy of ``DanceTrackDataset`` in
``stereotracking_tpu/data/tao_dancetrack.py``.

It reads the raw MOT-challenge layout (``<split>/<seq>/seqinfo.ini``,
``<seq>/img1/%08d.jpg``, ``<seq>/gt/gt.txt`` rows ``frame, id, x, y, w, h,
conf, class, visibility``) with no offline converter, behind the video
API of ``MOTDispDataset`` (``videos``, ``video_name``, ``video_frames``,
``frame_info``, ``load_frame``).  DanceTrack is monocular: ``load_frame``
gives an all-invalid disparity, so the stereo tracker runs with depth 0
and scale 1, and the eval CLI scores it with depth ignored.  The TAO
reader of the same JAX module belongs to the task zoo and is not ported.
"""
from __future__ import annotations

import configparser
import os
import os.path as osp
from typing import Dict, List

import numpy as np

from . import transforms as T


class DanceTrackDataset:
    """Raw MOT-challenge layout reader (DanceTrack / MOT17-style)."""

    GT_CLASSES = ('dancer',)

    def __init__(self, data_root: str, split: str = 'train',
                 visibility_thr: float = -1.0):
        self.data_root = data_root
        self.split_dir = osp.join(data_root, split)
        self.visibility_thr = visibility_thr
        seqs = sorted(d for d in os.listdir(self.split_dir)
                      if osp.isdir(osp.join(self.split_dir, d)))
        self._videos = []
        self._frames: Dict[str, List[dict]] = {}
        next_img_id = 1
        for seq in seqs:
            seq_dir = osp.join(self.split_dir, seq)
            meta = self._read_seqinfo(seq_dir)
            gt = self._read_gt(osp.join(seq_dir, 'gt', 'gt.txt'))
            frames = []
            for f in range(1, meta['seqLength'] + 1):
                rows = gt.get(f, np.zeros((0, 9)))
                keep = rows[:, 8] >= self.visibility_thr if len(rows) \
                    else np.zeros(0, bool)
                rows = rows[keep]
                x1y1 = rows[:, 2:4]
                frames.append(dict(
                    img_id=next_img_id,
                    img_path=osp.join(seq_dir, meta['imDir'],
                                      f'{f:0{meta["imExt_digits"]}d}'
                                      f'{meta["imExt"]}'),
                    video_id=seq, frame_id=f - 1,
                    width=meta['imWidth'], height=meta['imHeight'],
                    gt_bboxes=np.concatenate(
                        [x1y1, x1y1 + rows[:, 4:6]], axis=1)
                    .astype(np.float32),
                    gt_labels=np.zeros(len(rows), np.int64),
                    gt_instance_ids=rows[:, 1].astype(np.int64),
                    gt_ignore=rows[:, 6] == 0,     # conf 0 = ignore region
                    gt_visibility=rows[:, 8].astype(np.float32),
                    gt_locations=np.full((len(rows), 3), -1, np.float32)))
                next_img_id += 1
            self._videos.append(seq)
            self._frames[seq] = frames

    @staticmethod
    def _read_seqinfo(seq_dir: str) -> dict:
        path = osp.join(seq_dir, 'seqinfo.ini')
        out = dict(imDir='img1', imExt='.jpg', imExt_digits=8,
                   imWidth=1920, imHeight=1080, seqLength=0)
        if osp.exists(path):
            cp = configparser.ConfigParser()
            cp.read(path)
            s = cp['Sequence']
            out.update(imDir=s.get('imDir', 'img1'),
                       imExt=s.get('imExt', '.jpg'),
                       imWidth=int(s.get('imWidth', 1920)),
                       imHeight=int(s.get('imHeight', 1080)),
                       seqLength=int(s.get('seqLength', 0)))
        img_dir = osp.join(seq_dir, out['imDir'])
        if osp.isdir(img_dir):
            names = [x for x in os.listdir(img_dir)
                     if x.endswith(out['imExt'])]
            if names:
                # infer zero-pad width (8 for DanceTrack, 6 for MOT17)
                out['imExt_digits'] = len(osp.splitext(sorted(names)[0])[0])
            if not out['seqLength']:
                out['seqLength'] = len(names)
        return out

    @staticmethod
    def _read_gt(path: str) -> Dict[int, np.ndarray]:
        by_frame: Dict[int, list] = {}
        if osp.exists(path):
            with open(path) as fh:
                for line in fh:
                    vals = [float(v) for v in line.strip().split(',') if v]
                    if len(vals) < 6:
                        continue
                    vals = (vals + [1.0, 1.0, 1.0])[:9]
                    by_frame.setdefault(int(vals[0]), []).append(vals)
        return {f: np.asarray(rows, np.float64)
                for f, rows in by_frame.items()}

    # -- MOTDispDataset-compatible video API -------------------------------
    def videos(self) -> List[str]:
        return list(self._videos)

    def video_name(self, vid: str) -> str:
        return vid

    def video_frames(self, vid: str) -> List[int]:
        return [f['img_id'] for f in self._frames[vid]]

    def frame_info(self, img_id: int) -> dict:
        for frames in self._frames.values():
            i = img_id - frames[0]['img_id']
            if 0 <= i < len(frames):
                return dict(frames[i])
        raise KeyError(img_id)

    def load_frame(self, img_id: int) -> dict:
        sample = self.frame_info(img_id)
        sample['img'] = T.load_image(sample['img_path'])
        h, w = sample['img'].shape[:2]
        # monocular: all-invalid disparity (mask 0 everywhere -> depth 0,
        # scale 1 in the depth module)
        sample['disp_postp'] = np.zeros((h, w), np.float32)
        sample['disp_mask'] = np.zeros((h, w), np.float32)
        return sample

    def __len__(self):
        return sum(len(v) for v in self._frames.values())
