"""Datasets: COCO(-VID) with stereo-disparity path derivation.

A copy of ``CocoDispDataset``, ``MOTDispDataset`` and ``MOTKittiDataset``
from ``stereotracking_tpu/data/datasets.py``: the reference mmtrack
datasets (``datasets/coco_disparity.py:12-111``, image level;
``mot_disp_dataset.py:10-105``, video level with per-instance 3D
location/visibility; ``mot_kitti_dataset.py``), with the same path
conventions: AirSim file names derive ``disparity``/``depth`` paths by
replacing ``left``; KITTI replaces ``img2``.  The DanceTrack reader is
``data/dancetrack.py``; the training samplers are not ported (ROADMAP.md
Queue 1 item 3).
"""
from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from .coco_video import CocoVideo
from . import transforms as T


def derive_modal_path(img_path: str, file_name: str, dir_name: str,
                      token: str = 'auto') -> str:
    """Derive a disparity/depth path from the image path by replacing
    ``token`` in the file name (AirSim names use ``left``, KITTI ``img2``;
    reference coco_disparity.py:28-49 / mot_kitti_dataset.py).

    ``token='auto'`` keeps the reference's path-substring dispatch for
    standalone callers; the dataset classes pass it explicitly.
    """
    if token == 'auto':
        token = 'img2' if 'kitti' in img_path.lower() else 'left'
    new = file_name.replace(token, dir_name)
    return img_path.replace(file_name, new)


def _parse_instances(anns: List[dict], cat2label: Dict[int, int],
                     width: int, height: int, with_track: bool) -> dict:
    bboxes, labels, ignore = [], [], []
    instance_ids, locations, visibility = [], [], []
    for ann in anns:
        if ann.get('ignore', False):
            continue
        x1, y1, w, h = ann['bbox']
        inter_w = max(0, min(x1 + w, width) - max(x1, 0))
        inter_h = max(0, min(y1 + h, height) - max(y1, 0))
        if inter_w * inter_h == 0 or ann['area'] <= 0 or w < 1 or h < 1:
            continue
        if ann['category_id'] not in cat2label:
            continue
        bboxes.append([x1, y1, x1 + w, y1 + h])
        labels.append(cat2label[ann['category_id']])
        ignore.append(bool(ann.get('iscrowd', False)))
        if with_track:
            instance_ids.append(ann.get('instance_id', -1))
            locations.append(ann.get('location', [-1, -1, -1]))
            visibility.append(ann.get('visibility', 1.0))
    out = dict(
        gt_bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
        gt_labels=np.asarray(labels, np.int64),
        gt_ignore=np.asarray(ignore, bool),
    )
    if with_track:
        out['gt_instance_ids'] = np.asarray(instance_ids, np.int64)
        out['gt_locations'] = np.asarray(
            locations, np.float32).reshape(-1, 3)
        out['gt_visibility'] = np.asarray(visibility, np.float32)
    return out


class CocoDispDataset:
    """Image-level training dataset (stereo left image + disparity)."""

    def __init__(self, ann_file: str, data_root: str = '',
                 img_prefix: str = '',
                 disparity_dir_name: str = 'disparity',
                 depth_dir_name: Optional[str] = None,
                 classes: Optional[tuple] = None,
                 path_token: str = 'left',
                 depth_mode: str = 'airsim'):
        self.coco = CocoVideo(ann_file)
        self.data_root = data_root
        self.img_prefix = img_prefix
        self.disparity_dir_name = disparity_dir_name
        self.depth_dir_name = depth_dir_name
        self.path_token = path_token
        self.depth_mode = depth_mode
        cat_ids = self.coco.cat_ids()
        if classes is not None:
            name_to_id = {c['name']: cid for cid, c in self.coco.cats.items()}
            cat_ids = [name_to_id[c] for c in classes if c in name_to_id]
        self.cat2label = {cid: i for i, cid in enumerate(cat_ids)}
        self.img_ids = self.coco.get_img_ids()

    def __len__(self):
        return len(self.img_ids)

    def data_info(self, idx: int) -> dict:
        img = self.coco.load_img(self.img_ids[idx])
        fname = img['file_name']
        img_path = osp.join(self.data_root, self.img_prefix, fname)
        info = dict(
            img_id=img['id'], img_path=img_path,
            width=img['width'], height=img['height'],
            disp_path=derive_modal_path(img_path, fname,
                                        self.disparity_dir_name,
                                        self.path_token))
        if self.depth_dir_name:
            info['depth_path'] = derive_modal_path(img_path, fname,
                                                   self.depth_dir_name,
                                                   self.path_token)
        info.update(_parse_instances(
            self.coco.load_anns(img['id']), self.cat2label,
            img['width'], img['height'], with_track=False))
        return info

    def load_sample(self, idx: int) -> dict:
        info = self.data_info(idx)
        sample = dict(info)
        sample['img'] = T.load_image(info['img_path'])
        disp = T.load_disparity(info['disp_path'])
        sample.update(T.disparity_postprocess(disp))
        if 'depth_path' in info:
            sample['depth_postp'] = T.load_depth(info['depth_path'],
                                                 mode=self.depth_mode)
        return sample


class MOTDispDataset(CocoDispDataset):
    """Video-level evaluation dataset with 3D locations per instance."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.vid_ids = self.coco.get_vid_ids()

    def videos(self) -> List[int]:
        return self.vid_ids

    def video_name(self, vid: int) -> str:
        return self.coco.videos[vid].get('name', str(vid))

    def video_frames(self, vid: int) -> List[int]:
        return self.coco.get_img_ids_from_vid(vid)

    def frame_info(self, img_id: int) -> dict:
        img = self.coco.load_img(img_id)
        fname = img['file_name']
        img_path = osp.join(self.data_root, self.img_prefix, fname)
        info = dict(
            img_id=img_id, img_path=img_path,
            video_id=img.get('video_id', -1),
            frame_id=img.get('frame_id', 0),
            width=img['width'], height=img['height'],
            disp_path=derive_modal_path(img_path, fname,
                                        self.disparity_dir_name,
                                        self.path_token))
        if self.depth_dir_name:
            info['depth_path'] = derive_modal_path(img_path, fname,
                                                   self.depth_dir_name,
                                                   self.path_token)
        info.update(_parse_instances(
            self.coco.load_anns(img_id), self.cat2label,
            img['width'], img['height'], with_track=True))
        return info

    def load_frame(self, img_id: int) -> dict:
        info = self.frame_info(img_id)
        sample = dict(info)
        sample['img'] = T.load_image(info['img_path'])
        disp = T.load_disparity(info['disp_path'])
        sample['disp_raw'] = disp
        sample.update(T.disparity_postprocess(disp))
        if 'depth_path' in info:
            sample['depth_postp'] = T.load_depth(info['depth_path'],
                                                 mode=self.depth_mode)
        return sample


class MOTKittiDataset(MOTDispDataset):
    """KITTI stereo tracking dataset (reference mot_kitti_dataset.py):
    ``MOTDispDataset`` with the disparity paths derived from the ``img2``
    naming."""

    def __init__(self, *args, path_token: str = 'img2', **kwargs):
        super().__init__(*args, path_token=path_token, **kwargs)
