"""COCO-VID annotation reader (videos + per-video image lists + instances).

A copy of ``stereotracking_tpu/data/coco_video.py``.  Equivalent capability
to the reference mmtrack ``CocoVID`` wrapper
(``datasets/api_wrappers/coco_video_api.py:9-160``) without pycocotools: a plain-json indexer over the COCO-video schema
(``videos``, ``images`` with ``video_id``/``frame_id``, ``annotations`` with
``instance_id``).
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional


class CocoVideo:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            self.dataset = json.load(f)
        self._index()

    def _index(self):
        d = self.dataset
        self.videos = {v['id']: v for v in d.get('videos', [])}
        self.imgs = {img['id']: img for img in d.get('images', [])}
        self.cats = {c['id']: c for c in d.get('categories', [])}
        self.anns = {a['id']: a for a in d.get('annotations', [])}

        self.vid_to_imgs: Dict[int, List[dict]] = defaultdict(list)
        for img in d.get('images', []):
            if 'video_id' in img:
                self.vid_to_imgs[img['video_id']].append(img)
        for vid in self.vid_to_imgs:
            self.vid_to_imgs[vid].sort(key=lambda x: x.get('frame_id', 0))

        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for a in d.get('annotations', []):
            self.img_to_anns[a['image_id']].append(a)

        self.ins_to_imgs: Dict[int, List[int]] = defaultdict(list)
        for a in d.get('annotations', []):
            if a.get('instance_id', -1) >= 0:
                self.ins_to_imgs[a['instance_id']].append(a['image_id'])

    # CocoVID-like accessors ------------------------------------------------
    def get_vid_ids(self) -> List[int]:
        return sorted(self.videos)

    def get_img_ids_from_vid(self, vid: int) -> List[int]:
        return [img['id'] for img in self.vid_to_imgs[vid]]

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs)

    def get_ins_ids(self) -> List[int]:
        return sorted(self.ins_to_imgs)

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def load_anns(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    def cat_ids(self) -> List[int]:
        return sorted(self.cats)
