"""COCO-format line dataset (the wireframe and YorkUrban LETR benchmarks).

The port of `gwdepth_tpu.data.coco_lines`: `lines_{split}2017.json` holds
COCO images and annotations whose "line" is [x, y, dx, dy] (offset form).
Each sample is the GW-Depth dataset's canvas-fitted dict with zero depth
and seg: the lines as endpoints clipped to the image, their midpoints in
the center slot. The train and eval transforms take the same
`random.Random(seed)` stream as the GW-Depth dataset, so one seed gives
the JAX package's sample.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Optional

import numpy as np

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.data.dataset import _open_rgb, collate_sample
from gwdepth_tpu_torch.data.transforms import (Sample, eval_transform,
                                               train_transform)


class CocoLinesDataset:
    def __init__(self, cfg: GWDepthConfig, img_folder: str, ann_file: str,
                 split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.img_folder = img_folder
        with open(ann_file) as f:
            data = json.load(f)
        self.images = {im["id"]: im for im in data["images"]}
        self.anns: Dict[int, list] = {im_id: [] for im_id in self.images}
        for ann in data.get("annotations", []):
            if ann["image_id"] in self.anns:
                self.anns[ann["image_id"]].append(ann)
        self.ids = sorted(self.images)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int, seed: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        im_id = self.ids[idx]
        info = self.images[im_id]
        image = _open_rgb(os.path.join(self.img_folder, info["file_name"]))
        w, h = image.size
        lines = np.asarray([a["line"] for a in self.anns[im_id]],
                           np.float64).reshape(-1, 4)
        lines[:, 2:] += lines[:, :2]                 # offset -> endpoints
        lines[:, 0::2] = lines[:, 0::2].clip(0, w)
        lines[:, 1::2] = lines[:, 1::2].clip(0, h)
        mids = (lines[:, :2] + lines[:, 2:]) / 2.0
        zeros2d = np.zeros((h, w), np.int32)
        s = Sample(image, zeros2d, zeros2d.astype(np.uint8), lines, mids,
                   np.arange(len(lines)))
        if self.split == "train":
            rng = random.Random(seed if seed is not None
                                else random.getrandbits(32))
            s = train_transform(s, rng, cfg.train_hw)
            canvas = cfg.train_hw
        else:
            s = eval_transform(s, cfg.eval_hw)
            canvas = cfg.eval_hw
        name = os.path.splitext(info["file_name"])[0]
        return collate_sample(s, canvas, cfg, name)
