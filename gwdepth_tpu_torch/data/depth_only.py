"""Depth-only dataset (NYU-V2 / BTS-style filename lists).

The port of `gwdepth_tpu.data.depth_only`. Each line of the filenames
file is `rgb_path depth_path [focal]` (BTS's format, relative to `root`);
a sample is the GW-Depth dataset's canvas-fitted dict with no lines and
zero seg, for the depth-only model (`with_line=False`). Depth pngs are in
1/`depth_scale` meters (1000: millimeters, the NYU and GW-Depth
convention). The train and eval transforms take the same
`random.Random(seed)` stream as the GW-Depth dataset, so one seed gives
the JAX package's sample, and the dataset feeds the same `Loader`.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional

import numpy as np

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.data.dataset import (_open_array, _open_rgb,
                                            collate_sample)
from gwdepth_tpu_torch.data.transforms import (Sample, eval_transform,
                                               train_transform)


class DepthOnlyDataset:
    def __init__(self, cfg: GWDepthConfig, root: str, filenames_file: str,
                 split: str = "train", depth_scale: float = 1000.0):
        self.cfg = cfg
        self.root = root
        self.split = split
        self.depth_scale = depth_scale
        with open(filenames_file) as f:
            self.pairs = [ln.split()[:2] for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int, seed: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rgb_rel, depth_rel = self.pairs[idx]
        image = _open_rgb(os.path.join(self.root, rgb_rel.lstrip("/")))
        depth = _open_array(os.path.join(
            self.root, depth_rel.lstrip("/"))).astype(np.int32)
        h, w = depth.shape[:2]
        s = Sample(image, depth, np.zeros((h, w), np.uint8),
                   np.zeros((0, 4)), np.zeros((0, 2)),
                   np.zeros((0,), np.int64))
        if self.split == "train":
            rng = random.Random(seed if seed is not None
                                else random.getrandbits(32))
            s = train_transform(s, rng, cfg.train_hw)
            canvas = cfg.train_hw
        else:
            s = eval_transform(s, cfg.eval_hw)
            canvas = cfg.eval_hw
        name = os.path.splitext(os.path.basename(rgb_rel))[0]
        out = collate_sample(s, canvas, cfg, name)
        if self.depth_scale != 1000.0:
            # collate_sample divides by 1000
            out["depth"] = out["depth"] * (1000.0 / self.depth_scale)
        return out
