"""Eval-protocol preprocessing: the subset of `gwdepth_tpu.data.transforms`
that the serving CLI uses (`Sample`, `eval_transform` and what it calls),
numpy and PIL only.

Resize the long side to `test_size` (PIL bilinear for the image, PIL
NEAREST index replay for the depth/seg maps), scale down to fit the static
canvas if needed, then normalize with the GW-Depth channel stats and map
line coordinates to [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
from PIL import Image

# GW-Depth channel stats
MEAN = np.array([0.538, 0.494, 0.453], np.float32)
STD = np.array([0.257, 0.263, 0.273], np.float32)


@dataclasses.dataclass
class Sample:
    """image: PIL (until normalize) | float32 HWC; depth: (H, W) float32;
    seg: (H, W) uint8/int; lines: (N, 4) [x1 y1 x2 y2] pixels; centers:
    (N, 2) pixels; poly_ids: (N,) int."""
    image: object
    depth: np.ndarray
    seg: np.ndarray
    lines: np.ndarray
    centers: np.ndarray
    poly_ids: np.ndarray

    def copy(self) -> "Sample":
        return Sample(self.image, self.depth.copy(), self.seg.copy(),
                      self.lines.copy(), self.centers.copy(),
                      self.poly_ids.copy())


def _get_resize_hw(wh: Tuple[int, int], size, max_size=None) -> Tuple[int, int]:
    if isinstance(size, (list, tuple)):
        return size[1], size[0]
    w, h = wh
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def _pil_nearest_idx(n_in: int, n_out: int) -> np.ndarray:
    """Source indices PIL NEAREST picks: start at scale*0.5, advance by
    sequential double addition, truncate."""
    a = n_in / n_out
    steps = np.full(n_out, a, np.float64)
    steps[0] = a * 0.5
    return np.clip(np.add.accumulate(steps).astype(np.int64), 0, n_in - 1)


def resize(s: Sample, size, max_size=None) -> Sample:
    s = s.copy()
    oh, ow = _get_resize_hw(s.image.size, size, max_size)
    w0, h0 = s.image.size
    s.image = s.image.resize((ow, oh), Image.BILINEAR)
    rw, rh = ow / w0, oh / h0
    if len(s.lines):
        s.lines = s.lines * np.array([rw, rh, rw, rh])
        s.centers = s.centers * np.array([rw, rh])
    yi = _pil_nearest_idx(h0, oh)
    xi = _pil_nearest_idx(w0, ow)
    s.depth = np.ascontiguousarray(s.depth[yi][:, xi])
    s.seg = np.ascontiguousarray(s.seg[yi][:, xi])
    return s


def normalize(s: Sample) -> Sample:
    """To float, channel-normalize, coords -> [0, 1]."""
    s = s.copy()
    img = np.asarray(s.image, np.float32) / 255.0
    img = (img - MEAN) / STD
    h, w = img.shape[:2]
    s.image = img
    if len(s.lines):
        s.lines = s.lines / np.array([w, h, w, h], np.float64)
        s.centers = s.centers / np.array([w, h], np.float64)
    return s


def fit_canvas(s: Sample, canvas_hw: Tuple[int, int]) -> Sample:
    """Scale down (only) so the image fits the canvas."""
    w, h = s.image.size
    ch, cw = canvas_hw
    scale = min(ch / h, cw / w, 1.0)
    if scale < 1.0:
        return resize(s, (max(1, int(w * scale)), max(1, int(h * scale))))
    return s


def eval_transform(s: Sample, canvas_hw: Tuple[int, int],
                   test_size: int = 1024, max_size: int = 1024,
                   strict_protocol: bool = True) -> Sample:
    """Long side to `test_size`, fitted onto the canvas, normalized.
    `strict_protocol` rejects a portrait image on a landscape canvas (and
    vice versa) that would silently shrink below the protocol size."""
    s = resize(s, test_size, max_size)
    if strict_protocol:
        w, h = s.image.size
        ch, cw = canvas_hw
        if (h > ch or w > cw) and (h > w) != (ch > cw):
            raise ValueError(
                f"eval canvas (h, w)={canvas_hw} cannot hold the "
                f"protocol-resized image (h, w)=({h}, {w}); use a canvas "
                f"that fits the long-side-{test_size} resize, e.g. "
                f"--eval_h {h} --eval_w {w}")
    s = fit_canvas(s, canvas_hw)
    return normalize(s)
