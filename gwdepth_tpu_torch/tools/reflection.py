"""Reflection-hint generation.

The port's copy of `gwdepth_tpu.tools.reflection`: the same functions, the
same outputs, on the host.

Numpy re-derivation of the reference's reflection toolchain
(reference: depth_interpolation/reflection_check.py): the hint map is the
absolute difference between the original image and its reflection-removed
counterpart (produced by an external SIRR model, find_diff :18-41), and the
hint POINTS are cluster centers of the high-difference pixels
(reflection_sample :135-184: threshold at max*ratio, k-means to
`hint_center_num` centers, stored as [row, col] json).

cv2/sklearn are replaced by numpy + a small Lloyd's k-means (deterministic
seeding), keeping the same outputs: a uint8 difference map and a
{'rhint_points': [[row, col], ...]} dict consumed by the reflection-hint
dataset variant (reference: src/datasets/glassrgbd_data.py:256-304).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def reflection_difference(image: np.ndarray,
                          reflection_removed: np.ndarray) -> np.ndarray:
    """uint8 |original - reflection_removed| (find_diff :21)."""
    return np.abs(image.astype(np.int16)
                  - reflection_removed.astype(np.int16)).astype(np.uint8)


def _kmeans(points: np.ndarray, k: int, iters: int = 50,
            seed: int = 0) -> np.ndarray:
    """Plain Lloyd's k-means (sklearn KMeans stand-in, random_state=0)."""
    rng = np.random.default_rng(seed)
    k = min(k, len(points))
    centers = points[rng.choice(len(points), k, replace=False)].astype(float)
    for _ in range(iters):
        d = ((points[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        new = np.stack([
            points[assign == i].mean(0) if (assign == i).any() else centers[i]
            for i in range(k)])
        if np.allclose(new, centers):
            break
        centers = new
    return centers


def sample_reflection_points(hint_map: np.ndarray, hint_center_num: int = 20,
                             sample_max_ratio: float = 1 / 3) -> Dict:
    """Cluster high-difference pixels into hint centers
    (reflection_sample :146-160). hint_map: (H, W[, C]) uint8.
    Returns {'rhint_points': [[row, col], ...]}."""
    m = np.abs(hint_map)
    if m.ndim == 3:
        m = m.max(-1)
    thresh = m.max() * sample_max_ratio
    rows, cols = np.nonzero(m > thresh)
    if len(rows) == 0:
        return {"rhint_points": []}
    pts = np.unique(np.stack([rows, cols], 1), axis=0)
    centers = _kmeans(pts, hint_center_num)
    return {"rhint_points": centers.tolist()}
