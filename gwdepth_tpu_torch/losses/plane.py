"""Plane-normal consistency loss (`--with_plane_norm_loss`).

The port of `gwdepth_tpu.losses.plane`: surface normals from Sobel depth
gradients; for each of the `num_ref` highest-scoring predicted line
triangles (two endpoints and the polygon center), the variance of the
normal's x and y components inside the triangle. Triangle membership is
a half-plane sign test over the pixel grid, and the score and area gates
are multiplicative weights, so the loss runs on a fixed `num_ref`
triangles for any batch.

The training step logs this loss and never adds it to the optimized
total, as the original does; it computes it without a graph. Its mean
over images is the global batch's (`reduce`, as in `criterion.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gwdepth_tpu_torch.losses.criterion import Reducer, identity
from gwdepth_tpu_torch.ops.tables import device_table

SOBEL_KX = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_KY = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def sobel_grad(depth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) -> (dx, dy): the Sobel kernels as a cross-correlation with
    zero SAME padding, in float32."""
    k = device_table("sobel", lambda: np.array(
        (SOBEL_KX, SOBEL_KY), np.float32), depth.device)[:, None]  # (2,1,3,3)
    out = F.conv2d(depth.float()[:, None], k, padding=1)
    return out[:, 0], out[:, 1]


def point_in_triangle(tri: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """tri (..., 3, 2) pixel coordinates (x, y) -> (..., H, W) bool masks:
    the pixels on one side of all three edges (edges included)."""
    ys = torch.arange(H, dtype=torch.float32, device=tri.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=tri.device)[None, :]

    def edge(a, b):
        # cross(b - a, p - a) for every pixel p
        ax, ay = a[..., 0, None, None], a[..., 1, None, None]
        return ((b[..., 0, None, None] - ax) * (ys - ay)
                - (b[..., 1, None, None] - ay) * (xs - ax))

    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    d0, d1, d2 = edge(a, b), edge(b, c), edge(c, a)
    neg = (d0 <= 0) & (d1 <= 0) & (d2 <= 0)
    pos = (d0 >= 0) & (d1 >= 0) & (d2 >= 0)
    return neg | pos


def top_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, largest first, ties
    to the lower index (`jax.lax.top_k`'s order; `torch.topk` promises no
    order on ties)."""
    if k > x.shape[-1]:
        raise ValueError(f"top {k} of {x.shape[-1]} entries")
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def plane_norm_loss(depth_pred: torch.Tensor, pred_lines: torch.Tensor,
                    pred_logits: torch.Tensor, valid: torch.Tensor,
                    num_ref: int = 28, score_thresh: float = 0.6,
                    min_area: int = 100, reduce: Reducer = identity
                    ) -> torch.Tensor:
    """depth_pred (B, H, W); pred_lines (B, Q, 6) normalized [x1 y1 x2 y2
    cx cy]; pred_logits (B, Q, 2); valid (B, H, W) bool -> scalar."""
    B, H, W = depth_pred.shape
    dx, dy = sobel_grad(depth_pred)
    # normal = (-dx, -dy, 1); only x and y enter the variance

    logits = pred_logits.float()
    score = torch.softmax(logits, -1)[..., 0]               # (B, Q)
    ids = top_ids(logits[..., 0], num_ref)                  # (B, R)
    tri = torch.gather(pred_lines.float(), 1,
                       ids[..., None].expand(-1, -1, pred_lines.shape[-1]))
    tri_score = torch.gather(score, 1, ids)                 # (B, R)
    scale = device_table(("plane_scale", W, H), lambda: np.array(
        [W, H], np.float32), tri.device)
    tri = torch.round(tri.reshape(B, num_ref, 3, 2) * scale)   # half to even
    tri = torch.stack([tri[..., 0].clamp(0, W - 1),
                       tri[..., 1].clamp(0, H - 1)], -1)

    masks = point_in_triangle(tri, H, W) & valid[:, None]   # (B, R, H, W)
    area = masks.sum(dim=(2, 3)).float()                    # (B, R)
    gate = (tri_score > score_thresh) & (area >= min_area)
    m = masks.float()
    del masks
    cnt = area.clamp(min=1.0)

    def masked_var(g):
        mean = (g[:, None] * m).sum(dim=(2, 3)) / cnt
        return ((g[:, None] - mean[..., None, None]) ** 2 * m
                ).sum(dim=(2, 3)) / cnt                     # (B, R)

    var = masked_var(-dx) + masked_var(-dy)
    n = gate.sum(dim=1).float().clamp(min=1.0)
    per_image = (var * gate).sum(dim=1) / n
    s = reduce(torch.stack([per_image.sum(), torch.full(
        (), float(B), device=per_image.device)]))
    return s[0] / s[1]
