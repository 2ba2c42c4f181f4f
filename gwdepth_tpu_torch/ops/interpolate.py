"""torch `F.interpolate` semantics, written out so both devices and the
JAX package agree index-for-index.

torch 'nearest' takes src = floor(dst * in/out); bilinear follows torch's
align_corners rules. Index and weight tables are computed in float32 with
numpy, as the JAX package computes them, once per shape; each reaches
the device once (`ops/tables.py`), as XLA folds the JAX package's tables
into its program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gwdepth_tpu_torch.ops.tables import device_table


@functools.lru_cache(maxsize=None)
def _nearest_idx(out_len: int, in_len: int) -> np.ndarray:
    src = np.floor(np.arange(out_len, dtype=np.float32)
                   * np.float32(in_len / out_len)).astype(np.int64)
    return np.minimum(src, in_len - 1)


def nearest_idx(out_len: int, in_len: int, device) -> torch.Tensor:
    """`_nearest_idx` on `device`."""
    return device_table(("nearest", out_len, in_len),
                        lambda: _nearest_idx(out_len, in_len), device)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]) with torch-nearest indices."""
    H, W = x.shape[-2], x.shape[-1]
    iy = nearest_idx(size[0], H, x.device)
    ix = nearest_idx(size[1], W, x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def resize_nearest_nhwc(x: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W, C) -> (B, size[0], size[1], C), torch-nearest indices."""
    _, H, W, _ = x.shape
    iy = nearest_idx(size[0], H, x.device)
    ix = nearest_idx(size[1], W, x.device)
    return x.index_select(1, iy).index_select(2, ix)


@functools.lru_cache(maxsize=None)
def _src_coords(out_len: int, in_len: int, align_corners: bool):
    """Two-tap lerp table: (i0, i1, frac) in float32 arithmetic."""
    i = np.arange(out_len, dtype=np.float32)
    if align_corners:
        f = (i * np.float32((in_len - 1) / max(out_len - 1, 1))
             if out_len > 1 else np.zeros((1,), np.float32))
    else:
        f = np.clip((i + np.float32(0.5)) * np.float32(in_len / out_len)
                    - np.float32(0.5), 0.0, in_len - 1).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_len - 1)
    return i0, i1, (f - i0.astype(np.float32)).astype(np.float32)


def lerp_table(out_len: int, in_len: int, align_corners: bool, device,
               dtype: torch.dtype):
    """`_src_coords` on `device`: (i0, i1) int64 and the weights in
    `dtype`."""
    key = ("lerp", out_len, in_len, align_corners)

    def part(i):
        return lambda: _src_coords(out_len, in_len, align_corners)[i]

    return (device_table(key + (0,), part(0), device),
            device_table(key + (1,), part(1), device),
            device_table(key + (2,), part(2), device, dtype))


def resize_bilinear(x: torch.Tensor, size,
                    align_corners: bool = False) -> torch.Tensor:
    """(..., H, W) -> (..., Ho, Wo), torch bilinear semantics."""
    H, W = x.shape[-2], x.shape[-1]
    y0, y1, wy = lerp_table(size[0], H, align_corners, x.device, x.dtype)
    x0, x1, wx = lerp_table(size[1], W, align_corners, x.device, x.dtype)
    top = x.index_select(-2, y0)
    bot = x.index_select(-2, y1)
    row = top + (bot - top) * wy[:, None]
    left = row.index_select(-1, x0)
    right = row.index_select(-1, x1)
    return left + (right - left) * wx


def resize_bilinear_nhwc(x: torch.Tensor, size,
                         align_corners: bool = False) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, C), torch bilinear semantics."""
    _, H, W, _ = x.shape
    y0, y1, wy = lerp_table(size[0], H, align_corners, x.device, x.dtype)
    x0, x1, wx = lerp_table(size[1], W, align_corners, x.device, x.dtype)
    top = x.index_select(1, y0)
    bot = x.index_select(1, y1)
    row = top + (bot - top) * wy[None, :, None, None]
    left = row.index_select(2, x0)
    right = row.index_select(2, x1)
    return left + (right - left) * wx[None, :, None]


@functools.lru_cache(maxsize=None)
def _lerp_matrix(out_len: int, in_len: int, align_corners: bool) -> np.ndarray:
    """(out_len, in_len) row-stochastic matrix with torch bilinear weights."""
    i = np.arange(out_len, dtype=np.float64)
    if align_corners:
        f = (i * ((in_len - 1) / max(out_len - 1, 1))
             if out_len > 1 else np.zeros((1,)))
    else:
        f = np.clip((i + 0.5) * (in_len / out_len) - 0.5, 0.0, in_len - 1)
    i0 = np.floor(f).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_len - 1)
    w = f - i0
    M = np.zeros((out_len, in_len), np.float32)
    M[np.arange(out_len), i0] += (1.0 - w).astype(np.float32)
    M[np.arange(out_len), i1] += w.astype(np.float32)
    return M


@functools.lru_cache(maxsize=None)
def _pool_matrix(in_len: int, k: int) -> np.ndarray:
    """(in_len//k, in_len) mean-pool matrix; the `in_len % k` tail gets zero
    weight (VALID-window floor semantics, as `F.avg_pool2d`)."""
    out_len = in_len // k
    M = np.zeros((out_len, in_len), np.float32)
    for i in range(out_len):
        M[i, i * k:(i + 1) * k] = 1.0 / k
    return M


def _separable(x: torch.Tensor, Ry: torch.Tensor,
               Rx: torch.Tensor) -> torch.Tensor:
    y = torch.einsum("hH,bHWc->bhWc", Ry, x.float())
    y = torch.einsum("wW,bhWc->bhwc", Rx, y)
    return y.to(x.dtype)


def lerp_matrix(out_len: int, in_len: int, align_corners: bool,
                device) -> torch.Tensor:
    """`_lerp_matrix` on `device`."""
    return device_table(("lerp_matrix", out_len, in_len, align_corners),
                        lambda: _lerp_matrix(out_len, in_len, align_corners),
                        device)


def pool_matrix(in_len: int, k: int, device) -> torch.Tensor:
    """`_pool_matrix` on `device`."""
    return device_table(("pool_matrix", in_len, k),
                        lambda: _pool_matrix(in_len, k), device)


def resize_bilinear_matmul_nhwc(x: torch.Tensor, size,
                                align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize as two separable matmuls, the same lerp weights as
    `resize_bilinear_nhwc`."""
    _, H, W, _ = x.shape
    return _separable(x, lerp_matrix(size[0], H, align_corners, x.device),
                      lerp_matrix(size[1], W, align_corners, x.device))


def avg_pool_matmul_nhwc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k average pool as two separable matmuls."""
    _, H, W, _ = x.shape
    return _separable(x, pool_matrix(H, k, x.device),
                      pool_matrix(W, k, x.device))
