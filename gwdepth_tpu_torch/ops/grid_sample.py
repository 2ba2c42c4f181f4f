"""`F.grid_sample` semantics over NHWC maps, written as gathers.

Call sites keep their own mode and `align_corners`: 'nearest' with
align_corners=False for reference-line features (models/swin.py), default
bilinear with align_corners=False for point anchors (models/points.py).
padding_mode='zeros'. Unnormalization:

  align_corners=False: ix = ((x + 1) * W - 1) / 2
  align_corners=True:  ix = (x + 1) / 2 * (W - 1)

Nearest rounds half to even, as torch's nearbyint does. Written out rather
than calling `F.grid_sample` so the CPU and CUDA runs and the JAX package
share one formula.
"""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _gather2d_nhwc(x: torch.Tensor, iy: torch.Tensor,
                   ix: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C); iy/ix: (B, N) long, in bounds -> (B, N, C)."""
    B, H, W, C = x.shape
    flat = x.reshape(B, H * W, C)
    idx = (iy * W + ix)[:, :, None].expand(-1, -1, C)
    return torch.gather(flat, 1, idx)


def grid_sample_nhwc(x: torch.Tensor, grid: torch.Tensor,
                     mode: str = "bilinear",
                     align_corners: bool = False) -> torch.Tensor:
    """x (B, H, W, C), grid (B, Hg, Wg, 2) in [-1, 1], (x, y) order ->
    (B, Hg, Wg, C)."""
    B, H, W, C = x.shape
    _, Hg, Wg, _ = grid.shape
    gx = grid[..., 0].reshape(B, Hg * Wg).float()
    gy = grid[..., 1].reshape(B, Hg * Wg).float()
    fx = _unnormalize(gx, W, align_corners)
    fy = _unnormalize(gy, H, align_corners)

    def inb(yi, xi):
        return (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)

    def gather(yi, xi):
        return _gather2d_nhwc(x, yi.clamp(0, H - 1).long(),
                              xi.clamp(0, W - 1).long())

    if mode == "nearest":
        ix = torch.round(fx)
        iy = torch.round(fy)
        out = gather(iy, ix) * inb(iy, ix)[..., None].to(x.dtype)
        return out.reshape(B, Hg, Wg, C)
    if mode != "bilinear":
        raise ValueError(f"unsupported mode: {mode}")

    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    out = torch.zeros((B, Hg * Wg, C), dtype=x.dtype, device=x.device)
    for yi, wy in ((y0, 1.0 - (fy - y0)), (y0 + 1.0, fy - y0)):
        for xi, wx in ((x0, 1.0 - (fx - x0)), (x0 + 1.0, fx - x0)):
            w = (wx * wy * inb(yi, xi)).to(x.dtype)
            out = out + gather(yi, xi) * w[..., None]
    return out.reshape(B, Hg, Wg, C)
