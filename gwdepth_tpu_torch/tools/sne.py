"""Surface normals from a depth map (SNE), in torch on the inputs' device.

The port's counterpart of `gwdepth_tpu.tools.sne` (the original's
aggregation-based normal estimator, used offline by the dataset
toolchain): deproject the depth to camera-space X/Y/Z, take the
horizontal and vertical gradients of the inverse depth for the azimuth
`phi`, then aggregate 8 directional finite differences for the elevation
and recompose the unit normal. Kept quirks of the original: the azimuth
adds pi to an `atan` (not `atan2`), pixels with Y <= 0 are zeroed, fx
deprojects both X and Y, and the normal flips where ny > 0.

Non-finite values are the usual case here, not an edge case: the zeroed
upper half and every sensor hole make D = 1/Z infinite. The JAX version
convolves with XLA's direct convolution, which multiplies the zero taps
too, so 0 * inf = NaN reaches every pixel whose 3x3 window holds an inf.
`F.conv2d` lets cuDNN pick Winograd or FFT on the card, which would spread
NaN otherwise, so each 3x3 stencil here is nine shifted multiply-adds,
zero taps included: the same NaN pattern on every device. Each stencil has
two taps of +-1, so a finite result is one rounding, the same in any
order.

    normals = sne_normals(depth, cam)       # depth (H, W) m, cam (3, 3)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# 8 directional difference stencils
_DIFF = np.array([[-1, 0, 0, 0, 1, 0, 0, 0, 0],
                  [0, -1, 0, 0, 1, 0, 0, 0, 0],
                  [0, 0, -1, 0, 1, 0, 0, 0, 0],
                  [0, 0, 0, -1, 1, 0, 0, 0, 0],
                  [0, 0, 0, 0, 1, -1, 0, 0, 0],
                  [0, 0, 0, 0, 1, 0, -1, 0, 0],
                  [0, 0, 0, 0, 1, 0, 0, -1, 0],
                  [0, 0, 0, 0, 1, 0, 0, 0, -1]],
                 np.float32).reshape(8, 3, 3)
_GX = np.array([[0, 0, 0], [-1, 0, 1], [0, 0, 0]], np.float32)
_GY = np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]], np.float32)


def _conv3(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """(H, W) cross-correlated with a 3x3 stencil, zero padding SAME, as
    nine shifted products summed in row-major tap order; every tap
    multiplies, so 0 * inf gives NaN as XLA's direct convolution does."""
    H, W = x.shape
    xp = F.pad(x[None, None], (1, 1, 1, 1))[0, 0]
    out = torch.zeros_like(x)
    for a in range(3):
        for b in range(3):
            out = out + float(k[a, b]) * xp[a:a + H, b:b + W]
    return out


def _nan_to(x: torch.Tensor, v: float = 0.0) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.full_like(x, v), x)


def sne_normals(depth: torch.Tensor, cam) -> torch.Tensor:
    """depth (H, W) in meters; cam (3, 3) intrinsics (a tensor or array).
    Returns (3, H, W) unit normals on depth's device, (0, 0, -1) where the
    estimate is undefined."""
    dev = depth.device
    cam = torch.as_tensor(cam, dtype=torch.float32, device=dev)
    H, W = depth.shape
    v_map, u_map = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    Z = depth.float()
    fx, fy = cam[0, 0], cam[1, 1]
    Y = Z * (v_map - cam[1, 2]) / fx          # fx for both axes
    X = Z * (u_map - cam[0, 2]) / fx
    bad = Y <= 0
    Z = _nan_to(torch.where(bad, torch.zeros_like(Z), Z))
    Y = torch.where(bad, torch.zeros_like(Y), Y)
    D = 1.0 / Z                               # inf where Z == 0

    nx_t = _conv3(D, _GX) * fx
    ny_t = _conv3(D, _GY) * fy
    phi = torch.atan(ny_t / nx_t) + math.pi   # atan, not atan2
    a, b = torch.cos(phi), torch.sin(phi)

    sum_nx = torch.zeros_like(Z)
    sum_ny = torch.zeros_like(Z)
    sum_nz = torch.zeros_like(Z)
    for k in _DIFF:
        X_d, Y_d, Z_d = _conv3(X, k), _conv3(Y, k), _conv3(Z, k)
        nz_i = (nx_t * X_d + ny_t * Y_d) / Z_d
        norm = torch.sqrt(nx_t ** 2 + ny_t ** 2 + nz_i ** 2)
        sum_nx = sum_nx + _nan_to(nx_t / norm)
        sum_ny = sum_ny + _nan_to(ny_t / norm)
        sum_nz = sum_nz + _nan_to(nz_i / norm)

    theta = -torch.atan((sum_nx * a + sum_ny * b) / sum_nz)
    nx = torch.sin(theta) * torch.cos(phi)
    ny = torch.sin(theta) * torch.sin(phi)
    nz = torch.cos(theta)
    isnan = torch.isnan(nz)
    nx = torch.where(isnan, torch.zeros_like(nx), nx)
    ny = torch.where(isnan, torch.zeros_like(ny), ny)
    nz = torch.where(isnan, torch.full_like(nz, -1.0), nz)
    sign = torch.where(ny > 0, -1.0, 1.0)
    return torch.stack([nx * sign, ny * sign, nz * sign], dim=0)
