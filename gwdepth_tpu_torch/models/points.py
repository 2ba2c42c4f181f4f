"""Uncertainty-driven point sampling and point-based depth prediction, NHWC.

- `certain_sample`: `sample_num` high-variance points stratified by depth
  intervals, with the original's quirks (per-interval top-k over the
  GLOBAL variance map, index-ascending order, tile-then-repeat fill).
- `PyramidLayer`: mini ResNet + 4-scale SPP over the per-point planes.
  With `use_pallas`, as in the JAX package, its 12-link trunk and, where
  the concat is at most 400 channels wide, its `last0` link run through
  kernel K2 (`ops/fused_conv.py`, bf16 taps); otherwise, and for the SPP
  branches and the wide `last0`, plain float32 conv + LayerNorm.
- `PointBasedPred`: depth = sum over points of softmax(pyramid(global x
  refer)) * anchor depth, with the original's `dim**-2` scale.

The library half, which no model path builds:
- `OffsetGeneration`: every location of the map proposes
  `num_ref_points / 2` points; the location whose proposals span the
  largest convex hull (scipy on the host, the one copy off the device)
  adds its points to the reference coords. Its `PyramidLayer` runs
  unfused, as the JAX module builds it, so it launches no kernel.
- `sample_along_seg` / `sample_mid_seg`: extra points along each line.

Names follow the original PyTorch code: `firstconv.{0,2}`,
`layerK.J.conv1.0` / `layerK.J.conv2`, `branchK.1`, `lastconv.{0,2}`, and
ConvLn's `conv` / `layer_norm`; `OffsetGeneration` carries the JAX
package's names (`channel_attention_fc`, `backbone_fc0`, `goff0`..`goff6`,
`refer_proj`, `pyramid`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gwdepth_tpu_torch.ops.fused_conv import conv3x3_ln_act
from gwdepth_tpu_torch.ops.grid_sample import grid_sample_nhwc
from gwdepth_tpu_torch.ops.interpolate import (avg_pool_matmul_nhwc,
                                               resize_bilinear,
                                               resize_bilinear_matmul_nhwc)
from gwdepth_tpu_torch.ops.tables import device_table

# widest concat whose `last0` link still goes through the fused kernel
# (the 1/8 site, 300 channels; the 1/4 site's 800 stays a plain conv)
FUSE_LAST0_MAX_CI = 400


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, b=None, padding: int = 0,
                dilation: int = 1) -> torch.Tensor:
    """Conv of an NHWC tensor with a torch (O, I, kh, kw) weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=padding,
                 dilation=dilation)
    return y.permute(0, 2, 3, 1)


def conv_nhwc(c: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`c` applied to an NHWC tensor, with its own padding and dilation."""
    return conv2d_nhwc(x, c.weight, c.bias, padding=c.padding[0],
                       dilation=c.dilation[0])


# ---------------------------------------------------------------------------
# certain sample
# ---------------------------------------------------------------------------

def _topk_flat(v: torch.Tensor, S: int) -> torch.Tensor:
    """Top-S indices of a flat array, ties broken by the lower index first
    (as `lax.top_k`): a stable descending sort, since `torch.topk` promises
    no tie order."""
    return torch.sort(v, descending=True, stable=True).indices[:S]


def certain_sample(pred_small: torch.Tensor, pred_large: torch.Tensor,
                   intervals: Sequence[float], sample_num: int,
                   min_depth_norm: float) -> torch.Tensor:
    """pred_small (B, h, w), pred_large (B, H, W) normalized depths ->
    (B, S, 1, 2) coords in [-1, 1], grid_sample (x, y) convention."""
    B, H, W = pred_large.shape
    S = sample_num
    dev = pred_large.device
    up = resize_bilinear(pred_small, (H, W), align_corners=True)
    variance = (up - pred_large) ** 2
    bounds = [min_depth_norm] + list(intervals) + [1.0]
    K = len(bounds) - 1
    total = H * W
    r = torch.arange(S, device=dev)

    rows = []
    for bi in range(B):
        p = pred_large[bi].reshape(-1)
        v = variance[bi].reshape(-1)
        counts = torch.stack([((p >= bounds[i]) & (p < bounds[i + 1])).sum()
                              for i in range(K)]).float()
        quotas = torch.minimum(torch.floor(counts / total * S),
                               counts).long()                    # (K,)
        topi = _topk_flat(v, S)                                  # desc by var
        # segment k: its quota of largest-variance pixels, index-ascending
        masked = torch.where(r[None, :] < quotas[:, None], topi[None, :],
                             torch.full_like(topi, total)[None, :])
        mat = torch.sort(masked, dim=1).values                   # (K, S)
        csum = torch.cumsum(quotas, 0)
        starts = csum - quotas
        already = csum[-1]
        seg_id = torch.searchsorted(csum, r, right=True).clamp(0, K - 1)
        base = mat[seg_id, r - starts[seg_id]]
        # fixed-size fill: tile the sequence, then repeat its tail
        A = torch.clamp(already, min=1)
        copy_times = torch.where(S - A >= A, (S - A) // A + 1,
                                 torch.ones_like(A))
        T = A * copy_times
        remain2 = S - T
        tp = torch.where(r < T, r, (T - remain2) + (r - T))
        filled = base[tp.clamp(0, S - 1) % A]
        fallback = torch.sort(topi).values      # no quota: global top-S
        rows.append(torch.where(already > 0, filled, fallback))
    flat = torch.stack(rows)                                     # (B, S)
    x = ((flat % W).float() / W) * 2.0 - 1.0
    y = ((flat // W).float() / H) * 2.0 - 1.0
    return torch.stack([x, y], dim=-1)[:, :, None, :]


# ---------------------------------------------------------------------------
# pyramid layer
# ---------------------------------------------------------------------------

class ConvLn(nn.Module):
    """3x3 conv without bias + channels-last LayerNorm."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.layer_norm = nn.LayerNorm(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Plain conv + LayerNorm (x NHWC)."""
        return self.layer_norm(conv2d_nhwc(x, self.conv.weight, padding=1))

    def fused(self, x: torch.Tensor, act=None,
              residual=None) -> torch.Tensor:
        """act(LN(conv(x))) [+ residual] through kernel K2."""
        return conv3x3_ln_act(x, self.conv.weight.permute(2, 3, 1, 0),
                              self.layer_norm.weight, self.layer_norm.bias,
                              residual, act)


class BasicBlock(nn.Module):
    """ConvLn+GELU -> ConvLn, residual; `conv1` is `Sequential(ConvLn,
    GELU)` as in the original. `fuse` runs both links through K2."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Sequential(ConvLn(planes, planes), nn.GELU())
        self.conv2 = ConvLn(planes, planes)

    def forward(self, x: torch.Tensor, fuse: bool = False) -> torch.Tensor:
        if not fuse:
            return self.conv2(self.conv1(x)) + x
        out = self.conv1[0].fused(x, "gelu")
        # the residual add stays outside the kernel, as in the JAX package
        return self.conv2.fused(out) + x


class PyramidLayer(nn.Module):
    """Mini ResNet + SPP over per-point planes; in/out channels = points.
    The module containers mirror the original's Sequentials; index 0 of
    each `branchK` stands for its average pool, which runs here as a
    separable matmul (`avg_pool_matmul_nhwc`). `use_pallas` fuses the
    trunk and the narrow `last0` into K2, as the JAX module does."""

    def __init__(self, in_dim: int, pool_sizes: Tuple[int, ...],
                 use_pallas: bool = False):
        super().__init__()
        d2 = in_dim * 2
        self.use_pallas = use_pallas
        self.pool_sizes = tuple(pool_sizes)
        self.firstconv = nn.Sequential(ConvLn(in_dim, in_dim), nn.GELU(),
                                       ConvLn(in_dim, d2), nn.GELU())
        self.layer1 = nn.Sequential(BasicBlock(d2))
        self.layer2 = nn.Sequential(BasicBlock(d2), BasicBlock(d2))
        self.layer3 = nn.Sequential(BasicBlock(d2), BasicBlock(d2))
        for i, k in enumerate(self.pool_sizes):
            setattr(self, f"branch{i + 1}", nn.Sequential(
                nn.AvgPool2d(k, k), ConvLn(d2, d2), nn.GELU()))
        self.lastconv = nn.Sequential(
            ConvLn(d2 * (len(self.pool_sizes) + 1), d2 * 2), nn.GELU(),
            nn.Conv2d(d2 * 2, in_dim, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, P) -> (B, H, W, P)."""
        _, H, W, _ = x.shape
        fuse = self.use_pallas
        if fuse:
            x = self.firstconv[0].fused(x, "gelu")
            x = self.firstconv[2].fused(x, "gelu")
        else:
            x = self.firstconv(x)
        for layer in (self.layer1, self.layer2, self.layer3):
            for blk in layer:
                x = blk(x, fuse)
        # pad so the largest pool fits
        k0 = self.pool_sizes[0]
        Hp, Wp = max(H, k0), max(W, k0)
        if Hp != H or Wp != W:
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        branches = [x]
        for i, k in enumerate(self.pool_sizes):
            b = avg_pool_matmul_nhwc(x, k)
            b = F.gelu(getattr(self, f"branch{i + 1}")[1](b))
            branches.append(resize_bilinear_matmul_nhwc(b, (Hp, Wp),
                                                        align_corners=True))
        xx = torch.cat(branches, dim=-1)
        last0 = self.lastconv[0]
        if fuse and xx.shape[-1] <= FUSE_LAST0_MAX_CI:
            x = last0.fused(xx, "gelu")
        else:
            x = F.gelu(last0(xx))
        x = x @ self.lastconv[2].weight[:, :, 0, 0].t()
        return x[:, :H, :W]


# ---------------------------------------------------------------------------
# point based prediction
# ---------------------------------------------------------------------------

class PointBasedPred(nn.Module):
    """Depth from sampled anchor points."""

    def __init__(self, dim: int, token_dim: int,
                 pool_sizes: Tuple[int, ...], point_num: int,
                 use_pallas: bool = False):
        super().__init__()
        self.dim = dim
        self.pre_proj = nn.Linear(dim + token_dim, dim)
        self.refer_proj = nn.Linear(dim, 2 * dim)
        self.pyramid = PyramidLayer(point_num, pool_sizes, use_pallas)

    def forward(self, x, depth_token, pre_depth, coords, pos_embedding):
        """x (B, H, W, C); depth_token (B, H, W, tC); pre_depth (B, H, W);
        coords (B, S, 1, 2); pos_embedding (B, H, W, C) -> (B, H, W)."""
        x_global = self.pre_proj(torch.cat([x, depth_token], dim=-1))
        xg, xr = self.refer_proj(x_global).split(self.dim, dim=-1)
        refer = (grid_sample_nhwc(xr, coords)
                 + grid_sample_nhwc(pos_embedding, coords))[:, :, 0, :]
        anchor = grid_sample_nhwc(pre_depth[..., None], coords)[:, :, 0, 0]
        rg = torch.einsum("bhwc,bsc->bhws", xg, refer) * (self.dim ** -2)
        rg = self.pyramid(rg.to(x.dtype))
        attn = torch.softmax(rg.float(), dim=-1)
        return torch.einsum("bhws,bs->bhw", attn, anchor.float())


# ---------------------------------------------------------------------------
# offset generation and extra points along segments (library)
# ---------------------------------------------------------------------------

def _hull_areas_host(pts: np.ndarray) -> np.ndarray:
    """(..., n, 2) -> (...) convex-hull areas, scipy on the host; a
    degenerate (collinear) set has area 0."""
    from scipy.spatial import ConvexHull, QhullError

    flat = pts.reshape(-1, *pts.shape[-2:])
    out = np.zeros(flat.shape[0], np.float32)
    for i, p in enumerate(flat):
        try:
            out[i] = ConvexHull(p).volume      # in 2-D the volume is the area
        except QhullError:
            out[i] = 0.0
    return out.reshape(pts.shape[:-2])


class OffsetGeneration(nn.Module):
    """Extra reference points: token channel attention over the backbone
    features, a dilated conv tower, and per location `num_ref_points / 2`
    proposed points from a `PyramidLayer` over the correlation with the
    current reference points; the location whose proposals span the
    largest convex hull adds them, grouped P a line. The reference coords
    must hold L * P = `num_ref_points` points, the pyramid's planes."""

    def __init__(self, x_dim: int, token_dim: int, num_ref_points: int,
                 pool_sizes: Tuple[int, ...] = (32, 16, 8, 4)):
        super().__init__()
        tC = token_dim
        self.x_dim, self.token_dim = x_dim, tC
        self.num_ref_points = num_ref_points
        self.channel_attention_fc = nn.Linear(tC, tC)
        self.backbone_norm = nn.LayerNorm(x_dim, eps=1e-5)
        self.backbone_fc0 = nn.Conv2d(x_dim, x_dim // 2, 3, padding=1)
        self.backbone_fc1 = nn.Conv2d(x_dim // 2, tC, 1)
        self.global_norm = nn.LayerNorm(tC, eps=1e-5)
        h2, h4 = tC // 2, tC // 4
        for name, ci, co, k, dil in (
                ("goff0", tC, h2, 1, 1), ("goff1", h2, h2, 3, 1),
                ("goff2", h2, h2, 3, 6), ("goff3", h2, h2, 3, 16),
                ("goff4", h2, h2, 3, 1), ("goff5", h2, h4, 1, 1),
                ("goff6", h4, h4, 1, 1)):
            setattr(self, name, nn.Conv2d(ci, co, k, padding=dil * (k // 2),
                                          dilation=dil))
        self.refer_proj = nn.Linear(x_dim, h4)
        self.pyramid = PyramidLayer(num_ref_points, pool_sizes,
                                    use_pallas=False)

    def forward(self, x: torch.Tensor, depth_token: torch.Tensor,
                refer_coords: torch.Tensor,
                token_pos: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, H, W, x_dim); depth_token (B, H, W, tC); refer_coords
        (B, L, P, 2) in [-1, 1]; token_pos (B, H, W, x_dim) or None (the
        JAX module's `with_pos=False`). Returns
        (B, L + num_ref_points / (2 P), P, 2)."""
        B, P = x.shape[0], refer_coords.shape[2]
        coords = self.proposals(x, depth_token, refer_coords, token_pos)
        best = self.largest_hull(coords)
        chosen = coords[torch.arange(B, device=coords.device), best]
        chosen = chosen.reshape(B, -1, P, 2) * 2.0 - 1.0
        return torch.cat([refer_coords, chosen], dim=1)

    def largest_hull(self, coords: torch.Tensor) -> torch.Tensor:
        """(B, HW, num_ref_points) proposals -> (B,) the location whose
        points span the largest hull. The one copy off the device: the
        areas come from the host; argmax keeps the first of equal areas,
        as jnp.argmax."""
        B, HW, _ = coords.shape
        pts = coords.detach().reshape(B, HW, self.num_ref_points // 2, 2)
        areas = torch.from_numpy(_hull_areas_host(pts.cpu().numpy()))
        return torch.argmax(areas.to(coords.device), dim=-1)

    def proposals(self, x, depth_token, refer_coords, token_pos):
        """Every location's proposed points, (B, H*W, num_ref_points) in
        [0, 1], the arguments as `forward`'s."""
        B, H, W, _ = x.shape
        ch = torch.softmax(F.gelu(self.channel_attention_fc(depth_token)),
                           dim=-1)
        xs = self.backbone_norm(x)
        xo = F.gelu(conv_nhwc(self.backbone_fc0, xs))
        xo = F.gelu(conv_nhwc(self.backbone_fc1, xo))
        xo = self.global_norm(ch * xo + xo)
        g = F.gelu(conv_nhwc(self.goff0, xo))
        for name in ("goff1", "goff2", "goff3", "goff4", "goff5"):
            g = conv_nhwc(getattr(self, name), g)
        g = conv_nhwc(self.goff6, F.gelu(g))

        # bilinear samples at the current reference points
        refer_x = grid_sample_nhwc(xs, refer_coords)
        if token_pos is not None:
            refer_x = refer_x + grid_sample_nhwc(token_pos, refer_coords)
        refer_x = self.refer_proj(refer_x.reshape(B, -1, self.x_dim))
        ref_g = torch.einsum("bnc,bhwc->bhwn", refer_x, g).to(x.dtype)
        return torch.sigmoid(self.pyramid(ref_g).reshape(B, H * W, -1))


def sample_along_seg(lines: torch.Tensor, height: int, width: int,
                     sample_num_seg: int = 10) -> torch.Tensor:
    """Append `sample_num_seg` evenly spaced points along each segment.
    lines (B, L, 2, 2) in [-1, 1] -> (B, L, 2 + sample_num_seg, 2). The
    steps start from the leftmost endpoint (the first of equal x), and y
    moves by |dy| / n with the sign of (y_end - y_start), as the
    original."""
    scale = device_table(("seg_scale", width, height), lambda: np.array(
        [width, height], np.float32), lines.device, lines.dtype)
    px = (lines + 1.0) / 2.0 * scale
    st_id = torch.argmin(px[..., 0], dim=2)                 # (B, L)
    end_id = torch.argmax(px[..., 0], dim=2)

    def pick(i):
        return torch.gather(px, 2, i[..., None, None].expand(
            -1, -1, 1, 2))[:, :, 0]

    st, end = pick(st_id), pick(end_id)
    dist = torch.sqrt(((st - end) ** 2).sum(-1))
    safe = torch.clamp(dist, min=1e-12)
    cosv = torch.abs(st[..., 0] - end[..., 0]) / safe
    sinv = torch.abs(st[..., 1] - end[..., 1]) / safe
    seg = dist / sample_num_seg
    row_oper = torch.where(st[..., 1] < end[..., 1], 1.0, -1.0).to(px.dtype)
    steps = torch.arange(1, sample_num_seg + 1, dtype=px.dtype,
                         device=px.device)
    p_x = st[..., 0, None] + (seg * cosv)[..., None] * steps
    p_y = st[..., 1, None] + (seg * sinv * row_oper)[..., None] * steps
    allp = torch.cat([px, torch.stack([p_x, p_y], dim=-1)], dim=2)
    return allp / scale * 2.0 - 1.0


def sample_mid_seg(lines: torch.Tensor) -> torch.Tensor:
    """Append each segment's midpoint: (B, L, 2, 2) -> (B, L, 3, 2)."""
    mid = (lines[:, :, 0] + lines[:, :, 1]) / 2.0
    return torch.cat([lines, mid[:, :, None]], dim=2)
