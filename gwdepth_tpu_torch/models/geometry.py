"""Point- and line-guided geometry modules, NHWC.

The two modules the gated dense encoder builds:
- `PointGuidedTokenFuse` (`class_tokenfuse_layers`): the seg-token stream
  queries, at two pooling scales, a conv-processed pooled depth-token
  context together with the depth tokens sampled at the reference points;
  the two fused streams are merged linearly into the new depth tokens.
- `Global2PointGraph` (`with_line_depth`): a graph between a coarse token
  grid and per-line-endpoint tokens, fused into a per-pixel depth-token
  map.

The library half, which no model path builds (the original keeps it
behind gates that are off or broken):
- `TokenFuse`: the older single-scale seg-queried fusion, residual into
  the depth tokens;
- `ConvGRU`, `PyramidConv` and `NonLocalPlannarGuidance`: depth
  refinement by correlation against reference-point features, through a
  3x3-conv GRU;
- `ReflectionReduce`: the reflection-hint conv pyramid (1/16, 1/8, 1/4);
- `PointTokenAttention`: per-point tokens attending over the global
  features and themselves;
- `distance_map`, `_kmeans` and `sample_by_centers`: line selection by
  clustered centers.

Kept quirks of the original code:
- one conv tower (`convctx_*`, its 3x3 and then its 5x5 half) serves both
  pooling scales of `PointGuidedTokenFuse`;
- `PointGuidedTokenFuse` returns the fusion itself, with no residual;
- its context pools the raw depth tokens, zero-padded below and to the
  right where the map is smaller than two pooling windows;
- `ReflectionReduce`'s first stage is built with a resize ratio of 0,
  which cannot run: it is taken as no resize;
- `sample_by_centers` measures a line's length from its x-coordinates
  alone, scaled by both the width and the height;
- `PointTokenAttention` scales by `token_dim ** -0.5`, not by the head
  width's;
- `NonLocalPlannarGuidance`'s `pre_depth_upsample` is a one-channel
  `PyramidConv`, whose every level ends in a LayerNorm over that one
  channel, which gives its bias alone: the coarser depth map does not
  reach the output (as in the JAX module).

Parameter names follow the original PyTorch code: a block's
`token_relation.{xseg_proj,xdth_proj,kv_refer_depth,q_seg,mlpctx,
norm_seg,norm_fuse,convctx_pre3.N,convctx_norm3,convctx_after3,...,
fuse_proj,fused_depth_proj,mutil_depth_fuse}.*` and the encoder's
`gpgN.{node_relation,node_attention,token_node_fuse}.*`. The library
modules carry the JAX package's names (`convz`, `conv_pre0_0`,
`depth_fuse_fc1`, `sp_red1_conv`, `global_proj`, ...), since the original
code's are not recorded.
Reference coordinates are (B, L, P, 2) in [-1, 1], (x, y) order, sampled
nearest with align_corners=False.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gwdepth_tpu_torch.models.points import conv_nhwc, conv2d_nhwc
from gwdepth_tpu_torch.models.swin import Mlp
from gwdepth_tpu_torch.ops.grid_sample import grid_sample_nhwc
from gwdepth_tpu_torch.ops.interpolate import (resize_bilinear_nhwc,
                                               resize_nearest_nhwc)


class ConvA(nn.Module):
    """k x k conv (with bias, SAME padding) + GELU, NHWC, in float32: a
    bf16 input (the backbone's pyramid under `cfg.dtype="bfloat16"`) is
    cast up, as flax promotes it in a module without a dtype."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel,
                              padding=dilation * (kernel // 2),
                              dilation=dilation)

    def forward(self, x):
        c = self.conv
        return F.gelu(conv2d_nhwc(x.float(), c.weight, c.bias,
                                  padding=c.padding[0],
                                  dilation=c.dilation[0]))


def _flatten_hw(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)


def _sample_points(feat_map: torch.Tensor, coords: torch.Tensor,
                   pos_map: Optional[torch.Tensor]) -> torch.Tensor:
    """Nearest grid-sample of an NHWC map at (B, L, P, 2) coords, plus the
    positional map sampled at the same points. Returns (B, L*P, C)."""
    s = grid_sample_nhwc(feat_map, coords, mode="nearest")
    if pos_map is not None:
        s = s + grid_sample_nhwc(pos_map, coords, mode="nearest")
    return s.reshape(s.shape[0], -1, s.shape[-1])


def _attend(q: torch.Tensor, kv: torch.Tensor, dim: int) -> torch.Tensor:
    """softmax(q k^T) v, k and v the two halves of kv, softmax in float32."""
    k, v = kv[..., :dim], kv[..., dim:]
    attn = torch.softmax(torch.einsum("bnc,bmc->bnm", q, k).float(), dim=-1)
    return attn.to(v.dtype) @ v


class PointGuidedTokenFuse(nn.Module):
    """Seg-token-queried attention over the pooled depth-token context and
    the depth tokens sampled at the reference points, at the pooling
    scales `ks_list` ((kernel, stride) pairs)."""

    def __init__(self, x_dim: int, token_dim: int,
                 ks_list: Tuple[Tuple[int, int], ...] = ((11, 5), (17, 8))):
        super().__init__()
        tC = token_dim
        self.token_dim = tC
        self.ks_list = ks_list
        self.xseg_proj = Mlp(tC + x_dim, x_dim, tC)
        self.xdth_proj = Mlp(tC + x_dim, x_dim, tC)
        self.q_seg = Mlp(tC, tC, tC)
        self.norm_seg = nn.LayerNorm(tC, eps=1e-5)
        self.mlpctx = Mlp(tC, tC * 4, tC)
        self.kv_refer_depth = Mlp(tC, tC, 2 * tC)
        self.fuse_proj = nn.Linear(tC, tC)
        self.norm_fuse = nn.LayerNorm(tC, eps=1e-5)
        self.fused_depth_proj = nn.Linear(tC, tC)
        self.convctx_pre3 = nn.Sequential(ConvA(tC, tC * 4, 3),
                                          ConvA(tC * 4, tC * 4, 3))
        self.convctx_norm3 = nn.LayerNorm(tC * 4, eps=1e-5)
        self.convctx_after3 = ConvA(tC * 4, tC, 3)
        self.convctx_pre5 = nn.Sequential(ConvA(tC, tC * 4, 5),
                                          ConvA(tC * 4, tC * 4, 5))
        self.convctx_norm5 = nn.LayerNorm(tC * 4, eps=1e-5)
        self.convctx_after5 = ConvA(tC * 4, tC, 5)
        self.mutil_depth_fuse = nn.Linear(tC * len(ks_list), tC)

    def conv_process(self, y: torch.Tensor) -> torch.Tensor:
        """The one conv tower, shared by every pooling scale."""
        y = self.convctx_after3(self.convctx_norm3(self.convctx_pre3(y)))
        return self.convctx_after5(self.convctx_norm5(self.convctx_pre5(y)))

    def forward(self, x: torch.Tensor, seg_token: torch.Tensor,
                depth_token: torch.Tensor, refer_coords: torch.Tensor,
                token_pos: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, H, W, x_dim) block features; seg/depth tokens and
        token_pos (B, H, W, tC); refer_coords (B, L, P, 2). Returns the
        fused depth-token map (B, H, W, tC)."""
        tC = self.token_dim
        B, H, W, _ = x.shape
        xf = _flatten_hw(x)
        stx = self.xseg_proj(torch.cat([_flatten_hw(seg_token), xf], -1))
        dtx = self.xdth_proj(torch.cat([_flatten_hw(depth_token), xf], -1))
        refer_depth = _sample_points(dtx.reshape(B, H, W, tC), refer_coords,
                                     token_pos)                # (B, L*P, tC)
        q_seg = self.norm_seg(self.q_seg(stx)) * tC ** -0.5

        streams = []
        for k, s in self.ks_list:
            # pad so that two pooling steps fit
            min_size = s + k
            dtm = F.pad(depth_token, (0, 0, 0, max(0, min_size - W),
                                      0, max(0, min_size - H)))
            pooled = F.avg_pool2d(dtm.permute(0, 3, 1, 2), k, s)
            ctx = _flatten_hw(self.conv_process(pooled.permute(0, 2, 3, 1)))
            ctx1 = self.mlpctx(torch.cat([ctx, refer_depth], dim=1))
            fused = self.fuse_proj(_attend(q_seg, self.kv_refer_depth(ctx1),
                                           tC))
            streams.append(self.fused_depth_proj(self.norm_fuse(fused)))
        out = self.mutil_depth_fuse(torch.cat(streams, dim=-1))
        return out.reshape(B, H, W, tC)


class Global2PointGraph(nn.Module):
    """Graph fuse between a coarse token grid and per-point tokens: the
    grid, resized to `init_size * upsample_ratio` a side, relates to the
    point tokens (`node_relation`), aggregates along its rows and columns
    into one token a point (`token_node_fuse`), and every pixel of the
    token map attends over those (`node_attention`), with a residual."""

    def __init__(self, token_dim: int, num_point: int, init_size: int,
                 upsample_ratio: int):
        super().__init__()
        self.token_dim = token_dim
        self.new_size = init_size * upsample_ratio
        self.node_relation = Mlp(num_point, 4 * num_point, num_point)
        self.node_attention = Mlp(num_point, 4 * num_point, num_point)
        self.token_node_fuse = Mlp(2 * self.new_size, 2 * self.new_size, 1)

    def forward(self, token_init: torch.Tensor, point_token: torch.Tensor,
                height: int, width: int, is_init: bool = False
                ) -> torch.Tensor:
        """token_init (B, sH, sW, dim); point_token (B, nPnt, dim).
        Returns (B, height * width, dim)."""
        dim = self.token_dim
        B, nP = point_token.shape[:2]
        expd = token_init if is_init else \
            token_init.repeat_interleave(2, 1).repeat_interleave(2, 2)
        token_raw = resize_nearest_nhwc(expd, (height, width))
        if not is_init:
            expd = resize_nearest_nhwc(expd, (self.new_size, self.new_size))
        sH, sW = expd.shape[1:3]

        templ = expd.reshape(B, sH * sW, dim)
        adj = torch.einsum("bnc,bpc->bnp", templ, point_token) * dim ** -0.5
        adj = self.node_relation(adj).reshape(B, sH, sW, nP)
        # row and column aggregation of the grid per point
        node_w = torch.einsum("bhwp,bhwc->bhpc", adj, expd) * sW ** -0.5
        node_h = torch.einsum("bhwp,bhwc->bwpc", adj, expd) * sH ** -0.5
        tn = torch.cat([node_w, node_h], dim=1).reshape(
            B, sH + sW, nP * dim).transpose(1, 2)
        token_fused = self.token_node_fuse(tn).reshape(B, nP, dim)

        raw = token_raw.reshape(B, height * width, dim)
        attn = torch.einsum("bnc,bpc->bnp", raw, point_token) * dim ** -0.5
        attn = torch.softmax(self.node_attention(attn).float(), dim=-1)
        return attn.to(raw.dtype) @ token_fused + raw


# ---------------------------------------------------------------------------
# the library half: modules no model path builds
# ---------------------------------------------------------------------------

class TokenFuse(nn.Module):
    """Seg-queried attention over the depth tokens sampled at the
    reference points, residual into the depth-token map (the single-scale
    variant that `PointGuidedTokenFuse` superseded)."""

    def __init__(self, token_dim: int):
        super().__init__()
        tC = token_dim
        self.token_dim = tC
        self.depth_proj = Mlp(tC, tC, tC)
        self.kv_refer_depth = Mlp(tC, tC, 2 * tC)
        self.seg_proj = Mlp(tC, tC, tC)
        self.q_seg_geometry = Mlp(tC, tC, tC)
        self.norm_geometry = nn.LayerNorm(tC, eps=1e-5)
        self.norm_fuse = nn.LayerNorm(tC, eps=1e-5)
        self.fused_depth_proj = nn.Linear(tC, tC)

    def forward(self, seg_token: torch.Tensor, depth_token: torch.Tensor,
                refer_coords: torch.Tensor,
                token_pos: Optional[torch.Tensor]) -> torch.Tensor:
        """seg/depth tokens and token_pos (B, H, W, tC); refer_coords
        (B, L, P, 2). Returns (B, H, W, tC)."""
        tC = self.token_dim
        B, H, W, _ = depth_token.shape
        dproj = self.depth_proj(_flatten_hw(depth_token))
        refer_depth = _sample_points(dproj.reshape(B, H, W, tC),
                                     refer_coords, token_pos)
        kv = self.kv_refer_depth(refer_depth)
        k, v = kv[..., :tC], kv[..., tC:]
        q = self.norm_geometry(self.q_seg_geometry(
            self.seg_proj(_flatten_hw(seg_token))))
        # the scale after the product, as the original
        attn = torch.einsum("bnc,bmc->bnm", q, k) * tC ** -0.5
        fused = torch.softmax(attn.float(), dim=-1).to(v.dtype) @ v
        fused = self.fused_depth_proj(self.norm_fuse(fused))
        return fused.reshape(B, H, W, tC) + depth_token


class ConvGRU(nn.Module):
    """3x3-conv GRU cell over NHWC maps: h (B, H, W, hidden), x
    (B, H, W, in_dim) -> the new h."""

    def __init__(self, hidden_dim: int, in_dim: int):
        super().__init__()
        ci = hidden_dim + in_dim
        self.convz = nn.Conv2d(ci, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(ci, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(ci, hidden_dim, 3, padding=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(conv_nhwc(self.convz, hx))
        r = torch.sigmoid(conv_nhwc(self.convr, hx))
        q = torch.tanh(conv_nhwc(self.convq, torch.cat([r * h, x], dim=-1)))
        return (1.0 - z) * h + z * q


class PyramidConv(nn.Module):
    """Average-pool pyramid (`num_levels` 2x2 pools) -> a conv tower per
    level -> LayerNorm -> concat -> fuse conv, GELU throughout; `size`
    resizes every level bilinearly (align_corners=False) inside its tower.
    Convs without bias, as the original."""

    def __init__(self, in_dim: int, out: int, hidden: int,
                 num_levels: int = 2):
        super().__init__()
        self.num_levels = num_levels
        h2 = hidden // 2
        for i in range(num_levels + 1):
            for name, ci, co in ((f"conv_pre{i}_0", in_dim, h2),
                                 (f"conv_pre{i}_1", h2, hidden),
                                 (f"conv_scales{i}_0", hidden, h2),
                                 (f"conv_scales{i}_1", h2, out)):
                setattr(self, name, nn.Conv2d(ci, co, 3, padding=1,
                                              bias=False))
            setattr(self, f"norm_scales{i}", nn.LayerNorm(out, eps=1e-5))
        self.conv3 = nn.Conv2d(out * (num_levels + 1), out, 3, padding=1,
                               bias=False)

    def forward(self, x: torch.Tensor,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """x (B, H, W, in_dim) -> (B, *size, out)."""
        _, H, W, _ = x.shape
        # the least input on which num_levels stride-2 pools fit
        msize = 2
        for _ in range(self.num_levels):
            msize = (msize - 1) * 2 + 2
        xp = F.pad(x, (0, 0, 0, max(0, msize - W), 0, max(0, msize - H)))
        pyramid = [x]
        for _ in range(self.num_levels):
            xp = F.avg_pool2d(xp.permute(0, 3, 1, 2), 2, 2).permute(
                0, 2, 3, 1)
            pyramid.append(xp)
        outs = []
        for i, y in enumerate(pyramid):
            y = F.gelu(conv_nhwc(getattr(self, f"conv_pre{i}_0"), y))
            y = F.gelu(conv_nhwc(getattr(self, f"conv_pre{i}_1"), y))
            if size is not None:
                y = resize_bilinear_nhwc(y, size, align_corners=False)
            y = F.gelu(conv_nhwc(getattr(self, f"conv_scales{i}_0"), y))
            y = F.gelu(conv_nhwc(getattr(self, f"conv_scales{i}_1"), y))
            outs.append(getattr(self, f"norm_scales{i}")(y))
        return F.gelu(conv_nhwc(self.conv3, torch.cat(outs, dim=-1)))


class NonLocalPlannarGuidance(nn.Module):
    """Depth refinement by the correlation of every pixel's features with
    those at the reference points, integrated through a `ConvGRU`.
    `num_points` = L * P of the reference coords; `depth_dim` the
    channels of the coarser depth map."""

    def __init__(self, backbone_dim: int, token_dim: int, num_points: int,
                 num_levels: int = 2, depth_dim: int = 1):
        super().__init__()
        tC = token_dim
        self.token_dim = tC
        self.depth_fuse_fc1 = nn.Linear(backbone_dim + tC, 2 * tC)
        self.depth_fuse_fc2 = nn.Linear(2 * tC, tC)
        self.pre_depth_upsample = PyramidConv(depth_dim, 1, 32, num_levels)
        self.class_kv = nn.Linear(tC, 2 * tC)
        self.gru = ConvGRU(tC, num_points + 1)
        self.new_depth = nn.Linear(tC, 1)

    def forward(self, backbone_x: torch.Tensor, seg_token: torch.Tensor,
                depth_token: torch.Tensor, refer_coords: torch.Tensor,
                token_pos: Optional[torch.Tensor],
                depth_pred: torch.Tensor) -> Tuple[torch.Tensor, None]:
        """backbone_x (B, H, W, Cb); depth_token, token_pos (B, H, W, tC);
        refer_coords (B, L, P, 2); depth_pred (B, h, w, depth_dim).
        Returns ((B, H, W, 1) sigmoid depth, None); `seg_token` is unused,
        as in the original."""
        tC = self.token_dim
        B, H, W, _ = depth_token.shape
        fused = torch.cat([_flatten_hw(backbone_x),
                           _flatten_hw(depth_token)], dim=-1)
        depth_feats = F.gelu(self.depth_fuse_fc2(
            F.gelu(self.depth_fuse_fc1(fused))))              # (B, HW, tC)
        dp = self.pre_depth_upsample(depth_pred, size=(H, W))
        kv = F.gelu(self.class_kv(depth_feats))
        class_k, class_v = kv[..., :tC], kv[..., tC:]
        class_pnt = _sample_points(class_k.reshape(B, H, W, tC),
                                   refer_coords, token_pos) * tC ** -0.5
        corr = torch.einsum("bnc,bpc->bnp", class_v, class_pnt)
        c1 = torch.cat([corr.reshape(B, H, W, -1), dp], dim=-1)
        h = self.gru(depth_feats.reshape(B, H, W, tC), c1)
        return torch.sigmoid(self.new_depth(h)), None


class ReflectionReduce(nn.Module):
    """Conv pyramid turning a reflection-hint RGB map into 1/16, 1/8 and
    1/4 feature maps (256, 128 and 64 channels). Each stage: conv + ELU,
    nearest resize, conv without bias + ELU; the first stage does not
    resize (the original's ratio 0)."""

    STAGES = ((16, 32), (64, 64), (256, 128), (256, 256))

    def __init__(self, in_dim: int = 3):
        super().__init__()
        ci = in_dim
        for idx, (mid, out) in enumerate(self.STAGES, start=1):
            setattr(self, f"sp_red{idx}_conv",
                    nn.Conv2d(ci, mid, 3, padding=1))
            setattr(self, f"sp_red{idx}_up",
                    nn.Conv2d(mid, out, 3, padding=1, bias=False))
            ci = out

    def forward(self, reflc: torch.Tensor,
                layers_size: Sequence[Tuple[int, int]]):
        """reflc (B, H, W, 3); layers_size [(h16, w16), (h8, w8),
        (h4, w4)]. Returns [feat16, feat8, feat4]."""
        size16, size8, size4 = layers_size
        x, feats = reflc, []
        for idx, size in enumerate((None, size4, size8, size16), start=1):
            x = F.elu(conv_nhwc(getattr(self, f"sp_red{idx}_conv"), x))
            if size is not None:
                x = resize_nearest_nhwc(x, size)
            x = F.elu(conv_nhwc(getattr(self, f"sp_red{idx}_up"), x))
            feats.append(x)
        return feats[:0:-1]


class PointTokenAttention(nn.Module):
    """Per-point tokens attend, over `num_heads` heads, over the global
    features projected to tokens followed by the point tokens."""

    def __init__(self, dim: int, num_heads: int, token_dim: int):
        super().__init__()
        tC = token_dim
        self.token_dim, self.num_heads = tC, num_heads
        self.global_proj = nn.Linear(dim, tC)
        self.cls_pnt_q = nn.Linear(tC, tC)
        self.global_token_proj = nn.Linear(tC, tC)
        self.global_k = nn.Linear(tC, tC)
        self.global_v = nn.Linear(tC, tC)
        self.proj_token = nn.Linear(tC, tC)

    def forward(self, x: torch.Tensor,
                point_token: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, dim); point_token (B, nPnt, tC) -> (B, nPnt, tC)."""
        tC, nH = self.token_dim, self.num_heads
        B, H, W, _ = x.shape
        nP = point_token.shape[1]

        def heads(t):
            return t.reshape(B, t.shape[1], nH, tC // nH).transpose(1, 2)

        x_g = self.global_proj(x.reshape(B, H * W, -1))
        q = heads(self.cls_pnt_q(point_token))
        t_x = self.global_token_proj(torch.cat([x_g, point_token], dim=1))
        k, v = heads(self.global_k(t_x)), heads(self.global_v(t_x))
        attn = torch.einsum("bhnd,bhmd->bhnm", q * tC ** -0.5, k)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        return self.proj_token(out.transpose(1, 2).reshape(B, nP, tC))


def distance_map(height: int, width: int, device=None) -> torch.Tensor:
    """(H*W, H*W) pairwise distances of the normalized [-1, 1] pixel
    grid, divided by 4."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    g = torch.stack([(xs / (width - 1)) * 2.0 - 1.0,
                     (ys / (height - 1)) * 2.0 - 1.0], dim=-1).reshape(-1, 2)
    d = torch.sqrt(((g[None, :, :] - g[:, None, :]) ** 2).sum(-1))
    return d / 4.0


def _linspace_idx(n: int, k: int) -> np.ndarray:
    """int32 of `jnp.linspace(0, n - 1, k)`: float32 steps i / (k - 1)
    times n - 1, the last exactly n - 1, truncated. A linspace that rounds
    otherwise truncates some steps to the index below."""
    if k == 1:
        return np.zeros(1, np.int64)
    step = np.arange(k - 1, dtype=np.float32) / np.float32(k - 1)
    out = np.append(np.float32(n - 1) * step, np.float32(n - 1))
    return out.astype(np.int32).astype(np.int64)


def _kmeans(points: torch.Tensor, num_clusters: int,
            iters: int = 20) -> torch.Tensor:
    """Fixed-iteration Lloyd k-means labels of (N, 2) points. The initial
    centres are evenly strided points in x-sorted (stable) order; ties of
    distance go to the lower centre."""
    N = points.shape[0]
    order = torch.argsort(points[:, 0], stable=True)
    idx = torch.from_numpy(_linspace_idx(N, num_clusters)).to(points.device)
    centers = points[order[idx]]

    def labels_of(centers):
        d = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        return torch.argmin(d, dim=-1)

    for _ in range(iters):
        onehot = F.one_hot(labels_of(centers), num_clusters).to(points.dtype)
        counts = onehot.sum(0)[:, None]
        sums = onehot.t() @ points
        centers = torch.where(counts > 0, sums / counts.clamp(min=1.0),
                              centers)
    return labels_of(centers)


def sample_by_centers(center_coords: torch.Tensor, line_coords: torch.Tensor,
                      line_logits: torch.Tensor, input_h: int, input_w: int,
                      shortest_ratio: float = 0.05, num_clusters: int = 16,
                      top_num: int = 6, sample_line_num: int = 50
                      ) -> torch.Tensor:
    """Cluster the line centres, keep the `top_num` best lines of each
    cluster (by class-0 logit) that are long enough, and fill up to
    `sample_line_num` lines by the global logit order. center_coords
    (B, Q, 2), line_coords (B, Q, 4), line_logits (B, Q, 2), all
    normalized [0, 1]. Returns (B, sample_line_num, 4).

    Every ranking is a stable sort, so ties go to the lower index, as
    `jnp.argsort` and `lax.top_k` break them (`torch.topk` defines no
    order among ties)."""
    out = []
    for centers, lines, logits in zip(center_coords, line_coords,
                                      line_logits):
        Q = centers.shape[0]
        labels = _kmeans(centers, num_clusters)
        score = logits[:, 0]
        order = torch.argsort(-score, stable=True)
        onehot = F.one_hot(labels[order], num_clusters).to(score.dtype)
        within = ((torch.cumsum(onehot, 0) - 1.0) * onehot).sum(-1)
        rank_in_cluster = torch.zeros(Q, dtype=score.dtype,
                                      device=score.device)
        rank_in_cluster[order] = within
        # the original's length: both axes from the x-coordinates
        xd = lines[:, 0] - lines[:, 2]
        length = torch.sqrt((xd * input_w) ** 2 + (xd * input_h) ** 2)
        long_enough = length > min(input_h, input_w) * shortest_ratio
        selected = (rank_in_cluster < top_num) & long_enough
        prio = torch.where(selected, score + 1e3, score)
        idx = torch.sort(prio, descending=True, stable=True).indices
        out.append(lines[idx[:sample_line_num]])
    return torch.stack(out)
