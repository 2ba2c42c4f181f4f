"""Point- and line-guided geometry modules of the dense encoder, NHWC.

The two modules the gated dense encoder builds:
- `PointGuidedTokenFuse` (`class_tokenfuse_layers`): the seg-token stream
  queries, at two pooling scales, a conv-processed pooled depth-token
  context together with the depth tokens sampled at the reference points;
  the two fused streams are merged linearly into the new depth tokens.
- `Global2PointGraph` (`with_line_depth`): a graph between a coarse token
  grid and per-line-endpoint tokens, fused into a per-pixel depth-token
  map.

Kept quirks of the original code:
- one conv tower (`convctx_*`, its 3x3 and then its 5x5 half) serves both
  pooling scales of `PointGuidedTokenFuse`;
- `PointGuidedTokenFuse` returns the fusion itself, with no residual;
- its context pools the raw depth tokens, zero-padded below and to the
  right where the map is smaller than two pooling windows.

Parameter names follow the original PyTorch code: a block's
`token_relation.{xseg_proj,xdth_proj,kv_refer_depth,q_seg,mlpctx,
norm_seg,norm_fuse,convctx_pre3.N,convctx_norm3,convctx_after3,...,
fuse_proj,fused_depth_proj,mutil_depth_fuse}.*` and the encoder's
`gpgN.{node_relation,node_attention,token_node_fuse}.*`.
Reference coordinates are (B, L, P, 2) in [-1, 1], (x, y) order, sampled
nearest with align_corners=False.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gwdepth_tpu_torch.models.points import conv2d_nhwc
from gwdepth_tpu_torch.models.swin import Mlp
from gwdepth_tpu_torch.ops.grid_sample import grid_sample_nhwc
from gwdepth_tpu_torch.ops.interpolate import resize_nearest_nhwc


class ConvA(nn.Module):
    """k x k conv (with bias, SAME padding) + GELU, NHWC."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel,
                              padding=dilation * (kernel // 2),
                              dilation=dilation)

    def forward(self, x):
        c = self.conv
        return F.gelu(conv2d_nhwc(x, c.weight, c.bias, padding=c.padding[0],
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
