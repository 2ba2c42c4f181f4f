"""Coarse-to-fine dense depth/seg encoder, NHWC.

  1/32: line-referenced Swin layer (dim D, 4 blocks; kernel K1) -> d32
  1/16: upsample + fuse backbone C3, per-pixel depth/seg class tokens,
        class Swin layer (D/2) -> d16 -> certain-sample S0 points
  1/8 : upsample + fuse C2, token reprojection, class layer (D/4)
        -> point-based pred (kernel K2) -> certain-sample S1 points
  1/4 : upsample + fuse C1, class layer (D/8) -> point-based pred (K2)

The kernels run where `cfg.use_pallas` puts them, as in the JAX package;
otherwise their plain float32 formulations run. Depth predictions here
are normalized to (0, 1). Reference lines are the
top `num_ref` queries by the raw class-0 logit, endpoints only. The port
builds the shipped gates only: with_line, no line-depth tokens, no token
fusion, no group attention, point sampling at every scale.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.models.points import (PointBasedPred, certain_sample,
                                             conv2d_nhwc)
from gwdepth_tpu_torch.models.swin import SwinLayer
from gwdepth_tpu_torch.ops.interpolate import resize_nearest_nhwc
from gwdepth_tpu_torch.ops.posemb import sine_posemb_from_mask_nhwc


class ConvA(nn.Module):
    """3x3 conv (with bias) + GELU, NHWC."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return F.gelu(conv2d_nhwc(x, self.conv.weight, self.conv.bias,
                                  padding=1))


class MlpNorm(nn.Module):
    """fc1 -> fc2 -> LayerNorm (no activation)."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.norm = nn.LayerNorm(out, eps=1e-5)

    def forward(self, x):
        return self.norm(self.fc2(self.fc1(x)))


class DepthHead(nn.Sequential):
    """Linear -> Linear -> sigmoid (no inner activation), `.0`/`.1` as the
    original's Sequential."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__(nn.Linear(in_dim, hidden), nn.Linear(hidden, 1),
                         nn.Sigmoid())


def _up_nhwc(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-resize an NHWC map (torch 'nearest' semantics)."""
    return resize_nearest_nhwc(x, hw)


def _stable_topk(v: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices along the last axis, lower index first among ties."""
    return torch.sort(v, dim=-1, descending=True, stable=True).indices[..., :k]


def select_reference_points(pred_lines: torch.Tensor,
                            pred_logits: torch.Tensor, num_ref: int,
                            points_per_line: int) -> torch.Tensor:
    """Top-`num_ref` lines by raw class-0 logit -> (B, num_ref, P, 2) coords
    in [-1, 1]."""
    ids = _stable_topk(pred_logits[:, :, 0], num_ref)             # (B, R)
    chosen = torch.gather(pred_lines, 1,
                          ids[..., None].expand(-1, -1, pred_lines.shape[-1]))
    B = chosen.shape[0]
    chosen = chosen.reshape(B, num_ref, -1, 2) * 2.0 - 1.0
    return chosen[:, :, :points_per_line]


class DenseEncoder(nn.Module):
    """4-scale coarse-to-fine encoder. See the module docstring."""

    def __init__(self, cfg: GWDepthConfig):
        super().__init__()
        if cfg.with_line_depth or any(cfg.class_tokenfuse_layers) or \
                any(any(g) for g in cfg.group_attention_layers) or \
                not all(cfg.depth_sample_layers):
            raise NotImplementedError(
                "the port builds the shipped dense-encoder gates only "
                "(no line-depth tokens, token fusion or group attention; "
                "point sampling at every scale)")
        self.cfg = cfg
        D = cfg.dense_trans_dim
        tC = cfg.class_token_dim
        heads = cfg.dense_trans_heads
        ws = cfg.window_size
        mr = cfg.mlp_ratio
        c1, c2, c3, _ = cfg.backbone_channels
        kind32 = "ref" if cfg.with_line else "plain"
        self.dense_transformer = SwinLayer(D, cfg.dense_trans_layers[0],
                                           heads, ws, mr, kind32,
                                           use_pallas=cfg.use_pallas)
        self.depth_pred32 = DepthHead(D, tC)
        self.proj_class1 = nn.Linear(D, D // 2)
        self.proj_backbn1 = ConvA(c3, D // 2)
        self.seg_token = nn.Parameter(torch.zeros(1, 1, tC))
        self.depth_token = nn.Parameter(torch.zeros(1, 1, tC))
        self.class_transformer1 = SwinLayer(D // 2, cfg.class_trans_layers[0],
                                            heads, ws, mr, "class", tC)
        self.depth_pred16 = DepthHead(D // 2 + tC, tC)
        self.proj_class2 = nn.Linear(D // 2, D // 4)
        self.proj_backbn2 = ConvA(c2, D // 4)
        self.old_depth_token_proj8 = MlpNorm(tC, tC * 2, tC)
        self.old_seg_token_proj8 = MlpNorm(tC, tC * 2, tC)
        self.class_transformer2 = SwinLayer(D // 4, cfg.class_trans_layers[1],
                                            heads, ws, mr, "class", tC)
        pools = (16, 8, 4, 2)
        self.point_based_pred1 = PointBasedPred(
            D // 4, tC, pools, cfg.interval_sample_num[0], cfg.use_pallas)
        self.proj_class3 = nn.Linear(D // 4, D // 8)
        self.proj_backbn3 = ConvA(c1, D // 8)
        self.old_depth_token_proj4 = MlpNorm(tC, tC * 2, tC)
        self.old_seg_token_proj4 = MlpNorm(tC, tC * 2, tC)
        self.class_transformer3 = SwinLayer(D // 8, cfg.class_trans_layers[2],
                                            heads, ws, mr, "class", tC)
        self.point_based_pred2 = PointBasedPred(
            D // 8, tC, pools, cfg.interval_sample_num[1], cfg.use_pallas)

    def forward(self, top_feat: torch.Tensor, pyramid: Sequence[torch.Tensor],
                masks: Sequence[torch.Tensor],
                pred_lines: Optional[torch.Tensor],
                pred_logits: Optional[torch.Tensor]):
        """top_feat (B, H32, W32, D); pyramid [C1..C4] NHWC; masks per-level
        (B, h, w) bool; pred_lines (B, Q, line_dim) and pred_logits
        (B, Q, 2), or None. Returns feats [1/32, 1/16, 1/8, 1/4],
        depth_token, seg_token (1/4), depth_preds [d16, d8, d4]."""
        cfg = self.cfg
        D = cfg.dense_trans_dim
        tC = cfg.class_token_dim
        B = top_feat.shape[0]
        dt = top_feat.dtype
        ref = None
        if cfg.with_line and pred_logits is not None:
            ref = select_reference_points(pred_lines, pred_logits,
                                          cfg.num_ref, cfg.ref_points_per_line)

        def posmap(mask, feats):
            return sine_posemb_from_mask_nhwc(mask, feats // 2).to(dt)

        def sample(d_small, d_large, n):
            return certain_sample(d_small, d_large, cfg.depth_interval, n,
                                  cfg.min_depth_eval / cfg.max_depth_eval)

        # ---- 1/32 ----
        x, _, _ = self.dense_transformer(top_feat, ref_coords=ref,
                                         ref_pos=posmap(masks[3], D))
        d32 = self.depth_pred32(x)[..., 0]
        feat32 = x

        # ---- 1/16 ----
        h1, w1 = pyramid[2].shape[1:3]
        x = self.proj_class1(_up_nhwc(feat32, (h1, w1)))
        x = x + self.proj_backbn1(pyramid[2])
        pos1 = posmap(masks[2], D // 2)
        seg_token = self.seg_token[:, None].expand(B, h1, w1, tC).to(dt)
        depth_token = self.depth_token[:, None].expand(B, h1, w1, tC).to(dt)
        x, depth_token, seg_token = self.class_transformer1(
            x, ref_coords=ref, ref_pos=pos1, depth_token=depth_token,
            seg_token=seg_token)
        d16 = self.depth_pred16(torch.cat([x, depth_token], dim=-1))[..., 0]
        feat16 = x
        coords = sample(d32, d16, cfg.interval_sample_num[0])

        # ---- 1/8 ----
        h2, w2 = pyramid[1].shape[1:3]
        x = self.proj_class2(_up_nhwc(feat16, (h2, w2)))
        x = x + self.proj_backbn2(pyramid[1])
        pos2 = posmap(masks[1], D // 4)
        depth_token = self.old_depth_token_proj8(_up_nhwc(depth_token, (h2, w2)))
        seg_token = self.old_seg_token_proj8(_up_nhwc(seg_token, (h2, w2)))
        x, depth_token, seg_token = self.class_transformer2(
            x, ref_coords=coords, ref_pos=pos2, depth_token=depth_token,
            seg_token=seg_token)
        d8 = self.point_based_pred1(x, depth_token, d16, coords, pos2)
        feat8 = x
        coords = sample(d16, d8, cfg.interval_sample_num[1])

        # ---- 1/4 ----
        h3, w3 = pyramid[0].shape[1:3]
        x = self.proj_class3(_up_nhwc(feat8, (h3, w3)))
        x = x + self.proj_backbn3(pyramid[0])
        pos3 = posmap(masks[0], D // 8)
        depth_token = self.old_depth_token_proj4(_up_nhwc(depth_token, (h3, w3)))
        seg_token = self.old_seg_token_proj4(_up_nhwc(seg_token, (h3, w3)))
        x, depth_token, seg_token = self.class_transformer3(
            x, ref_coords=coords, ref_pos=pos3, depth_token=depth_token,
            seg_token=seg_token)
        d4 = self.point_based_pred2(x, depth_token, d8, coords, pos3)
        return [feat32, feat16, feat8, x], depth_token, seg_token, [d16, d8, d4]
