"""Coarse-to-fine dense depth/seg encoder, NHWC.

  1/32: line-referenced Swin layer (dim D, 4 blocks; kernel K1) -> d32
  1/16: upsample + fuse backbone C3, per-pixel depth/seg class tokens,
        class Swin layer (D/2) -> d16 -> certain-sample S0 points
  1/8 : upsample + fuse C2, token reprojection, class layer (D/4)
        -> point-based pred (kernel K2) -> certain-sample S1 points
  1/4 : upsample + fuse C1, class layer (D/8) -> point-based pred (K2)

The kernels run where `cfg.use_pallas` puts them, as in the JAX package;
otherwise their plain float32 formulations run. Depth predictions here
are normalized to (0, 1). Reference lines are the top `num_ref` queries
by the raw class-0 logit, their endpoints (and centers with
`with_dense_center`).

The gates, as the JAX package builds them:
- `group_attention_layers`: a class block with group attention replaces
  its queries by the reference mixture over the layer's reference points
  (the lines at 1/16, the sampled depth points at 1/8 and 1/4; K1 on
  their planes);
- `class_tokenfuse_layers`: each block of the layer ends with the
  point-guided depth-token fusion, with a sine position map of the
  tokens' width;
- `with_line_depth`: the depth tokens come from learned per-endpoint
  tokens `point_depth_token` and a coarse grid `init_token` through
  `gpg1..3` (`Global2PointGraph`), in place of the `depth_token`
  parameter and the token reprojections; the seg tokens are upsampled
  with no projection, the JAX package's repair of the original, whose
  forward cannot run with this gate;
- `depth_sample_layers`: off at a scale, no points are sampled there and
  a linear head (`depth_pred8`, `depth_pred4`) replaces the point head.
A block only builds the parameters its forward reads: group attention
and token fusion exist where the layer has reference points.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.models.geometry import ConvA, Global2PointGraph
from gwdepth_tpu_torch.models.points import PointBasedPred, certain_sample
from gwdepth_tpu_torch.models.swin import SwinLayer
from gwdepth_tpu_torch.ops.interpolate import resize_nearest_nhwc
from gwdepth_tpu_torch.ops.posemb import sine_posemb_from_mask_nhwc


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
        self.cfg = cfg
        D = cfg.dense_trans_dim
        tC = cfg.class_token_dim
        heads = cfg.dense_trans_heads
        ws = cfg.window_size
        mr = cfg.mlp_ratio
        c1, c2, c3, _ = cfg.backbone_channels
        sample = cfg.depth_sample_layers
        kind32 = "ref" if cfg.with_line else "plain"
        self.dense_transformer = SwinLayer(D, cfg.dense_trans_layers[0],
                                           heads, ws, mr, kind32,
                                           use_pallas=cfg.use_pallas)
        self.depth_pred32 = DepthHead(D, tC)
        # which class layers get reference points: the lines at 1/16, the
        # points sampled at 1/16 (kept at 1/4 unless resampled at 1/8)
        has_ref = (cfg.with_line, sample[0], sample[0] or sample[1])

        def class_layer(i, dim):
            return SwinLayer(
                dim, cfg.class_trans_layers[i], heads, ws, mr, "class", tC,
                tuple(g and has_ref[i] for g in cfg.group_attention_layers[i]),
                use_pallas=cfg.use_pallas,
                token_fuse=cfg.class_tokenfuse_layers[i] and has_ref[i])

        self.proj_class1 = nn.Linear(D, D // 2)
        self.proj_backbn1 = ConvA(c3, D // 2)
        self.seg_token = nn.Parameter(torch.zeros(1, 1, tC))
        if cfg.with_line_depth:
            cis, nP = cfg.class_init_size, cfg.num_ref * 2
            self.point_depth_token = nn.Parameter(torch.zeros(1, nP, tC))
            self.init_token = nn.Parameter(torch.zeros(1, cis, cis, tC))
            self.gpg1 = Global2PointGraph(tC, nP, cis, 1)
            self.gpg2 = Global2PointGraph(tC, nP, cis, 2)
            self.gpg3 = Global2PointGraph(tC, nP, cis, 4)
        else:
            self.depth_token = nn.Parameter(torch.zeros(1, 1, tC))
        self.class_transformer1 = class_layer(0, D // 2)
        self.depth_pred16 = DepthHead(D // 2 + tC, tC)
        self.proj_class2 = nn.Linear(D // 2, D // 4)
        self.proj_backbn2 = ConvA(c2, D // 4)
        if not cfg.with_line_depth:
            self.old_depth_token_proj8 = MlpNorm(tC, tC * 2, tC)
            self.old_seg_token_proj8 = MlpNorm(tC, tC * 2, tC)
        self.class_transformer2 = class_layer(1, D // 4)
        pools = (16, 8, 4, 2)
        if sample[0]:
            self.point_based_pred1 = PointBasedPred(
                D // 4, tC, pools, cfg.interval_sample_num[0], cfg.use_pallas)
        else:
            self.depth_pred8 = DepthHead(D // 4 + tC, tC)
        self.proj_class3 = nn.Linear(D // 4, D // 8)
        self.proj_backbn3 = ConvA(c1, D // 8)
        if not cfg.with_line_depth:
            self.old_depth_token_proj4 = MlpNorm(tC, tC * 2, tC)
            self.old_seg_token_proj4 = MlpNorm(tC, tC * 2, tC)
        self.class_transformer3 = class_layer(2, D // 8)
        if sample[2]:
            self.point_based_pred2 = PointBasedPred(
                D // 8, tC, pools, cfg.interval_sample_num[1], cfg.use_pallas)
        else:
            self.depth_pred4 = DepthHead(D // 8 + tC, tC)

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
        sample = cfg.depth_sample_layers
        tokfuse = cfg.class_tokenfuse_layers
        ref = None
        if cfg.with_line and pred_logits is not None:
            ref = select_reference_points(pred_lines, pred_logits,
                                          cfg.num_ref, cfg.ref_points_per_line)

        def posmap(mask, feats):
            return sine_posemb_from_mask_nhwc(mask, feats // 2).to(dt)

        def certain(d_small, d_large, n):
            return certain_sample(d_small, d_large, cfg.depth_interval, n,
                                  cfg.min_depth_eval / cfg.max_depth_eval)

        def tokens(i, depth_token, seg_token, hw):
            """The token streams carried to scale i (2: 1/8, 3: 1/4)."""
            if cfg.with_line_depth:
                gpg = self.gpg2 if i == 2 else self.gpg3
                return (gpg(depth_token, point_token, *hw).reshape(
                            B, *hw, tC),
                        _up_nhwc(seg_token, hw))
            scale = 8 if i == 2 else 4
            return (getattr(self, f"old_depth_token_proj{scale}")(
                        _up_nhwc(depth_token, hw)),
                    getattr(self, f"old_seg_token_proj{scale}")(
                        _up_nhwc(seg_token, hw)))

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
        if cfg.with_line_depth:
            point_token = self.point_depth_token.expand(B, -1, -1).to(dt)
            init = self.init_token.expand(B, -1, -1, -1).to(dt)
            depth_token = self.gpg1(init, point_token, h1, w1,
                                    is_init=True).reshape(B, h1, w1, tC)
        else:
            depth_token = self.depth_token[:, None].expand(
                B, h1, w1, tC).to(dt)
        x, depth_token, seg_token = self.class_transformer1(
            x, ref_coords=ref, ref_pos=pos1, depth_token=depth_token,
            seg_token=seg_token,
            token_pos=posmap(masks[2], tC) if tokfuse[0] else None)
        d16 = self.depth_pred16(torch.cat([x, depth_token], dim=-1))[..., 0]
        feat16 = x
        coords = certain(d32, d16, cfg.interval_sample_num[0]) \
            if sample[0] else None

        # ---- 1/8 ----
        h2, w2 = pyramid[1].shape[1:3]
        x = self.proj_class2(_up_nhwc(feat16, (h2, w2)))
        x = x + self.proj_backbn2(pyramid[1])
        pos2 = posmap(masks[1], D // 4)
        depth_token, seg_token = tokens(2, depth_token, seg_token, (h2, w2))
        x, depth_token, seg_token = self.class_transformer2(
            x, ref_coords=coords, ref_pos=pos2, depth_token=depth_token,
            seg_token=seg_token,
            token_pos=posmap(masks[1], tC) if tokfuse[1] else None)
        if sample[0]:
            d8 = self.point_based_pred1(x, depth_token, d16, coords, pos2)
        else:
            d8 = self.depth_pred8(torch.cat([x, depth_token], dim=-1))[..., 0]
        feat8 = x
        if sample[1]:
            coords = certain(d16, d8, cfg.interval_sample_num[1])

        # ---- 1/4 ----
        h3, w3 = pyramid[0].shape[1:3]
        x = self.proj_class3(_up_nhwc(feat8, (h3, w3)))
        x = x + self.proj_backbn3(pyramid[0])
        pos3 = posmap(masks[0], D // 8)
        depth_token, seg_token = tokens(3, depth_token, seg_token, (h3, w3))
        x, depth_token, seg_token = self.class_transformer3(
            x, ref_coords=coords, ref_pos=pos3, depth_token=depth_token,
            seg_token=seg_token,
            token_pos=posmap(masks[0], tC) if tokfuse[2] else None)
        if sample[2]:
            d4 = self.point_based_pred2(x, depth_token, d8, coords, pos3)
        else:
            d4 = self.depth_pred4(torch.cat([x, depth_token], dim=-1))[..., 0]
        return [feat32, feat16, feat8, x], depth_token, seg_token, [d16, d8, d4]
