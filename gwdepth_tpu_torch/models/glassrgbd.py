"""GW-Depth top model: joint line detection + dense depth + glass seg.

ResNet backbone -> 4-level pyramid; line branch = 1x1 projection of C4 +
DETR transformer with learned line queries and class/line heads (sigmoid
coords); dense branch = 1x1 projection of C4 + coarse-to-fine dense
encoder + full-resolution decoder.

Input: a padded canvas (B, H, W, 3), normalized, and a (B, H, W) bool
validity mask. Output dict, as the JAX package's:
  pred_logits (B, Q, 2), pred_lines (B, Q, 4|6), aux_outputs [per decoder
  layer but the last], pred_depth [d16, d8, d4, dfull] (normalized for the
  first three, meters for dfull), pred_seg (B, H, W, 2).

State-dict names are the original PyTorch code's (`backbone.0.body.*`,
`transformer.encoder.layers.N.*`, `dense_encoder.*`, `depth_decoder.*`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.models.decoder import DensePrediction
from gwdepth_tpu_torch.models.dense_encoder import DenseEncoder
from gwdepth_tpu_torch.models.detr import MLP, DETRTransformer
from gwdepth_tpu_torch.models.points import conv2d_nhwc
from gwdepth_tpu_torch.models.resnet import BackboneBody, pyramid_masks
from gwdepth_tpu_torch.ops.posemb import sine_posemb_from_mask_nhwc


class GlassRGBD(nn.Module):
    def __init__(self, cfg: GWDepthConfig):
        super().__init__()
        if cfg.position_embedding != "sine" or not cfg.with_line or \
                not cfg.with_dense:
            raise NotImplementedError(
                "the port builds the shipped config: sine position "
                "embedding, line and dense branches on")
        self.cfg = cfg
        C4 = cfg.backbone_channels[cfg.layer1_num]
        self.backbone = nn.ModuleList([BackboneBody(cfg.backbone)])
        self.input_proj = nn.Conv2d(C4, cfg.hidden_dim, 1)
        self.query_embed = nn.Embedding(cfg.num_queries, cfg.hidden_dim)
        self.transformer = DETRTransformer(
            cfg.hidden_dim, cfg.nheads, cfg.enc_layers, cfg.dec_layers,
            cfg.dim_feedforward)
        self.class_embed = nn.Linear(cfg.hidden_dim, cfg.num_classes + 1)
        self.lines_embed = MLP(cfg.hidden_dim, cfg.hidden_dim, cfg.line_dim, 3)
        self.dense_input_proj = nn.Conv2d(C4, cfg.dense_trans_dim, 1)
        self.dense_encoder = DenseEncoder(cfg)
        self.depth_decoder = DensePrediction(
            cfg.dense_trans_dim // 8, cfg.max_depth, cfg.class_token_dim)

    def forward(self, images: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, object]:
        """images (B, H, W, 3) normalized; valid_mask (B, H, W) bool."""
        cfg = self.cfg
        B, H, W, _ = images.shape
        if valid_mask is None:
            valid_mask = torch.ones((B, H, W), dtype=torch.bool,
                                    device=images.device)
        images = images.to(cfg.compute_dtype)
        feats = self.backbone[0](images)
        masks = pyramid_masks(valid_mask, feats)
        src = feats[cfg.layer1_num]
        src_mask = masks[cfg.layer1_num]

        out: Dict[str, object] = {}
        pos = sine_posemb_from_mask_nhwc(src_mask, cfg.hidden_dim // 2,
                                         normalize=True).to(src.dtype)
        proj = conv2d_nhwc(src, self.input_proj.weight, self.input_proj.bias)
        N = proj.shape[1] * proj.shape[2]
        hs, _ = self.transformer(proj.reshape(B, N, cfg.hidden_dim),
                                 pos.reshape(B, N, cfg.hidden_dim),
                                 src_mask.reshape(B, N),
                                 self.query_embed.weight)
        logits = self.class_embed(hs)
        coords = torch.sigmoid(self.lines_embed(hs))
        out["pred_logits"] = logits[-1]
        out["pred_lines"] = coords[-1]
        if cfg.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": logits[i], "pred_lines": coords[i]}
                for i in range(cfg.dec_layers - 1)]

        dense_in = conv2d_nhwc(src, self.dense_input_proj.weight,
                               self.dense_input_proj.bias)
        feats_d, depth_token, seg_token, depth_preds = self.dense_encoder(
            dense_in, feats, masks, out["pred_lines"], out["pred_logits"])
        depth_full, seg = self.depth_decoder(
            feats_d[-1], depth_preds[-1], depth_token, seg_token, (H, W))
        out["pred_depth"] = depth_preds + [depth_full]
        out["pred_seg"] = seg
        return out


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from one explicit CPU generator: LayerNorm
    weight 1 / bias 0, other biases 0, matrices and conv kernels normal
    with std 1/sqrt(fan_in), query embeddings normal(1), relative-position
    tables and learned tokens normal(0.02). Buffers (frozen BatchNorm, the
    relative-position index) keep their identity values. The same seed
    gives the same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = model.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else model
        if isinstance(owner, nn.LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias" or leaf.endswith("_bias"):
            p.zero_()
        elif isinstance(owner, nn.Embedding):
            p.copy_(torch.randn(p.shape, generator=g))
        elif p.dim() >= 2 and leaf not in ("relative_position_bias_table",
                                          "diff_mu", "diff_logsigma"):
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
        else:
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return model


def build_glassrgbd(cfg: GWDepthConfig, seed: int = 0,
                    device="cuda") -> GlassRGBD:
    """A GlassRGBD with weights from `seed`, in eval mode on `device`."""
    model = init_weights(GlassRGBD(cfg), seed)
    return model.to(device).eval()
