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

Gates, as in the JAX package: `with_line=False` builds no line-branch
module, returns `pred_logits` and `pred_lines` as None, and the dense
encoder takes its plain 1/32 Swin layer; `with_dense=False` builds no
dense module and returns no `pred_depth` or `pred_seg`;
`position_embedding` "learned" or "v3" feeds DETR from `LearnedPosEmb2D`
(held as `backbone[1]`, so its tables are `backbone.1.row_embed.weight`
and `backbone.1.col_embed.weight`, the names of DETR's `Joiner`) in place
of the sine embedding.

State-dict names are the original PyTorch code's (`backbone.0.body.*`,
`transformer.encoder.layers.N.*`, `dense_encoder.*`, `depth_decoder.*`).

Training: the backbone stem (`conv1`, `layer1`; its frozen BatchNorms are
buffers) is built with `requires_grad=False`, the JAX package's "frozen"
parameter group. Dropout (DETR only, `cfg.dropout`) is active in
`train()` mode and draws from the `generator` passed to `forward`.

Precision (`cfg.dtype`, `main.py --bf16`), where the JAX package has its
`compute_dtype`: the images are cast to it, the backbone runs in it
(`models/resnet.py`) and so does the DETR's `dense` layers
(`models/detr.py`). Every module that flax builds without a dtype
promotes the bf16 pyramid to float32: `input_proj`, `dense_input_proj`
and the dense encoder's `proj_backbn*` (`geometry.ConvA`) cast their
input up. The position embedding is rounded to the pyramid's dtype, as
in JAX. So the dense encoder, the decoder, the heads, K1 and K2 see
float32, and every output is float32. Parameters stay float32.
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
from gwdepth_tpu_torch.ops.posemb import (LearnedPosEmb2D,
                                         sine_posemb_from_mask_nhwc)


class GlassRGBD(nn.Module):
    def __init__(self, cfg: GWDepthConfig):
        super().__init__()
        self.cfg = cfg
        C4 = cfg.backbone_channels[cfg.layer1_num]
        self.backbone = nn.ModuleList([BackboneBody(cfg.backbone)])
        body = self.backbone[0].body
        for frozen in (body.conv1, body.layer1):
            frozen.requires_grad_(False)
        if cfg.with_line:
            if cfg.position_embedding in ("learned", "v3"):
                # the original's DETR Joiner holds it as backbone[1]
                self.backbone.append(LearnedPosEmb2D(cfg.hidden_dim // 2))
            self.input_proj = nn.Conv2d(C4, cfg.hidden_dim, 1)
            self.query_embed = nn.Embedding(cfg.num_queries, cfg.hidden_dim)
            self.transformer = DETRTransformer(
                cfg.hidden_dim, cfg.nheads, cfg.enc_layers, cfg.dec_layers,
                cfg.dim_feedforward, cfg.dropout, cfg.compute_dtype)
            self.class_embed = nn.Linear(cfg.hidden_dim, cfg.num_classes + 1)
            self.lines_embed = MLP(cfg.hidden_dim, cfg.hidden_dim,
                                   cfg.line_dim, 3)
        if cfg.with_dense:
            self.dense_input_proj = nn.Conv2d(C4, cfg.dense_trans_dim, 1)
            self.dense_encoder = DenseEncoder(cfg)
            self.depth_decoder = DensePrediction(
                cfg.dense_trans_dim // 8, cfg.max_depth, cfg.class_token_dim)

    def forward(self, images: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
        """images (B, H, W, 3) normalized; valid_mask (B, H, W) bool;
        `generator` feeds the dropout masks in train mode."""
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

        out: Dict[str, object] = {"pred_logits": None, "pred_lines": None}
        if cfg.with_line:
            if len(self.backbone) > 1:
                pos = self.backbone[1](B, *src.shape[1:3])
            else:
                pos = sine_posemb_from_mask_nhwc(src_mask, cfg.hidden_dim // 2,
                                                 normalize=True)
            pos = pos.to(src.dtype)
            # float32 from here, as flax promotes the bf16 pyramid against
            # the float32 weights of a module without a dtype
            proj = conv2d_nhwc(src.float(), self.input_proj.weight,
                               self.input_proj.bias)
            N = proj.shape[1] * proj.shape[2]
            hs, _ = self.transformer(proj.reshape(B, N, cfg.hidden_dim),
                                     pos.reshape(B, N, cfg.hidden_dim),
                                     src_mask.reshape(B, N),
                                     self.query_embed.weight, generator)
            logits = self.class_embed(hs)
            coords = torch.sigmoid(self.lines_embed(hs))
            out["pred_logits"] = logits[-1]
            out["pred_lines"] = coords[-1]
            if cfg.aux_loss:
                out["aux_outputs"] = [
                    {"pred_logits": logits[i], "pred_lines": coords[i]}
                    for i in range(cfg.dec_layers - 1)]

        if cfg.with_dense:
            dense_in = conv2d_nhwc(src.float(), self.dense_input_proj.weight,
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
    with std 1/sqrt(fan_in), query embeddings normal(1), learned position
    tables uniform [0, 1), relative-position tables and learned tokens
    normal(0.02). Buffers (frozen BatchNorm, the
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
        elif name.startswith("backbone.1."):
            p.copy_(torch.rand(p.shape, generator=g))
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
