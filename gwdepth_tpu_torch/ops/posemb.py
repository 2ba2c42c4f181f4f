"""Sine position embeddings (DETR-style), NHWC.

`valid_mask` is True on VALID pixels. The line branch uses normalize=True;
the dense encoder uses the un-normalized variant.
"""

from __future__ import annotations

import math

import torch


def _sine_embed(y_embed: torch.Tensor, x_embed: torch.Tensor,
                num_pos_feats: int, temperature: float) -> torch.Tensor:
    """y_embed/x_embed: (B, H, W) float -> (B, H, W, 2*num_pos_feats)."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=y_embed.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    B, H, W = x_embed.shape
    pos_x = torch.stack((pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()),
                        dim=4).reshape(B, H, W, -1)
    pos_y = torch.stack((pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()),
                        dim=4).reshape(B, H, W, -1)
    return torch.cat((pos_y, pos_x), dim=3)


def sine_posemb_from_mask_nhwc(valid_mask: torch.Tensor, num_pos_feats: int,
                               temperature: float = 10000.0,
                               normalize: bool = False,
                               scale: float | None = None) -> torch.Tensor:
    """valid_mask: (B, H, W) bool -> (B, H, W, 2*num_pos_feats) float32."""
    if scale is None:
        scale = 2 * math.pi
    not_mask = valid_mask.to(torch.float32)
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    return _sine_embed(y_embed, x_embed, num_pos_feats, temperature)
