"""Full-resolution depth/seg decoder, NHWC.

Token-fused MLP at 1/4, two upconv stages (nearest x2 resize + 3x3 conv +
ELU) with a LayerNorm after the first, then 3x3 head convs: sigmoid x
max_depth for depth, 2-channel logits for segmentation.

Only the direct tail is ported. The JAX package's default
`decoder_blockconv=True` tail (`ops/blockconv.py`) is an exact re-layout
of the same convs into space-to-depth blocks, made so the TPU's 128-lane
tile stays full for 16/32-channel planes; the JAX tests assert it equals
the direct tail. That layout trick has no purpose on a GPU, so the port
leaves it out and matches both settings with this one tail.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gwdepth_tpu_torch.models.points import conv2d_nhwc
from gwdepth_tpu_torch.models.swin import Mlp
from gwdepth_tpu_torch.ops.interpolate import resize_nearest_nhwc


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class UpConv(nn.Module):
    """Nearest resize + 3x3 conv (no bias) + ELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv3x3(cin, cout)

    def forward(self, x, new_hw):
        x = resize_nearest_nhwc(x, new_hw)
        return F.elu(conv2d_nhwc(x, self.conv.weight, padding=1))


class DensePrediction(nn.Module):
    """Names as the original: `{depth,seg}_token_fuse`, `upconvK_{branch}`,
    `norm_{branch}`, `convK_{branch}.0`, `get_depth.0` / `get_seg.0`."""

    def __init__(self, feat_dim: int, max_depth: float, token_dim: int):
        super().__init__()
        self.max_depth = max_depth
        tC = token_dim
        dfuse = feat_dim + 1 + tC
        sfuse = feat_dim + tC
        self.depth_token_fuse = Mlp(dfuse, dfuse, tC)
        self.seg_token_fuse = Mlp(sfuse, sfuse, tC)
        for branch, head, out_ch in (("depth", "get_depth", 1),
                                     ("seg", "get_seg", 2)):
            setattr(self, f"upconv1_{branch}", UpConv(tC, tC))
            setattr(self, f"norm_{branch}", nn.LayerNorm(tC, eps=1e-5))
            setattr(self, f"conv1_{branch}",
                    nn.Sequential(_conv3x3(tC, tC), nn.ELU()))
            setattr(self, f"upconv2_{branch}", UpConv(tC, tC // 2))
            setattr(self, f"conv2_{branch}",
                    nn.Sequential(_conv3x3(tC // 2, tC // 2), nn.ELU()))
            setattr(self, head, nn.Sequential(_conv3x3(tC // 2, out_ch)))

    def _tail(self, y, branch: str, head: str, mid_hw, out_hw):
        def conv(name, t):
            return conv2d_nhwc(t, getattr(self, name)[0].weight, padding=1)

        y = getattr(self, f"norm_{branch}")(
            getattr(self, f"upconv1_{branch}")(y, mid_hw))
        y = F.elu(conv(f"conv1_{branch}", y))
        y = getattr(self, f"upconv2_{branch}")(y, out_hw)
        y = F.elu(conv(f"conv2_{branch}", y))
        return conv(head, y)

    def forward(self, feat, depth_pred4, depth_token, seg_token,
                out_hw: Tuple[int, int]):
        """feat (B, h, w, C) 1/4 feature; depth_pred4 (B, h, w) normalized;
        tokens (B, h, w, tC). Returns depth (B, H, W) in meters and seg
        logits (B, H, W, 2)."""
        _, h, w, _ = feat.shape
        mid_hw = (h * 2, w * 2)
        d = self.depth_token_fuse(
            torch.cat([feat, depth_pred4[..., None], depth_token], dim=-1))
        s = self.seg_token_fuse(torch.cat([feat, seg_token], dim=-1))
        d = self._tail(d, "depth", "get_depth", mid_hw, out_hw)
        seg = self._tail(s, "seg", "get_seg", mid_hw, out_hw)
        return self.max_depth * torch.sigmoid(d)[..., 0], seg
