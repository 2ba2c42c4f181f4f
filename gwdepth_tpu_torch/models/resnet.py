"""ResNet-50/101 backbone with frozen BatchNorm.

Parameter names follow torchvision (`conv1`, `bn1`, `layerN.M.convK`,
`downsample.{0,1}`), so the original checkpoint loads by name. The
backbone runs NCHW tensors in channels-last memory and returns the 4-level
pyramid (1/4, 1/8, 1/16, 1/32) as NHWC views, the JAX package's layout.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gwdepth_tpu_torch.ops.interpolate import resize_nearest


class FrozenBatchNorm2d(nn.Module):
    """Per-channel affine x * scale + bias with scale = w / sqrt(rv + eps),
    bias = b - rm * scale. All four tensors are buffers: never trained."""

    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        bias = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + bias[None, :, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + shortcut."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * 4
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride),
                                         FrozenBatchNorm2d(out))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + identity)


_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class ResNetBackbone(nn.Module):
    """images (B, H, W, 3) -> [C1 (1/4, 256), C2 (1/8, 512),
    C3 (1/16, 1024), C4 (1/32, 2048)], NHWC."""

    def __init__(self, name: str = "resnet50"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for i, (planes, nblk) in enumerate(zip((64, 128, 256, 512),
                                               _LAYERS[name])):
            blocks = []
            for j in range(nblk):
                blocks.append(Bottleneck(cin, planes,
                                         (1 if i == 0 else 2) if j == 0 else 1,
                                         downsample=j == 0))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = images.permute(0, 3, 1, 2)              # channels-last NCHW view
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            feats.append(x.permute(0, 2, 3, 1))
        return tuple(feats)


class BackboneBody(nn.Module):
    """Holds the ResNet as `body`, so names read `backbone.0.body.*` as in
    the original DETR-style checkpoint."""

    def __init__(self, name: str = "resnet50"):
        super().__init__()
        self.body = ResNetBackbone(name)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.body(images)


def pyramid_masks(valid_mask: torch.Tensor,
                  feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Nearest-downsample the (B, H, W) bool validity mask to each level."""
    m = valid_mask.to(torch.float32)
    return tuple(resize_nearest(m, (f.shape[1], f.shape[2])) > 0.5
                 for f in feats)
