"""PyTorch/CUDA port of `gwdepth_tpu` for NVIDIA Hopper (H100).

GW-Depth: from one RGB image, detect glass-structure lines and predict
metric depth and glass segmentation. The JAX package `gwdepth_tpu` is the
reference this port is held against; this package never imports it.

Entry points take an explicit `device` (default "cuda"). The hand-written
CUDA kernels (`csrc/`) run for CUDA tensors; CPU tensors take each
kernel's plain PyTorch version.
"""

from gwdepth_tpu_torch.config import GWDepthConfig, tiny_test_config

__all__ = ["GWDepthConfig", "tiny_test_config"]
