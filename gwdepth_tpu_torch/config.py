"""Typed configuration, field-for-field the same as `gwdepth_tpu.config`.

The port keeps its own copy: importing the JAX package's config would pull
in `jax.numpy`. `compute_dtype` returns a torch dtype. `use_pallas` routes
the model through kernels K1 and K2 where the JAX package routes it
through its Pallas kernels (bf16 taps in K2). `decoder_blockconv` is kept
so configs round-trip between the packages; the port ignores it (its
decoder runs the direct tail, see `models/decoder.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GWDepthConfig:
    # ---- model topology ----
    backbone: str = "resnet50"
    position_embedding: str = "sine"
    layer1_num: int = 3              # backbone level fed to both branches (1/32)
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    dropout: float = 0.1
    nheads: int = 8
    num_queries: int = 100
    pre_norm: bool = False
    aux_loss: bool = True

    # ---- feature gates ----
    with_line: bool = True
    with_dense: bool = True
    with_center: bool = True
    with_reflection: bool = False
    with_dense_center: bool = False
    with_line_depth: bool = False
    with_plane_norm_loss: bool = False

    # ---- dense branch ----
    max_depth: float = 10.0
    min_depth_eval: float = 1e-3
    max_depth_eval: float = 10.0
    dense_trans_dim: int = 512
    dense_trans_layers: Tuple[int, ...] = (4,)
    dense_trans_heads: int = 16
    class_trans_layers: Tuple[int, ...] = (2, 2, 1)
    group_attention_layers: Tuple[Tuple[bool, ...], ...] = (
        (False, False), (False, False), (False,))
    depth_interval: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7, 0.9)
    depth_sample_layers: Tuple[bool, ...] = (True, True, True)
    interval_sample_num: Tuple[int, ...] = (30, 80, 160)
    class_tokenfuse_layers: Tuple[bool, ...] = (False, False, False)
    class_token_dim: int = 64
    class_init_size: int = 32
    num_ref: int = 20
    window_size: int = 7
    mlp_ratio: float = 2.0

    # ---- matcher / losses ----
    set_cost_class: float = 1.0
    set_cost_line: float = 5.0
    line_loss_coef: float = 5.0
    eos_coef: float = 0.1
    label_loss_func: str = "cross_entropy"
    focal_gamma: float = 2.0
    variance_focus: float = 0.85
    log_depth_error: bool = True
    depth_loss_weights: Tuple[float, ...] = (0.25, 0.25, 0.25, 1.0)
    seg_loss_weight: float = 2.0
    plane_norm_loss_coef: float = 50.0
    # "jax": the JV solver (one CUDA kernel launch a criterion call on the
    # card, its plain version on the CPU) | "scipy": the host solve
    matcher: str = "jax"

    # ---- optimization ----
    lr: float = 1e-4
    lr_backbone: float = 1e-5
    weight_decay: float = 1e-4
    epochs: int = 300
    lr_drop: int = 200
    clip_max_norm: float = 0.1
    batch_size: int = 2
    grad_accum: int = 1
    seed: int = 42

    # ---- static-shape data pipeline ----
    train_hw: Tuple[int, int] = (704, 1024)
    eval_hw: Tuple[int, int] = (768, 1024)
    max_lines: int = 96
    train_min_depth: float = 0.2

    # ---- numerics ----
    dtype: str = "float32"
    param_dtype: str = "float32"
    use_pallas: bool = False
    decoder_blockconv: bool = True
    remat: bool = False

    # ---- parallelism ----
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)

    # ---- dataset paths ----
    data_path: str = ""
    gt_depth_path: str = ""
    gt_seg_path: str = ""
    gt_line_path: str = ""
    filenames_file_train: str = ""
    filenames_file_eval: str = ""
    glassrgbd_images_json: str = ""
    output_dir: str = ""
    glassrgbd_rhint_path: str = ""
    glassrgbd_rhint_points_path: str = ""
    max_rhint_points: int = 50

    # ------------------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def num_classes(self) -> int:
        return 1

    @property
    def line_dim(self) -> int:
        return 6 if self.with_center else 4

    @property
    def ref_points_per_line(self) -> int:
        return 3 if self.with_dense_center else 2

    @property
    def backbone_channels(self) -> Tuple[int, int, int, int]:
        return (256, 512, 1024, 2048)

    def replace(self, **kw) -> "GWDepthConfig":
        return dataclasses.replace(self, **kw)

    def set_matmul_precision(self) -> None:
        """Run cuBLAS matmuls and cuDNN convs at the config's precision:
        full float32 (no TF32) for `dtype="float32"`, which PyTorch would
        otherwise round to TF32 in every cuDNN conv."""
        tf32 = self.dtype != "float32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32


def tiny_test_config(**kw) -> GWDepthConfig:
    """Small config for unit tests: every architectural mechanism (4 scales,
    window shift, ref attention, point sampling) at toy sizes."""
    base = dict(
        enc_layers=2,
        dec_layers=2,
        dim_feedforward=64,
        hidden_dim=32,
        nheads=4,
        num_queries=12,
        dense_trans_dim=32,
        dense_trans_layers=(2,),
        dense_trans_heads=4,
        class_trans_layers=(1, 1, 1),
        group_attention_layers=((False,), (False,), (False,)),
        interval_sample_num=(6, 8, 12),
        class_token_dim=8,
        class_init_size=4,
        num_ref=4,
        train_hw=(64, 96),
        eval_hw=(64, 96),
        max_lines=8,
        dropout=0.0,
    )
    base.update(kw)
    return GWDepthConfig(**base)
