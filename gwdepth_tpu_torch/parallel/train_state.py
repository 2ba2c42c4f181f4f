"""Optimizer and train state with the original parameter grouping.

The port of `gwdepth_tpu/parallel/train_state.py`:

- groups: "backbone" (ResNet parameters past the stem) at `lr_backbone`,
  "main" (everything else) at `lr`; "frozen" parameters (the stem,
  `requires_grad=False`) are left out of the optimizer. The frozen
  BatchNorm tensors are buffers and never reach it either.
- AdamW, beta (0.9, 0.999), eps 1e-8, decoupled `weight_decay` on every
  trained parameter: optax's `adamw` update, written the torch way.
- StepLR by step: x0.1 every `lr_drop` epochs of `steps_per_epoch` steps
  (`make_lr_schedule`).
- `clip_grad_norm_(trainable, clip_max_norm)`: the factor
  max_norm / (norm + 1e-6) clamped to 1, over the trained parameters
  only (`clip_like_torch`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn as nn

from gwdepth_tpu_torch.config import GWDepthConfig


def param_group_label(name: str, param: nn.Parameter) -> str:
    """frozen | backbone | main for one named parameter of GlassRGBD."""
    if not param.requires_grad:
        return "frozen"
    # the learned position tables (`backbone.1.*`) train at `lr`, as the
    # JAX package's `position_embedding` does
    return "backbone" if name.startswith("backbone.0.") else "main"


def param_groups(model: nn.Module, cfg: GWDepthConfig) -> List[Dict]:
    groups = {"main": [], "backbone": []}
    for name, p in model.named_parameters():
        label = param_group_label(name, p)
        if label != "frozen":
            groups[label].append(p)
    return [{"params": groups["main"], "lr": cfg.lr, "name": "main"},
            {"params": groups["backbone"], "lr": cfg.lr_backbone,
             "name": "backbone"}]


def lr_factor(step: int, steps_per_epoch: int, lr_drop: int) -> float:
    """StepLR: 0.1 ** (epoch // lr_drop), the epoch counted in steps."""
    epoch = step // max(steps_per_epoch, 1)
    return 0.1 ** (epoch // lr_drop)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and LR schedule, and the step count."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    max_norm: float
    step: int = 0

    @property
    def trainable(self) -> List[nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def apply_gradients(self) -> None:
        """Clip, one AdamW step, advance the schedule, clear the grads. A
        trained parameter the loss did not reach takes a zero gradient,
        so Adam's moments and the weight decay still move, as in optax."""
        params = self.trainable
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_norm_(params, self.max_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def create_train_state(cfg: GWDepthConfig, model: nn.Module,
                       steps_per_epoch: int = 1000) -> TrainState:
    opt = torch.optim.AdamW(param_groups(model, cfg), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: lr_factor(step, steps_per_epoch, cfg.lr_drop))
    return TrainState(model, opt, sched, cfg.clip_max_norm)
