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

Data parallel (a `DataMesh` of W ranks): `create_train_state` broadcasts
rank 0's parameters and buffers, so every rank starts from the same
state, and `apply_gradients` sums the gradients over ranks (one
`all_reduce` a bucket) before it clips, so the clip sees the global
gradient and every rank takes the same step.

Tensor parallel (a `(D, M)` mesh): after the broadcast
`create_train_state` keeps each rank's shards of the weights that
`partition.spec_for` splits (`place_params`), so AdamW's moments are
shards too; the gradients are summed over the data group, and the clip's
global norm counts each shard once: it is the one-process norm of the
gradients, the split ones gathered whole (`clip_grad_norm_`).

On a card the optimizer and its schedule are device state, as optax keeps
them inside the jitted step: AdamW is built with `capturable=True`, its
step counts live on the card and each group's learning rate is a device
tensor that the schedule fills in place between steps (`advance`). So the
train step's device half (`update`: the sums over ranks, the clip, AdamW,
clearing the gradients) can be captured in a CUDA graph and replayed
(`train_step.make_train_step`), and a step run eagerly under
`graphs.disable()` does the same arithmetic. On the CPU AdamW keeps its
float learning rates (`capturable` takes device parameters only).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.parallel.mesh import DataMesh, make_mesh
from gwdepth_tpu_torch.parallel.partition import (place_params, placed,
                                                  unshard)


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


def clip_grad_norm_(params: List[nn.Parameter], max_norm: float,
                    model: nn.Module) -> torch.Tensor:
    """`torch.nn.utils.clip_grad_norm_(params, max_norm)`, also where
    `model`'s split weights (`place_params`) hold shards of `params`: the
    shards' gradients are gathered whole for the norm, which torch's own
    `get_total_norm` then takes over the one-process list of gradients,
    so every rank scales by the one-process factor, bit for bit. (A sum
    of the shards' squares over the model group counts each shard once
    too, but in another order: the last-bit change of the factor moved
    later steps of the `use_pallas` model by bf16 rounding flips.)
    Returns the norm."""
    pl = placed(model)
    if pl is None:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    index = {id(p): n for n, p in zip(pl.names, pl.params)}
    full = unshard(model, {index[id(p)]: p.grad for p in params
                           if id(p) in index})
    total = torch.nn.utils.get_total_norm(
        [full[index[id(p)]] if id(p) in index else p.grad for p in params])
    torch.nn.utils.clip_grads_with_norm_(params, max_norm, total)
    return total


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
    mesh: DataMesh
    step: int = 0

    @property
    def trainable(self) -> List[nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def apply_gradients(self) -> None:
        """Sum the grads over ranks, clip, one AdamW step, clear the
        grads (`update`), then advance the schedule (`advance`)."""
        self.update()
        self.advance()

    def update(self) -> None:
        """The device half of a step: sum the grads over ranks, clip, one
        AdamW step, clear the grads; nothing here waits for the card, so a
        CUDA graph can capture it. A trained parameter the loss did not
        reach takes a zero gradient, so Adam's moments and the weight
        decay still move, as in optax."""
        params = self.trainable
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.mesh.all_reduce_grads(params)
        clip_grad_norm_(params, self.max_norm, self.model)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def advance(self) -> None:
        """The host half: the schedule's next learning rates, written into
        the groups' device tensors in place (a graph reads them there),
        and the step count."""
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        self.scheduler.step()
        _keep_lr_tensors(self.optimizer, lrs)
        self.step += 1

    def load_optimizer_state(self, sd: dict) -> None:
        """`optimizer.load_state_dict(sd)`, whatever device wrote `sd`: the
        learning rates written into the groups' own tensors where they are
        tensors, and each group's `capturable` flag the one this optimizer
        was built with (a state dict carries its writer's), with AdamW's
        step counts on the parameters' device as capturable takes them or
        on the host as it does not."""
        groups = self.optimizer.param_groups
        lrs = [g["lr"] for g in groups]
        capturable = [g.get("capturable", False) for g in groups]
        self.optimizer.load_state_dict(sd)
        _keep_lr_tensors(self.optimizer, lrs)
        for g, cap in zip(self.optimizer.param_groups, capturable):
            g["capturable"] = cap
            for p in g["params"]:
                st = self.optimizer.state.get(p, {})
                if torch.is_tensor(st.get("step")):
                    st["step"] = (st["step"].to(p.device, torch.float32)
                                  if cap else st["step"].cpu())

    def snapshot(self) -> Callable[[], None]:
        """Copies of what a step writes (the parameters and the optimizer
        state) and a function that writes them back in place. State that
        the optimizer creates after the snapshot (at AdamW's first step)
        goes back to zeros, the state AdamW starts from."""
        params = list(self.model.parameters())
        saved = [p.detach().clone() for p in params]
        state = [t for st in self.optimizer.state.values()
                 for t in st.values() if isinstance(t, torch.Tensor)]
        saved_state = [t.clone() for t in state]
        known = {id(t) for t in state}

        def restore():
            with torch.no_grad():
                for p, v in zip(params, saved):
                    p.copy_(v)
                for t, v in zip(state, saved_state):
                    t.copy_(v)
                for st in self.optimizer.state.values():
                    for t in st.values():
                        if isinstance(t, torch.Tensor) and id(t) not in known:
                            t.zero_()
                for p in params:
                    p.grad = None

        return restore


def _keep_lr_tensors(optimizer: torch.optim.Optimizer, lrs: list) -> None:
    """Put each group's learning-rate tensor of `lrs` back in its group,
    holding the group's new value: a schedule or a state dict may have
    put a float or another tensor there."""
    for g, lr in zip(optimizer.param_groups, lrs):
        if isinstance(lr, torch.Tensor) and g["lr"] is not lr:
            with torch.no_grad():
                lr.fill_(g["lr"])
            g["lr"] = lr


def create_train_state(cfg: GWDepthConfig, model: nn.Module,
                       steps_per_epoch: int = 1000,
                       mesh: Optional[DataMesh] = None,
                       shard: bool = True) -> TrainState:
    """The train state of `model` on `mesh` (default: this process's,
    `make_mesh()`); over several ranks rank 0's parameters and buffers
    overwrite every other rank's first. On a mesh with a model axis each
    rank then keeps its shards (`place_params`) unless `shard` is False
    (`--eval`, which runs on replicated weights as the JAX CLI's)."""
    mesh = make_mesh() if mesh is None else mesh
    mesh.broadcast_([*model.parameters(), *model.buffers()])
    if shard:
        place_params(model, mesh)
    groups = param_groups(model, cfg)
    device = next(model.parameters()).device
    capturable = device.type == "cuda"
    for g in groups:
        # the schedule scales the float; the group's tensor holds the result
        g["initial_lr"] = g["lr"]
        if capturable:
            g["lr"] = torch.tensor(g["lr"], dtype=torch.float32,
                                   device=device)
    opt = torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay,
                            capturable=capturable)
    lrs = [g["lr"] for g in opt.param_groups]
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: lr_factor(step, steps_per_epoch, cfg.lr_drop))
    _keep_lr_tensors(opt, lrs)
    return TrainState(model, opt, sched, cfg.clip_max_norm, mesh)
