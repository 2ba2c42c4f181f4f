"""Tensor-parallel parameter partitioning over the `model` mesh axis.

The port of `gwdepth_tpu/parallel/partition.py`. The JAX package
annotates the weights of the big matmuls and convolutions with
PartitionSpecs over `model` and lets XLA insert the gathers, with no
change to the model's code; the sharding changes the layout, never the
result. The port keeps that contract on a `(data, model)` `DataMesh`:

- `spec_for` is the JAX rule on the port's `state_dict` names and
  PyTorch layouts. A flax Dense kernel (din, dout) is a PyTorch (dout,
  din) weight, so JAX's `P(None, "model")` splits dim 0 here and
  `P("model", None)` dim 1; a flax conv kernel (kh, kw, I, O) is (O, I,
  kh, kw), so its O split is dim 0. The name lists, the divisibility
  rules and the size floors (dout >= 4 M for a Dense kernel, O >= 8 M for
  a conv) are JAX's; biases, norms, embeddings, K1's `conv_kernel` and
  every other tensor stay replicated.
- `place_params` keeps, on each rank, only its 1/M slice of every split
  weight: the `nn.Parameter` itself becomes the local shard (plain
  tensors, not DTensors), so AdamW's moments and the gradients are 1/M
  too, and the `state_dict` keeps the original names.
- `gathered(model)` is the compute: for a forward (and its backward),
  every shard is gathered to its full tensor in one `all_gather` over
  the model group and put in its module's place, so the model's code
  reads whole weights, K1 and K2 among them, and no DTensor reaches a
  kernel. The gather's backward hands each rank the slice of the full
  weight's gradient that its shard holds: the M ranks of a model group
  compute the same loss on the same images, so that slice is the whole
  gradient of the shard (a sum over the group would count it M times).
- `full_state_dict` / `full_optimizer_state` gather the shards for a
  checkpoint, and `shard_state_dict` / `shard_optimizer_state` slice a
  full one on load, so a checkpoint is the one-process checkpoint
  whatever the mesh.

Megatron-style compute, where the activations between a column-split
and a row-split linear stay split over `model`, is not done: every
weight is gathered whole at use.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gwdepth_tpu_torch.parallel.mesh import DataMesh

# the JAX rule's names of the flax modules whose kernels split by output
# features (column) or by input features (row)
_COL_NAMES = ("qkv", "linear1", "fc1", "ref_qk", "in_proj_weight",
              "global_k", "global_v")
_ROW_NAMES = ("proj", "out_proj", "linear2", "fc2")
# port parents whose flax module has another name: the depth heads'
# Sequential(Linear, Linear, Sigmoid) is `fc1`/`fc2` in flax
_FLAX_PARENT = (
    (re.compile(r"(^|\.)depth_pred\d+\.0\.weight$"), "fc1"),
    (re.compile(r"(^|\.)depth_pred\d+\.1\.weight$"), "fc2"),
)
# `.weight` tensors that are no flax `kernel`: the embeddings (flax leaves
# `query_embed`, `row_embed`, `col_embed`) and K1's `conv_kernel`
_NOT_KERNELS = re.compile(r"(^|\.)(query_embed|row_embed|col_embed|"
                          r"ref_attn_diffusion)\.weight$")


def _flax_parent(name: str) -> str:
    for pattern, parent in _FLAX_PARENT:
        if pattern.search(name):
            return parent
    parts = name.split(".")
    return parts[-2] if len(parts) > 1 else ""


def spec_for(name: str, shape: Sequence[int], model_size: int
             ) -> Optional[int]:
    """The dim of the PyTorch tensor `name` of `shape` that splits over a
    `model` axis of `model_size` ranks, or None (replicated)."""
    shape = tuple(shape)
    if model_size <= 1 or not shape:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "in_proj_weight" and len(shape) == 2:
        # (3C, C), verbatim in flax: the fused qkv splits per head group
        return 0 if shape[0] % (3 * model_size) == 0 else None
    if leaf != "weight" or _NOT_KERNELS.search(name):
        return None
    if len(shape) == 2:
        dout, din = shape
        parent = _flax_parent(name)
        if parent in _COL_NAMES and dout % model_size == 0:
            return 0
        if parent in _ROW_NAMES and din % model_size == 0:
            return 1
        if dout % model_size == 0 and dout >= 4 * model_size:
            return 0
        return None
    if len(shape) == 4:
        dout = shape[0]
        if dout % model_size == 0 and dout >= 8 * model_size:
            return 0
    return None


def param_placements(model: nn.Module, mesh: DataMesh
                     ) -> Dict[str, Optional[int]]:
    """{parameter name: split dim or None} of `model` on `mesh`, by the
    full shapes (call it before `place_params`)."""
    return {n: spec_for(n, p.shape, mesh.model_size)
            for n, p in model.named_parameters()}


@dataclasses.dataclass
class _Placed:
    """What `place_params` did to a model: the mesh, and per split
    parameter its name and split dim, and every module slot that holds
    it."""
    mesh: DataMesh
    names: List[str]
    params: List[nn.Parameter]
    dims: List[int]
    slots: List[Tuple[nn.Module, str, int]]   # (module, key, index)


def placed(model: nn.Module) -> Optional[_Placed]:
    """The model's placement, None when `place_params` split nothing."""
    return getattr(model, "_tp_placed", None)


def _local(t: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
    """This rank's 1/M slice of the full `t` along `dim`."""
    size = t.shape[dim] // mesh.model_size
    return t.narrow(dim, mesh.model_rank * size, size)


def place_params(model: nn.Module, mesh: DataMesh) -> nn.Module:
    """Keep on this rank only its shard of every weight that `spec_for`
    splits over `mesh`'s model axis (each rank must hold the same full
    weights first). A mesh without a model axis splits nothing."""
    if placed(model) is not None:
        raise ValueError("place_params: the model is placed already")
    names, params, dims = [], [], []
    placements = param_placements(model, mesh)
    for name, p in model.named_parameters():
        dim = placements[name]
        if dim is None:
            continue
        names.append(name)
        params.append(p)
        dims.append(dim)
        with torch.no_grad():
            p.data = _local(p.data, dim, mesh).clone()
    if not params:
        return model
    index = {id(p): i for i, p in enumerate(params)}
    slots = [(mod, key, index[id(v)]) for mod in model.modules()
             for key, v in mod._parameters.items()
             if v is not None and id(v) in index]
    model._tp_placed = _Placed(mesh, names, params, dims, slots)
    return model


class _GatherShards(torch.autograd.Function):
    """The full tensors of shards split along `dims`, in one all_gather
    over the model group; the backward hands each shard its slice of the
    full tensor's gradient (see the module docstring)."""

    @staticmethod
    def forward(ctx, mesh, dims, *shards):
        ctx.mesh, ctx.dims = mesh, dims
        flat = torch.cat([s.detach().reshape(-1) for s in shards])
        pieces = mesh.model_all_gather(flat)
        out, off = [], 0
        for s, d in zip(shards, dims):
            n = s.numel()
            out.append(torch.cat([p[off:off + n].view(s.shape)
                                  for p in pieces], dim=d))
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        return (None, None, *[_local(g, d, mesh).contiguous()
                              for g, d in zip(grads, ctx.dims)])


@contextlib.contextmanager
def gathered(model: nn.Module) -> Iterator[None]:
    """Within the block, every split weight of `model` reads as its full
    tensor, gathered (differentiably) on entry; the shards are back in
    place on exit. Run the forward and its backward inside (a recompute
    in the backward, `--remat`, reads the full weights too). A model that
    `place_params` did not split is left as it is."""
    pl = placed(model)
    if pl is None:
        yield
        return
    full = _GatherShards.apply(pl.mesh, tuple(pl.dims), *pl.params)
    for mod, key, i in pl.slots:
        mod._parameters[key] = full[i]
    try:
        yield
    finally:
        for mod, key, i in pl.slots:
            mod._parameters[key] = pl.params[i]


def _full(pl: _Placed, tensors: Sequence[torch.Tensor]
          ) -> List[torch.Tensor]:
    """The full tensors of shard-shaped `tensors` (one per split
    parameter, in `pl.params` order), without autograd."""
    with torch.no_grad():
        return list(_GatherShards.apply(pl.mesh, tuple(pl.dims),
                                        *[t.detach() for t in tensors]))


def unshard(model: nn.Module, tensors: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """`tensors` by parameter name (values, gradients or moments), each
    of a split parameter gathered whole from this rank's shard-shaped
    one; the others as they are. A collective: every rank calls it with
    the same names."""
    pl = placed(model)
    if pl is None:
        return dict(tensors)
    # the names not given gather as zeros, on the given tensors' device
    device = next((t.device for t in tensors.values()), None)
    shards = [tensors[n] if n in tensors
              else torch.zeros(p.shape, dtype=p.dtype, device=device)
              for n, p in zip(pl.names, pl.params)]
    out = dict(tensors)
    for n, t in zip(pl.names, _full(pl, shards)):
        if n in tensors:
            out[n] = t
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every split weight gathered whole: the
    one-process state dict. A collective: every rank calls it."""
    return unshard(model, model.state_dict())


def shard_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A full (one-process) state dict cut to this rank's shards."""
    pl = placed(model)
    if pl is None:
        return sd
    sd = dict(sd)
    for name, dim in zip(pl.names, pl.dims):
        if name in sd:
            sd[name] = _local(sd[name], dim, pl.mesh).clone()
    return sd


def _split_slots(model: nn.Module, optimizer: torch.optim.Optimizer
                 ) -> Dict[int, str]:
    """{optimizer state index: parameter name} of the split parameters."""
    pl = placed(model)
    name = {id(p): n for n, p in zip(pl.names, pl.params)}
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    return {k: name[id(p)] for k, p in enumerate(flat) if id(p) in name}


def _moment_keys(state: dict) -> List[str]:
    return sorted(k for k, v in state.items()
                  if torch.is_tensor(v) and v.dim() > 0)


def full_optimizer_state(model: nn.Module,
                         optimizer: torch.optim.Optimizer) -> dict:
    """`optimizer.state_dict()` with the moments of the split parameters
    gathered whole. A collective: every rank calls it."""
    sd = optimizer.state_dict()
    if placed(model) is None:
        return sd
    slots = _split_slots(model, optimizer)
    state = {k: dict(v) for k, v in sd["state"].items()}
    for m in sorted({m for k in slots if k in state
                     for m in _moment_keys(state[k])}):
        have = {k: n for k, n in slots.items()
                if k in state and m in state[k]}
        full = unshard(model, {n: state[k][m] for k, n in have.items()})
        for k, n in have.items():
            state[k][m] = full[n]
    sd["state"] = state
    return sd


def shard_optimizer_state(model: nn.Module,
                          optimizer: torch.optim.Optimizer, sd: dict) -> dict:
    """A full (one-process) optimizer state dict cut to this rank's
    shards, for `optimizer.load_state_dict`."""
    pl = placed(model)
    if pl is None:
        return sd
    dims = dict(zip(pl.names, pl.dims))
    state = {k: dict(v) for k, v in sd["state"].items()}
    for k, n in _split_slots(model, optimizer).items():
        if k in state:
            for m in _moment_keys(state[k]):
                state[k][m] = _local(state[k][m], dims[n], pl.mesh).clone()
    return dict(sd, state=state)
