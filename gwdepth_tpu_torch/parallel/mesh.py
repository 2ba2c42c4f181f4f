"""Data parallelism over `torch.distributed`.

The port of `gwdepth_tpu/parallel/mesh.py`. The JAX package partitions
one program over a `("data",)` mesh: the batch is sharded over the axis,
and the loss and its gradient are those of the whole (global) batch. The
port runs one process per rank, launched by `torchrun`, each on its
contiguous part of every global batch:

- `setup` joins torchrun's process group (its `RANK`, `WORLD_SIZE`,
  `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`): NCCL for CUDA, each rank
  on `cuda:LOCAL_RANK`; gloo on the CPU. Without that environment there
  is one rank, no process group, and every collective below is the
  identity.
- `make_mesh(shape)` resolves -1 to the world and refuses a second
  (`model`) axis: tensor parallelism (`partition.py`) is not ported.
- `DataMesh.all_sum` is the differentiable sum over ranks that the losses
  take as their reducer. Its backward is the identity: every rank computes
  the same (global) loss from the sums, so rank r's gradient is that
  loss's gradient through rank r's own terms, and the SUM of the ranks'
  gradients (`all_reduce_grads`) is the gradient of the global loss. A
  sum backward would count it W times.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
BUCKET_BYTES = 25 << 20


def launched() -> bool:
    """True in a process that torchrun started."""
    return all(k in os.environ for k in ENV)


def env_world_size() -> int:
    """torchrun's world size, 1 outside torchrun; readable before `setup`."""
    return int(os.environ["WORLD_SIZE"]) if launched() else 1


def setup(device: str = "cuda", backend: Optional[str] = None
          ) -> torch.device:
    """Join torchrun's process group (once per process) and return this
    rank's device: `cuda` means `cuda:LOCAL_RANK`; an explicit `cuda:N` or
    `cpu` stays. The backend is NCCL for a CUDA device and gloo for the
    CPU unless `backend` names one (gloo also takes CUDA tensors for
    `all_reduce` and `broadcast`, so several ranks can share one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           if launched() else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if launched() and not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            device_id=dev if dev.type == "cuda" and backend in (
                None, "nccl") else None)
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def teardown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective on `t` runs: NCCL takes only CUDA tensors."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


class _AllSum(torch.autograd.Function):
    """Sum over ranks, identity backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive runs of one dtype and device, at most BUCKET_BYTES each
    (a larger tensor alone)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if (not out or size + nb > BUCKET_BYTES
                or (t.dtype, t.device) != (out[-1][0].dtype,
                                           out[-1][0].device)):
            out.append([])
            size = 0
        out[-1].append(t)
        size += nb
    return out


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A one-axis `data` mesh of `world` ranks; this process is `rank`.
    `distributed` is False for one process without a process group,
    where every collective is the identity."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int
    world: int
    distributed: bool

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def share(self, n: int) -> slice:
        """This rank's contiguous part of a global batch of `n`."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The differentiable sum of `t` over ranks (identity backward)."""
        return _AllSum.apply(t) if self.distributed else t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over ranks in place (no autograd); returns `t`."""
        if self.distributed:
            dev = _comm_device(t)
            if dev == t.device:
                dist.all_reduce(t)
            else:
                t.copy_(self.sum_(t.to(dev)).to(t.device))
        return t

    def sum_host(self, values) -> np.ndarray:
        """Sum a float64 host array over ranks."""
        t = torch.as_tensor(np.asarray(values, np.float64)).clone()
        return self.sum_(t).numpy()

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()

    def broadcast_(self, tensors: Sequence[torch.Tensor],
                   src: int = 0) -> None:
        """Overwrite `tensors` with rank `src`'s, bucketed."""
        if not self.distributed:
            return
        for bucket in _buckets([t for t in tensors if t.numel()]):
            flat = torch.cat([t.detach().reshape(-1) for t in bucket])
            dev = _comm_device(flat)
            flat = flat.to(dev)
            dist.broadcast(flat, src)
            for t, piece in zip(bucket, flat.split(
                    [t.numel() for t in bucket])):
                with torch.no_grad():
                    t.copy_(piece.view_as(t))

    def all_reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Sum every parameter's `.grad` over ranks, bucketed (one
        `all_reduce` a bucket). Every rank must hold a gradient for each
        parameter (`TrainState.apply_gradients` fills the missing ones)."""
        if not self.distributed:
            return
        grads = [p.grad for p in params]
        for bucket in _buckets(grads):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            self.sum_(flat)
            for g, piece in zip(bucket, flat.split(
                    [g.numel() for g in bucket])):
                g.copy_(piece.view_as(g))

    def gather(self, obj) -> Optional[list]:
        """Every rank's `obj`, in rank order, on rank 0 (None elsewhere)."""
        if not self.distributed:
            return [obj]
        out = [None] * self.world if self.is_main else None
        dist.gather_object(obj, out, dst=0)
        return out


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)) -> DataMesh:
    """The data mesh over the process group (`setup` first, under
    torchrun). A -1 entry is the world size; the size must equal it."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) > 1 or axes[:1] != ("data",):
        raise ValueError(f"mesh {shape} over {axes}: only a one-axis data "
                         "mesh is ported (tensor parallelism, "
                         "partition.py, is not)")
    world = world_size()
    size = world if shape[0] == -1 else shape[0]
    if size != world:
        raise ValueError(f"mesh {shape}: {size} ranks, but the world has "
                         f"{world} (torchrun --nproc_per_node)")
    return DataMesh((size,), axes[:1], rank(), world, dist.is_initialized())
