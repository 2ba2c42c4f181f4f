"""Data and tensor parallelism over `torch.distributed`.

The port of `gwdepth_tpu/parallel/mesh.py`. The JAX package partitions
one program over a `("data",)` or `("data", "model")` mesh: the batch is
sharded over `data`, some weights over `model` (`partition.py`), and the
loss and its gradient are those of the whole (global) batch. The port
runs one process per rank, launched by `torchrun`, each on its
contiguous part of every global batch:

- `setup` joins torchrun's process group (its `RANK`, `WORLD_SIZE`,
  `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`): NCCL for CUDA, each rank
  on `cuda:LOCAL_RANK`; gloo on the CPU. Without that environment there
  is one rank, no process group, and every collective below is the
  identity.
- `make_mesh(shape)` resolves -1 to the world. A `(D, M)` mesh lays the
  ranks out row-major, rank = d * M + m, as the JAX mesh lays out its
  devices: the M ranks of data coordinate d (a model group) hold the
  same images and compute the same loss, each with its 1/M shards of
  the weights that `partition.py` splits; the D ranks of model
  coordinate m (a data group) hold the same shards. So every sum over
  images (`share`, `all_sum`, `sum_`, `sum_host`, `all_reduce_grads`,
  `gather`) runs over this rank's data group: over the world it would
  count each image M times. `broadcast_` still reaches the world.
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


def _comm_device(t: torch.Tensor, reduces: bool = True) -> torch.device:
    """Where a collective on `t` runs: NCCL takes only CUDA tensors; gloo
    takes CUDA tensors for `all_reduce` and `broadcast` only (`reduces`),
    so its gathers of CUDA tensors go through the host."""
    backend = dist.get_backend()
    if backend == "nccl" and t.device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo" and not reduces and t.device.type == "cuda":
        return torch.device("cpu")
    return t.device


class _AllSum(torch.autograd.Function):
    """Sum over a group, identity backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


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
    """A `data` mesh of `world` ranks, or a `(data, model)` mesh of
    `shape` (D, M) with D * M = `world`; this process is `rank`.
    `distributed` is False for one process without a process group,
    where every collective is the identity. `data_group` and
    `model_group` are this rank's groups of a two-axis mesh (None: the
    world, and no model group)."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int
    world: int
    distributed: bool
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def model_size(self) -> int:
        return self.shape[1] if len(self.shape) > 1 else 1

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def share(self, n: int) -> slice:
        """This rank's contiguous part of a global batch of `n`: its data
        coordinate's."""
        if n % self.data_size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.data_size} ranks")
        b = n // self.data_size
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The differentiable sum of `t` over the data group (identity
        backward)."""
        return _AllSum.apply(t, self.data_group) if self.distributed else t

    def _sum_(self, t: torch.Tensor, group) -> torch.Tensor:
        if self.distributed:
            dev = _comm_device(t)
            if dev == t.device:
                dist.all_reduce(t, group=group)
            else:
                t.copy_(self._sum_(t.to(dev), group).to(t.device))
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the data group in place (no autograd); returns
        `t`."""
        return self._sum_(t, self.data_group)

    def model_all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every model rank's `t`, in model-rank order (no autograd)."""
        if self.model_size == 1:
            return [t]
        dev = _comm_device(t, reduces=False)
        src = t.detach().contiguous().to(dev)
        out = [torch.empty_like(src) for _ in range(self.model_size)]
        dist.all_gather(out, src, group=self.model_group)
        return [o.to(t.device) for o in out]

    def sum_host(self, values) -> np.ndarray:
        """Sum a float64 host array over the data group."""
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
        """Sum every parameter's `.grad` over the data group, bucketed (one
        `all_reduce` a bucket); a sharded parameter's over the ranks that
        hold the same shard. Every rank must hold a gradient for each
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
        """Every data rank's `obj`, in data-rank order, on rank 0 (None
        elsewhere): the data group of model coordinate 0 gathers; the
        other model coordinates hold the same objects and send none."""
        if not self.distributed:
            return [obj]
        if self.model_rank:
            return None
        out = [None] * self.data_size if self.is_main else None
        dist.gather_object(obj, out, dst=0, group=self.data_group)
        return out


def resolve_shape(shape: Sequence[int], world: int) -> Tuple[int, ...]:
    """`shape` with its -1 entry (at most one) resolved so that the
    entries multiply to `world`; raises where they cannot."""
    shape = tuple(int(s) for s in shape)
    known = int(np.prod([s for s in shape if s != -1]))
    if shape.count(-1) > 1 or known < 1 or any(s < -1 or s == 0
                                               for s in shape):
        raise ValueError(f"mesh {shape}: positive sizes and at most one -1")
    if -1 in shape:
        if world % known:
            raise ValueError(f"mesh {shape}: {known} does not divide the "
                             f"world of {world} (torchrun --nproc_per_node)")
        shape = tuple(world // known if s == -1 else s for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {shape}: {int(np.prod(shape))} ranks, but "
                         f"the world has {world} (torchrun --nproc_per_node)")
    return shape


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)) -> DataMesh:
    """The `data` or `(data, model)` mesh over the process group (`setup`
    first, under torchrun). A -1 entry takes the rest of the world; the
    sizes must multiply to it. A two-axis mesh makes its groups here, on
    every rank in one order (the process-group rule)."""
    axes = tuple(axes)
    if len(shape) > 2 or axes != ("data", "model")[:len(shape)]:
        raise ValueError(f"mesh {tuple(shape)} over {axes}: the axes are "
                         "('data',) or ('data', 'model')")
    world = world_size()
    shape = resolve_shape(shape, world)
    data_group = model_group = None
    if len(shape) == 2 and dist.is_initialized():
        D, M = shape
        for m in range(M):
            g = dist.new_group([d * M + m for d in range(D)])
            if m == rank() % M:
                data_group = g
        for d in range(D):
            g = dist.new_group([d * M + m for m in range(M)])
            if d == rank() // M:
                model_group = g
    return DataMesh(shape, axes, rank(), world, dist.is_initialized(),
                    data_group, model_group)
