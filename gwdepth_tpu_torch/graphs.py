"""Compiled entry points: the port's counterpart of `jax.jit`.

The JAX package runs its serving forward, its eval step and its train
step as programs that `jax.jit` compiles once per static signature and
then dispatches whole. The port captures each of the three as a CUDA
graph once per signature and replays it, so a call costs the host one
graph launch and the copies of its inputs instead of thousands of kernel
launches from Python. `export.load_exported` serves a loaded artifact the
same way, as JAX's `exp.call` runs its deserialized program.

`compiled(fn)` returns the wrapped callable. Its cache is keyed as jit's:

- the structure of the arguments, and each tensor's shape, dtype, device
  and `requires_grad` (values are copied in: they are not part of it);
- `torch.is_grad_enabled()`, inference mode, and the numerics settings
  that a warm-up freezes into the graph (deterministic algorithms,
  cuDNN's benchmark and TF32 switches, the float32 matmul precision);
- every argument that is not a tensor or a container of tensors, by
  identity (a module, a train state, a generator), with a module's
  `training` flag; plain Python values (ints, floats, strings) by value.

The first call of a key, on CUDA tensors:

1. copies the tensors into static inputs and runs `fn` on them WARMUPS
   times on a side stream (one per device, which the capture uses too),
   as PyTorch asks before a capture. The warm-up
   builds the tables of `ops/tables.py`, the optimizer's state, cuBLAS's
   workspaces and the algorithms cuDNN picks; its kernel launches count
   as any eager launch does;
2. puts back what the warm-ups wrote: the states of every generator
   argument and of the device's default generator, and whatever the
   caller's `snapshot` saved (the train step's parameters and AdamW
   state), so that the call still runs `fn` exactly once;
3. captures one call into a `torch.cuda.CUDAGraph`, from one memory pool
   shared by every graph of the process (`pool`), with each generator
   argument registered, so that every replay draws fresh numbers from it
   as an eager call would (the default generator is registered by the
   capture itself);
4. replays it.

Later calls copy their tensors into the static inputs on the current
stream and replay. Either way the call returns the graph's static
outputs, in new containers: they are valid until the next call of a
compiled callable on that device (the graphs share one pool, so a graph
captured earlier may use an output's memory as scratch), as a donated
JAX buffer. A caller that keeps an output past that point takes a copy
(`engine.py` does, on the device).

Kernel launches a graph holds are counted at each replay, not at the
capture (`count`). Its cache entry holds every table that `ops/tables.py`
had cached when the capture ended (the warm-ups built those it reads),
so the tables' bound never frees one under a live graph. `stats` counts
the captures, replays and eager runs by name.

CPU tensors run `fn` as it is: the caller put them there. There is no
fallback: a capture that fails raises with its key; a gloo process group
with CUDA tensors (gloo's collectives cannot be captured) raises unless
the call runs under `disable()`, the counterpart of `jax.disable_jit()`,
which runs `fn` eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, Hashable, List, Optional

import torch

WARMUPS = 2

# (name, "captures" | "replays" | "eager_runs") -> count over the process,
# every `compiled` callable of that name together; eager runs include the
# warm-ups of each capture
stats: collections.Counter = collections.Counter()

# the capture in progress: launches counted go to it, from any thread
# (the backward's kernels launch on autograd's)
_active: Optional["_Capture"] = None
_pools: Dict[torch.device, tuple] = {}
_side: Dict[torch.device, object] = {}
_disabled = 0


@contextlib.contextmanager
def disable():
    """Within the block every `compiled` callable runs its function
    eagerly, as under `jax.disable_jit()`. Nests."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def enabled() -> bool:
    """False under `disable()`."""
    return _disabled == 0


def pool(device: torch.device):
    """The memory pool that the live graphs of `device` share: the forward,
    eval and train graphs of one run (their replays run one after another
    on one stream). Once every graph of a pool is gone, PyTorch frees the
    pool and its handle cannot be captured into again: the next capture
    starts a new one."""
    handle, live = _pools.get(device, (None, None))
    if not live:
        handle, live = torch.cuda.graph_pool_handle(), weakref.WeakSet()
        _pools[device] = handle, live
    return handle, live


def count(obj, attr: str, key: Optional[Hashable] = None) -> None:
    """Add one to `obj.<attr>` (`obj.<attr>[key]`, a Counter, with `key`):
    now, or, while `compiled` captures a graph, at each of its replays."""
    cap = _active
    if cap is not None:
        cap.counts.append((obj, attr, key))
    else:
        _bump(obj, attr, key)


def _bump(obj, attr: str, key) -> None:
    if key is None:
        setattr(obj, attr, getattr(obj, attr) + 1)
    else:
        getattr(obj, attr)[key] += 1


@dataclasses.dataclass
class _Capture:
    counts: list = dataclasses.field(default_factory=list)
    held: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def _capturing(cap: _Capture):
    """`count` records into `cap` within the block; at its end `cap`
    holds the cached tables (a graph reads each at the address it had
    during the capture)."""
    from gwdepth_tpu_torch.ops import tables

    global _active
    _active = cap
    try:
        yield cap
    finally:
        _active = None
    cap.held = tables.cached_tensors()


@dataclasses.dataclass
class _Entry:
    graph: object
    inputs: List[torch.Tensor]
    outputs: object             # fn's result: the static outputs
    out_tensors: List[torch.Tensor]
    fingerprint: tuple          # data_ptr of every held tensor
    capture: _Capture


def _is_container(obj) -> bool:
    """A dataclass whose fields are all tensors or None (a `Batch`) is an
    argument container; any other object is held by identity."""
    return (dataclasses.is_dataclass(obj) and not isinstance(obj, type)
            and all(v is None or isinstance(v, torch.Tensor)
                    for v in vars(obj).values()))


def _held_tensors(obj, out: list) -> None:
    """The tensors a graph reads through a held object, in a fixed
    order: a module's parameters and buffers, an optimizer's state and
    tensor hyper-parameters, and those of a dataclass's fields."""
    if isinstance(obj, torch.nn.Module):
        out.extend(obj.parameters())
        out.extend(obj.buffers())
    elif isinstance(obj, torch.optim.Optimizer):
        for g in obj.param_groups:
            out.extend(v for v in g.values() if isinstance(v, torch.Tensor))
            for p in g["params"]:
                st = obj.state.get(p)
                if st:
                    out.extend(v for v in st.values()
                               if isinstance(v, torch.Tensor))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for v in vars(obj).values():
            if isinstance(v, (torch.nn.Module, torch.optim.Optimizer)):
                _held_tensors(v, out)


def _module_flags(obj) -> tuple:
    if isinstance(obj, torch.nn.Module):
        return (obj.training,)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return tuple(v.training for v in vars(obj).values()
                     if isinstance(v, torch.nn.Module))
    return ()


def _walk(obj, key: list, tensors: list, held: list, gens: list) -> None:
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        key.append(("t", tuple(obj.shape), obj.dtype, obj.device,
                    obj.requires_grad))
    elif obj is None or isinstance(obj, (bool, int, float, str)):
        key.append(("v", type(obj), obj))
    elif isinstance(obj, (tuple, list)):
        key.append((type(obj), len(obj)))
        for v in obj:
            _walk(v, key, tensors, held, gens)
    elif isinstance(obj, dict):
        key.append((dict, tuple(obj)))
        for v in obj.values():
            _walk(v, key, tensors, held, gens)
    elif _is_container(obj):
        key.append((type(obj),))
        for v in vars(obj).values():
            _walk(v, key, tensors, held, gens)
    elif isinstance(obj, torch.Generator):
        gens.append(obj)
        key.append(("g", id(obj)))
    else:
        held.append(obj)
        key.append(("h", id(obj), _module_flags(obj)))


def _settings() -> tuple:
    """The process settings a warm-up bakes into a graph."""
    return (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
            torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def _rebuild(obj, it):
    """`obj`'s structure with its tensors taken in order from `it`."""
    if isinstance(obj, torch.Tensor):
        return next(it)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(v, it) for v in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, it) for k, v in obj.items()}
    if _is_container(obj):
        return dataclasses.replace(obj, **{k: _rebuild(v, it)
                                           for k, v in vars(obj).items()})
    return obj


def _gloo_active() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "gloo")


def _fingerprint(held: list) -> tuple:
    """The addresses of every tensor a graph reads through `held`."""
    tensors: list = []
    for obj in held:
        _held_tensors(obj, tensors)
    return tuple(t.data_ptr() for t in tensors)


class compiled:
    """`fn` run as a CUDA graph per signature on CUDA tensors, as it is
    on CPU tensors (see the module docstring); `fn.__name__` names it in
    `stats` and errors. `snapshot(*args)`, called before the warm-ups of
    a new signature, returns a function that puts back what the warm-ups
    wrote."""

    def __init__(self, fn: Callable, snapshot: Optional[Callable] = None):
        self.fn = fn
        self.name = fn.__name__
        self.snapshot = snapshot
        self.entries: Dict[tuple, _Entry] = {}

    def _tally(self, kind: str) -> None:
        stats[self.name, kind] += 1

    @staticmethod
    def key(*args) -> tuple:
        """The cache key of a call with `args`."""
        key: list = []
        _walk(args, key, [], [], [])
        return (tuple(key), _settings())

    def __call__(self, *args):
        key: list = []
        tensors: list = []
        held: list = []
        gens: list = []
        _walk(args, key, tensors, held, gens)
        devices = {t.device for t in tensors}
        if not devices:
            raise TypeError(f"{self.name}: no tensor argument tells the "
                            "device")
        if len(devices) > 1:
            raise ValueError(f"{self.name}: arguments on "
                             f"{sorted(map(str, devices))}")
        dev, = devices
        if dev.type != "cuda" or not enabled():
            self._tally("eager_runs")
            return self.fn(*args)
        if _gloo_active():
            raise RuntimeError(
                f"{self.name}: a gloo process group with CUDA tensors: its "
                "collectives cannot be captured in a CUDA graph; run the "
                "call under gwdepth_tpu_torch.graphs.disable()")
        key = (tuple(key), _settings())
        entry = self.entries.get(key)
        if entry is not None and entry.fingerprint != _fingerprint(held):
            # a held object's tensors moved (a restored optimizer, a
            # module moved to another device): the graph reads the old ones
            del self.entries[key]
            entry = None
        if entry is None:
            entry = self._capture(key, args, tensors, held, gens, dev)
        else:
            with torch.no_grad():
                for dst, src in zip(entry.inputs, tensors):
                    dst.copy_(src)
        entry.graph.replay()
        for obj, attr, k in entry.capture.counts:
            _bump(obj, attr, k)
        self._tally("replays")
        return _rebuild(entry.outputs, iter(entry.out_tensors))

    def _capture(self, key, args, tensors, held, gens, dev) -> _Entry:
        with torch.no_grad():
            inputs = [src.detach().clone(memory_format=torch.contiguous_format)
                      for src in tensors]
        inputs = [t.requires_grad_(src.requires_grad)
                  for t, src in zip(inputs, tensors)]
        static_args = _rebuild(args, iter(inputs))
        cuda_gens = [g for g in gens if g.device.type == "cuda"]
        rng = [(g, g.get_state()) for g in cuda_gens]
        default_rng = torch.cuda.get_rng_state(dev)
        restore = self.snapshot(*args) if self.snapshot is not None else None
        side = _side.get(dev)
        if side is None:
            side = _side[dev] = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUPS):
                self.fn(*static_args)
                self._tally("eager_runs")
        cur.wait_stream(side)
        if restore is not None:
            restore()
        for g, st in rng:
            g.set_state(st)
        torch.cuda.set_rng_state(default_rng, dev)
        graph = torch.cuda.CUDAGraph()
        for g in cuda_gens:
            if g is not torch.cuda.default_generators[dev.index or 0]:
                graph.register_generator_state(g)
        handle, live = pool(dev)
        try:
            # on the warm-ups' stream: the library workspaces kept per
            # stream (cuBLAS's) exist by now, so none is allocated from the
            # graph's pool, where it would outlive the graph and keep the
            # pool's memory from going back to the card
            with _capturing(_Capture()) as cap, torch.cuda.graph(
                    graph, pool=handle, stream=side,
                    capture_error_mode="thread_local"):
                out = self.fn(*static_args)
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: CUDA graph capture failed for the signature "
                f"{key}: {type(e).__name__}: {e}") from e
        live.add(graph)
        out_tensors: list = []
        _walk(out, [], out_tensors, [], [])
        # read after the warm-ups, which made the optimizer's state
        entry = _Entry(graph, inputs, out, out_tensors, _fingerprint(held),
                       cap)
        self.entries[key] = entry
        self._tally("captures")
        return entry
