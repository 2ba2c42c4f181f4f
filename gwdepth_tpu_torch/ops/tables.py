"""Constant tables that live on the device.

The JAX package builds its resize indices, lerp weights and shifted-window
masks inside `jax.jit`, so XLA folds them into the program and they reach
the device once per compile. Eagerly, a table built on the host and copied
at every call costs one synchronizing host-to-device copy from pageable
memory a call. `device_table` keeps one device tensor per (table, device,
dtype) instead: the numpy builder runs once, its result crosses once, and
later calls of the same shape make no copy. On the CPU the cached tensor
is the numpy-backed one.

A CUDA graph reads each table at the address it had when it was
captured. So the cache entry of a graph that `graphs.compiled` captured
also holds the tables cached at the capture's end (`cached_tensors`): the
cache's bound then drops only the cache's own reference, never the table
under a live graph. A table is built by the warm-up calls before a
capture; one first asked for while the current stream is capturing would
copy from pageable memory inside the capture, so that raises.

Entries are built outside inference mode, so a table first made under
`torch.inference_mode()` can still be saved for a later backward
(`index_select` saves its index). Under a tracer (`torch.export`'s fake
tensors) a table is built and returned but not kept. The cache holds the
`MAX_TABLES` most recently used entries; one model's shapes are far
fewer. Callers must not write into a table.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Hashable, Optional

import numpy as np
import torch

MAX_TABLES = 1024

_tables: "collections.OrderedDict" = collections.OrderedDict()
_lock = threading.Lock()


def device_table(key: Hashable, build: Callable[[], np.ndarray], device,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The tensor of `build()` on `device` (cast to `dtype` if given),
    built and copied on the first call with this `key`, device and dtype
    and returned as it is afterwards."""
    full = (key, torch.device(device if device is not None else "cpu"),
            dtype)
    with _lock:
        t = _tables.get(full)
        if t is not None:
            _tables.move_to_end(full)
            return t
    if full[1].type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"device_table {key!r} on {full[1]}: first built while a CUDA "
            "graph is being captured; run the function eagerly once before "
            "capturing it (graphs.compiled warms up first)")
    # each mode switched only where it is on: a switch inside
    # `torch.export`'s trace becomes a grad-mode region of the program
    # (an artifact that then fails to load)
    with (torch.inference_mode(False) if torch.is_inference_mode_enabled()
          else contextlib.nullcontext()), \
            (torch.no_grad() if torch.is_grad_enabled()
             else contextlib.nullcontext()):
        t = torch.from_numpy(np.ascontiguousarray(build()))
        t = t.to(full[1], dtype) if dtype is not None else t.to(full[1])
    if type(t) is not torch.Tensor:
        # a tracer's tensor (torch.export's fake mode): its program holds
        # the table as a constant; only real tensors are kept
        return t
    with _lock:
        t = _tables.setdefault(full, t)
        _tables.move_to_end(full)
        while len(_tables) > MAX_TABLES:
            _tables.popitem(last=False)
    return t


def clear() -> None:
    """Drop every cached table."""
    with _lock:
        _tables.clear()


def cached_tensors() -> list:
    """Every cached table, oldest first."""
    with _lock:
        return list(_tables.values())


def cached_keys() -> list:
    """The (key, device, dtype) of every cached table, oldest first."""
    with _lock:
        return list(_tables)
