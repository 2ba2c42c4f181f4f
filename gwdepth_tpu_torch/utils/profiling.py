"""Profiling helpers: a device trace, step timing, device memory.

The port's counterpart of `gwdepth_tpu.utils.profiling`, on
`torch.profiler` and `torch.cuda`:

    with trace("exp/run0/trace"):
        loss = train_step(...)
        torch.cuda.synchronize()

`StepTimer` times host wall clock; as with the JAX version's
`block_until_ready`, the caller synchronizes inside the timed block.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where available) and write a
    Chrome trace (`trace_<pid>_<ns>.json`, TensorBoard and Perfetto read
    it) into `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Lightweight step timing with a compile / steady-state split: the
    first step apart, the mean over the steps after the first two."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        steady = self.times[2:] or self.times
        return {
            "first_step_s": self.times[0],
            "steady_mean_s": sum(steady) / len(steady),
            "steps_per_sec": len(steady) / max(sum(steady), 1e-9),
        }


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """`torch.cuda.memory_stats` of a CUDA device (the current one by
    default); None where the device reports none (the CPU, or no CUDA)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(device)
