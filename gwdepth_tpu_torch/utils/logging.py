"""Metric meters + training logger.

The port's `SmoothedValue` / `MetricLogger` (`gwdepth_tpu.utils.logging`):
windowed median/avg meters, a global average, and a console line every
`print_freq` steps with ETA, iteration and data time, printed the same
way. Over data-parallel ranks `sync` sums a meter's count and total
over the ranks, and only rank 0 prints.
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np


class SmoothedValue:
    """Track a series over a sliding window + global stats."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        # torch.median semantics: the LOWER of the two middle values for
        # even counts, not numpy's midpoint average
        if not self.deque:
            return 0.0
        d = sorted(self.deque)
        return float(d[(len(d) - 1) // 2])

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def sync(self, mesh):
        """Sum (count, total) over the ranks of `mesh` (a `DataMesh`);
        the window stays local."""
        count, total = mesh.sum_host([self.count, self.total])
        self.count, self.total = int(count), float(total)

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Named meters and the periodic status line."""

    def __init__(self, delimiter: str = "  ", print_freq: int = 10):
        from gwdepth_tpu_torch.parallel.mesh import is_main

        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq
        self.is_main = is_main()

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self, mesh):
        """`sync` every meter over `mesh`. Meters fed the train step's
        log vectors, which are global on every rank, need none: the sum of
        W equal copies leaves each global_avg as it is."""
        for m in self.meters.values():
            m.sync(mesh)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, header: str = "",
                  total: Optional[int] = None,
                  before_print: Optional[Callable[[], None]] = None
                  ) -> Iterator:
        """Yield items, printing a status line with ETA + iter/data time
        every `print_freq`. `before_print` runs just ahead of each status
        line: the train loop moves its pending device scalars to the meters
        there, one host sync per print window."""
        total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = time.time()
        i = 0
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 or (total and i == total - 1):
                # every rank moves its pending values to its meters; rank
                # 0 prints
                if before_print is not None:
                    before_print()
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    prefix = f"{header} [{i}/{total}] eta: {eta_str}"
                else:
                    prefix = f"{header} [{i}]"
                if self.is_main:
                    print(self.delimiter.join([
                        prefix, str(self), f"time: {iter_time}",
                        f"data: {data_time}"]), flush=True)
            i += 1
            end = time.time()
        tt = str(datetime.timedelta(seconds=int(time.time() - start)))
        n = max(i, 1)
        if self.is_main:
            print(f"{header} Total time: {tt} "
                  f"({(time.time() - start) / n:.4f} s / it)", flush=True)


def git_sha_banner() -> str:
    """'sha: <sha>, status: <clean|has uncommitted changes>, branch: <b>',
    with 'N/A' parts outside a git checkout."""
    import os
    import subprocess

    cwd = os.path.dirname(os.path.abspath(__file__))

    def run(cmd):
        try:
            return subprocess.check_output(
                cmd, cwd=cwd, stderr=subprocess.DEVNULL).decode().strip()
        except (OSError, subprocess.CalledProcessError):
            return "N/A"

    sha = run(["git", "rev-parse", "HEAD"])
    diff = run(["git", "diff-index", "HEAD"])
    branch = run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
    status = "has uncommitted changes" if diff and diff != "N/A" else "clean"
    return f"sha: {sha}, status: {status}, branch: {branch}"
