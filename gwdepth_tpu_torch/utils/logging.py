"""Metric meters + training logger, single process.

The port's `SmoothedValue` / `MetricLogger` (`gwdepth_tpu.utils.logging`):
windowed median/avg meters, a global average, and a console line every
`print_freq` steps with ETA, iteration and data time, printed the same
way. A run has one process, so nothing is reduced across processes.
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

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Named meters and the periodic status line."""

    def __init__(self, delimiter: str = "  ", print_freq: int = 10):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

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
                if before_print is not None:
                    before_print()
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    prefix = f"{header} [{i}/{total}] eta: {eta_str}"
                else:
                    prefix = f"{header} [{i}]"
                print(self.delimiter.join([
                    prefix, str(self),
                    f"time: {iter_time}", f"data: {data_time}"]), flush=True)
            i += 1
            end = time.time()
        tt = str(datetime.timedelta(seconds=int(time.time() - start)))
        n = max(i, 1)
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
