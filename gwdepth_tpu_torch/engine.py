"""Epoch-level train and eval loops.

The port of `gwdepth_tpu/engine.py`. PyTorch runs eagerly, so the loop
calls the step per batch. The step's log vector stays on the device until
the print window ends: then the window's vectors cross to the host in one
copy, feed the meters, and a non-finite loss stops training, as the
original's per-step check does (here within one print window). Eval sums
its accumulators on the device and moves them to the host once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.parallel.train_step import (summarize_depth,
                                                   summarize_seg)
from gwdepth_tpu_torch.utils.logging import MetricLogger


def train_one_epoch(state, train_step: Callable, loader, epoch: int,
                    generator: Optional[torch.Generator], device,
                    logger: Optional[MetricLogger] = None):
    """Returns (state, dict of the epoch's global averages)."""
    logger = logger or MetricLogger(print_freq=10)
    pending = []

    def flush():
        if not pending:
            return
        mat = torch.stack(pending).cpu().numpy()
        pending.clear()
        for row in mat:
            scal = dict(zip(train_step.log_keys, row.tolist()))
            if not math.isfinite(scal["loss"]):
                raise FloatingPointError(
                    f"Loss is {scal['loss']}, stopping training")
            logger.update(**scal)

    for batch, _names in logger.log_every(loader.epoch(epoch),
                                          f"Epoch: [{epoch}]",
                                          total=len(loader),
                                          before_print=flush):
        state, log_vec = train_step(state, batch.to(device), generator)
        pending.append(log_vec)
    flush()
    return state, {k: m.global_avg for k, m in logger.meters.items()}


def evaluate(cfg: GWDepthConfig, model, eval_step: Callable, loader,
             device) -> Dict[str, float]:
    """The eval dict: 9 depth metrics, seg IoUs and accuracies, and the
    eval line losses averaged over real images."""
    acc = None
    for batch, _names in loader.epoch(0):
        res = eval_step(model, batch.to(device))
        cur = {k: res[k] for k in ("depth_sums", "confusion", "eval_losses",
                                   "eval_loss_count") if k in res}
        acc = cur if acc is None else {k: acc[k] + v for k, v in cur.items()}
    acc = {k: v.cpu().numpy().astype(np.float64)
           for k, v in (acc or {}).items()}
    stats: Dict[str, float] = {}
    if cfg.with_dense:
        stats.update(summarize_depth(acc.get("depth_sums", np.zeros(10))))
        stats.update(summarize_seg(acc.get("confusion", np.zeros((2, 2)))))
    if "eval_losses" in acc:
        losses = acc["eval_losses"] / max(float(acc["eval_loss_count"]), 1.0)
        stats["loss_ce"] = float(losses[0])
        stats["loss_line"] = float(losses[1])
        stats["cardinality_error"] = float(losses[2])
    return stats


def format_eval_line(epoch: int, stats: Dict[str, float]) -> str:
    """The eval_results.txt line."""
    depth_keys = ["silog", "abs_rel", "log10", "rms", "sq_rel", "log_rms",
                  "d1", "d2", "d3"]
    seg_keys = ["iou_glass", "iou_background", "mean_iou",
                "pixel_accuracy", "mean_accuracy"]
    d = {k: round(stats[k], 4) for k in depth_keys if k in stats}
    s = {k: round(stats[k], 2) for k in seg_keys if k in stats}
    return f"oneline eval epoch{epoch} depth:{d} segmentation:{s}"
