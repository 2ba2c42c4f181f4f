"""Epoch-level train and eval loops.

The port of `gwdepth_tpu/engine.py`. PyTorch runs eagerly, so the loop
calls the step per batch. The step's log vector stays on the device until
the print window ends: then the window's vectors cross to the host in one
copy, feed the meters, and a non-finite loss stops training, as the
original's per-step check does (here within one print window). Eval sums
its accumulators on the device and moves them to the host after the
loop, with the line outputs that the benchmark dumps and line overlays
need; the dense prediction grids cost one more copy per batch.

Over data-parallel ranks (`mesh`) each rank steps on its part of every
global batch; the logs are already global. Eval sums its accumulators
over the ranks, gathers the line dumps to rank 0 in dataset order, and
each rank writes its own images' dense and line pictures; only rank 0
writes the training-input overlay. On a `(data, model)` mesh every sum
and gather runs over the data group, and of the M ranks that hold the
same images only model rank 0 writes their pictures, so each data
coordinate counts and writes once.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.evaluation.line_metrics import softmax
from gwdepth_tpu_torch.parallel.mesh import DataMesh, make_mesh
from gwdepth_tpu_torch.parallel.train_step import (summarize_depth,
                                                   summarize_seg)
from gwdepth_tpu_torch.utils.logging import MetricLogger
from gwdepth_tpu_torch.utils.visualize import (save_dense_pred, show_labels,
                                               vis_pred_lines)


def train_one_epoch(state, train_step: Callable, loader, epoch: int,
                    generator: Optional[torch.Generator], device,
                    logger: Optional[MetricLogger] = None,
                    vis_dir: Optional[str] = None, with_center: bool = True):
    """Returns (state, dict of the epoch's global averages). `vis_dir`
    saves the first batch's label overlay, `input_epoch{epoch}.png`, once
    per epoch (the original's training-input check)."""
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

    first = True
    for batch, _names in logger.log_every(loader.epoch(epoch),
                                          f"Epoch: [{epoch}]",
                                          total=len(loader),
                                          before_print=flush):
        if first and vis_dir is not None and logger.is_main:
            # the loader's batch is still on the host
            show_labels(batch.images[0].numpy(),
                        batch.lines[0][batch.line_mask[0]].numpy(),
                        os.path.join(vis_dir, f"input_epoch{epoch}.png"),
                        with_center=with_center)
        first = False
        state, log_vec = train_step(state, batch.to(device), generator)
        pending.append(log_vec)
    flush()
    # no `synchronize_between_processes`: every rank's log vectors are
    # already the global ones, so a sum over ranks would leave each
    # global_avg as it is
    return state, {k: m.global_avg for k, m in logger.meters.items()}


def evaluate(cfg: GWDepthConfig, model, eval_step: Callable, loader,
             device, collect_lines: bool = False,
             save_dense_dir: Optional[str] = None,
             save_line_dir: Optional[str] = None,
             mesh: Optional[DataMesh] = None) -> Dict[str, object]:
    """The eval dict of a model with the dense branch: 9 depth metrics,
    seg IoUs and accuracies, and the eval line losses averaged over real
    images. A line-only model's is empty, as the JAX package's: its
    metrics are the offline line scores of the benchmark dumps.

    `collect_lines` adds `line_dumps`, one {name, pred_logits, pred_lines,
    extent} of numpy arrays per image, for the benchmark npz files.
    `save_dense_dir` writes each image's prediction grid
    (`save_dense_pred`; needs an eval step made with `return_dense`), at
    one device-to-host copy per batch. `save_line_dir` writes each
    image's predicted (class-0 probability above 0.7) beside its GT
    lines (`vis_pred_lines`). The sums and the line outputs
    stay on the device until the loop ends.

    Over `mesh` (the loader yields this rank's part of each batch) the
    sums are the global ones on every rank; `line_dumps`, in dataset
    order, are on rank 0 only (empty elsewhere)."""
    mesh = make_mesh() if mesh is None else mesh
    acc = None
    names, line_out, gts, order = [], [], [], []
    keep_lines = cfg.with_line and (collect_lines or save_line_dir)
    if mesh.model_rank:
        # model rank 0 of this data coordinate writes the same pictures
        save_dense_dir = save_line_dir = None
    for bi, (batch, batch_names) in enumerate(loader.epoch(0)):
        res = eval_step(model, batch.to(device))
        if cfg.with_dense:
            cur = {k: res[k] for k in ("depth_sums", "confusion",
                                       "eval_losses", "eval_loss_count")
                   if k in res}
            acc = cur if acc is None else {k: acc[k] + v
                                           for k, v in cur.items()}
        if save_dense_dir is not None and "pred_depth_full" in res:
            depth = res["pred_depth_full"].cpu().numpy()
            seg = res["pred_seg_cls"].cpu().numpy()
            for i, name in enumerate(batch_names):
                save_dense_pred(depth[i], batch.depth[i].numpy(), seg[i],
                                batch.seg[i].numpy(), batch.images[i].numpy(),
                                os.path.join(save_dense_dir, f"{name}.png"),
                                max_depth=cfg.max_depth)
        if keep_lines:
            n = len(batch_names)      # the rows past it pad the last batch
            names += batch_names
            order += [(bi, mesh.data_rank, j) for j in range(n)]
            line_out.append([res[k][:n] for k in ("pred_logits",
                                                  "pred_lines", "extent")])
            if save_line_dir is not None:
                gts += [(batch.lines[i].numpy(), batch.line_mask[i].numpy(),
                         batch.images[i].numpy()) for i in range(n)]
    if acc:
        # every accumulator summed over ranks in one all_reduce
        keys = sorted(acc)
        flat = mesh.sum_(torch.cat([acc[k].reshape(-1) for k in keys]))
        acc = {k: piece.view_as(acc[k]) for k, piece in zip(
            keys, flat.split([acc[k].numel() for k in keys]))}
    acc = {k: v.cpu().numpy().astype(np.float64)
           for k, v in (acc or {}).items()}
    line_dumps = []
    if line_out:
        logits, lines, extent = (torch.cat(col).cpu().numpy()
                                 for col in zip(*line_out))
        line_dumps = [{"name": name, "pred_logits": logits[i],
                       "pred_lines": lines[i], "extent": extent[i]}
                      for i, name in enumerate(names)]

    if save_line_dir is not None:
        for d, (gt_lines, gt_mask, img) in zip(line_dumps, gts):
            h, w = img.shape[:2]
            scores = softmax(d["pred_logits"], -1)[:, 0]
            pred_px = d["pred_lines"][:, :4] * np.array([w, h, w, h])
            gt_px = gt_lines[gt_mask][:, :4] * np.array([w, h, w, h])
            vis_pred_lines(pred_px, scores, gt_px, img,
                           os.path.join(save_line_dir, f"{d['name']}.png"))

    if collect_lines:
        # every data rank's dumps, on rank 0, in dataset order: global
        # batch, then data rank, then position in the rank's part
        parts = mesh.gather(list(zip(order, line_dumps)))
        line_dumps = [d for _, d in sorted(
            (p for part in parts for p in part), key=lambda kv: kv[0])] \
            if parts is not None else []

    stats: Dict[str, object] = {}
    if cfg.with_dense:
        stats.update(summarize_depth(acc.get("depth_sums", np.zeros(10))))
        stats.update(summarize_seg(acc.get("confusion", np.zeros((2, 2)))))
    if "eval_losses" in acc:
        losses = acc["eval_losses"] / max(float(acc["eval_loss_count"]), 1.0)
        stats["loss_ce"] = float(losses[0])
        stats["loss_line"] = float(losses[1])
        stats["cardinality_error"] = float(losses[2])
    if collect_lines:
        stats["line_dumps"] = line_dumps
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
