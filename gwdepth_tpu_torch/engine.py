"""Epoch-level train and eval loops.

The port of `gwdepth_tpu/engine.py`, with its asynchronous dispatch.
PyTorch runs eagerly, so the loop calls the step per batch; nothing in
the loop waits for the card:

- `device_prefetch` issues the next batch's copy to the device before
  the current step runs, from pinned memory on a copy stream of its own
  (the loader's worker thread pins), as `jax.device_put` dispatches
  ahead in the JAX package; the step's stream waits on the copy's event,
  never the host.
- The step's log vectors stay on the device until the print window
  ends. Then the window's vectors are stacked and their copy into pinned
  host memory starts, and the PREVIOUS window is drained into the meters
  once its copy's event has completed, as the JAX package's loop drains
  one window late. Every value reaches the meters in order, and a
  non-finite loss stops training within two print windows.

The steps return their graphs' static outputs (`graphs.compiled`), which
the next call overwrites: what the loops keep past it (a log vector until
its window is drained, the first batch's eval sums, the line outputs) is
copied on the device first.

Eval sums its accumulators on the device and moves them to the host after
the loop, with the line outputs that the benchmark dumps and line
overlays need; the dense prediction grids cost one more copy per batch.
The pictures read the loader's host batch, not a copy back from the card.

Over data-parallel ranks (`mesh`) each rank steps on its part of every
global batch, prefetched to its own device; the logs are already global.
Eval sums its accumulators over the ranks, gathers the line dumps to rank
0 in dataset order, and each rank writes its own images' dense and line
pictures; only rank 0 writes the training-input overlay. On a `(data,
model)` mesh every sum and gather runs over the data group, and of the M
ranks that hold the same images only model rank 0 writes their pictures,
so each data coordinate counts and writes once.
"""

from __future__ import annotations

import collections
import math
import os
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.data.batch import FIELDS, Batch
from gwdepth_tpu_torch.evaluation.line_metrics import softmax
from gwdepth_tpu_torch.parallel.mesh import DataMesh, make_mesh
from gwdepth_tpu_torch.parallel.train_step import (summarize_depth,
                                                   summarize_seg)
from gwdepth_tpu_torch.utils.logging import MetricLogger
from gwdepth_tpu_torch.utils.visualize import (save_dense_pred, show_labels,
                                               vis_pred_lines)


def device_prefetch(it: Iterable, device, lookahead: int = 1
                    ) -> Iterator[Tuple[Batch, Batch, list]]:
    """Yield (device batch, host batch, names) for each (host batch,
    names) of `it`, the copies of the next `lookahead` batches already
    issued: the port of the JAX package's `device_prefetch`. On a card
    the host batches must be pinned (`Batch.pin_memory`; the loader pins
    with `pin_memory=True`): each copy runs with `non_blocking=True` on a
    copy stream, and the batch is yielded once the current stream has
    been told to wait for it. On the CPU the device batch is the host
    batch."""
    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    queue = collections.deque()

    def issue(host: Batch):
        if stream is None:
            return host.to(dev), None
        if not host.is_pinned():
            raise ValueError("device_prefetch copies to a card from pinned "
                             "memory only: pin the batch (Batch.pin_memory, "
                             "Loader.epoch(pin_memory=True))")
        with torch.cuda.stream(stream):
            moved = host.to(dev, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        return moved, copied

    def ready(item):
        moved, copied, host, names = item
        if copied is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(copied)
            for f in FIELDS:
                # the copy stream allocated it; the current stream uses it
                getattr(moved, f).record_stream(current)
        return moved, host, names

    for host, names in it:
        queue.append((*issue(host), host, names))
        if len(queue) > lookahead:
            yield ready(queue.popleft())
    while queue:
        yield ready(queue.popleft())


def train_one_epoch(state, train_step: Callable, loader, epoch: int,
                    generator: Optional[torch.Generator], device,
                    logger: Optional[MetricLogger] = None,
                    vis_dir: Optional[str] = None, with_center: bool = True):
    """Returns (state, dict of the epoch's global averages). `vis_dir`
    saves the first batch's label overlay, `input_epoch{epoch}.png`, once
    per epoch (the original's training-input check)."""
    logger = logger or MetricLogger(print_freq=10)
    dev = torch.device(device)
    pending = []
    inflight = []

    def drain():
        """The window in flight into the meters, once its copy is done:
        this waits on the copy's event, not on the device."""
        if not inflight:
            return
        host, copied = inflight.pop()
        if copied is not None:
            copied.synchronize()
        for row in host.numpy():
            scal = dict(zip(train_step.log_keys, row.tolist()))
            if not math.isfinite(scal["loss"]):
                raise FloatingPointError(
                    f"Loss is {scal['loss']}, stopping training")
            logger.update(**scal)

    def flush():
        """Start this window's copy to the host, then drain the previous
        window."""
        started = None
        if pending:
            stacked = torch.stack(pending)
            pending.clear()
            started = (stacked, None)
            if stacked.is_cuda:
                host = torch.empty(stacked.shape, dtype=stacked.dtype,
                                   pin_memory=True)
                host.copy_(stacked, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(torch.cuda.current_stream(stacked.device))
                started = (host, copied)
        drain()
        if started is not None:
            inflight.append(started)

    first = True
    stream = device_prefetch(loader.epoch(epoch,
                                          pin_memory=dev.type == "cuda"), dev)
    for batch, host, _names in logger.log_every(stream, f"Epoch: [{epoch}]",
                                                total=len(loader),
                                                before_print=flush):
        if first and vis_dir is not None and logger.is_main:
            show_labels(host.images[0].numpy(),
                        host.lines[0][host.line_mask[0]].numpy(),
                        os.path.join(vis_dir, f"input_epoch{epoch}.png"),
                        with_center=with_center)
        first = False
        state, log_vec = train_step(state, batch, generator)
        pending.append(log_vec.clone())
    flush()
    drain()     # the last window is still in flight after flush()
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
    dev = torch.device(device)
    stream = device_prefetch(loader.epoch(0, pin_memory=dev.type == "cuda"),
                             dev)
    for bi, (batch, host, batch_names) in enumerate(stream):
        res = eval_step(model, batch)
        if cfg.with_dense:
            cur = {k: res[k] for k in ("depth_sums", "confusion",
                                       "eval_losses", "eval_loss_count")
                   if k in res}
            acc = ({k: v.clone() for k, v in cur.items()} if acc is None
                   else {k: acc[k] + v for k, v in cur.items()})
        if save_dense_dir is not None and "pred_depth_full" in res:
            depth = res["pred_depth_full"].cpu().numpy()
            seg = res["pred_seg_cls"].cpu().numpy()
            for i, name in enumerate(batch_names):
                save_dense_pred(depth[i], host.depth[i].numpy(), seg[i],
                                host.seg[i].numpy(), host.images[i].numpy(),
                                os.path.join(save_dense_dir, f"{name}.png"),
                                max_depth=cfg.max_depth)
        if keep_lines:
            n = len(batch_names)      # the rows past it pad the last batch
            names += batch_names
            order += [(bi, mesh.data_rank, j) for j in range(n)]
            line_out.append([res[k][:n].clone() for k in (
                "pred_logits", "pred_lines", "extent")])
            if save_line_dir is not None:
                gts += [(host.lines[i].numpy(), host.line_mask[i].numpy(),
                         host.images[i].numpy()) for i in range(n)]
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
