"""Train and eval steps.

The port of `gwdepth_tpu/parallel/train_step.py`, eager:

train step = forward (train mode, dropout from the step's generator) ->
Hungarian set criterion (weighted CE + 5 * L1 over the final and aux
layers) + multi-scale SiLog (weights 1/4, 1/4, 1/4, 1 against
nearest-downsampled GT, mask 0.2 m <= depth < max_depth) + 2 x seg CE ->
backward -> clip 0.1 -> grouped AdamW. With `with_plane_norm_loss` (and
both branches) the step also logs `loss_plane`, the plane-normal loss x
`plane_norm_loss_coef`, which the total never includes (the original
logs it and does not optimize it). `grad_accum` A > 1 splits the
batch strided (image i -> microbatch i % A) and applies the mean of the A
microbatch gradients once.

eval step = forward (eval mode) -> 9 depth error sums + count over the
GT-valid mask, a 2x2 seg confusion matrix and the per-image line losses,
as device tensors the caller sums over the split.

Logs come back as ONE device vector in `log_keys` order (sorted, the
JAX package's order, so `log.txt` lists the same keys in the same order),
so the caller moves them to the host once per print
window.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.data.batch import Batch
from gwdepth_tpu_torch.losses import (line_set_criterion,
                                      multiscale_depth_loss, plane_norm_loss,
                                      seg_ce_loss)
from gwdepth_tpu_torch.parallel.train_state import TrainState


def compute_losses(cfg: GWDepthConfig, outputs: Dict, batch: Batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss and the log dict."""
    logs: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=batch.images.device)
    if cfg.with_line:
        ld = line_set_criterion(
            outputs, batch.lines, batch.line_mask,
            eos_coef=cfg.eos_coef, set_cost_class=cfg.set_cost_class,
            set_cost_line=cfg.set_cost_line,
            focal=cfg.label_loss_func == "focal_loss",
            focal_gamma=cfg.focal_gamma)
        for k, v in ld.items():
            logs[k] = v
            if k.startswith("loss_ce"):
                total = total + v
            elif k.startswith("loss_line"):
                total = total + v * cfg.line_loss_coef
    if cfg.with_dense:
        valid = (batch.depth >= cfg.train_min_depth) & \
                (batch.depth < cfg.max_depth)
        preds = [d[:, None] for d in outputs["pred_depth"]]
        loss_depth, per_scale = multiscale_depth_loss(
            preds, batch.depth[:, None], valid[:, None],
            cfg.depth_loss_weights, cfg.variance_focus)
        for name, l in zip(("1_16", "1_8", "1_4", "1"), per_scale):
            logs[f"loss_depth_{name}"] = l
        loss_seg = seg_ce_loss(outputs["pred_seg"], batch.seg, "nhwc") \
            * cfg.seg_loss_weight
        logs["loss_seg"] = loss_seg
        total = total + loss_depth + loss_seg
        if cfg.with_plane_norm_loss and cfg.with_line:
            # logged only: no graph, so its (B, 28, H, W) masks are freed
            with torch.no_grad():
                lp = plane_norm_loss(outputs["pred_depth"][-1],
                                     outputs["pred_lines"],
                                     outputs["pred_logits"], valid)
            logs["loss_plane"] = lp * cfg.plane_norm_loss_coef
    logs["loss"] = total
    return total, logs


def make_train_step(cfg: GWDepthConfig) -> Callable:
    """(state, batch, generator) -> (state, log vector on the device).
    The returned callable carries `log_keys`, filled on the first call."""
    log_keys: list = []
    A = max(int(cfg.grad_accum), 1)

    def loss_and_backward(model, batch: Batch, generator, scale: float):
        outputs = model(batch.images, batch.valid, generator=generator)
        loss, logs = compute_losses(cfg, outputs, batch)
        (loss * scale).backward()
        if not log_keys:
            # sorted, as the JAX step's keys come out of its pytree
            log_keys.extend(sorted(logs))
        return torch.stack([logs[k].detach().float() for k in log_keys])

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None):
        model = state.model
        model.train()
        B = batch.batch_size
        if B % A:
            raise ValueError(f"batch {B} not divisible by grad_accum {A}")
        logs = [loss_and_backward(model, batch.map(lambda t: t[i::A]),
                                  generator, 1.0 / A) for i in range(A)]
        state.apply_gradients()
        return state, torch.stack(logs).mean(dim=0)

    step.log_keys = log_keys
    return step


def depth_error_sums(pred: torch.Tensor, gt: torch.Tensor,
                     valid: torch.Tensor, min_d: float, max_d: float
                     ) -> torch.Tensor:
    """Per-image 9 depth metrics over the valid mask, summed over the
    batch, then the count of images with any valid pixel: (10,).
    pred/gt (B, H, W); valid (B, H, W) bool. silog is x100."""
    pred = pred.float().clamp(min_d, max_d)
    pred = torch.where(torch.isnan(pred), torch.full_like(pred, min_d), pred)
    pred = torch.where(torch.isinf(pred), torch.full_like(pred, max_d), pred)
    m = valid.float()
    cnt = m.sum(dim=(1, 2)).clamp(min=1.0)
    gt_s = torch.where(valid, gt.float(), torch.ones_like(pred))
    pr_s = torch.where(valid, pred, torch.ones_like(pred))

    def mmean(x):
        return (x * m).sum(dim=(1, 2)) / cnt

    thresh = torch.maximum(gt_s / pr_s, pr_s / gt_s)
    d1 = mmean((thresh < 1.25).float())
    d2 = mmean((thresh < 1.25 ** 2).float())
    d3 = mmean((thresh < 1.25 ** 3).float())
    rms = torch.sqrt(mmean((gt_s - pr_s) ** 2))
    log_rms = torch.sqrt(mmean((torch.log(gt_s) - torch.log(pr_s)) ** 2))
    abs_rel = mmean((gt_s - pr_s).abs() / gt_s)
    sq_rel = mmean((gt_s - pr_s) ** 2 / gt_s)
    err = torch.log(pr_s) - torch.log(gt_s)
    silog = torch.sqrt(mmean(err ** 2) - mmean(err) ** 2) * 100.0
    log10 = mmean((torch.log10(pr_s) - torch.log10(gt_s)).abs())
    per_img = torch.stack([silog, abs_rel, log10, rms, sq_rel, log_rms,
                           d1, d2, d3], dim=1)                  # (B, 9)
    has_any = (m.sum(dim=(1, 2)) > 0).float()
    sums = (per_img * has_any[:, None]).sum(dim=0)
    return torch.cat([sums, has_any.sum()[None]])


def seg_confusion(pred_cls: torch.Tensor, gt: torch.Tensor,
                  valid: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """Confusion counts [gt, pred] over the valid pixels, float32."""
    idx = gt.long() * num_classes + pred_cls.long()
    idx = torch.where(valid, idx, torch.full_like(idx,
                                                  num_classes * num_classes))
    counts = torch.bincount(idx.reshape(-1),
                            minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes).float()


def make_eval_step(cfg: GWDepthConfig, return_dense: bool = False
                   ) -> Callable:
    """(model, batch) -> dict of device tensors: eval_losses (3,) summed
    over real images and eval_loss_count, depth_sums (10,), confusion
    (2, 2), and the line outputs with each image's extent on the canvas.
    `return_dense` adds the full-resolution depth `pred_depth_full`
    (B, H, W) and the seg argmax `pred_seg_cls` (B, H, W), for
    `--save_dense`."""

    @torch.no_grad()
    def step(model, batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        outputs = model(batch.images, batch.valid)
        res: Dict[str, torch.Tensor] = {}
        # all-invalid images pad the last batch and count nowhere
        img_ok = batch.valid.any(dim=2).any(dim=1)
        if cfg.with_line:
            per_img = []
            for i in range(batch.batch_size):
                ld = line_set_criterion(
                    {"pred_logits": outputs["pred_logits"][i:i + 1],
                     "pred_lines": outputs["pred_lines"][i:i + 1]},
                    batch.lines[i:i + 1], batch.line_mask[i:i + 1],
                    eos_coef=cfg.eos_coef, set_cost_class=cfg.set_cost_class,
                    set_cost_line=cfg.set_cost_line)
                per_img.append(torch.stack([ld["loss_ce"], ld["loss_line"],
                                            ld["cardinality_error"]]))
            res["eval_losses"] = (torch.stack(per_img)
                                  * img_ok[:, None].float()).sum(0)
            res["eval_loss_count"] = img_ok.float().sum()
        if cfg.with_dense:
            depth = outputs["pred_depth"][-1]
            gt_valid = (batch.depth > cfg.min_depth_eval) & \
                       (batch.depth < cfg.max_depth_eval) & batch.valid \
                       & img_ok[:, None, None]
            res["depth_sums"] = depth_error_sums(
                depth, batch.depth, gt_valid, cfg.min_depth_eval,
                cfg.max_depth_eval)
            pred_cls = outputs["pred_seg"].argmax(-1)
            res["confusion"] = seg_confusion(pred_cls, batch.seg, batch.valid)
            if return_dense:
                res["pred_depth_full"] = depth
                res["pred_seg_cls"] = pred_cls
        if cfg.with_line:
            res["pred_logits"] = outputs["pred_logits"]
            res["pred_lines"] = outputs["pred_lines"]
            res["extent"] = torch.stack(
                [batch.valid.any(dim=2).sum(dim=1),
                 batch.valid.any(dim=1).sum(dim=1)], dim=1)
        return res

    return step


def summarize_depth(depth_sums) -> Dict[str, float]:
    names = ["silog", "abs_rel", "log10", "rms", "sq_rel", "log_rms",
             "d1", "d2", "d3"]
    sums = np.asarray(depth_sums, np.float64)
    cnt = max(float(sums[9]), 1.0)
    return {n: float(sums[i]) / cnt for i, n in enumerate(names)}


def summarize_seg(confusion) -> Dict[str, float]:
    """IoUs and accuracies from the summed confusion matrix."""
    cm = np.asarray(confusion, np.float64)
    pos = cm.sum(1)
    res = cm.sum(0)
    tp = np.diag(cm)
    iou = tp / np.maximum(1.0, pos + res - tp) * 100
    return {
        "iou_background": float(iou[0]),
        "iou_glass": float(iou[1]) if len(iou) > 1 else 0.0,
        "mean_iou": float(iou.mean()),
        "pixel_accuracy": float(tp.sum() / max(pos.sum(), 1.0) * 100),
        "mean_accuracy": float((tp / np.maximum(1.0, pos)).mean() * 100),
    }
