"""Losses: Hungarian set criterion for lines, SiLog depth, seg CE.

The port of `gwdepth_tpu/losses/criterion.py`, over the same fixed-size
padded targets: each image carries `max_lines` slots with a validity mask.
The line normaliser `num_items` is the whole batch's matched-pair count,
the quotient the original code's all-reduce and DDP averaging amount to.

`seg_ce_loss` takes its layout as an argument ("nhwc" or "nchw"); the JAX
package infers it from `shape[1] == seg_gt.shape[1]`, which reads an NCHW
input with H == 2 as NHWC.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from gwdepth_tpu_torch.ops.interpolate import resize_nearest
from gwdepth_tpu_torch.ops.lap import match_lines


def build_match_cost(pred_logits: torch.Tensor, pred_lines: torch.Tensor,
                     tgt_lines: torch.Tensor, cost_class: float,
                     cost_line: float) -> torch.Tensor:
    """(..., B, Q, 2), (..., B, Q, D), (B, T, D) -> (..., B, Q, T):
    cost_line * L1(lines) - cost_class * p(class 0)."""
    prob0 = torch.softmax(pred_logits, dim=-1)[..., 0]
    l1 = (pred_lines[..., :, None, :] - tgt_lines[..., None, :, :]
          ).abs().sum(-1)
    return cost_line * l1 - cost_class * prob0[..., None]


def line_set_criterion(
    outputs: Dict,
    tgt_lines: torch.Tensor,
    line_mask: torch.Tensor,
    *,
    eos_coef: float,
    set_cost_class: float,
    set_cost_line: float,
    focal: bool = False,
    focal_gamma: float = 2.0,
) -> Dict[str, torch.Tensor]:
    """Set criterion over the final and aux decoder layers.

    outputs: {'pred_logits': (B, Q, 2), 'pred_lines': (B, Q, D),
    'aux_outputs': [dicts with the same keys]}; tgt_lines (B, T, D);
    line_mask (B, T) bool. Returns loss_ce, loss_line, cardinality_error,
    then loss_ce_i / loss_line_i per aux layer. Every layer is matched in
    one host call."""
    n_valid = line_mask.sum(dim=1)                                # (B,)
    num_items = line_mask.sum().float().clamp(min=1.0)
    aux = list(outputs.get("aux_outputs", ()))
    logits = torch.stack([outputs["pred_logits"]]
                         + [a["pred_logits"] for a in aux])      # (L,B,Q,2)
    lines = torch.stack([outputs["pred_lines"]]
                        + [a["pred_lines"] for a in aux])        # (L,B,Q,D)
    L, B, Q, D = lines.shape
    maskf = line_mask.float()

    cost = build_match_cost(logits, lines, tgt_lines, set_cost_class,
                            set_cost_line)
    cost = torch.where(line_mask[None, :, None, :], cost,
                       torch.zeros_like(cost))
    tgt2q = match_lines(cost, n_valid.expand(L, B))               # (L,B,T)

    src = torch.gather(lines, 2, tgt2q[..., None].expand(-1, -1, -1, D))
    l1 = (src - tgt_lines).abs().sum(-1) * maskf
    loss_line = l1.sum(dim=(1, 2)) / num_items                    # (L,)

    matched = torch.zeros((L, B, Q), device=lines.device).scatter_reduce(
        2, tgt2q, maskf.expand(L, B, -1), reduce="amax")
    target_class = (1.0 - matched).long()                         # 0 = line
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target_class[..., None])[..., 0]
    w = torch.where(target_class == 0, torch.ones_like(nll),
                    torch.full_like(nll, eos_coef))
    if focal:
        prob = torch.softmax(logits.float(), dim=-1)
        p_t = prob[..., 1] * target_class + prob[..., 0] * (1 - target_class)
        loss_ce = (nll * w * (1.0 - p_t) ** focal_gamma).mean(dim=(1, 2))
    else:
        loss_ce = (nll * w).sum(dim=(1, 2)) / w.sum(dim=(1, 2))

    losses: Dict[str, torch.Tensor] = {"loss_ce": loss_ce[0],
                                       "loss_line": loss_line[0]}
    final = outputs["pred_logits"]
    card_pred = (final.argmax(-1) != final.shape[-1] - 1).sum(1)
    losses["cardinality_error"] = (card_pred.float()
                                   - n_valid.float()).abs().mean()
    for i in range(len(aux)):
        losses[f"loss_ce_{i}"] = loss_ce[i + 1]
        losses[f"loss_line_{i}"] = loss_line[i + 1]
    return losses


def silog_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor,
               mask: torch.Tensor, variance_focus: float = 0.85,
               eps: float = 1e-7) -> torch.Tensor:
    """Scale-invariant log loss x10."""
    m = mask.float()
    cnt = m.sum().clamp(min=1.0)
    d = (torch.log(depth_est.clamp(min=eps))
         - torch.log(depth_gt.clamp(min=eps))) * m
    mean_d2 = (d * d).sum() / cnt
    mean_d = d.sum() / cnt
    return torch.sqrt((mean_d2 - variance_focus * mean_d ** 2)
                      .clamp(min=1e-12)) * 10.0


def multiscale_depth_loss(preds: Sequence[torch.Tensor],
                          depth_gt: torch.Tensor, valid: torch.Tensor,
                          weights: Sequence[float],
                          variance_focus: float = 0.85
                          ) -> Tuple[torch.Tensor, list]:
    """Per-scale SiLog against nearest-downsampled GT and mask. preds
    (B, 1, h, w); depth_gt (B, 1, H, W); valid (B, 1, H, W) bool."""
    total = 0.0
    per_scale = []
    for pred, w in zip(preds, weights):
        h, w_ = pred.shape[-2:]
        gt = resize_nearest(depth_gt, (h, w_))
        m = resize_nearest(valid.to(torch.uint8), (h, w_)) > 0
        l = silog_loss(pred, gt, m, variance_focus) * w
        per_scale.append(l)
        total = total + l
    return total, per_scale


def seg_ce_loss(seg_logits: torch.Tensor, seg_gt: torch.Tensor,
                layout: str) -> torch.Tensor:
    """Plain CE over all pixels (padding trains as background, as in the
    original). seg_logits (B, H, W, C) for layout "nhwc" or (B, C, H, W)
    for "nchw"; seg_gt (B, H, W) int."""
    if layout == "nhwc":
        axis = -1
    elif layout == "nchw":
        axis = 1
    else:
        raise ValueError(f"layout must be 'nhwc' or 'nchw', got {layout!r}")
    logp = torch.log_softmax(seg_logits.float(), dim=axis)
    nll = -torch.gather(logp, axis, seg_gt.long().unsqueeze(axis))
    return nll.mean()
