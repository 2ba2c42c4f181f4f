"""Losses: Hungarian set criterion for lines, SiLog depth, seg CE.

The port of `gwdepth_tpu/losses/criterion.py`, over the same fixed-size
padded targets: each image carries `max_lines` slots with a validity mask.
The line normaliser `num_items` is the whole batch's matched-pair count,
the quotient the original code's all-reduce and DDP averaging amount to.

Every normaliser is the global batch's: each loss sums its numerators and
counts through `reduce` before it divides, and `reduce` is the identity
in one process and `DataMesh.all_sum` over data-parallel ranks, so W
ranks compute the loss of the whole batch, as the JAX package's step on
a `data` mesh does (a mean of per-rank SiLog square roots, or of per-rank
CE quotients, is another value).

`seg_ce_loss` takes its layout as an argument ("nhwc" or "nchw"); the JAX
package infers it from `shape[1] == seg_gt.shape[1]`, which reads an NCHW
input with H == 2 as NHWC.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from gwdepth_tpu_torch.ops.interpolate import resize_nearest
from gwdepth_tpu_torch.ops.lap import match_lines

Reducer = Callable[[torch.Tensor], torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    """The reducer of one process."""
    return t


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
    matcher_backend: str = "jax",
    focal: bool = False,
    focal_gamma: float = 2.0,
    reduce: Reducer = identity,
) -> Dict[str, torch.Tensor]:
    """Set criterion over the final and aux decoder layers.

    outputs: {'pred_logits': (B, Q, 2), 'pred_lines': (B, Q, D),
    'aux_outputs': [dicts with the same keys]}; tgt_lines (B, T, D);
    line_mask (B, T) bool. Returns loss_ce, loss_line, cardinality_error,
    then loss_ce_i / loss_line_i per aux layer. Every layer is matched in
    one `match_lines` call (`matcher_backend` "jax": one launch of the JV
    kernel on the card, no copy to the host; "scipy": one host solve);
    the sums of all layers cross `reduce` in one vector."""
    n_valid = line_mask.sum(dim=1)                                # (B,)
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
    tgt2q = match_lines(cost, n_valid.expand(L, B),
                        matcher_backend)                          # (L,B,T)

    src = torch.gather(lines, 2, tgt2q[..., None].expand(-1, -1, -1, D))
    l1 = (src - tgt_lines).abs().sum(-1) * maskf

    matched = torch.zeros((L, B, Q), device=lines.device).scatter_reduce(
        2, tgt2q, maskf.expand(L, B, -1), reduce="amax")
    target_class = (1.0 - matched).long()                         # 0 = line
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target_class[..., None])[..., 0]
    w = torch.where(target_class == 0, torch.ones_like(nll),
                    torch.full_like(nll, eos_coef))
    if focal:
        # a mean over the global batch's B x Q slots
        prob = torch.softmax(logits.float(), dim=-1)
        p_t = prob[..., 1] * target_class + prob[..., 0] * (1 - target_class)
        ce_num = (nll * w * (1.0 - p_t) ** focal_gamma).sum(dim=(1, 2))
        ce_den = torch.full_like(ce_num, float(B * Q))
    else:
        ce_num = (nll * w).sum(dim=(1, 2))
        ce_den = w.sum(dim=(1, 2))
    final = outputs["pred_logits"]
    card_pred = (final.argmax(-1) != final.shape[-1] - 1).sum(1)
    card = (card_pred.float() - n_valid.float()).abs()
    sums = reduce(torch.cat([
        l1.sum(dim=(1, 2)), ce_num, ce_den,
        torch.stack([line_mask.sum().float(), card.sum(),
                     torch.full((), float(B), device=card.device)])]))
    loss_line = sums[:L] / sums[3 * L].clamp(min=1.0)             # (L,)
    loss_ce = sums[L:2 * L] / sums[2 * L:3 * L]

    losses: Dict[str, torch.Tensor] = {"loss_ce": loss_ce[0],
                                       "loss_line": loss_line[0]}
    losses["cardinality_error"] = sums[3 * L + 1] / sums[3 * L + 2]
    for i in range(len(aux)):
        losses[f"loss_ce_{i}"] = loss_ce[i + 1]
        losses[f"loss_line_{i}"] = loss_line[i + 1]
    return losses


def silog_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor,
               mask: torch.Tensor, variance_focus: float = 0.85,
               eps: float = 1e-7, reduce: Reducer = identity
               ) -> torch.Tensor:
    """Scale-invariant log loss x10: sum d^2, sum d and the pixel count
    reduced, then the square root."""
    m = mask.float()
    d = (torch.log(depth_est.clamp(min=eps))
         - torch.log(depth_gt.clamp(min=eps))) * m
    s = reduce(torch.stack([(d * d).sum(), d.sum(), m.sum()]))
    cnt = s[2].clamp(min=1.0)
    mean_d2 = s[0] / cnt
    mean_d = s[1] / cnt
    return torch.sqrt((mean_d2 - variance_focus * mean_d ** 2)
                      .clamp(min=1e-12)) * 10.0


def multiscale_depth_loss(preds: Sequence[torch.Tensor],
                          depth_gt: torch.Tensor, valid: torch.Tensor,
                          weights: Sequence[float],
                          variance_focus: float = 0.85,
                          reduce: Reducer = identity
                          ) -> Tuple[torch.Tensor, list]:
    """Per-scale SiLog against nearest-downsampled GT and mask. preds
    (B, 1, h, w); depth_gt (B, 1, H, W); valid (B, 1, H, W) bool."""
    total = 0.0
    per_scale = []
    for pred, w in zip(preds, weights):
        h, w_ = pred.shape[-2:]
        gt = resize_nearest(depth_gt, (h, w_))
        m = resize_nearest(valid.to(torch.uint8), (h, w_)) > 0
        l = silog_loss(pred, gt, m, variance_focus, reduce=reduce) * w
        per_scale.append(l)
        total = total + l
    return total, per_scale


def seg_ce_loss(seg_logits: torch.Tensor, seg_gt: torch.Tensor,
                layout: str, reduce: Reducer = identity) -> torch.Tensor:
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
    s = reduce(torch.stack([nll.sum(), torch.full(
        (), float(nll.numel()), device=nll.device)]))
    return s[0] / s[1]
