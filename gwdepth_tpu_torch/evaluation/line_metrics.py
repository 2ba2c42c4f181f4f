"""Offline line-detection evaluation: sAP, F-score, APH, line NMS and the
benchmark dumps.

The port's copy of `gwdepth_tpu.evaluation.line_metrics`, numpy (and
scipy for the one-to-one APH matcher) only: the same functions give the
same numbers on the same arrays and npz directories.

- `ap` / `fscore`          PR-curve area and best F (lcnn/metric.py:11-30)
- `ms_tp_fp`               min-endpoint-permutation squared-distance
                           matching (lcnn/metric.py:194-210)
- `sap_score`/`fscore_score` directory-level scorers (128x128-normalized
                           coords, thresholds 5/10/15, duplicate-tail
                           truncation; eval-sAP-glassrgbd.py:34-87)
- `postprocess_lines`      score softmax + rescale to pixels
- `line_nms`               overlap-aware projection NMS
                           (eval_post_online.py:22-91)
- `dump_benchmark_npz`     per-image {lines (yxyx, 128-normalized), score}
- `dump_gt_lines`          per-image GT {lpos, file_name, image_id}
- `aph_score`              heatmap AP over rasterized 128-grid lines
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# PR metrics (lcnn/metric.py:11-30)
# ---------------------------------------------------------------------------

def ap(tp: np.ndarray, fp: np.ndarray) -> float:
    recall = tp
    precision = tp / np.maximum(tp + fp, 1e-9)
    recall = np.concatenate(([0.0], recall, [1.0]))
    precision = np.concatenate(([0.0], precision, [0.0]))
    for i in range(precision.size - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    i = np.where(recall[1:] != recall[:-1])[0]
    return float(np.sum((recall[i + 1] - recall[i]) * precision[i + 1]))


def fscore(tp: np.ndarray, fp: np.ndarray) -> float:
    recall = tp
    precision = tp / np.maximum(tp + fp, 1e-9)
    recall = np.concatenate(([0.0], recall, [1.0]))
    precision = np.concatenate(([0.0], precision, [0.0]))
    return float((2 * precision * recall /
                  (1e-9 + precision + recall)).max())


def ms_tp_fp(line_pred: np.ndarray, line_gt: np.ndarray,
             threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy one-to-one matching by min over both endpoint orders of the
    summed squared endpoint distance (lcnn/metric.py:194-210).
    line_pred: (P, 2, 2); line_gt: (G, 2, 2)."""
    if len(line_pred) == 0:
        return np.zeros(0), np.zeros(0)
    diff = ((line_pred[:, None, :, None] - line_gt[:, None]) ** 2).sum(-1)
    diff = np.minimum(diff[:, :, 0, 0] + diff[:, :, 1, 1],
                      diff[:, :, 0, 1] + diff[:, :, 1, 0])
    choice = np.argmin(diff, 1)
    dist = np.min(diff, 1)
    hit = np.zeros(len(line_gt), bool)
    tp = np.zeros(len(line_pred))
    fp = np.zeros(len(line_pred))
    for i in range(len(line_pred)):
        if dist[i] < threshold and not hit[choice[i]]:
            hit[choice[i]] = True
            tp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def _truncate_duplicate_tail(lines: np.ndarray, scores: np.ndarray):
    """The reference detectors pad dumps by repeating the first line; the
    eval truncates at the first repeat (eval-sAP-glassrgbd.py:54-58)."""
    for i in range(1, len(lines)):
        if (lines[i] == lines[0]).all():
            return lines[:i], scores[:i]
    return lines, scores


def _score_curve(preds_gts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 threshold: float):
    n_gt = 0
    tps, fps, scores = [], [], []
    for pred_lines, pred_scores, gt_lines in preds_gts:
        pred_lines, pred_scores = _truncate_duplicate_tail(
            pred_lines, pred_scores)
        n_gt += len(gt_lines)
        tp, fp = ms_tp_fp(pred_lines, gt_lines, threshold)
        tps.append(tp)
        fps.append(fp)
        scores.append(pred_scores)
    tps = np.concatenate(tps)
    fps = np.concatenate(fps)
    scores = np.concatenate(scores)
    idx = np.argsort(-scores)
    tp = np.cumsum(tps[idx]) / max(n_gt, 1)
    fp = np.cumsum(fps[idx]) / max(n_gt, 1)
    return tp, fp


def _load_dir_pairs(pred_dir: str, gt_dir: str):
    preds = sorted(glob.glob(os.path.join(pred_dir, "*.npz")))
    gts = sorted(glob.glob(os.path.join(gt_dir, "*.npz")))
    out = []
    for p, g in zip(preds, gts):
        with np.load(p) as fp:
            pl = fp["lines"][:, :, :2]
            ps = fp["score"]
        with np.load(g) as fg:
            gl = fg["lpos"][:, :, :2]
        out.append((pl, ps, gl))
    return out


def sap_score(pred_dir: str, gt_dir: str,
              thresholds: Sequence[float] = (5, 10, 15)) -> Dict[float, float]:
    """sAP at each threshold, x100 (eval-sAP-glassrgbd.py:76-87)."""
    pairs = _load_dir_pairs(pred_dir, gt_dir)
    return {t: 100 * ap(*_score_curve(pairs, t)) for t in thresholds}


def fscore_score(pred_dir: str, gt_dir: str,
                 thresholds: Sequence[float] = (5, 10, 15)) -> Dict[float, float]:
    pairs = _load_dir_pairs(pred_dir, gt_dir)
    return {t: 100 * fscore(*_score_curve(pairs, t)) for t in thresholds}


def pr_curve(pred_dir: str, gt_dir: str, threshold: float = 10
             ) -> Dict[str, np.ndarray]:
    """Precision/recall arrays at one endpoint-distance threshold — the
    data behind the reference's PR plots (reference: evaluation/
    eval-aph-post-*.py renders curves from the same cumulative tp/fp)."""
    tp, fp = _score_curve(_load_dir_pairs(pred_dir, gt_dir), threshold)
    recall = tp
    precision = tp / np.maximum(tp + fp, 1e-9)
    return {"recall": recall, "precision": precision}


def plot_pr_curves(curves: Dict[str, Dict[str, np.ndarray]], out_png: str,
                   title: str = "PR") -> str:
    """Render named PR curves to a png (matplotlib Agg; the reference uses
    MATLAB + TkAgg plots for the same figure). `curves`: label ->
    {recall, precision}."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axm = plt.subplots(figsize=(5, 5))
    for label, c in curves.items():
        axm.plot(c["recall"], c["precision"], label=label)
    axm.set_xlabel("recall")
    axm.set_ylabel("precision")
    axm.set_xlim(0, 1)
    axm.set_ylim(0, 1)
    axm.grid(alpha=0.3)
    axm.legend()
    axm.set_title(title)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_png


# ---------------------------------------------------------------------------
# postprocess + dumps
# ---------------------------------------------------------------------------

def softmax(x: np.ndarray, axis=-1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def postprocess_lines(pred_logits: np.ndarray, pred_lines: np.ndarray,
                      hw: Tuple[int, int]):
    """'prediction' mode (glassrgbd.py:464-479): scores = max foreground
    prob, lines scaled to pixels. pred_lines may carry center coords —
    only the 4 endpoint coords are used."""
    prob = softmax(pred_logits, -1)
    scores = prob[:, :-1].max(-1)
    h, w = hw
    lines = pred_lines[:, :4] * np.array([w, h, w, h])
    return lines, scores


def dump_benchmark_npz(out_dir: str, name: str, pred_logits: np.ndarray,
                       pred_lines: np.ndarray, orig_hw: Tuple[int, int]):
    """Per-image npz in the offline-eval contract (src/engine.py:117-165):
    lines (Q, 2, 2) in yxyx order scaled onto a 128x128 grid, scores sorted
    descending."""
    lines, scores = postprocess_lines(pred_logits, pred_lines, orig_hw)
    h, w = orig_hw
    ln = lines.reshape(-1, 2, 2)[:, :, ::-1].astype(np.float64)  # yx
    ln[:, :, 0] *= 128.0 / h
    ln[:, :, 1] *= 128.0 / w
    idx = np.argsort(-scores)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{name}.npz"),
             lines=ln[idx], score=scores[idx])


def dump_gt_lines(dataset, out_dir: str) -> int:
    """Write the GT `lpos` npz files the offline sAP/F-score scorers consume
    (reference: src/datasets/glassrgbd_norhint.py:306-330 `loadertest`):
    per image, eval-transformed line endpoints normalized to [0,1] over the
    image, scaled onto the 128 grid, reshaped (N, 2, 2) and flipped to
    (y, x) point order; keys {lpos, file_name, image_id}.  Returns the
    number of files written.

    (The reference script builds mode='train' with val transforms and
    saves under lines_npz/eval — here the caller picks the split by
    passing the matching dataset.)"""
    from gwdepth_tpu_torch.data.transforms import eval_transform

    os.makedirs(out_dir, exist_ok=True)
    name_to_id = {v: k for k, v in getattr(dataset, "id_to_img", {}).items()}
    n = 0
    for idx in range(len(dataset)):
        s, name = dataset.load_raw(idx)
        s = eval_transform(s, dataset.cfg.eval_hw)
        ln = np.asarray(s.lines, np.float64) * 128.0          # (N, 4) xyxy
        lpos = ln.reshape(-1, 2, 2)[:, :, ::-1]               # -> yx points
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 lpos=lpos, file_name=name,
                 image_id=name_to_id.get(name, idx))
        n += 1
    return n


# ---------------------------------------------------------------------------
# overlap-aware line NMS (eval_post_online.py:22-91)
# ---------------------------------------------------------------------------

def _pline(x1, y1, x2, y2, x, y) -> float:
    """Squared point-to-LINE distance: the projection is NOT clamped to the
    segment (reference eval_post_online.py:17-25 `pline`; the clamped
    variant is its separate `psegment`, which the NMS never uses)."""
    px, py = x2 - x1, y2 - y1
    dd = px * px + py * py
    u = ((x - x1) * px + (y - y1) * py) / max(float(dd), 1e-9)
    dx = x1 + u * px - x
    dy = y1 + u * py - y
    return dx * dx + dy * dy


def _plambda(x1, y1, x2, y2, x, y) -> float:
    px, py = x2 - x1, y2 - y1
    dd = px * px + py * py
    return ((x - x1) * px + (y - y1) * py) / max(1e-9, float(dd))


def line_nms(lines: np.ndarray, scores: np.ndarray, threshold: float = 0.01,
             tol: float = 1e9):
    """Suppress near-collinear overlapping segments; keeps the uncovered
    sub-segment of each survivor. lines: (N, 2, 2) [(p, q)] sorted by
    descending score."""
    nlines: List[np.ndarray] = []
    nscores, chosen = [], []
    for idx, ((p, q), score) in enumerate(zip(lines, scores)):
        start, end = 0.0, 1.0
        for a, b in nlines:
            if min(max(_pline(*p, *q, *a), _pline(*p, *q, *b)),
                   max(_pline(*a, *b, *p), _pline(*a, *b, *q))) \
                    > threshold ** 2:
                continue
            la = _plambda(*p, *q, *a)
            lb = _plambda(*p, *q, *b)
            if la > lb:
                la, lb = lb, la
            la -= tol
            lb += tol
            if start < la and lb < end:
                continue
            if lb < start or la > end:
                continue
            if la <= start and end <= lb:
                start = 10
                break
            if la <= start <= lb:
                start = lb
            if la <= end <= lb:
                end = la
            if start >= end:
                break
        if start >= end:
            continue
        nlines.append(np.array([p + (q - p) * start, p + (q - p) * end]))
        nscores.append(score)
        chosen.append(idx)
    return np.array(nlines), np.array(nscores), np.array(chosen)


# ---------------------------------------------------------------------------
# heatmap-based AP (APH) — MATLAB-free equivalent of evaluation/eval-aph-*
# ---------------------------------------------------------------------------

def rasterize_lines(lines: np.ndarray, size: int = 128) -> np.ndarray:
    """(N, 2, 2) [y, x] endpoint pairs on a `size`x`size` grid -> bool map.
    Dense sub-pixel stepping along each segment."""
    img = np.zeros((size, size), bool)
    for (y1, x1), (y2, x2) in lines:
        n = int(max(abs(y2 - y1), abs(x2 - x1)) * 2) + 2
        t = np.linspace(0.0, 1.0, n)
        ys = np.clip(np.round(y1 + t * (y2 - y1)).astype(int), 0, size - 1)
        xs = np.clip(np.round(x1 + t * (x2 - x1)).astype(int), 0, size - 1)
        img[ys, xs] = True
    return img


def _dilate(mask: np.ndarray, r: int) -> np.ndarray:
    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            out |= np.roll(np.roll(mask, dy, 0), dx, 1)
    return out


def _match_counts(pmap: np.ndarray, gmap: np.ndarray, tolerance: int
                  ) -> tuple:
    """ONE-TO-ONE pixel correspondence counts (tp, fp, fn).

    Maximum-cardinality bipartite matching between pred and GT pixels
    within Chebyshev distance `tolerance` — each GT pixel validates at
    most ONE pred pixel and vice versa, the semantics of the BSDS
    `correspondPixels` matcher inside the MATLAB `eval_release` the
    reference shells out to (evaluation/eval-aph-score-glassrgbd.py:70-77;
    the .m sources are not shipped).  The dilation protocol in
    `aph_pr_points` is many-to-one and therefore an UPPER BOUND on
    tp (lower bound on fp/fn); tests/test_aph_tolerance_bound.py pins the
    worst-case and realistic-case deltas."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching
    pp = np.argwhere(pmap)
    gg = np.argwhere(gmap)
    if len(pp) == 0 or len(gg) == 0:
        return 0, int(len(pp)), int(len(gg))
    # adjacency: |dy|<=r and |dx|<=r (the square structuring element the
    # dilation protocol uses, so the two protocols differ ONLY in
    # one-to-one-ness, not in the distance notion)
    close = (np.abs(pp[:, None, 0] - gg[None, :, 0]) <= tolerance) & \
            (np.abs(pp[:, None, 1] - gg[None, :, 1]) <= tolerance)
    graph = csr_matrix(close)
    match = maximum_bipartite_matching(graph, perm_type="column")
    tp = int((match >= 0).sum())
    return tp, int(len(pp) - tp), int(len(gg) - tp)


def aph_pr_points(pred_dir: str, gt_dir: str, tolerance: int = 1,
                  n_thresholds: int = 20, protocol: str = "dilate"):
    """Heatmap precision/recall sweep over score thresholds.

    Lines are rasterized on the 128-grid; pred pixels within `tolerance`
    of a GT pixel count as true. Returns (thresholds, precisions,
    recalls) as float arrays — the raw points `aph_score` integrates and
    `utils.visualize.aph_pr_curve` plots (the reference computes the same
    sweep inside MATLAB, evaluation/eval-aph-score-glassrgbd.py:104-122).

    `protocol`: "dilate" counts a pred pixel as tp when it lands inside
    the `tolerance`-dilated GT map (many-to-one, fast); "match" uses
    maximum one-to-one bipartite pixel correspondence (`_match_counts`) —
    the closer analogue of the MATLAB correspondPixels protocol."""
    assert protocol in ("dilate", "match"), protocol
    pairs = _load_dir_pairs(pred_dir, gt_dir)
    all_scores = np.concatenate([p[1] for p in pairs]) if pairs else np.array([0.])
    thresholds = np.quantile(all_scores, np.linspace(0, 1, n_thresholds))
    precisions, recalls = [], []
    gt_maps = [rasterize_lines(g) for _, _, g in pairs]
    gt_dil = [_dilate(g, tolerance) for g in gt_maps]
    for t in thresholds:
        tp = fp = fn = 0
        for (pl, ps, _), gmap, gdil in zip(pairs, gt_maps, gt_dil):
            pl, ps = _truncate_duplicate_tail(pl, ps)
            pmap = rasterize_lines(pl[ps >= t])
            if protocol == "match":
                tp_i, fp_i, fn_i = _match_counts(pmap, gmap, tolerance)
                tp, fp, fn = tp + tp_i, fp + fp_i, fn + fn_i
                continue
            pdil = _dilate(pmap, tolerance)
            tp += int((pmap & gdil).sum())
            fp += int((pmap & ~gdil).sum())
            fn += int((gmap & ~pdil).sum())
        precisions.append(tp / max(tp + fp, 1))
        recalls.append(tp / max(tp + fn, 1))
    return (np.asarray(thresholds, np.float64),
            np.asarray(precisions, np.float64),
            np.asarray(recalls, np.float64))


def aph_score(pred_dir: str, gt_dir: str, tolerance: int = 1,
              n_thresholds: int = 20, protocol: str = "dilate") -> float:
    """Heatmap-based AP over a dump directory, x100.

    The reference shells out to MATLAB for this metric
    (evaluation/eval-aph-score-glassrgbd.py:70-77); this is a
    MATLAB-free numpy equivalent: pixel precision/recall from
    `aph_pr_points`, AP as the area under the interpolated PR curve.

    Protocol bound (tests/test_aph_tolerance_bound.py): the default
    "dilate" counting is many-to-one and upper-bounds the one-to-one
    correspondPixels counting ("match") — adversarial pred sets that
    crowd (2r+1)^2 pixels onto single GT pixels drive the precision gap
    to its (2r+1)^2 factor worst case, but on realistic 1-px line
    rasters (non-overlapping predictions) the measured AP^H delta stays
    within a few points; pass protocol="match" for the MATLAB-style
    one-to-one numbers."""
    _, precisions, recalls = aph_pr_points(pred_dir, gt_dir, tolerance,
                                           n_thresholds, protocol)
    order = np.argsort(recalls)
    r = np.concatenate([[0.0], np.asarray(recalls)[order], [1.0]])
    p = np.concatenate([[0.0], np.asarray(precisions)[order], [0.0]])
    for i in range(p.size - 1, 0, -1):
        p[i - 1] = max(p[i - 1], p[i])
    i = np.where(r[1:] != r[:-1])[0]
    return float(100 * np.sum((r[i + 1] - r[i]) * p[i + 1]))
