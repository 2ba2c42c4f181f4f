"""Visualization helpers: label overlays, dense-prediction grids, line preds.

The port's copy of `gwdepth_tpu.utils.visualize`: the same uint8 images
for the same arrays. PIL/numpy re-derivation of the original code's
visual checks (src/util/commons.py:19-407 `inv_preprocess`, `show_labels`,
`save_dense_pred`; evaluation/eval_post_online.py:118-176
`vis_pred_lines`). Drawing uses PIL; the depth colormap is an inline
blue-green-red ramp; only the PR-curve figure needs matplotlib, imported
when it is drawn.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image, ImageDraw

from gwdepth_tpu_torch.data.transforms import MEAN, STD


def inv_preprocess(image: np.ndarray) -> np.ndarray:
    """Undo channel normalization -> uint8 HWC
    (reference: src/util/commons.py inv_preprocess)."""
    img = image * STD + MEAN
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def colorize_depth(depth: np.ndarray, max_depth: float = 10.0) -> np.ndarray:
    """(H, W) meters -> (H, W, 3) uint8 using a blue->green->red ramp."""
    t = np.clip(depth / max_depth, 0, 1)
    r = np.clip(1.5 - np.abs(2 * t - 1.5) * 2, 0, 1)
    g = np.clip(1.5 - np.abs(2 * t - 1.0) * 2, 0, 1)
    b = np.clip(1.5 - np.abs(2 * t - 0.5) * 2, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def draw_lines(image: np.ndarray, lines: np.ndarray,
               color=(220, 30, 30), width: int = 2,
               centers: Optional[np.ndarray] = None,
               center_color=(30, 220, 30)) -> np.ndarray:
    """lines: (N, 4) pixel coords [x1 y1 x2 y2]; centers: (N, 2)."""
    img = Image.fromarray(image.copy())
    d = ImageDraw.Draw(img)
    for ln in np.asarray(lines):
        d.line([(float(ln[0]), float(ln[1])),
                (float(ln[2]), float(ln[3]))], fill=color, width=width)
    if centers is not None:
        for c in np.asarray(centers):
            x, y = float(c[0]), float(c[1])
            d.ellipse([x - 3, y - 3, x + 3, y + 3], outline=center_color,
                      width=2)
    return np.asarray(img)


def show_labels(image_norm: np.ndarray, lines_norm: np.ndarray,
                save_path: Optional[str] = None,
                with_center: bool = True) -> np.ndarray:
    """Training-input overlay (reference: util/commons.py show_labels,
    called from engine_glassrgbd.py:47-50). image_norm: normalized HWC;
    lines_norm: (N, 4|6) in [0, 1]."""
    h, w = image_norm.shape[:2]
    img = inv_preprocess(image_norm)
    lines = np.asarray(lines_norm)
    px = lines[:, :4] * np.array([w, h, w, h])
    centers = (lines[:, 4:6] * np.array([w, h])
               if with_center and lines.shape[1] >= 6 else None)
    out = draw_lines(img, px, centers=centers)
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        Image.fromarray(out).save(save_path)
    return out


def save_dense_pred(pred_depth: np.ndarray, gt_depth: np.ndarray,
                    pred_seg: np.ndarray, gt_seg: np.ndarray,
                    image_norm: np.ndarray, save_path: str,
                    max_depth: float = 10.0) -> None:
    """2x3 grid: image | pred depth | gt depth / seg pred | seg gt | error
    (reference: util/commons.py save_dense_pred, engine_glassrgbd.py:266-274)."""
    img = inv_preprocess(image_norm)
    h, w = img.shape[:2]

    def seg_rgb(seg):
        return np.stack([(seg > 0) * 255, (seg > 0) * 128,
                         np.zeros_like(seg)], -1).astype(np.uint8)

    err = colorize_depth(np.abs(pred_depth - gt_depth), max_depth / 4)
    top = np.concatenate([img, colorize_depth(pred_depth, max_depth),
                          colorize_depth(gt_depth, max_depth)], axis=1)
    bot = np.concatenate([seg_rgb(pred_seg), seg_rgb(gt_seg), err], axis=1)
    grid = np.concatenate([top, bot], axis=0)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    Image.fromarray(grid).save(save_path)


def vis_pred_lines(pred_lines_px: np.ndarray, pred_scores: np.ndarray,
                   gt_lines_px: np.ndarray, image_norm: np.ndarray,
                   save_path: str, score_thresh: float = 0.7) -> np.ndarray:
    """Side-by-side pred (score-filtered) vs GT overlay
    (reference: evaluation/eval_post_online.py:118-176)."""
    img = inv_preprocess(image_norm)
    keep = pred_scores > score_thresh
    left = draw_lines(img, pred_lines_px[keep], color=(220, 30, 30))
    right = draw_lines(img, gt_lines_px, color=(30, 120, 220))
    out = np.concatenate([left, right], axis=1)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    Image.fromarray(out).save(save_path)
    return out


def aph_pr_curve(pred_dir: str, gt_dir: str, out_dir: str,
                 tolerance: int = 1, n_thresholds: int = 20,
                 label: str = "gwdepth_tpu") -> dict:
    """APH PR-curve figure + points dump — the paper-figure tail of the
    APH pipeline (reference: evaluation/eval-aph-score-glassrgbd.py:
    104-170 computes F^H / AP^H from the per-threshold PR sweep, then
    plots the monotonic PR curve with iso-F contours; the MATLAB step it
    shells out to is replaced by evaluation.line_metrics.aph_pr_points).

    Writes `aph_pr.png` and `aph_pr_points.npz` (thresholds, precisions,
    recalls) into out_dir; returns {"aph", "fh", "png", "npz"}.
    """
    from gwdepth_tpu_torch.evaluation.line_metrics import (aph_pr_points,
                                                           aph_score)

    thresholds, prs, rcs = aph_pr_points(pred_dir, gt_dir, tolerance,
                                         n_thresholds)
    aph = aph_score(pred_dir, gt_dir, tolerance, n_thresholds)
    # F^H = max F over the sweep (eval-aph-score-glassrgbd.py:111-114)
    fh = float((2 * prs * rcs / (prs + rcs + 1e-9)).max()) if prs.size else 0.0

    os.makedirs(out_dir, exist_ok=True)
    npz_path = os.path.join(out_dir, "aph_pr_points.npz")
    np.savez_compressed(npz_path, thresholds=thresholds,
                        precisions=prs, recalls=rcs,
                        aph=np.float64(aph), fh=np.float64(fh))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    # iso-F contours, as in the reference figure (:135-141)
    for f_score in np.linspace(0.2, 0.8, num=8):
        x = np.linspace(0.01, 1)
        y = f_score * x / np.maximum(2 * x - f_score, 1e-9)
        m = (y >= 0) & (y <= 1.05)
        ax.plot(x[m], y[m], color="green", alpha=0.3, linewidth=1)
        if m.any():
            ax.annotate(f"f={f_score:0.1f}", xy=(0.9, min(y[45], 1.0) + 0.02),
                        alpha=0.4, fontsize=8)
    order = np.argsort(rcs)
    ax.plot(rcs[order], prs[order], linewidth=3, label=label)
    ax.grid(True)
    ax.set_xlim(0.0, 1.0)
    ax.set_ylim(0.0, 1.0)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.legend(loc=3)
    ax.set_title(f"PR Curve for APH (AP$^H$={aph:.1f}, F$^H$={fh:.3f})")
    png_path = os.path.join(out_dir, "aph_pr.png")
    fig.savefig(png_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return {"aph": aph, "fh": fh, "png": png_path, "npz": npz_path}
