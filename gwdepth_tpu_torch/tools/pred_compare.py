"""Offline prediction-set comparison + no-GT eval listing.

The port's copy of `gwdepth_tpu.tools.pred_compare`: the same functions, the
same outputs, on the host.

Port of the reference's offline comparison tail (SURVEY.md §2.7):

- `compare_depth_predictions` — the working core of
  `depth_interpolation/depth_pred_comparison.py:43-132` (`all_works_depth`):
  given saved per-image depth predictions from N methods (``.npy`` in
  meters, the contract `gwdepth_tpu_torch.predict` writes) and a GT directory of
  16-bit mm PNGs, nearest-resize GT (and every other method) onto the first
  method's grid, compute per-image RMSE per method, append the reference's
  ``rmse_log.txt`` line format, and save JET-colormapped depth and
  abs-error visualizations per method.  cv2/torch-free: the nearest resize
  reproduces torch `interpolate(mode='nearest')` index math
  (`depth_pred_comparison.py:24-28`) and the colormap reproduces
  `cv2.convertScaleAbs(d*1000, alpha=0.0255)` + COLORMAP_JET
  (`depth_pred_comparison.py:11-17`) via matplotlib's jet ramp.
- `id_to_image` — `depth_interpolation/eval_wogt.py:4-20` verbatim
  semantics: index->filename json + ``eval_nogt_{N}.txt`` name list for
  running eval on unlabeled capture folders.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
from PIL import Image


def _cmap(name: str):
    """matplotlib's colormap `name` (`matplotlib.colormaps`, which
    outlives `cm.get_cmap`)."""
    import matplotlib
    return matplotlib.colormaps[name]


def compute_rmse(gt: np.ndarray, pred: np.ndarray) -> float:
    """RMSE over the full map (depth_pred_comparison.py:19-22 — the
    reference does NOT mask invalid GT here; kept)."""
    return float(np.sqrt(((gt - pred) ** 2).mean()))


def resize_nearest(depth: np.ndarray, h: int, w: int) -> np.ndarray:
    """torch `interpolate(mode='nearest')` equivalent: output pixel (i, j)
    reads input (floor(i*H/h), floor(j*W/w)) (depth_pred_comparison.py:24-28
    `resize_by_torch`)."""
    H, W = depth.shape[-2], depth.shape[-1]
    yi = np.minimum((np.arange(h) * (H / h)).astype(np.int64), H - 1)
    xi = np.minimum((np.arange(w) * (W / w)).astype(np.int64), W - 1)
    return depth[..., yi[:, None], xi[None, :]]


def vis_depth_jet(depth_m: np.ndarray, alpha: float = 0.0255) -> np.ndarray:
    """(H, W) meters -> (H, W, 3) uint8 RGB, reproducing
    `cv2.applyColorMap(cv2.convertScaleAbs(d*1000, alpha=a), JET)`
    (depth_pred_comparison.py:11-17; alpha=0.0255 spans 0-10 m)."""
    idx = np.clip(np.rint(np.abs(depth_m * 1000.0) * alpha), 0, 255)
    lut = (_cmap("jet")(np.arange(256) / 255.0)[:, :3] * 255)
    return lut.astype(np.uint8)[idx.astype(np.int64)]


def _load_gt_png(path: str) -> np.ndarray:
    """16-bit mm PNG -> float32 mm (cv2.IMREAD_UNCHANGED equivalent)."""
    return np.asarray(Image.open(path), dtype=np.float32)


def compare_depth_predictions(pred_dirs: Mapping[str, str], gt_dir: str,
                              save_dir: str, e_max: float = 3.0,
                              cmap: str = "jet",
                              save_vis: bool = True) -> Dict[str, float]:
    """Compare N saved prediction sets against GT.

    pred_dirs: {method_name: dir of per-image ``<name>.npy`` depth in
    meters} — the first entry is the anchor whose file list and resolution
    drive the comparison (the reference anchors on `ours`,
    depth_pred_comparison.py:78-96). gt_dir holds ``<name>.png`` 16-bit mm.

    Writes into save_dir: ``rmse_log.txt`` (one reference-format line per
    image: ``name, m1:x.xxx, m2:y.yyy``), per-method JET depth PNGs under
    ``<method>/``, a ``gt/`` set, and abs-error maps under
    ``<method>/error-em{e_max}-{cmap}/`` clipped to [0, e_max] with GT<1mm
    or >10m zeroed (depth_pred_comparison.py:118-130).

    Returns {method: mean RMSE over the compared images}.
    """
    methods = list(pred_dirs)
    if not methods:
        raise ValueError("pred_dirs is empty")
    os.makedirs(save_dir, exist_ok=True)
    for m in methods + ["gt"]:
        os.makedirs(os.path.join(save_dir, m), exist_ok=True)
        if m != "gt":
            os.makedirs(os.path.join(
                save_dir, m, f"error-em{e_max}-{cmap}"), exist_ok=True)

    anchor = methods[0]
    rmse_sums = {m: 0.0 for m in methods}
    n = 0
    log_path = os.path.join(save_dir, "rmse_log.txt")
    for npy_path in sorted(glob.glob(
            os.path.join(pred_dirs[anchor], "*.npy"))):
        name = os.path.splitext(os.path.basename(npy_path))[0]
        gt_png = os.path.join(gt_dir, name + ".png")
        if not os.path.exists(gt_png):
            continue
        depths = {}
        skip = False
        for m in methods:
            p = os.path.join(pred_dirs[m], name + ".npy")
            if not os.path.exists(p):
                skip = True
                break
            depths[m] = np.load(p).astype(np.float32)
        if skip:
            continue
        h, w = depths[anchor].shape
        gt_m = resize_nearest(_load_gt_png(gt_png), h, w) / 1000.0
        for m in methods:
            if depths[m].shape != (h, w):
                depths[m] = resize_nearest(depths[m], h, w)
        rmses = {m: compute_rmse(gt_m, depths[m]) for m in methods}
        for m in methods:
            rmse_sums[m] += rmses[m]
        n += 1
        with open(log_path, "a+") as f:
            f.write(name + ", " + ", ".join(
                f"{m}:{rmses[m]:2.3f}" for m in methods) + "\n")

        if save_vis:
            Image.fromarray(vis_depth_jet(gt_m)).save(
                os.path.join(save_dir, "gt", name + ".png"))
            lut = (_cmap(cmap)(np.arange(256) / 255.0)[:, :3]
                   * 255).astype(np.uint8)
            for m in methods:
                Image.fromarray(vis_depth_jet(depths[m])).save(
                    os.path.join(save_dir, m, name + ".png"))
                err = np.abs(depths[m] - gt_m)
                err[(gt_m < 0.001) | (gt_m > 10.0)] = 0.0
                idx = np.clip(err / max(e_max, 1e-9) * 255, 0,
                              255).astype(np.int64)
                Image.fromarray(lut[idx]).save(os.path.join(
                    save_dir, m, f"error-em{e_max}-{cmap}",
                    name + ".png"))
    return {m: (rmse_sums[m] / n if n else float("nan")) for m in methods}


def id_to_image(img_dir: str, save_file: str,
                names: Optional[list] = None) -> str:
    """No-GT eval listing (eval_wogt.py:4-20): {index: filename} json +
    ``eval_nogt_{N}.txt`` of extension-less names beside it. Returns the
    txt path. `names` overrides os.listdir for deterministic tests."""
    img_names = sorted(os.listdir(img_dir)) if names is None else list(names)
    map_dict = {i: v for i, v in enumerate(img_names)}
    assert len(img_names) == len(map_dict)
    os.makedirs(os.path.dirname(save_file) or ".", exist_ok=True)
    with open(save_file, "w") as f:
        json.dump(map_dict, f)
    im_names = [im.split(".")[0] for im in img_names]
    save_im = os.path.join(os.path.dirname(save_file),
                           f"eval_nogt_{len(im_names)}.txt")
    with open(save_im, "w+") as f:
        for im in im_names:
            f.write(im + "\n")
    return save_im
