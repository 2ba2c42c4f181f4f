"""GT depth completion for glass regions.

The port's copy of `gwdepth_tpu.tools.depth_completion`: the same functions, the
same outputs, on the host.

Vectorized numpy re-derivation of the reference's offline toolchain
(reference: depth_interpolation/depth_interpolation.py): consumer depth
cameras return holes/garbage on glass, so the ground-truth depth inside
each labeled glass polygon is reconstructed from the (reliable) depth at
the polygon's frame vertices:

 1. deproject the polygon vertices to 3D with the pinhole intrinsics
    (the reference calls pyrealsense2 `rs2_deproject_pixel_to_point`,
    depth_interpolation.py:382-395 — plain pinhole math here);
 2. walk each polygon side in fixed metric steps, linearly interpolating
    3D positions between consecutive vertices
    (inline_points_interpolation, :397-420, default step 6 mm);
 3. project the side samples back to pixels (:389-395);
 4. fill the interior by horizontal scanline interpolation between the
    side crossings, done in both sweep directions and fused with
    "first non-zero wins, average on overlap"
    (interpolate_region_depth_bylines + fuse_region_depth, :303-321);
 5. write the completed region back into the raw depth map (:315-321).

The reference's per-pixel python loops, scipy interp2d calls, and
multiprocessing folder walker collapse into array ops; behavior (metric
side stepping, both-direction sweep fusion, millimeter output) is kept.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole camera model (reference: read_camera_intrin,
    depth_interpolation.py:365-380)."""
    fx: float
    fy: float
    ppx: float
    ppy: float
    width: int = 1280
    height: int = 720

    @classmethod
    def from_json(cls, path: str) -> "Intrinsics":
        with open(path) as f:
            d = json.load(f)
        return cls(fx=d["fx"], fy=d["fy"], ppx=d["ppx"], ppy=d["ppy"],
                   width=d.get("width", 1280), height=d.get("height", 720))


def deproject(pixels: np.ndarray, depths_m: np.ndarray,
              intr: Intrinsics) -> np.ndarray:
    """(N, 2) pixel (x, y) + (N,) depth meters -> (N, 3) camera-space
    points (rs2_deproject_pixel_to_point equivalent)."""
    x = (pixels[:, 0] - intr.ppx) / intr.fx * depths_m
    y = (pixels[:, 1] - intr.ppy) / intr.fy * depths_m
    return np.stack([x, y, depths_m], axis=1)


def project(points: np.ndarray, intr: Intrinsics) -> np.ndarray:
    """(N, 3) camera-space -> (N, 2) pixel coords
    (rs2_project_point_to_pixel equivalent)."""
    z = np.maximum(points[:, 2], 1e-9)
    u = points[:, 0] / z * intr.fx + intr.ppx
    v = points[:, 1] / z * intr.fy + intr.ppy
    return np.stack([u, v], axis=1)


def interpolate_side_points(p1: np.ndarray, p2: np.ndarray,
                            step_mm: float = 6.0) -> np.ndarray:
    """3D samples between two 3D points (meters) at the reference's exact
    placement: one sample every `step_mm` of 3D distance starting 1 mm
    from p1 (inline_points_interpolation walks inc = 1, 1+step, ... along
    the direction cosines, endpoints appended separately by
    calculate_sides_depth — reference: depth_interpolation.py:397-420,
    121-145).  Endpoints included here."""
    diff = p2 - p1
    dist_mm = float(np.linalg.norm(diff)) * 1000.0
    if dist_mm <= 0.0:
        return np.stack([p1, p2])
    unit = diff / (dist_mm / 1000.0)            # direction, per-mm in meters
    incs = np.arange(1, int(dist_mm), step_mm, dtype=np.float64)
    inner = p1[None] + incs[:, None] * (unit[None] / 1000.0)
    return np.concatenate([p1[None], inner, p2[None]], axis=0)


def _scanline_fill(h: int, w: int, side_px: np.ndarray, side_depth: np.ndarray,
                   mask: np.ndarray) -> np.ndarray:
    """Fill `mask` rows by interpolating depth between the side samples
    crossing each row (the reference's by-lines sweep, :303-314).
    side_px: (N, 2) float pixels; side_depth: (N,) meters."""
    out = np.zeros((h, w), np.float32)
    cols = np.clip(np.round(side_px[:, 0]).astype(int), 0, w - 1)
    rows = np.clip(np.round(side_px[:, 1]).astype(int), 0, h - 1)
    for r in np.unique(rows):
        on_row = rows == r
        if on_row.sum() < 1:
            continue
        c = cols[on_row]
        d = side_depth[on_row]
        order = np.argsort(c)
        c, d = c[order], d[order]
        # average duplicate columns (reference averages on overlap)
        uc, inv = np.unique(c, return_inverse=True)
        ud = np.zeros(len(uc))
        cnt = np.zeros(len(uc))
        np.add.at(ud, inv, d)
        np.add.at(cnt, inv, 1)
        ud /= cnt
        row_mask = mask[r]
        xs = np.nonzero(row_mask)[0]
        if len(xs) == 0:
            continue
        if len(uc) == 1:
            # a single crossing cannot define a row gradient — write only
            # the sample itself; the vertical pass closes the rest
            sel = xs[np.abs(xs - uc[0]) <= 1]
            out[r, sel] = ud[0]
            continue
        # interpolate ONLY within the crossing span: np.interp's clamped
        # extrapolation would paint a flat (wrong-for-slanted-panes) value
        # over interior pixels the row's samples don't bracket (e.g. rows
        # crossed by a near-horizontal edge whose samples stop mid-row);
        # the vertical pass closes what's left (interior-fill oracle test)
        span = xs[(xs >= uc[0]) & (xs <= uc[-1])]
        out[r, span] = np.interp(span, uc, ud)
    return out


def _fill_column_gaps(fill: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Interpolate zero rows inside the mask along each column from the
    filled rows above/below."""
    h, w = fill.shape
    out = fill.copy()
    for c in range(w):
        col_mask = mask[:, c]
        if not col_mask.any():
            continue
        ys = np.nonzero(col_mask)[0]
        src = np.nonzero(fill[:, c] > 0)[0]
        if len(src) == 0:
            continue
        # within-span only (same no-flat-extrapolation rule as the row
        # pass); a final cleanup handles the unbracketed leftovers
        ys = ys[(ys >= src[0]) & (ys <= src[-1])]
        out[ys, c] = np.interp(ys, src, fill[src, c])
    # leftover zeros inside the mask (pixels no row/column span brackets,
    # only near corners): row-interpolate from the now-dense fill
    rest_r, rest_c = np.nonzero(mask & (out <= 0))
    for r in np.unique(rest_r):
        src = np.nonzero(out[r] > 0)[0]
        if len(src) < 2:
            continue
        cs = rest_c[rest_r == r]
        out[r, cs] = np.interp(cs, src, out[r, src])
    return out


def polygon_mask(vertices: np.ndarray, h: int, w: int) -> np.ndarray:
    """(V, 2) pixel polygon -> (h, w) bool inclusion mask (even-odd rule,
    the reference uses matplotlib-path-style inclusion via within_poly)."""
    from PIL import Image, ImageDraw
    img = Image.new("1", (w, h), 0)
    ImageDraw.Draw(img).polygon(
        [(float(x), float(y)) for x, y in vertices], fill=1)
    return np.asarray(img, bool)


def complete_polygon_depth(raw_depth_mm: np.ndarray, vertices: np.ndarray,
                           intr: Intrinsics, step_mm: float = 6.0,
                           vertex_depth_mm: Optional[np.ndarray] = None
                           ) -> np.ndarray:
    """Reconstruct depth inside one glass polygon. Returns a copy of
    `raw_depth_mm` with the polygon region replaced by interpolated values
    (millimeters, like the stored GT pngs)."""
    h, w = raw_depth_mm.shape
    verts = np.asarray(vertices, np.float64)
    if vertex_depth_mm is None:
        vx = np.clip(np.round(verts[:, 0]).astype(int), 0, w - 1)
        vy = np.clip(np.round(verts[:, 1]).astype(int), 0, h - 1)
        vertex_depth_mm = raw_depth_mm[vy, vx].astype(np.float64)
    pts3d = deproject(verts, vertex_depth_mm / 1000.0, intr)

    # sample all sides in 3D, project back
    side_px, side_d = [], []
    V = len(verts)
    for i in range(V):
        seg = interpolate_side_points(pts3d[i], pts3d[(i + 1) % V], step_mm)
        side_px.append(project(seg, intr))
        side_d.append(seg[:, 2])
    side_px = np.concatenate(side_px)
    side_d = np.concatenate(side_d)

    mask = polygon_mask(verts, h, w)
    # Interpolate in INVERSE depth: for a planar pane 1/Z is affine in
    # pixel coords, so linear scanline interpolation of disparity is
    # EXACT where the reference's 3D chord walk (calculate_region_depth,
    # :168-206) is also exact — linear-in-Z interpolation carries a
    # reciprocal-curvature error (measured 30 mm RMSE on a 0.25-slope
    # pane vs 0.4 mm for the reference; disparity interpolation matches
    # it — tests/test_reference_parity_toolchain.py interior-fill oracle).
    side_disp = np.where(side_d > 0, 1.0 / np.maximum(side_d, 1e-9), 0.0)
    # both sweep directions, fused first-nonzero-wins (fuse_region_depth)
    fill_a = _scanline_fill(h, w, side_px, side_disp, mask)
    fill_b = _scanline_fill(h, w, side_px[::-1], side_disp[::-1], mask)
    fill = np.where(fill_a > 0, fill_a, fill_b)
    # the 3D side stepping can skip pixel rows (6mm ≈ several px at range);
    # close the gaps with a vertical interpolation pass per column — the
    # reference's scattered-point interp2d has the same effect (:216-234)
    fill = _fill_column_gaps(fill, mask)
    fill = np.where(fill > 0, 1.0 / np.maximum(fill, 1e-9), 0.0)

    out = raw_depth_mm.astype(np.float32).copy()
    write = mask & (fill > 0)
    out[write] = fill[write] * 1000.0
    return out


def complete_depth(raw_depth_mm: np.ndarray, label: Dict,
                   intr: Intrinsics, step_mm: float = 6.0) -> np.ndarray:
    """Complete every labeled polygon of one image
    (the original's per-image loop: depth_completion, :600-700)."""
    out = raw_depth_mm.astype(np.float32).copy()
    for shape in label.get("shapes", []):
        pts = shape.get("points", [])
        if len(pts) >= 3:
            out = complete_polygon_depth(out, np.asarray(pts, np.float64),
                                         intr, step_mm)
    return out


def compare_depth_preds(pred_mm: np.ndarray, gt_mm: np.ndarray,
                        min_mm: float = 1.0, max_mm: float = 10000.0) -> Dict:
    """Offline RMSE/MAE comparison of saved depth predictions vs GT
    (reference: depth_interpolation/depth_pred_comparison.py). Inputs in
    millimeters; invalid GT (outside [min, max]) excluded."""
    valid = (gt_mm > min_mm) & (gt_mm < max_mm)
    if not valid.any():
        return {"rmse_mm": float("nan"), "mae_mm": float("nan"),
                "valid_frac": 0.0}
    d = pred_mm[valid].astype(np.float64) - gt_mm[valid].astype(np.float64)
    return {"rmse_mm": float(np.sqrt((d ** 2).mean())),
            "mae_mm": float(np.abs(d).mean()),
            "valid_frac": float(valid.mean())}
