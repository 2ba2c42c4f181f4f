"""Joint augmentations of image, lines, centers, depth and seg: the port's
copy of `gwdepth_tpu.data.transforms`. `resize`, `color_jitter` and
`normalize` call the native loader's entries (`gwdepth_tpu_torch.native`)
where the JAX package calls its own, and take the PIL/numpy path where
the library is unavailable or GWDEPTH_NO_NATIVE is set; both paths give
the same bytes (tests/test_torch_native_loader.py).

Eval: resize the long side to `test_size` (PIL bilinear for the image,
PIL NEAREST index replay for the depth/seg maps), scale down to fit the
static canvas if needed, then normalize with the GW-Depth channel stats
and map line coordinates to [0, 1].

Train (`train_transform`): a random h- or v-flip, a multi-scale resize or
a resize-crop-resize, ColorJitter(0.4) in a random order, fit to the
canvas, normalize. Every random draw comes from the caller's
`random.Random`, in the JAX package's order, so one seed gives the same
sample in both packages.

- crop drops lines fully outside and clamps partly-outside lines along
  their slope; polygon centers are recomputed from the surviving lines,
  or, when at most 3 lines of a polygon survive, from the intersection of
  the crop rectangle with the original polygon (shapely, where installed).
- hflip swaps endpoint order so the left point stays first; vflip
  re-orders only vertical lines.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance

from gwdepth_tpu_torch import native

# GW-Depth channel stats
MEAN = np.array([0.538, 0.494, 0.453], np.float32)
STD = np.array([0.257, 0.263, 0.273], np.float32)


@dataclasses.dataclass
class Sample:
    """image: PIL (until normalize) | float32 HWC; depth: (H, W) float32;
    seg: (H, W) uint8/int; lines: (N, 4) [x1 y1 x2 y2] pixels; centers:
    (N, 2) pixels; poly_ids: (N,) int."""
    image: object
    depth: np.ndarray
    seg: np.ndarray
    lines: np.ndarray
    centers: np.ndarray
    poly_ids: np.ndarray

    def copy(self) -> "Sample":
        return Sample(self.image, self.depth.copy(), self.seg.copy(),
                      self.lines.copy(), self.centers.copy(),
                      self.poly_ids.copy())


def centroid(points: Sequence[Sequence[float]]) -> Tuple[float, float]:
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    return sum(xs) / len(xs), sum(ys) / len(ys)


def polygon_points(lines: np.ndarray) -> List[List[float]]:
    """Vertices of a closed line loop: the first line's two endpoints,
    then every later line's second endpoint."""
    pts = [list(lines[0][:2]), list(lines[0][2:4])]
    pts += [list(l[2:4]) for l in lines[1:]]
    return pts


# ---------------------------------------------------------------------------
# geometric ops
# ---------------------------------------------------------------------------

def hflip(s: Sample) -> Sample:
    s = s.copy()
    w = s.image.size[0]
    s.image = s.image.transpose(Image.FLIP_LEFT_RIGHT)
    s.depth = s.depth[:, ::-1].copy()
    s.seg = s.seg[:, ::-1].copy()
    if len(s.lines):
        s.lines = s.lines[:, [2, 3, 0, 1]] * np.array([-1, 1, -1, 1]) \
            + np.array([w, 0, w, 0])
        s.centers = s.centers * np.array([-1, 1]) + np.array([w, 0])
    return s


def vflip(s: Sample) -> Sample:
    s = s.copy()
    h = s.image.size[1]
    s.image = s.image.transpose(Image.FLIP_TOP_BOTTOM)
    s.depth = s.depth[::-1].copy()
    s.seg = s.seg[::-1].copy()
    if len(s.lines):
        lines = s.lines * np.array([1, -1, 1, -1]) + np.array([0, h, 0, h])
        vert = lines[:, 0] == lines[:, 2]
        lines[vert] = lines[vert][:, [2, 3, 0, 1]]
        s.lines = lines
        s.centers = s.centers * np.array([1, -1]) + np.array([0, h])
    return s


def _get_resize_hw(wh: Tuple[int, int], size, max_size=None) -> Tuple[int, int]:
    if isinstance(size, (list, tuple)):
        return size[1], size[0]
    w, h = wh
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def _pil_nearest_idx(n_in: int, n_out: int) -> np.ndarray:
    """Source indices PIL NEAREST picks: start at scale*0.5, advance by
    sequential double addition, truncate."""
    a = n_in / n_out
    steps = np.full(n_out, a, np.float64)
    steps[0] = a * 0.5
    return np.clip(np.add.accumulate(steps).astype(np.int64), 0, n_in - 1)


def resize(s: Sample, size, max_size=None) -> Sample:
    s = s.copy()
    oh, ow = _get_resize_hw(s.image.size, size, max_size)
    w0, h0 = s.image.size
    img = None
    if s.image.mode == "RGB":
        img = native.resize_bilinear_rgb8(np.asarray(s.image), oh, ow)
    s.image = (Image.fromarray(img) if img is not None
               else s.image.resize((ow, oh), Image.BILINEAR))
    rw, rh = ow / w0, oh / h0
    if len(s.lines):
        s.lines = s.lines * np.array([rw, rh, rw, rh])
        s.centers = s.centers * np.array([rw, rh])
    yi = _pil_nearest_idx(h0, oh)
    xi = _pil_nearest_idx(w0, ow)
    s.depth = np.ascontiguousarray(s.depth[yi][:, xi])
    s.seg = np.ascontiguousarray(s.seg[yi][:, xi])
    return s


def _clamp_line(x1, y1, x2, y2, h, w):
    """Clamp one line into [0, w] x [0, h] along its slope."""
    slope = (y2 - y1) / (x2 - x1 + 1e-12)
    if x1 < 0:
        x1 = 0.0
        y1 = y2 + (x1 - x2) * slope
    if y1 < 0:
        y1 = 0.0
        x1 = x2 - (y2 - y1) / slope
    if x2 > w:
        x2 = float(w)
        y2 = y1 + (x2 - x1) * slope
    if y2 > h:
        y2 = float(h)
        x2 = x1 + (y2 - y1) / slope
    if x2 < 0:
        x2 = 0.0
        y2 = y1 + (x2 - x1) * slope
    if y2 < 0:
        y2 = 0.0
        x2 = x1 - (y1 - y2) / slope
    if x1 > w:
        x1 = float(w)
        y1 = y2 + (x1 - x2) * slope
    if y1 > h:
        y1 = float(h)
        x1 = x2 + (y1 - y2) / slope
    return [x1, y1, x2, y2]


def _crop_centroid(src_loop, crop_box):
    """Centroid of the crop rectangle's intersection with the original
    polygon, in crop coordinates; None when shapely is absent or the
    intersection is not one polygon."""
    try:
        from shapely.geometry import Polygon
    except ImportError:
        return None
    i, j, h, w = crop_box
    rect = Polygon([(j, i), (j, i + h - 1), (j + w - 1, i + h - 1),
                    (j + w - 1, i)])
    try:
        inter = rect.intersection(Polygon(src_loop))
    except Exception:   # a degenerate loop: the line centroid, as in JAX
        return None
    if inter.geom_type != "Polygon" or inter.is_empty \
            or len(inter.exterior.coords) <= 1:
        return None
    cx, cy = centroid(list(inter.exterior.coords))
    return np.clip([cx - j, cy - i], 0, [w, h])


def crop(s: Sample, top: int, left: int, h: int, w: int) -> Sample:
    s = s.copy()
    i, j = top, left
    s.image = s.image.crop((j, i, j + w, i + h))
    s.depth = s.depth[i:i + h, j:j + w]
    s.seg = s.seg[i:i + h, j:j + w]
    if not len(s.lines):
        return s

    src_lines = s.lines.copy()
    src_ids = s.poly_ids.copy()
    lines = s.lines - np.array([j, i, j, i], np.float64)
    rm_x = ((lines[:, 0] < 0) & (lines[:, 2] < 0)) | \
           ((lines[:, 0] > w) & (lines[:, 2] > w))
    rm_y = ((lines[:, 1] < 0) & (lines[:, 3] < 0)) | \
           ((lines[:, 1] > h) & (lines[:, 3] > h))
    keep = ~(rm_x | rm_y)
    lines = lines[keep]
    clamped = np.zeros_like(lines)
    for n, (x1, y1, x2, y2) in enumerate(lines):
        clamped[n] = _clamp_line(x1, y1, x2, y2, h, w)
    clamped[:, 0::2] = clamped[:, 0::2].clip(0, w)
    clamped[:, 1::2] = clamped[:, 1::2].clip(0, h)

    ids = s.poly_ids[keep]
    centers = np.zeros((keep.sum(), 2))
    # a prior hflip shows in the endpoint order of the first two lines
    hflipped = (len(src_lines) > 1
                and src_lines[0, 0] == src_lines[1, 2]
                and src_lines[0, 1] == src_lines[1, 3])

    def loop_points(ls):
        ls = ls.reshape(-1, 2, 2)[:, ::-1].reshape(-1, 4) if hflipped else ls
        return polygon_points(ls)

    for pid in np.unique(ids):
        sel = ids == pid
        py_lines = clamped[sel]
        new_c = None
        if sel.sum() <= 3:
            new_c = _crop_centroid(loop_points(src_lines[src_ids == pid]),
                                   (i, j, h, w))
        centers[sel] = (new_c if new_c is not None
                        else centroid(loop_points(py_lines)))

    s.lines = clamped
    s.centers = centers
    s.poly_ids = ids
    return s


# ---------------------------------------------------------------------------
# photometric ops
# ---------------------------------------------------------------------------

def adjust_hue(img: Image.Image, factor: float,
               shift: int = None) -> Image.Image:
    """Hue rotation through the HSV channel; `shift` (integer uint8 steps)
    takes precedence over `factor` when given."""
    if img.mode != "RGB":
        return img
    if shift is None:
        shift = int(factor * 255)
    h, sat, v = img.convert("HSV").split()
    np_h = (np.asarray(h, np.uint8).astype(np.int16) + shift) % 256
    h = Image.fromarray(np_h.astype(np.uint8), "L")
    return Image.merge("HSV", (h, sat, v)).convert("RGB")


def color_jitter(img: Image.Image, rng: random.Random,
                 strength: float = 0.4) -> Image.Image:
    """Brightness/contrast/saturation/hue in a random order, factors
    U(1-s, 1+s), hue shift U(-s, s) * 255 steps; the native entry where
    it runs, else PIL, with the same draws on both paths."""
    ops = list(range(4))
    rng.shuffle(ops)
    factors = []
    for op in ops:
        f = rng.uniform(1 - strength, 1 + strength)
        factors.append(int(rng.uniform(-strength, strength) * 255)
                       if op == 3 else f)
    if img.mode == "RGB":
        out = native.color_jitter(np.asarray(img), ops, factors)
        if out is not None:
            return Image.fromarray(out)
    for op, f in zip(ops, factors):
        if op == 0:
            img = ImageEnhance.Brightness(img).enhance(f)
        elif op == 1:
            img = ImageEnhance.Contrast(img).enhance(f)
        elif op == 2:
            img = ImageEnhance.Color(img).enhance(f)
        else:
            img = adjust_hue(img, 0.0, shift=f)
    return img


def normalize(s: Sample) -> Sample:
    """To float, channel-normalize, coords -> [0, 1]."""
    s = s.copy()
    img = None
    if getattr(s.image, "mode", None) == "RGB":
        u8 = np.asarray(s.image)
        img = native.normalize_pad(u8, u8.shape[:2], MEAN, STD)
    if img is None:
        img = np.asarray(s.image, np.float32) / 255.0
        img = (img - MEAN) / STD
    h, w = img.shape[:2]
    s.image = img
    if len(s.lines):
        s.lines = s.lines / np.array([w, h, w, h], np.float64)
        s.centers = s.centers / np.array([w, h], np.float64)
    return s


def fit_canvas(s: Sample, canvas_hw: Tuple[int, int]) -> Sample:
    """Scale down (only) so the image fits the canvas."""
    w, h = s.image.size
    ch, cw = canvas_hw
    scale = min(ch / h, cw / w, 1.0)
    if scale < 1.0:
        return resize(s, (max(1, int(w * scale)), max(1, int(h * scale))))
    return s


TRAIN_SCALES = (480, 512, 544, 576, 608, 640, 672, 680, 690, 704,
                736, 768, 788, 800)


def train_transform(s: Sample, rng: random.Random,
                    canvas_hw: Tuple[int, int],
                    max_size: int = 1024) -> Sample:
    if rng.random() < 0.5:
        s = hflip(s) if rng.random() < 0.5 else s
    else:
        s = vflip(s) if rng.random() < 0.5 else s

    if rng.random() < 0.5:
        s = resize(s, rng.choice(TRAIN_SCALES), max_size)
    else:
        s = resize(s, rng.choice((400, 500, 600)))
        w, h = s.image.size
        cw = rng.randint(384, min(w, 600))
        ch = rng.randint(384, min(h, 600))
        top = rng.randint(0, h - ch)
        left = rng.randint(0, w - cw)
        s = crop(s, top, left, ch, cw)
        s = resize(s, rng.choice(TRAIN_SCALES), max_size)

    s.image = color_jitter(s.image, rng)
    s = fit_canvas(s, canvas_hw)
    return normalize(s)


def eval_transform(s: Sample, canvas_hw: Tuple[int, int],
                   test_size: int = 1024, max_size: int = 1024,
                   strict_protocol: bool = True) -> Sample:
    """Long side to `test_size`, fitted onto the canvas, normalized.
    `strict_protocol` rejects a portrait image on a landscape canvas (and
    vice versa) that would silently shrink below the protocol size."""
    s = resize(s, test_size, max_size)
    if strict_protocol:
        w, h = s.image.size
        ch, cw = canvas_hw
        if (h > ch or w > cw) and (h > w) != (ch > cw):
            raise ValueError(
                f"eval canvas (h, w)={canvas_hw} cannot hold the "
                f"protocol-resized image (h, w)=({h}, {w}); use a canvas "
                f"that fits the long-side-{test_size} resize, e.g. "
                f"--eval_h {h} --eval_w {w}")
    s = fit_canvas(s, canvas_hw)
    return normalize(s)
