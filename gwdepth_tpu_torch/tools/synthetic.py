"""Synthetic GW-Depth-format scene generator (numpy only).

The port's copy of `gwdepth_tpu.tools.synthetic`: the same scenes for the
same seed. It writes structured glass-wall scenes in the on-disk format
the dataset reads (rgb png / uint16-mm depth png / seg png / labelme
polygon json / name lists / glassrgbd_images.json), so the train and eval
CLI runs end to end without the real dataset:

  * background: textured wall/floor with a smooth depth gradient,
  * 1-3 quadrilateral glass panels per image, each marked by a dark frame,
    a brightness tint and diagonal reflection streaks,
  * panel depth: a random plane strictly in front of the background,
  * sensor-like zero-depth holes.

Usage:
    python -m gwdepth_tpu_torch.tools.synthetic --root /tmp/ds \
        --n_train 64 --n_val 16 [--height 720 --width 1280] [--seed 0]
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

__all__ = ["generate_scene", "generate_dataset"]


def _panel_quad(rng, H, W) -> np.ndarray:
    """Random convex quadrilateral (a perspective-skewed rectangle)."""
    pw = rng.uniform(0.18, 0.38) * W
    ph = rng.uniform(0.3, 0.6) * H
    x0 = rng.uniform(0.02 * W, W - pw - 0.02 * W)
    y0 = rng.uniform(0.05 * H, H - ph - 0.05 * H)
    quad = np.array([[x0, y0], [x0 + pw, y0],
                     [x0 + pw, y0 + ph], [x0, y0 + ph]], np.float64)
    # skew each corner a little, preserving convexity by bounding it
    quad += rng.uniform(-1, 1, (4, 2)) * [0.04 * pw, 0.04 * ph]
    return quad


def _quad_mask(quad: np.ndarray, H: int, W: int) -> np.ndarray:
    """Rasterize a convex quad (half-plane intersection, CCW or CW)."""
    yy, xx = np.mgrid[0:H, 0:W]
    yy = yy + 0.5
    xx = xx + 0.5
    inside = np.ones((H, W), bool)
    crosses = []
    for i in range(4):
        ax, ay = quad[i]
        bx, by = quad[(i + 1) % 4]
        crosses.append((bx - ax) * (yy - ay) - (by - ay) * (xx - ax))
    area2 = 0.0
    for i in range(4):
        ax, ay = quad[i]
        bx, by = quad[(i + 1) % 4]
        area2 += ax * by - bx * ay
    sign = 1.0 if area2 > 0 else -1.0
    for c in crosses:
        inside &= (sign * c) >= 0
    return inside


def generate_scene(rng: np.random.Generator, H: int, W: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[dict]]:
    """One scene -> (rgb uint8 (H,W,3), depth_mm uint16, seg uint8,
    labelme shapes)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    # --- background: wall gradient + low-frequency texture
    base = rng.uniform(90, 160, 3).astype(np.float32)
    tex = (np.sin(xx / rng.uniform(25, 70)) *
           np.cos(yy / rng.uniform(25, 70)))
    rgb = base[None, None] + tex[..., None] * rng.uniform(8, 25) \
        + rng.normal(0, 4, (H, W, 3))
    depth = (rng.uniform(4.0, 7.5)
             + (yy / H) * rng.uniform(1.0, 2.5)
             + (xx / W) * rng.uniform(-0.8, 0.8))        # meters
    # keep every valid pixel below max_depth (10 m): deeper pixels are
    # masked out of the SiLog loss and excluded at eval
    np.clip(depth, None, 9.5, out=depth)

    seg = np.zeros((H, W), np.uint8)
    shapes = []
    for pid in range(int(rng.integers(1, 4))):
        quad = _panel_quad(rng, H, W)
        mask = _quad_mask(quad, H, W)
        if mask.sum() < 500:
            continue
        # panel depth: a plane strictly in front of the local background
        d0 = rng.uniform(0.8, 3.2)
        plane = (d0 + (yy - quad[:, 1].mean()) / H * rng.uniform(-0.5, 0.5)
                 + (xx - quad[:, 0].mean()) / W * rng.uniform(-0.5, 0.5))
        depth = np.where(mask, np.minimum(plane, depth - 0.3), depth)
        seg[mask] = 1

        # glass look: brightness tint + diagonal reflection streaks
        tint = rng.uniform(0.75, 0.9)
        streak = (np.sin((xx + yy) / rng.uniform(9, 22)) >
                  rng.uniform(0.75, 0.95))
        rgb = np.where(mask[..., None], rgb * tint, rgb)
        rgb = np.where((mask & streak)[..., None],
                       np.minimum(rgb + rng.uniform(50, 90), 255), rgb)

        # dark frame along the borders (the line-detection cue)
        frame = np.zeros((H, W), bool)
        for i in range(4):
            a, b = quad[i], quad[(i + 1) % 4]
            n = int(np.hypot(*(b - a))) + 1
            t = np.linspace(0, 1, 2 * n)[:, None]
            pts = a[None] + t * (b - a)[None]
            px = np.clip(pts[:, 0].astype(int), 0, W - 1)
            py = np.clip(pts[:, 1].astype(int), 0, H - 1)
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    frame[np.clip(py + dy, 0, H - 1),
                          np.clip(px + dx, 0, W - 1)] = True
        rgb = np.where(frame[..., None], rgb * 0.25, rgb)

        shapes.append({"points": quad.tolist(), "poly_id": pid,
                       "label": "wall"})

    # sensor-like holes (zero depth = invalid)
    holes = rng.random((H, W)) < 0.02
    depth_mm = np.where(holes, 0, np.round(depth * 1000.0)).astype(np.uint16)
    rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
    return rgb8, depth_mm, seg, shapes


def generate_dataset(root: str, n_train: int, n_val: int,
                     height: int = 720, width: int = 1280,
                     seed: int = 0) -> List[str]:
    """Write a complete dataset under `root`; returns all image names.
    Directory layout mirrors what recipes/*.sh pass to the CLI."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for d in ("rgb", "depth", "seg", "lines"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names: List[str] = []
    images_json = []
    splits = [("train", n_train), ("val", n_val)]
    for split, count in splits:
        split_names = []
        for _ in range(count):
            i = len(names)
            name = f"synth_{i:05d}"
            rgb, depth_mm, seg, shapes = generate_scene(rng, height, width)
            Image.fromarray(rgb).save(
                os.path.join(root, "rgb", name + ".png"))
            Image.fromarray(depth_mm).save(
                os.path.join(root, "depth", name + ".png"))
            Image.fromarray(seg * 255).save(
                os.path.join(root, "seg", name + ".png"))
            label = {"shapes": shapes, "imageWidth": width,
                     "imageHeight": height, "imageId": i}
            with open(os.path.join(root, "lines", name + ".json"),
                      "w") as f:
                json.dump(label, f)
            images_json.append({"id": i, "file_name": name + ".png"})
            names.append(name)
            split_names.append(name)
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(split_names) + "\n")
    with open(os.path.join(root, "glassrgbd_images.json"), "w") as f:
        json.dump({"images": images_json}, f)
    return names


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser("synthetic GW-Depth-format dataset")
    p.add_argument("--root", required=True)
    p.add_argument("--n_train", type=int, default=64)
    p.add_argument("--n_val", type=int, default=16)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    names = generate_dataset(a.root, a.n_train, a.n_val, a.height, a.width,
                             a.seed)
    print(f"wrote {len(names)} scenes under {a.root}")


if __name__ == "__main__":
    main()
