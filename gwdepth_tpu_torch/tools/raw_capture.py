"""Raw-capture and labeling-prep toolchain (offline, host-side).

The port's copy of `gwdepth_tpu.tools.raw_capture`: the same functions, the
same outputs, on the host.

Portable re-derivation of the reference's RealSense capture/crop/split
tools (reference: depth_interpolation/raw_preprocess.py,
read_binfile.py:16-29, depth_raw2npy.py). Everything that is pure image /
label processing runs here with numpy + PIL (no cv2, no matplotlib); the
pieces that need a physical RealSense device (`capture_frames`, bag
replay) are gated on `pyrealsense2` being importable and raise a clear
error otherwise — the dataset ships precomputed, so these only matter when
re-capturing raw data.

All functions are library-callable (the reference versions are `__main__`
scripts with hard-coded personal paths).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from gwdepth_tpu_torch.tools.depth_completion import polygon_mask

# reference label taxonomy (raw_preprocess.py GLASS_LABELS / LABELS_ID_MAP
# — glass region classes rasterized into the segmentation map)
GLASS_LABELS: Tuple[str, ...] = ("glass", "glass_wall", "glass_door")
LABELS_ID_MAP: Dict[str, int] = {n: 1 for n in GLASS_LABELS}


# ---------------------------------------------------------------------------
# raw depth IO (read_binfile.py:16-29, commons.read_depth_npy)
# ---------------------------------------------------------------------------

def read_raw_depth(width: int, height: int, raw_depth_file: str) -> np.ndarray:
    """Little-endian uint16 .bin -> (H, W) depth in mm
    (reference: read_binfile.py:16-29, vectorized)."""
    data = np.fromfile(raw_depth_file, dtype="<u2")
    if data.size != width * height:
        raise ValueError(
            f"{raw_depth_file}: {data.size} uint16s, expected {width * height}")
    return data.reshape(height, width)


def read_depth_npy(path: str) -> np.ndarray:
    return np.load(path)


def read_json_label(path: str, key: Optional[str] = None):
    with open(path) as f:
        d = json.load(f)
    return d[key] if key is not None else d


def depth_to_vis(depth_mm: np.ndarray, max_mm: float = 10000.0) -> np.ndarray:
    """uint16 depth -> uint8 grayscale visualization (stands in for the
    reference's cv2 colormap vis, raw_preprocess.py:79)."""
    d = np.clip(depth_mm.astype(np.float32), 0, max_mm) / max_mm
    return (d * 255.0).astype(np.uint8)


# ---------------------------------------------------------------------------
# crop by labelme "crop" rectangle (raw_preprocess.py:62-92)
# ---------------------------------------------------------------------------

def crop_by_labelme(json_label: str, rgb_png: str, raw_depth_npy: str,
                    save_dir: str, crop_label: str = "crop") -> List[str]:
    """Crop the RGB and raw-depth arrays to every labelme rectangle named
    `crop_label`; save <name>.png / <name>.npy / depth_vis/<name>-vis.png
    (reference: raw_preprocess.py:62-92, inclusive bottom-right corner).
    Returns the saved image paths."""
    img = np.asarray(Image.open(rgb_png).convert("RGB"))
    depth = read_depth_npy(raw_depth_npy)
    shapes = read_json_label(json_label, key="shapes")
    vis_dir = os.path.join(save_dir, "depth_vis")
    os.makedirs(vis_dir, exist_ok=True)
    saved = []
    fname = os.path.splitext(os.path.basename(rgb_png))[0]
    for ann in shapes:
        if ann.get("label") != crop_label or ann.get("shape_type") != "rectangle":
            continue
        (x0, y0), (x1, y1) = (list(map(int, p)) for p in ann["points"])
        img_c = img[y0:y1 + 1, x0:x1 + 1]
        depth_c = depth[y0:y1 + 1, x0:x1 + 1]
        out_png = os.path.join(save_dir, fname + ".png")
        Image.fromarray(img_c).save(out_png)
        np.save(os.path.join(save_dir, fname + ".npy"), depth_c)
        Image.fromarray(depth_to_vis(depth_c.astype(np.uint16))).save(
            os.path.join(vis_dir, fname + "-vis.png"))
        saved.append(out_png)
    return saved


# ---------------------------------------------------------------------------
# polygon labels -> segmentation mask (raw_preprocess.py:179-219)
# ---------------------------------------------------------------------------

def polygon_labels_to_mask(label_json: str, width: int = 1280,
                           height: int = 720,
                           label_ids: Optional[Dict[str, int]] = None
                           ) -> np.ndarray:
    """Rasterize every glass polygon of one labelme json into a (H, W)
    uint8 id map (reference: raw_preprocess.py:179-219; later polygons of
    the same class overwrite earlier ones, as there)."""
    ids = LABELS_ID_MAP if label_ids is None else label_ids
    out = np.zeros((height, width), np.uint8)
    by_id: Dict[int, List] = {}
    for ann in read_json_label(label_json, key="shapes"):
        if ann.get("label") in ids:
            by_id.setdefault(ids[ann["label"]], []).append(ann["points"])
    for real_id in sorted(by_id):
        for pts in by_id[real_id]:
            m = polygon_mask(np.asarray(pts, np.float64), height, width)
            out = np.where(m, np.uint8(real_id), out)
    return out


def polygon2mask_dir(json_dir: str, save_dir: str, width: int = 1280,
                     height: int = 720) -> int:
    """Batch `polygon_labels_to_mask` over a labelme directory
    (reference: raw_preprocess.py:179-219). Returns the file count."""
    os.makedirs(save_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(json_dir) if n.endswith(".json"))
    for n in names:
        m = polygon_labels_to_mask(os.path.join(json_dir, n), width, height)
        np.save(os.path.join(save_dir, os.path.splitext(n)[0]), m)
    return len(names)


# ---------------------------------------------------------------------------
# train/val split (raw_preprocess.py:643-669)
# ---------------------------------------------------------------------------

def split_train_val(image_dir: str, train_txt: str, val_txt: str,
                    val_ratio: float = 0.333, seed: int = 0
                    ) -> Tuple[int, int]:
    """Shuffle image basenames, split by `val_ratio`, write sorted name
    lists (reference: raw_preprocess.py:643-669 — shuffles with the global
    RNG; here seeded for reproducibility). Returns (n_train, n_val)."""
    fnames = sorted(os.listdir(image_dir))
    rng = random.Random(seed)
    for _ in range(3):                      # reference shuffles 3x (:652-654)
        rng.shuffle(fnames)
    n_val = int(len(fnames) * val_ratio)
    train = sorted(fnames[:len(fnames) - n_val])
    val = sorted(fnames[len(fnames) - n_val:])
    for path, names in ((train_txt, train), (val_txt, val)):
        with open(path, "w") as f:
            for n in names:
                f.write(os.path.splitext(n)[0] + "\n")
    return len(train), len(val)


# ---------------------------------------------------------------------------
# label copy between crop and depth label dirs (raw_preprocess.py:136-147)
# ---------------------------------------------------------------------------

def label_copy(src_label_dir: str, dst_label_dir: str,
               suffix: str = ".json") -> int:
    """Copy label jsons whose basename exists in the destination dir's
    images (reference: raw_preprocess.py:136-147). Returns copies made."""
    import shutil
    os.makedirs(dst_label_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src_label_dir)):
        if name.endswith(suffix):
            shutil.copy(os.path.join(src_label_dir, name),
                        os.path.join(dst_label_dir, name))
            n += 1
    return n


# ---------------------------------------------------------------------------
# hardware-bound capture (depth_raw2npy.py) — gated on pyrealsense2
# ---------------------------------------------------------------------------

def capture_frames(out_dir: str, num_frames: int = 1,
                   width: int = 1280, height: int = 720, fps: int = 30):
    """Capture aligned color+depth frames from a live RealSense device and
    save <i>.png / <i>.npy / intrinsics json (reference: depth_raw2npy.py).
    Requires a physical device + pyrealsense2 (not bundled here)."""
    try:
        import pyrealsense2 as rs  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "capture_frames needs pyrealsense2 and a RealSense device; "
            "the GW-Depth dataset ships precomputed raw captures, so this "
            "is only needed to re-capture new data") from e

    pipeline = rs.pipeline()
    config = rs.config()
    config.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
    config.enable_stream(rs.stream.color, width, height, rs.format.bgr8, fps)
    profile = pipeline.start(config)
    align = rs.align(rs.stream.color)
    os.makedirs(out_dir, exist_ok=True)
    try:
        scale = profile.get_device().first_depth_sensor().get_depth_scale()
        for i in range(num_frames):
            frames = align.process(pipeline.wait_for_frames())
            depth = np.asanyarray(frames.get_depth_frame().get_data())
            color = np.asanyarray(frames.get_color_frame().get_data())
            Image.fromarray(color[..., ::-1]).save(
                os.path.join(out_dir, f"{i:06d}.png"))
            np.save(os.path.join(out_dir, f"{i:06d}.npy"), depth)
        intr = (profile.get_stream(rs.stream.depth)
                .as_video_stream_profile().get_intrinsics())
        with open(os.path.join(out_dir, "intrinsics.json"), "w") as f:
            json.dump({"width": intr.width, "height": intr.height,
                       "fx": intr.fx, "fy": intr.fy,
                       "ppx": intr.ppx, "ppy": intr.ppy,
                       "coeffs": list(intr.coeffs),
                       "model": str(intr.model),
                       "depth_scale": scale}, f)
    finally:
        pipeline.stop()
