"""GW-Depth dataset: host-side decode + augmentation + static-canvas collate.

The port's copy of `gwdepth_tpu.data.dataset`; PNG files decode through
the native loader (`gwdepth_tpu_torch.native`) where it has its decoder,
else through PIL, with the same bytes:

- name lists from train.txt / val.txt;
- per sample: RGB png, depth png (/1000 -> meters), seg png (>0 -> 1),
  labelme-style polygon json -> closed line loops + per-polygon centroids;
- `with_center` appends the polygon center to each line -> 6 coords;
- with `with_reflection` and `glassrgbd_rhint_points_path`, each sample
  also carries the reflection-hint points (`reflection_points`, padded
  to `max_rhint_points`, and `reflection_mask`), in the canvas frame of
  the lines. `make_batch` leaves them out, as the JAX package's does: no
  model reads them.

Samples are padded bottom-right onto the configured canvas with a validity
mask, GT lines onto `max_lines` slots with a line mask. `Loader` decodes
with a thread pool and a prefetch queue ahead of the consumer; over W
data-parallel ranks each rank decodes its contiguous part of every global
batch.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from gwdepth_tpu_torch import native
from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.data.batch import Batch
from gwdepth_tpu_torch.data.transforms import (
    Sample, centroid, eval_transform, train_transform)


def _open_rgb(path: str) -> Image.Image:
    """Image file -> PIL RGB image, as `Image.open(path).convert("RGB")`."""
    if path.endswith(".png"):
        arr = native.decode_png(path, rgb=True)
        if arr is not None:
            return Image.fromarray(arr)
    return Image.open(path).convert("RGB")


def _open_array(path: str) -> np.ndarray:
    """Image file -> its raw array, as `np.asarray(Image.open(path))`."""
    if path.endswith(".png"):
        arr = native.decode_png(path, rgb=False)
        if arr is not None:
            return arr
    return np.asarray(Image.open(path))


def gen_pairs(vertices: np.ndarray) -> np.ndarray:
    """Consecutive vertex pairs closing the loop: (N, 2) -> (N, 2, 2)."""
    return np.stack([vertices, np.roll(vertices, -1, axis=0)], axis=1)


def lines_from_polygons(label: Dict
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """labelme dict -> (lines (N, 4), centers (N, 2), poly_ids (N,))."""
    lines, centers, ids = [], [], []
    for poly in label.get("shapes", []):
        pts = poly.get("points", [])
        if len(pts) == 0:
            continue
        pl = gen_pairs(np.asarray(pts, np.float64)).reshape(-1, 4)
        loop_pts = [list(pl[0][:2]), list(pl[0][2:4])] + \
                   [list(l[2:4]) for l in pl[1:]]
        c = centroid(loop_pts)
        for l in pl:
            lines.append(l)
            centers.append(c)
            ids.append(poly.get("poly_id", 0))
    if not lines:
        return (np.zeros((0, 4)), np.zeros((0, 2)), np.zeros((0,), np.int64))
    return (np.asarray(lines, np.float64), np.asarray(centers, np.float64),
            np.asarray(ids, np.int64))


class GlassRGBDDataset:
    """Indexable dataset of augmented, canvas-fitted samples."""

    def __init__(self, cfg: GWDepthConfig, split: str = "train"):
        self.cfg = cfg
        self.split = split
        names_file = (cfg.filenames_file_train if split == "train"
                      else cfg.filenames_file_eval)
        with open(names_file) as f:
            self.names = [ln.split()[0] for ln in f if ln.strip()]
        # image id -> name, for the GT line dumps' `image_id`
        self.id_to_img = {}
        if cfg.glassrgbd_images_json and os.path.exists(
                cfg.glassrgbd_images_json):
            with open(cfg.glassrgbd_images_json) as f:
                for d in json.load(f).get("images", []):
                    self.id_to_img[d["id"]] = d["file_name"].split(".")[0]

    def __len__(self) -> int:
        return len(self.names)

    def load_raw(self, idx: int) -> Tuple[Sample, str]:
        cfg = self.cfg
        name = self.names[idx]
        image = _open_rgb(os.path.join(cfg.data_path, name + ".png"))
        depth = _open_array(
            os.path.join(cfg.gt_depth_path, name + ".png")).astype(np.int32)
        seg = _open_array(os.path.join(cfg.gt_seg_path, name + ".png"))
        if seg.ndim == 3:
            seg = seg[..., 0]
        with open(os.path.join(cfg.gt_line_path, name + ".json")) as f:
            label = json.load(f)
        lines, centers, ids = lines_from_polygons(label)
        w, h = image.size
        if len(lines):
            lines[:, 0::2] = lines[:, 0::2].clip(0, w)
            lines[:, 1::2] = lines[:, 1::2].clip(0, h)
            centers[:, 0] = centers[:, 0].clip(0, w)
            centers[:, 1] = centers[:, 1].clip(0, h)
        return Sample(image, depth, seg.astype(np.uint8), lines,
                      centers, ids), name

    def load_reflection(self, name: str) -> Optional[np.ndarray]:
        """The reflection-hint points of `name` as (N, 2) [x, y] pixels of
        the original image (the json holds [row, col]); None without
        `with_reflection` or a hint directory, (0, 2) without a file."""
        cfg = self.cfg
        if not cfg.with_reflection or not cfg.glassrgbd_rhint_points_path:
            return None
        path = os.path.join(cfg.glassrgbd_rhint_points_path, name + ".json")
        if not os.path.exists(path):
            return np.zeros((0, 2), np.float32)
        with open(path) as f:
            pts = np.asarray(json.load(f).get("rhint_points", []),
                             np.float32).reshape(-1, 2)
        return pts[:, ::-1]

    def __getitem__(self, idx: int, seed: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        s, name = self.load_raw(idx)
        if self.split == "train":
            rng = random.Random(seed if seed is not None
                                else random.getrandbits(32))
            s = train_transform(s, rng, cfg.train_hw)
            canvas = cfg.train_hw
        else:
            s = eval_transform(s, cfg.eval_hw)
            canvas = cfg.eval_hw
        out = collate_sample(s, canvas, cfg, name)
        rpts = self.load_reflection(name)
        if rpts is not None:
            # original pixels -> normalized by the raw extent -> the canvas
            # frame of the lines
            raw_w, raw_h = Image.open(
                os.path.join(cfg.data_path, name + ".png")).size
            ih, iw = out["orig_hw"]
            ch, cw = canvas
            P = cfg.max_rhint_points
            padded = np.zeros((P, 2), np.float32)
            mask = np.zeros((P,), bool)
            n = min(len(rpts), P)
            if n:
                norm = rpts[:n] / np.array([raw_w, raw_h], np.float32)
                padded[:n] = norm * np.array([iw / cw, ih / ch], np.float32)
                mask[:n] = True
            out["reflection_points"] = padded
            out["reflection_mask"] = mask
        return out


def collate_sample(s: Sample, canvas_hw: Tuple[int, int],
                   cfg: GWDepthConfig, name: str = "") -> Dict[str, np.ndarray]:
    """Pad a normalized sample onto the canvas; depth png units -> meters,
    seg binarized, centers appended to lines when with_center. Lines go
    from image-normalized to canvas-normalized coordinates, the frame the
    dense branch samples them in."""
    ch, cw = canvas_hw
    h, w = s.image.shape[:2]
    assert h <= ch and w <= cw, (h, w, canvas_hw)
    img = np.zeros((ch, cw, 3), np.float32)
    img[:h, :w] = s.image
    valid = np.zeros((ch, cw), bool)
    valid[:h, :w] = True
    depth = np.zeros((ch, cw), np.float32)
    depth[:h, :w] = s.depth.astype(np.float32) / 1000.0
    seg = np.zeros((ch, cw), np.int32)
    seg[:h, :w] = (s.seg > 0).astype(np.int32)

    T, D = cfg.max_lines, cfg.line_dim
    lines = np.zeros((T, D), np.float32)
    mask = np.zeros((T,), bool)
    n = min(len(s.lines), T)
    if n:
        ln = s.lines[:n].astype(np.float32)
        if cfg.with_center:
            ln = np.concatenate([ln, s.centers[:n].astype(np.float32)], 1)
        scale = np.array([w / cw, h / ch], np.float32)
        lines[:n] = ln * np.tile(scale, D // 2)
        mask[:n] = True
    return {"images": img, "valid": valid, "depth": depth, "seg": seg,
            "lines": lines, "line_mask": mask, "name": name,
            "orig_hw": np.array([h, w], np.int32)}


def make_batch(samples: Sequence[Dict[str, np.ndarray]]) -> Batch:
    """Stack collated samples into a CPU `Batch`."""
    return Batch.from_numpy({k: np.stack([s[k] for s in samples])
                             for k in ("images", "valid", "depth", "seg",
                                       "lines", "line_mask")})


class Loader:
    """Epoch iterator: a decode thread pool behind a prefetch queue. PIL
    and zlib release the GIL while decoding, so threads overlap the host
    work with the device steps.

    `batch_size` is the global batch. Rank `rank` of `world` yields the
    rank-th contiguous part of each global batch (`batch_size / world`
    images), so the W ranks together see exactly one process's batches,
    as the JAX step's batch is sharded contiguously over `data`; every
    rank shuffles with the same seed and has `len(self)` global batches.
    Each sample's augmentation draws from a seed of (seed, epoch, index),
    so a sample is augmented alike whichever rank decodes it."""

    def __init__(self, dataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, num_workers: int = 4,
                 pad_to_batch: bool = False, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{world} ranks")
        if world > 1 and not (drop_last or pad_to_batch):
            raise ValueError("a short last batch splits over ranks only "
                             "with pad_to_batch")
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        # a short final batch is padded with all-invalid images, which
        # every eval accumulator treats as "not an image"
        self.pad_to_batch = pad_to_batch
        self.rank = rank
        self.world = world

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def _share(self, bi: int, order: np.ndarray) -> List[int]:
        """This rank's dataset indices of global batch `bi`, -1 where the
        padded tail has no image."""
        idxs = list(order[bi * self.bs:(bi + 1) * self.bs])
        if self.pad_to_batch:
            idxs += [-1] * (self.bs - len(idxs))
        lb = len(idxs) // self.world
        return idxs[self.rank * lb:(self.rank + 1) * lb]

    def epoch(self, epoch: int = 0, pin_memory: bool = False
              ) -> Iterator[Tuple[Batch, List[str]]]:
        """This rank's (batch, names) of epoch `epoch`. `pin_memory` pins
        each batch in the worker thread before it enters the queue, so
        that a copy to a card runs asynchronously and the consumer never
        pins; a pinning failure reaches the consumer as an exception."""
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        seeds = np.random.default_rng((self.seed, epoch)).integers(
            0, 2 ** 32, size=n)
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        def load(i):
            return self.ds.__getitem__(int(i), seed=int(seeds[i]))

        def worker():
            with ThreadPoolExecutor(max(1, self.num_workers)) as pool:
                pending: "collections.deque" = collections.deque()
                bi = 0
                while bi < nb or pending:
                    while bi < nb and len(pending) <= self.prefetch:
                        share = self._share(bi, order)
                        real = [i for i in share if i >= 0]
                        if share and not real:
                            # only padding here: the batch's first image
                            # gives the pad's shapes
                            real = [order[bi * self.bs]]
                        pending.append((sum(i >= 0 for i in share), len(share),
                                        [pool.submit(load, i) for i in real]))
                        bi += 1
                    n_real, n_share, futs = pending.popleft()
                    samples = [f.result() for f in futs][:n_real]
                    names = [s["name"] for s in samples]
                    if len(samples) < n_share:
                        pad = {k: np.zeros_like(v) for k, v in
                               futs[0].result().items()
                               if isinstance(v, np.ndarray)}
                        pad["name"] = ""
                        samples += [pad] * (n_share - len(samples))
                    batch = make_batch(samples)
                    q.put((batch.pin_memory() if pin_memory else batch,
                           names))
            q.put(None)

        def worker_guard():
            # a worker's exception must reach the consumer, or q.get()
            # would wait for a sentinel that never comes
            try:
                worker()
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                q.put(e)

        threading.Thread(target=worker_guard, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
