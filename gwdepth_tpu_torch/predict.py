"""Inference CLI: folder of RGB images -> depth / seg / lines, on the card.

The same flags and outputs as `gwdepth_tpu.predict`, plus `--device`:
eval-protocol preprocessing (long side to 1024, normalize, fixed canvas +
validity mask), one GlassRGBD forward per batch.

Outputs per image `<name>`:
  <name>_depth.npy    float32 meters at the original resolution
  <name>_depth.png    16-bit millimeters
  <name>_seg.png      8-bit {0, 255} glass mask
  <name>_lines.json   {"lines": [[x1,y1,x2,y2]...] original-pixel coords,
                       "centers": [[x,y]...], "scores": [...]} (empty lists
                      with --no_line)
  <name>_vis.png      with --save_vis: the depth colormap with the kept
                      lines drawn on it

On the card the model runs kernels K1 and K2 (`use_pallas`, bf16 taps in
K2) unless `--no_pallas`; on the CPU their plain float32 formulations.
On the card the forward is one CUDA graph per `--batch`
(`make_forward`, as the JAX CLI jits it): the tail batch is padded to
keep its shape, each batch goes from pinned host memory into the
graph's static input, and its outputs reach the host before the next
replay.

Weights: `--torch_init` an original-code `.pth`, or `--resume` a
checkpoint of the port's `main.py` (its `checkpoint.pth`, or the
directory holding it). The JAX package's orbax directories are refused
with the two steps that bring one over: `python -m
gwdepth_tpu.convert.export_torch --resume DIR --template T.pth --out
X.pth` (T.pth any checkpoint of the port's `main.py`), then
`--torch_init X.pth`.

`--mesh N` serves data-parallel under torchrun with N ranks
(`torchrun --nproc_per_node N -m gwdepth_tpu_torch.predict --mesh N
--batch B ...`): each rank runs its contiguous B / N images of every
batch on `cuda:LOCAL_RANK` and writes those images' files, as the JAX
CLI shards the serving batch over `data`.

Usage:
  python -m gwdepth_tpu_torch.predict --images <dir|file> --output_dir out \
      [--torch_init <original.pth> | --resume <checkpoint.pth|dir>] \
      [--score 0.75] [--tiny] [--device cuda] [--no_pallas] [--no_line] \
      [--save_vis] [--batch B] [--mesh N]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
from typing import List, Tuple

import numpy as np
from PIL import Image

from gwdepth_tpu_torch.utils.visualize import colorize_depth, draw_lines

VALID_EXT = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GW-Depth inference (PyTorch/CUDA port)")
    p.add_argument("--images", required=True,
                   help="image file or directory of images")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--resume", type=str, default="",
                   help="a checkpoint of the port's main.py: "
                        "checkpoint.pth or its directory")
    p.add_argument("--torch_init", type=str, default="",
                   help="original GlassRGBD .pth checkpoint to load")
    p.add_argument("--score", type=float, default=0.75,
                   help="line score threshold (softmax class 0)")
    p.add_argument("--eval_h", type=int, default=0)
    p.add_argument("--eval_w", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--save_vis", action="store_true",
                   help="also write <name>_vis.png: depth colormap with "
                        "the kept lines")
    p.add_argument("--no_line", action="store_true",
                   help="the depth-only model (no line branch)")
    p.add_argument("--no_pallas", action="store_true",
                   help="kernel-free path: the model's plain float32 "
                        "formulations in place of kernels K1 and K2")
    p.add_argument("--batch", type=int, default=1,
                   help="images per forward pass (last batch pads by "
                        "repeating)")
    p.add_argument("--mesh", type=int, default=1,
                   help="ranks to shard the batch over: the torchrun world "
                        "size")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights when no checkpoint")
    return p


def list_images(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    return sorted(os.path.join(path, n) for n in os.listdir(path)
                  if n.lower().endswith(VALID_EXT))


def preprocess(img: Image.Image, canvas_hw: Tuple[int, int], test_size=1024):
    """Eval-protocol preprocessing for a GT-free image: the padded canvas,
    its validity mask, and the resized (h, w) of the real area."""
    from gwdepth_tpu_torch.data.transforms import Sample, eval_transform

    z = np.zeros((img.height, img.width), np.float32)
    s = Sample(img.convert("RGB"), z, z.astype(np.uint8),
               np.zeros((0, 4)), np.zeros((0, 2)), np.zeros((0,), np.int64))
    s = eval_transform(s, canvas_hw, test_size=test_size,
                       max_size=test_size, strict_protocol=False)
    h, w = s.image.shape[:2]
    ch, cw = canvas_hw
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:h, :w] = s.image
    valid = np.zeros((ch, cw), bool)
    valid[:h, :w] = True
    return canvas, valid, (h, w)


def _normalize_keys(sd):
    """Strip DDP prefixes, apply the original's legacy rename, drop
    BatchNorm step counters."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        out[k.replace("bbox_embed", "lines_embed")] = v
    return out


def load_original_checkpoint(model, path: str,
                             warm_start: bool = False) -> int:
    """`load_state_dict` of an original-code checkpoint; returns the number
    of its tensors loaded. Every tensor the port holds must be present (a
    `relative_position_index` buffer excepted: the model computes it), and
    a shape that differs raises; keys of modules the original declares but
    never calls are left unused. With `warm_start` (the training CLI's
    `--torch_init`), a checkpoint that lacks tensors of the model (a
    DETR-R50 one, for the backbone, transformer and heads) loads instead
    every tensor whose name and shape match."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = _normalize_keys(raw.get("model", raw))
    own = model.state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("relative_position_index")]
    if missing and warm_start:
        sd = {k: v for k, v in sd.items()
              if k in own and tuple(v.shape) == tuple(own[k].shape)}
    elif missing:
        raise KeyError(f"{path} lacks {len(missing)} tensors of the model, "
                       f"e.g. {missing[:5]}")
    model.load_state_dict(sd, strict=False)
    return sum(k in own for k in sd)


def config_from_args(args: argparse.Namespace):
    """The model config of a run: the kernels (`use_pallas`) on the card
    unless `--no_pallas`, as the JAX CLI turns its Pallas kernels on on a
    TPU; off on the CPU."""
    from gwdepth_tpu_torch.config import GWDepthConfig, tiny_test_config

    cfg = tiny_test_config() if args.tiny else GWDepthConfig(dropout=0.0)
    if args.device == "cuda" and not args.no_pallas:
        cfg = cfg.replace(use_pallas=True)
    if args.no_line:
        cfg = cfg.replace(with_line=False)
    if args.eval_h and args.eval_w:
        cfg = cfg.replace(eval_hw=(args.eval_h, args.eval_w))
    return cfg


def forward(model, images, valid):
    """The serving outputs of `model` on a batch."""
    out = model(images, valid)
    res = {"depth": out["pred_depth"][-1], "seg": out["pred_seg"]}
    if out["pred_logits"] is not None:
        res["logits"] = out["pred_logits"]
        res["lines"] = out["pred_lines"]
    return res


def make_forward(model):
    """(images, valid) -> {depth, seg[, logits, lines]}: the serving
    forward of `model`, `graphs.compiled` (one CUDA graph per input shape,
    `model.training` and set of parameters on a card; the outputs are
    valid until the next compiled call). Call it under `torch.no_grad()`.
    The model is an argument of the compiled call, so its key holds the
    mode and its fingerprint the parameters (`.func` is the compiled
    callable)."""
    from gwdepth_tpu_torch import graphs

    return functools.partial(graphs.compiled(forward), model)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from gwdepth_tpu_torch.parallel.mesh import env_world_size

    world = env_world_size()
    if args.mesh != world:
        raise SystemExit(f"--mesh {args.mesh}: the data mesh spans the "
                         f"torchrun world, {world} rank(s)")
    if max(1, args.batch) % args.mesh:
        raise SystemExit(f"--batch {args.batch} must be a multiple of "
                         f"--mesh {args.mesh}")
    import torch
    from gwdepth_tpu_torch.export import load_weights
    from gwdepth_tpu_torch.models import build_glassrgbd
    from gwdepth_tpu_torch.parallel.mesh import make_mesh, setup

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but CUDA is not available")
    device = setup(args.device)
    mesh = make_mesh((args.mesh,))
    cfg = config_from_args(args)
    cfg.set_matmul_precision()

    files = list_images(args.images)
    if not files:
        raise SystemExit(f"no images under {args.images}")
    os.makedirs(args.output_dir, exist_ok=True)

    model = build_glassrgbd(cfg, args.seed, device="cpu")
    if args.torch_init:
        n = load_original_checkpoint(model, args.torch_init)
        print(f"loaded {args.torch_init}: {n} tensors")
    elif args.resume:
        print(f"restored {load_weights(model, args.resume, '')}")
    else:
        print("WARNING: random weights (no --torch_init or --resume) - for "
              "pipeline smoke tests only")
    model = model.to(device).eval()
    fwd = make_forward(model)
    pin = device.type == "cuda"

    ch, cw = cfg.eval_hw
    B = max(1, args.batch)
    part = mesh.share(B)
    for start in range(0, len(files), B):
        group = files[start:start + B]
        metas, canvases, valids = [], [], []
        for path in group:
            img = Image.open(path)
            canvas, valid, hw = preprocess(img, (ch, cw))
            metas.append((path, img.size, hw))
            canvases.append(canvas)
            valids.append(valid)
        while len(canvases) < B:          # pad the tail batch by repetition
            canvases.append(canvases[-1])
            valids.append(valids[-1])
        # this rank's contiguous part of the batch
        metas = metas[part]
        x, v = (torch.from_numpy(np.stack(a[part]))
                for a in (canvases, valids))
        if pin:
            x, v = x.pin_memory(), v.pin_memory()
        with torch.no_grad():
            outb = fwd(x.to(device, non_blocking=pin),
                       v.to(device, non_blocking=pin))
        outb = {k: t.float().cpu().numpy() for k, t in outb.items()}
        for bi, (path, (ow, oh), (h, w)) in enumerate(metas):
            _emit_one(outb, bi, path, ow, oh, h, w, cfg, args)


def _emit_one(out, bi, path, ow, oh, h, w, cfg, args):
    """Write the outputs for one image of a batched forward."""
    ch, cw = cfg.eval_hw
    name = os.path.splitext(os.path.basename(path))[0]

    depth = out["depth"][bi][:h, :w]
    depth_full = np.asarray(Image.fromarray(depth).resize(
        (ow, oh), Image.BILINEAR))
    seg = out["seg"][bi][:h, :w].argmax(-1).astype(np.uint8)
    seg_full = np.asarray(Image.fromarray(seg * 255).resize(
        (ow, oh), Image.NEAREST))

    np.save(os.path.join(args.output_dir, f"{name}_depth.npy"),
            depth_full.astype(np.float32))
    Image.fromarray((np.clip(depth_full, 0, 65.535) * 1000)
                    .astype(np.uint16)).save(
        os.path.join(args.output_dir, f"{name}_depth.png"))
    Image.fromarray(seg_full).save(
        os.path.join(args.output_dir, f"{name}_seg.png"))

    rec = {"image": os.path.basename(path), "lines": [], "centers": [],
           "scores": []}
    if "logits" in out:
        # lines are CANVAS-normalized; the real area is the top-left (h, w)
        p = np.exp(out["logits"][bi])
        p = p / p.sum(-1, keepdims=True)
        scores = p[:, 0]
        keep = scores > args.score
        ln = out["lines"][bi][keep]
        sx, sy = cw * (ow / w), ch * (oh / h)
        rec["lines"] = (ln[:, :4] * [sx, sy, sx, sy]).tolist()
        if ln.shape[1] >= 6:
            rec["centers"] = (ln[:, 4:6] * [sx, sy]).tolist()
        rec["scores"] = scores[keep].tolist()
    with open(os.path.join(args.output_dir, f"{name}_lines.json"), "w") as f:
        json.dump(rec, f)

    if args.save_vis:
        vis = colorize_depth(depth_full, cfg.max_depth)
        if rec["lines"]:
            vis = draw_lines(vis, np.asarray(rec["lines"]))
        Image.fromarray(vis).save(
            os.path.join(args.output_dir, f"{name}_vis.png"))
    print(f"{name}: depth [{depth_full.min():.2f}, "
          f"{depth_full.max():.2f}] m, {len(rec['lines'])} lines")


if __name__ == "__main__":
    from gwdepth_tpu_torch.parallel.mesh import teardown

    main()
    teardown()
