#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gwdepth_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card

Phases (any failure raises and exits non-zero; nothing is caught):
  1. probe    require CUDA, pin float32 matmuls/convs to full float32 (no
              TF32), print the card's name and power limit (nvidia-smi);
  2. build    compile the CUDA kernels from `gwdepth_tpu_torch/csrc/`
              (one nvcc each, in parallel) and print ptxas' register and
              spill lines;
  3. kernels  hold each kernel against its plain PyTorch version on the
              card at every main-path shape, with seeded inputs; time the
              kernel, the plain version and a cuDNN/ATen composition of the
              same function (conv2d + layer_norm + activation; K2's on
              contiguous NCHW with cuDNN autotuned) with CUDA events,
              medians of 30 runs after warm-up;
  4. model    GlassRGBD(GWDepthConfig(dropout=0.0)) at 768x1024, batch 1,
              weights from a seed (the repo holds no checkpoint): one
              forward on the card with the launch counts zeroed just before
              and read just after (K1 must launch 4 times, K2 25 times),
              output shapes and finiteness, the median forward time, a
              torch.profiler breakdown of one forward's device time (by
              kernel name, and the device's idle share), and the same
              forward on the CPU (the wrappers take the plain versions
              there) compared with the card's;
  5. serve    three seeded synthetic images of different aspect ratios
              through `gwdepth_tpu_torch.predict.main` on the card; every
              output file must exist;
  6. backward at every train-canvas shape of K2 (bs2, 88x128 and 176x256)
              and of K1: each kernel's forward output and its
              autograd.Function's gradients of every input against the
              plain version and autograd through it, and forward and
              backward times of the kernel, the plain version, the
              cuDNN/ATen composition, and the bound;
  7. train    8 train and 2 val synthetic scenes at 720x1280 through
              `gwdepth_tpu_torch.main.main` on the card at the shipped
              config (bs2 704x1024, dropout 0.1): one epoch of 4 steps,
              eval, checkpoint, then a `--resume` epoch; the launch counts
              of each run are zeroed just before and read just after and
              must equal the numbers the link list gives; finite losses,
              output files, frozen stem bit-equal, trained weights moved;
              then the median ms/step, the host matcher's share and a
              torch.profiler split of one step;
  8. train card vs CPU  one train step's losses and every gradient tensor
              at the shipped widths on a 128x192 canvas, dropout 0, the
              same weights and batch on both devices.
Then one JSON line lists each kernel with its launches and times per
serving forward and, under `train_*`, per train step (K2's backward per
train step), and the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from gwdepth_tpu_torch import _build
from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.models import build_glassrgbd
from gwdepth_tpu_torch.ops import fused_conv
from gwdepth_tpu_torch.ops.fused_conv import (conv3x3_ln_act,
                                              conv3x3_ln_act_plain, link_key)
from gwdepth_tpu_torch.ops.ref_attn_diffusion import (
    diffusion_torch, ref_attn_diffusion, ref_attn_diffusion_plain)

# H100 SXM data-sheet peaks (dense): float32 on the CUDA cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# kernel vs plain version on the card, both float32 (the plain version's
# matmuls without TF32): reassociation of sums of up to 2700 products
# after a LayerNorm, far below this
K1_TOL = 1e-4
K2_TOL = 1e-4
# card vs CPU forward: lines and logits come from the backbone and DETR in
# float32, so they agree tightly; depth and seg additionally pass through
# two discrete choices (certain_sample's top-S, the top-20 reference
# lines) where a near-tie could flip between devices, so they are held by
# relative L2
LINE_TOL = 1e-3
DENSE_REL_L2_TOL = 1e-2

SEED = 0
H_IMG, W_IMG = 768, 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def probe():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def bound_fields(flops: float, nbytes: float) -> dict:
    """Least time on the card: the larger of the float32 arithmetic time
    and the memory time, with both parts."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_mem}


def phase_build():
    secs = _build.build()
    log(f"[build] {len(_build.KERNELS)} kernels in {secs:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def cudnn_autotuned():
    """cuDNN chooses its conv algorithms by timing them, so that one poor
    heuristic pick does not set K2's yardstick. PyTorch keeps the first
    plan it finds for a conv shape, by heuristic or by timing, so every
    call of a yardstick shape runs inside this (none of them is a shape
    the model gives cuDNN)."""
    old = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = old


def library_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """`time_ms` of K2's cuDNN/ATen yardstick, autotuned."""
    with cudnn_autotuned():
        return time_ms(fn, reps=reps, warmup=warmup)


def k2_library_inputs(x, w):
    """x (B, H, W, Ci) and w (3, 3, Ci, Co) as cuDNN takes them: contiguous
    (B, Ci, H, W) and (Co, Ci, 3, 3)."""
    return (x.permute(0, 3, 1, 2).contiguous(),
            w.permute(3, 2, 0, 1).contiguous())


def k2_library(x_nchw, w_oihw, g, b, r, act):
    """cuDNN/ATen composition of K2's function (yardstick only), on the
    inputs of `k2_library_inputs`; returns (B, H, W, Co)."""
    y = F.conv2d(x_nchw, w_oihw, padding=1).permute(0, 2, 3, 1)
    y = F.layer_norm(y, (w_oihw.shape[0],), g, b, eps=1e-5)
    y = fused_conv.apply_act(y, act)
    return y if r is None else y + r


def phase_k1(rng, dev):
    B, P, R, H = 1, 980, 40, 16
    a = torch.from_numpy(rng.normal(size=(B, P, R, H)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, H, H))
                          / np.sqrt(9 * H)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(H,))).astype(np.float32))
    a, w, b = a.to(dev), w.to(dev), b.to(dev)
    got = ref_attn_diffusion(a, w, b)
    want = ref_attn_diffusion_plain(a, w, b)
    lib = diffusion_torch(a, w, b)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    lib_err = float((lib - want).abs().max())
    assert torch.isfinite(got).all(), "K1 output not finite"
    assert err <= K1_TOL, f"K1 max abs err {err} > {K1_TOL}"
    again = ref_attn_diffusion(a, w, b)
    assert torch.equal(again, got), "K1 is not deterministic"
    flops = 3 * 2 * B * P * R * H * H * 9
    nbytes = 4 * (2 * B * P * R * H + 9 * H * H + H)
    rec = {"name": "K1", "shape": [B, P, R, H], "max_err": err,
           "library_max_err": lib_err,
           "kernel_ms": time_ms(lambda: ref_attn_diffusion(a, w, b)),
           "plain_ms": time_ms(lambda: ref_attn_diffusion_plain(a, w, b)),
           "library_ms": time_ms(lambda: diffusion_torch(a, w, b)),
           **bound_fields(flops, nbytes)}
    log(json.dumps(rec))
    return rec


# main-path links of K2: (H, W, Ci, Co, act, residual); 1/8 head then 1/4
K2_LINKS = [
    (96, 128, 30, 30, "gelu", False),
    (96, 128, 30, 60, "gelu", False),
    (96, 128, 60, 60, "gelu", False),
    (96, 128, 60, 60, None, False),
    (96, 128, 300, 120, "gelu", False),
    (192, 256, 80, 80, "gelu", False),
    (192, 256, 80, 160, "gelu", False),
    (192, 256, 160, 160, "gelu", False),
    (192, 256, 160, 160, None, False),
    # not on the path: ELU and the residual operand the kernel also takes
    (96, 128, 60, 60, "elu", True),
]


def phase_k2(rng, dev):
    recs = {}
    for (H, W, Ci, Co, act, with_res) in K2_LINKS:
        x = torch.from_numpy(rng.normal(size=(1, H, W, Ci)).astype(np.float32))
        w = torch.from_numpy((rng.normal(size=(3, 3, Ci, Co))
                              / np.sqrt(9 * Ci)).astype(np.float32))
        g = torch.from_numpy((1 + 0.1 * rng.normal(size=(Co,))).astype(np.float32))
        b = torch.from_numpy((0.1 * rng.normal(size=(Co,))).astype(np.float32))
        r = (torch.from_numpy(rng.normal(size=(1, H, W, Co)).astype(np.float32))
             if with_res else None)
        x, w, g, b = x.to(dev), w.to(dev), g.to(dev), b.to(dev)
        r = None if r is None else r.to(dev)
        got = conv3x3_ln_act(x, w, g, b, r, act)
        want = conv3x3_ln_act_plain(x, w, g, b, r, act)
        xl, wl = k2_library_inputs(x, w)
        with cudnn_autotuned():
            lib = k2_library(xl, wl, g, b, r, act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert torch.isfinite(got).all(), f"K2 {H}x{W} {Ci}->{Co} not finite"
        assert err <= K2_TOL, \
            f"K2 {H}x{W} {Ci}->{Co} {act}: max abs err {err} > {K2_TOL}"
        flops = 2 * H * W * Ci * Co * 9
        nbytes = 4 * (H * W * Ci + 9 * Ci * Co + 2 * Co + H * W * Co
                      * (2 if with_res else 1))
        rec = {"name": "K2", "shape": [1, H, W, Ci, Co], "act": act,
               "residual": with_res, "max_err": err,
               "library_max_err": float((lib - want).abs().max()),
               "kernel_ms": time_ms(lambda: conv3x3_ln_act(x, w, g, b, r, act)),
               "plain_ms": time_ms(
                   lambda: conv3x3_ln_act_plain(x, w, g, b, r, act)),
               "library_ms": library_ms(
                   lambda: k2_library(xl, wl, g, b, r, act)),
               **bound_fields(flops, nbytes)}
        log(json.dumps(rec))
        recs[link_key(x, w, g, r, act)] = rec
    return recs


# ---------------------------------------------------------------------------
# model phase
# ---------------------------------------------------------------------------

_K1_NAMES = ("conv_stats_kernel", "norm_act_kernel")
_K2_NAMES = ("conv3x3_ln_act_kernel",)


def profile_device(fn, wall_ms: float, label: str, tag: str) -> dict:
    """Where one call's device time goes: torch.profiler (CUPTI) over one
    call of `fn`, device kernels summed by name, and the device's idle
    share of the unprofiled median wall time `wall_ms`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"[{tag}] the profiler saw no device events: device time "
            "not measured")
        return {}
    busy_us, end = 0.0, -1.0
    for s, e, _ in spans:                     # union of device intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name = {}
    for s, e, name in spans:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), n + 1)

    def share(keys):
        return sum(t for name, (t, _) in by_name.items()
                   if any(k in name for k in keys)) / 1e3

    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    rec = {label: wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "device_kernels": len(spans), "k1_ms": share(_K1_NAMES),
           "k2_ms": share(_K2_NAMES),
           "top": [[name[:90], t / 1e3, n] for name, (t, n) in top]}
    log(f"[{tag}] " + json.dumps(rec))
    return rec


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def phase_model(card: str):
    cfg = GWDepthConfig(dropout=0.0)
    log(f"[model] GlassRGBD default config at {H_IMG}x{W_IMG}, bs1, random "
        f"weights from seed {SEED} (no checkpoint in the repo)")
    model_cpu = build_glassrgbd(cfg, SEED, device="cpu")
    model = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(SEED + 1)
    img = torch.from_numpy(
        rng.normal(size=(1, H_IMG, W_IMG, 3)).astype(np.float32))
    x = img.to("cuda")

    with torch.no_grad():
        torch.cuda.synchronize()
        ref_attn_diffusion.launches = 0
        fused_conv.reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        k1_n = ref_attn_diffusion.launches
        k2_n = conv3x3_ln_act.launches
        k2_links = dict(conv3x3_ln_act.shape_launches)
    log(f"[model] launches in one forward: K1 {k1_n}, K2 {k2_n}")
    for key, n in sorted(k2_links.items(), key=str):
        log(f"[model]   K2 link {key}: {n}")
    assert k1_n == 4, f"K1 launched {k1_n} times, expected 4"
    assert k2_n == 25, f"K2 launched {k2_n} times, expected 25"

    Q = cfg.num_queries
    expect = {"pred_logits": (1, Q, 2), "pred_lines": (1, Q, cfg.line_dim),
              "pred_seg": (1, H_IMG, W_IMG, 2)}
    for k, shp in expect.items():
        assert tuple(out[k].shape) == shp, f"{k} {tuple(out[k].shape)}"
        assert torch.isfinite(out[k]).all(), f"{k} not finite"
    depth_shapes = [(1, H_IMG // s, W_IMG // s) for s in (16, 8, 4, 1)]
    for d, shp in zip(out["pred_depth"], depth_shapes):
        assert tuple(d.shape) == shp, f"pred_depth {tuple(d.shape)}"
        assert torch.isfinite(d).all(), "pred_depth not finite"

    with torch.no_grad():
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = float(np.median(times))
    log(f"[model] forward bs1 {H_IMG}x{W_IMG}: median {fwd_ms:.3f} ms over "
        f"{len(times)} runs on {card}")
    with torch.no_grad():
        profile_device(lambda: model(x), fwd_ms, "forward_ms", "profile")

    t0 = time.perf_counter()
    with torch.no_grad():
        out_cpu = model_cpu(img)
    log(f"[model] CPU forward of the same port: "
        f"{time.perf_counter() - t0:.1f} s")
    cmp = {}
    for k in ("pred_logits", "pred_lines"):
        a, b = out[k].cpu(), out_cpu[k]
        cmp[k] = float((a - b).abs().max())
        assert cmp[k] <= LINE_TOL, f"{k}: card vs CPU {cmp[k]} > {LINE_TOL}"
    for k, a, b in (("pred_depth[-1]", out["pred_depth"][-1],
                     out_cpu["pred_depth"][-1]),
                    ("pred_seg", out["pred_seg"], out_cpu["pred_seg"])):
        cmp[k] = _rel_l2(a.cpu(), b)
        assert cmp[k] <= DENSE_REL_L2_TOL, \
            f"{k}: card vs CPU rel L2 {cmp[k]} > {DENSE_REL_L2_TOL}"
    log("[model] card vs CPU: " + json.dumps(cmp))
    return k1_n, k2_n, k2_links


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def phase_serve():
    from PIL import Image
    from gwdepth_tpu_torch.predict import main as predict_main

    rng = np.random.default_rng(SEED + 2)
    sizes = {"wide": (720, 1280), "vga": (480, 640), "portrait": (1024, 768)}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "images")
        dst = os.path.join(tmp, "out")
        os.makedirs(src)
        for name, (h, w) in sizes.items():
            arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(src, f"{name}.png"))
        t0 = time.perf_counter()
        predict_main(["--images", src, "--output_dir", dst,
                      "--device", "cuda"])
        secs = time.perf_counter() - t0
        for name, (h, w) in sizes.items():
            for suffix in ("_depth.npy", "_depth.png", "_seg.png",
                           "_lines.json"):
                path = os.path.join(dst, name + suffix)
                assert os.path.exists(path), f"missing {path}"
            depth = np.load(os.path.join(dst, f"{name}_depth.npy"))
            assert depth.shape == (h, w) and np.isfinite(depth).all(), \
                f"{name}: depth {depth.shape}"
    log(f"[serve] {len(sizes)} images through predict.main in {secs:.1f} s")


# ---------------------------------------------------------------------------
# backward phase
# ---------------------------------------------------------------------------

# K2 links of one forward at the 1/8 and 1/4 scales: (scale, Ci, Co, act,
# links of this kind per forward) -- the trunk of each PyramidLayer
# (firstconv 2, then 5 BasicBlocks of a GELU and a plain link) and the
# 1/8 head's `last0`
K2_PATH = [
    (8, 30, 30, "gelu", 1), (8, 30, 60, "gelu", 1), (8, 60, 60, "gelu", 5),
    (8, 60, 60, None, 5), (8, 300, 120, "gelu", 1),
    (4, 80, 80, "gelu", 1), (4, 80, 160, "gelu", 1),
    (4, 160, 160, "gelu", 5), (4, 160, 160, None, 5),
]
K2_FWD_PER_FORWARD = sum(n for *_, n in K2_PATH)               # 25
# backward of a link: one recompute, dx in ceil(Ci / MAX_CO) pieces
K2_BWD_PER_STEP = sum(n * (1 + -(-ci // fused_conv.MAX_CO))
                      for _, ci, _, _, n in K2_PATH)            # 51
K1_PER_FORWARD = 4
TRAIN_HW = (704, 1024)
TRAIN_BS = 2
K1_TRAIN_SHAPE = (TRAIN_BS, 980, 40, 16)
# gradients: kernel Function vs autograd through the plain version, both
# float32; the weight gradient sums B*H*W = up to 90k products per
# element in another order, so the tolerance scales with max(1, the
# call's largest |reference gradient|)
GRAD_TOL = 1e-4
# train step card vs CPU at the shipped widths: the losses pass through the
# host matcher and the top-k point choices, where a float near-tie could
# flip between devices; held by relative error
TRAIN_LOSS_REL_TOL = 1e-3
# every gradient tensor above a norm floor of 1e-6 x the largest
TRAIN_GRAD_REL_L2_TOL = 1e-3


def bwd_time_ms(y, leaves, ct, reps: int = 10, library: bool = False) -> float:
    """Median device time of one backward of a kept graph (`library`: a
    cuDNN yardstick, timed as `library_ms` times it)."""
    timer = library_ms if library else time_ms
    return timer(lambda: torch.autograd.grad(y, leaves, ct,
                                             retain_graph=True),
                 reps=reps, warmup=2)


def _leaves(*ts):
    return [None if t is None else t.detach().clone().requires_grad_()
            for t in ts]


def _max_scaled_err(got, want) -> float:
    """Largest error over the gradients of one call, scaled by max(1, the
    call's largest reference gradient): K1's bias gradient is zero in
    exact arithmetic (the parameter-free LayerNorm removes a per-head
    constant), so it holds float noise of the size of the others."""
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale


def phase_backward(rng, dev):
    """K2 at every train-canvas link and K1 at its train shape: forward
    and backward of the kernel's Function against autograd through the
    plain version and the cuDNN/ATen composition."""
    recs = {}
    for scale, Ci, Co, act, _ in K2_PATH:
        H, W = TRAIN_HW[0] // scale, TRAIN_HW[1] // scale
        B = TRAIN_BS
        x = torch.from_numpy(rng.normal(size=(B, H, W, Ci)).astype(np.float32))
        w = torch.from_numpy((rng.normal(size=(3, 3, Ci, Co))
                              / np.sqrt(9 * Ci)).astype(np.float32))
        g = torch.from_numpy((1 + 0.1 * rng.normal(size=(Co,)))
                             .astype(np.float32))
        b = torch.from_numpy((0.1 * rng.normal(size=(Co,))).astype(np.float32))
        ct = torch.from_numpy(rng.normal(size=(B, H, W, Co))
                              .astype(np.float32))
        x, w, g, b, ct = (t.to(dev) for t in (x, w, g, b, ct))
        inputs = _leaves(x, w, g, b)

        fused_conv.reset_counts()
        y = conv3x3_ln_act(*inputs, None, act)
        got = torch.autograd.grad(y, inputs, ct, retain_graph=True)
        torch.cuda.synchronize()
        assert y.grad_fn is not None, "K2 output has no grad_fn"
        n_bwd = conv3x3_ln_act.bwd_launches
        assert n_bwd == 1 + -(-Ci // fused_conv.MAX_CO), n_bwd
        y_plain = conv3x3_ln_act_plain(*inputs, None, act)
        want = torch.autograd.grad(y_plain, inputs, ct, retain_graph=True)
        lib_leaves = [t.requires_grad_() for t in k2_library_inputs(x, w)]
        lib_leaves += _leaves(g, b)
        with cudnn_autotuned():
            y_lib = k2_library(*lib_leaves, None, act)
            dxl, dwl, dgl, dbl = torch.autograd.grad(y_lib, lib_leaves, ct,
                                                     retain_graph=True)
        lib = (dxl.permute(0, 2, 3, 1), dwl.permute(2, 3, 1, 0), dgl, dbl)
        fwd_err = float((y - y_plain).abs().max())
        assert torch.isfinite(y).all(), f"K2 {H}x{W} {Ci}->{Co} not finite"
        assert fwd_err <= K2_TOL, \
            f"K2 {B}x{H}x{W} {Ci}->{Co} {act}: max abs err {fwd_err} > {K2_TOL}"
        err = _max_scaled_err(got, want)
        assert all(torch.isfinite(t).all() for t in got), "K2 grad not finite"
        assert err <= GRAD_TOL, \
            f"K2 bwd {H}x{W} {Ci}->{Co} {act}: scaled err {err} > {GRAD_TOL}"
        xd, wd = x, w
        w_flip = wd.flip(0, 1).transpose(2, 3).contiguous()
        dc = ct

        def kernel_bwd():
            fused_conv._conv_bwd(xd, wd)
            fused_conv._conv_bwd(dc, w_flip)

        def plain_two_convs():
            conv3x3_ln_act_plain(xd, wd)
            conv3x3_ln_act_plain(dc, w_flip)

        conv_flops = 2 * B * H * W * Ci * Co * 9
        fwd_bytes = 4 * (B * H * W * (Ci + Co) + 9 * Ci * Co + 2 * Co)
        # backward launches: recompute (reads x, w; writes the pre-LN
        # conv) and dx (reads dc, w; writes dx)
        bwd_bytes = 4 * (2 * B * H * W * (Ci + Co) + 2 * 9 * Ci * Co)
        xl, wl = k2_library_inputs(x, w)
        with torch.no_grad():
            fwd = {"max_err": fwd_err,
                   "kernel_ms": time_ms(
                       lambda: conv3x3_ln_act(x, w, g, b, None, act)),
                   "plain_ms": time_ms(
                       lambda: conv3x3_ln_act_plain(x, w, g, b, None, act),
                       reps=10),
                   "library_ms": library_ms(
                       lambda: k2_library(xl, wl, g, b, None, act)),
                   **bound_fields(conv_flops, fwd_bytes)}
            bwd_kernel_ms = time_ms(kernel_bwd)
            bwd_plain_convs_ms = time_ms(plain_two_convs, reps=10)
            bwd_total_ms = time_ms(lambda: fused_conv.fused_backward(
                xd, wd, g, b, act, ct), reps=10)
        rec = {"name": "K2", "shape": [B, H, W, Ci, Co], "act": act,
               "fwd": fwd,
               "bwd": {"max_scaled_err": err,
                       "library_max_scaled_err": _max_scaled_err(lib, want),
                       "launches": n_bwd,
                       "kernel_ms": bwd_kernel_ms,
                       "plain_convs_ms": bwd_plain_convs_ms,
                       "backward_ms": bwd_total_ms,
                       "plain_ms": bwd_time_ms(y_plain, inputs, ct),
                       "library_ms": bwd_time_ms(y_lib, lib_leaves, ct,
                                                 library=True),
                       **bound_fields(2 * conv_flops, bwd_bytes)}}
        log("[backward] " + json.dumps(rec))
        recs[(B, H, W, Ci, Co, act, True, False)] = rec

    a = torch.from_numpy(rng.normal(size=K1_TRAIN_SHAPE).astype(np.float32))
    Hh = K1_TRAIN_SHAPE[3]
    w = torch.from_numpy((rng.normal(size=(3, 3, Hh, Hh))
                          / np.sqrt(9 * Hh)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(Hh,))).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=K1_TRAIN_SHAPE).astype(np.float32))
    a, w, b, ct = (t.to(dev) for t in (a, w, b, ct))
    inputs = _leaves(a, w, b)
    y = ref_attn_diffusion(*inputs)
    assert y.grad_fn is not None, "K1 output has no grad_fn"
    got = torch.autograd.grad(y, inputs, ct, retain_graph=True)
    y_plain = ref_attn_diffusion_plain(*inputs)
    want = torch.autograd.grad(y_plain, inputs, ct, retain_graph=True)
    y_lib = diffusion_torch(*inputs)
    fwd_err = float((y - y_plain).abs().max())
    assert torch.isfinite(y).all(), "K1 output not finite"
    assert fwd_err <= K1_TOL, f"K1 train shape max abs err {fwd_err} > {K1_TOL}"
    err = _max_scaled_err(got, want)
    assert err <= GRAD_TOL, f"K1 bwd scaled err {err} > {GRAD_TOL}"
    Bk, P, R, _ = K1_TRAIN_SHAPE
    conv = 2 * Bk * P * R * Hh * Hh * 9
    with torch.no_grad():
        fwd = {"max_err": fwd_err,
               "kernel_ms": time_ms(lambda: ref_attn_diffusion(a, w, b)),
               "plain_ms": time_ms(lambda: ref_attn_diffusion_plain(a, w, b)),
               "library_ms": time_ms(lambda: diffusion_torch(a, w, b)),
               **bound_fields(3 * conv,
                              4 * (2 * a.numel() + 9 * Hh * Hh + Hh))}
    k1 = {"name": "K1", "shape": list(K1_TRAIN_SHAPE), "fwd": fwd,
          "bwd": {"max_scaled_err": err,
                  "backward_ms": bwd_time_ms(y, inputs, ct),
                  "plain_ms": bwd_time_ms(y_plain, inputs, ct),
                  "library_ms": bwd_time_ms(y_lib, inputs, ct),
                  # recompute, dx and dw of each of the 3 convs
                  **bound_fields(3 * 3 * conv,
                                 4 * (3 * a.numel() + 2 * 9 * Hh * Hh))}}
    log("[backward] " + json.dumps(k1))
    return recs, k1


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def _counts():
    from gwdepth_tpu_torch.ops.lap import match_lines
    return {"k1": ref_attn_diffusion.launches,
            "k2": conv3x3_ln_act.launches,
            "k2_bwd": conv3x3_ln_act.bwd_launches,
            "matcher_calls": match_lines.calls}


def _reset_counts():
    from gwdepth_tpu_torch.ops import ref_attn_diffusion as k1_mod
    from gwdepth_tpu_torch.ops.lap import match_lines
    k1_mod.reset_counts()
    fused_conv.reset_counts()
    match_lines.calls = 0
    match_lines.solve_seconds = 0.0


def _expected_counts(steps: int, eval_forwards: int) -> dict:
    return {"k1": K1_PER_FORWARD * (steps + eval_forwards),
            "k2": K2_FWD_PER_FORWARD * (steps + eval_forwards),
            "k2_bwd": K2_BWD_PER_STEP * steps,
            "matcher_calls": steps + eval_forwards}


def phase_train(card: str, tmp: str):
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.ops.lap import match_lines
    from gwdepth_tpu_torch.parallel import make_train_step
    from gwdepth_tpu_torch.tools.synthetic import generate_dataset

    n_train, n_val = 8, 2
    root = os.path.join(tmp, "ds")
    t0 = time.perf_counter()
    generate_dataset(root, n_train, n_val, height=720, width=1280, seed=SEED)
    log(f"[train] {n_train}+{n_val} synthetic scenes at 720x1280 in "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "exp")
    args = ["--device", "cuda", "--with_line", "--with_dense",
            "--with_center", "--num_workers", "4", "--output_dir", out,
            "--data_path", f"{root}/rgb", "--gt_depth_path", f"{root}/depth",
            "--gt_seg_path", f"{root}/seg", "--gt_line_path", f"{root}/lines",
            "--filenames_file_train", f"{root}/train.txt",
            "--filenames_file_eval", f"{root}/val.txt"]
    cfg = train_main.config_from_args(train_main.build_argparser()
                                      .parse_args(args))
    assert cfg.train_hw == TRAIN_HW and cfg.batch_size == TRAIN_BS
    assert cfg.dropout == 0.1 and cfg.num_queries == 100
    init = build_glassrgbd(cfg, cfg.seed, device="cpu").state_dict()
    steps = n_train // cfg.batch_size

    runs = {}
    for label, extra in (("epoch0", ["--epochs", "1"]),
                         ("resume", ["--epochs", "2", "--resume", "auto"])):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state = train_main.main(args + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _counts()
        want = _expected_counts(steps, n_val)
        log(f"[train] main.main {label}: {secs:.1f} s, launches {got}, "
            f"expected {want}")
        assert got == want, f"{label}: launches {got} != {want}"
        runs[label] = {"seconds": secs, **got}

    logs = [json.loads(l) for l in open(os.path.join(out, "log.txt"))]
    assert [l["epoch"] for l in logs] == [0, 1], logs
    for l in logs:
        bad = [k for k, v in l.items() if not np.isfinite(v)]
        assert not bad, f"non-finite log values {bad}"
    for name in ("eval_results.txt", "log.txt",
                 os.path.join("checkpoints", "checkpoint.pth")):
        assert os.path.exists(os.path.join(out, name)), f"missing {name}"
    evals = open(os.path.join(out, "eval_results.txt")).read().splitlines()
    assert len(evals) == 2 and evals[0].startswith("oneline eval epoch0")
    log(f"[train] log.txt epoch 1: loss {logs[-1]['train_loss']}, "
        f"test rms {logs[-1]['test_rms']}")
    log(f"[train] {evals[-1]}")

    final = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    frozen = [n for n, p in state.model.named_parameters()
              if not p.requires_grad]
    assert frozen and all(torch.equal(final[n], init[n]) for n in frozen), \
        "a frozen stem parameter changed"
    trained = [n for n, p in state.model.named_parameters() if p.requires_grad]
    still = [n for n in trained if torch.equal(final[n], init[n])]
    # a tensor the loss does not reach only decays by lr * weight_decay
    # (1e-8), below float32 resolution; the rest must move
    assert len(still) <= 0.1 * len(trained), f"unmoved: {still}"
    log(f"[train] {len(frozen)} frozen tensors bit-equal; "
        f"{len(trained) - len(still)} of {len(trained)} trained tensors "
        f"moved (unmoved: {still})")

    # ms/step: the trained state, batches decoded ahead onto the card
    loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=TRAIN_BS,
                    seed=SEED, num_workers=4)
    batches = [b.to("cuda") for b, _ in loader.epoch(5)]
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times, solve = [], []
    for i in range(10):
        torch.cuda.synchronize()
        match_lines.solve_seconds = 0.0
        t0 = time.perf_counter()
        state, vec = step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
            solve.append(match_lines.solve_seconds * 1e3)
        assert torch.isfinite(vec).all(), "non-finite train loss"
    step_ms = float(np.median(times))
    matcher_ms = float(np.median(solve))
    log(f"[train] train step bs{TRAIN_BS} {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
        f"median {step_ms:.3f} ms over {len(times)} steps "
        f"({json.dumps(times)}) on {card}; host matcher solve "
        f"{matcher_ms:.3f} ms/step, share {matcher_ms / step_ms:.4f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prof = profile_device(lambda: step(state, batches[0], gen), step_ms,
                          "step_ms", "train-profile")
    return runs, {"step_ms": step_ms, "matcher_ms": matcher_ms,
                  "step_times": times, "profile": prof}


def phase_train_card_vs_cpu():
    """One train step's losses and gradients on the card and on the CPU:
    the shipped widths on a 128x192 canvas, dropout 0, one batch."""
    from gwdepth_tpu_torch.data.batch import dummy_batch
    from gwdepth_tpu_torch.parallel import compute_losses

    cfg = GWDepthConfig(dropout=0.0, train_hw=(128, 192))
    batch = dummy_batch(cfg, TRAIN_BS, num_lines=6, seed=SEED)
    model_cpu = build_glassrgbd(cfg, SEED, device="cpu").train()
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    res = {}
    for name, model, dev in (("cpu", model_cpu, "cpu"),
                             ("cuda", model_gpu, "cuda")):
        b = batch.to(dev)
        _, logs = compute_losses(cfg, model(b.images, b.valid), b)
        logs["loss"].backward()
        res[name] = ({k: float(v.detach()) for k, v in logs.items()},
                     {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    (lc, gc), (lg, gg) = res["cpu"], res["cuda"]
    loss_rel = {k: abs(lg[k] - lc[k]) / max(1.0, abs(lc[k])) for k in lc}
    top = max(float(v.norm()) for v in gc.values())
    rel = {n: _rel_l2(gg[n], gc[n]) for n in gc
           if float(gc[n].norm()) >= 1e-6 * top}
    line = [n for n in rel if n.startswith(
        ("transformer.", "class_embed", "lines_embed", "query_embed",
         "input_proj"))]
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    summary = {"max_loss_rel": max(loss_rel.values()),
               "grad_tensors": len(rel),
               "grad_rel_l2_median": float(np.median(list(rel.values()))),
               "grad_rel_l2_max": worst[0][1],
               "line_branch_rel_l2_max": max(rel[n] for n in line),
               "worst": worst}
    log("[train-cmp] card vs CPU: " + json.dumps(summary))
    assert set(gg) == set(gc)
    assert summary["max_loss_rel"] <= TRAIN_LOSS_REL_TOL, loss_rel
    assert summary["grad_rel_l2_max"] <= TRAIN_GRAD_REL_L2_TOL, worst
    return summary


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    smi = probe()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    phase_build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        k1 = phase_k1(rng, dev)
        k2 = phase_k2(rng, dev)
    k1_n, k2_n, k2_links = phase_model(card)
    phase_serve()
    k2_train, k1_train = phase_backward(rng, dev)
    with tempfile.TemporaryDirectory() as tmp:
        runs, train = phase_train(card, tmp)
    phase_train_card_vs_cpu()

    missing = [key for key in k2_links if key not in k2]
    assert not missing, f"main-path K2 links not timed: {missing}"

    def per_forward(field):
        return sum(n * k2[key][field] for key, n in k2_links.items())

    def per_step(part, field):
        """Sum over the train links of the links per forward x the
        per-call `field` of the forward or backward record."""
        return sum(n * k2_train[(TRAIN_BS, TRAIN_HW[0] // sc,
                                 TRAIN_HW[1] // sc, ci, co, act, True,
                                 False)][part][field]
                   for sc, ci, co, act, n in K2_PATH)

    def bound_by(total):
        return ("operations" if total("ops_ms") >= total("bytes_ms")
                else "bytes")

    def train_fwd(field):
        return per_step("fwd", field)

    def train_bwd(field):
        return per_step("bwd", field)

    k2_train_err = max(r["fwd"]["max_err"] for r in k2_train.values())
    k2_bwd_err = max(r["bwd"]["max_scaled_err"] for r in k2_train.values())
    run = runs["epoch0"]
    kernels = [
        {"name": "ref_attn_diffusion", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/ref_attn_diffusion.cu",
         "replaces": "gwdepth_tpu/ops/pallas_kernels.py:112",
         "launches": k1_n,
         "max_abs_err": max(k1["max_err"], k1_train["fwd"]["max_err"]),
         "ms": k1_n * k1["kernel_ms"], "plain_ms": k1_n * k1["plain_ms"],
         "bound_ms": k1_n * k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1_n * k1["library_ms"],
         "train_launches": run["k1"],
         "train_launches_per_step": K1_PER_FORWARD,
         "train_ms": K1_PER_FORWARD * k1_train["fwd"]["kernel_ms"],
         "train_plain_ms": K1_PER_FORWARD * k1_train["fwd"]["plain_ms"],
         "train_bound_ms": K1_PER_FORWARD * k1_train["fwd"]["bound_ms"],
         "train_bound_by": k1_train["fwd"]["bound_by"],
         "train_library_ms": K1_PER_FORWARD * k1_train["fwd"]["library_ms"],
         # no backward kernel: the backward is plain PyTorch
         "train_backward_max_scaled_err": k1_train["bwd"]["max_scaled_err"],
         "train_backward_ms": K1_PER_FORWARD * k1_train["bwd"]["backward_ms"],
         "train_backward_plain_ms":
             K1_PER_FORWARD * k1_train["bwd"]["plain_ms"]},
        {"name": "conv3x3_ln_act", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/conv3x3_ln_act.cu",
         "replaces": "gwdepth_tpu/ops/fused_conv.py:378",
         "launches": k2_n,
         "max_abs_err": max(k2_train_err,
                            max(r["max_err"] for r in k2.values())),
         "ms": per_forward("kernel_ms"), "plain_ms": per_forward("plain_ms"),
         "bound_ms": per_forward("bound_ms"), "bound_by": bound_by(per_forward),
         "library_ms": per_forward("library_ms"),
         "train_launches": run["k2"],
         "train_launches_per_step": K2_FWD_PER_FORWARD,
         "train_ms": train_fwd("kernel_ms"),
         "train_plain_ms": train_fwd("plain_ms"),
         "train_bound_ms": train_fwd("bound_ms"),
         "train_bound_by": bound_by(train_fwd),
         "train_library_ms": train_fwd("library_ms")},
        {"name": "conv3x3_ln_act_backward", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/conv3x3_ln_act.cu",
         "replaces": "gwdepth_tpu/ops/fused_conv.py:378",
         "launches": run["k2_bwd"],
         "launches_per_step": K2_BWD_PER_STEP,
         "max_abs_err": k2_bwd_err,
         "ms": train_bwd("kernel_ms"),
         "plain_ms": train_bwd("plain_ms"),
         "bound_ms": train_bwd("bound_ms"), "bound_by": bound_by(train_bwd),
         "library_ms": train_bwd("library_ms"),
         "backward_ms": train_bwd("backward_ms"),
         "plain_convs_ms": train_bwd("plain_convs_ms")},
    ]
    log("[kernels] K1 and K2: launches, ms, plain_ms, bound_ms and "
        "library_ms per 768x1024 bs1 serving forward (launches on that path "
        "x the per-call medians above); train_* per train step at bs2 "
        "704x1024, train_launches over the first main.main train run (4 "
        "steps, 2 eval forwards). K2 backward: launches over that run, the "
        "times per train step; ms = the recompute and dx launches, "
        "backward_ms = the whole Function backward (kernel, LayerNorm "
        "backward, dw matmuls), plain_ms / library_ms = autograd through "
        "the plain version / F.conv2d + F.layer_norm + act on contiguous "
        "NCHW with cuDNN autotuned; its max_abs_err is scaled by max(1, "
        "the call's largest reference gradient). "
        f"train step median {train['step_ms']:.3f} ms, host matcher "
        f"{train['matcher_ms']:.3f} ms")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
