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
              card at every main-path shape, with seeded inputs (K2 in its
              bf16-tap precision, `fast=True`; K1 also at the gated
              forward's planes, the class-layer ones in its device-memory
              schedule, two calls bit-equal); time the kernel, the plain
              version and a cuDNN/ATen composition of the same function
              (conv2d + layer_norm + activation; K2's in bf16 on
              channels-last, and as before in float32 on contiguous NCHW,
              cuDNN autotuned) with CUDA events, medians of 30 runs after
              warm-up, and device times of 10 calls in a CUDA graph;
  4. model    GlassRGBD(GWDepthConfig(dropout=0.0, use_pallas=True)) at
              768x1024, batch 1, weights from a seed (the repo holds no
              checkpoint): one forward on the card with the launch counts
              zeroed just before and read just after (K1 must launch 4
              times, K2 25 times, K3 and K4 not at all),
              output shapes and finiteness, the median forward time, a
              torch.profiler breakdown of one forward's device time (by
              kernel name, and the device's idle share; each K1 call must
              be one CUDA kernel), and the same
              forward on the CPU (the wrappers take the plain versions
              there) compared with the card's; then the same weights with
              use_pallas=False: no K1 or K2 launch, its median time, and
              its distance from the kernels' forward;
  5. serve    three seeded synthetic images of different aspect ratios
              through `gwdepth_tpu_torch.predict.main` on the card (K1 4
              and K2 25 launches per image); every output file must
              exist;
  6. backward at every train-canvas shape of K2 (bs2, 88x128 and 176x256)
              and of K1: each kernel's forward output and its
              autograd.Function's gradients of every input against the
              plain version and autograd through it, and forward and
              backward times of the kernel, the plain version, the
              cuDNN/ATen compositions, and the bound;
  7. train    8 train and 2 val synthetic scenes at 720x1280 through
              `gwdepth_tpu_torch.main.main --use_pallas` on the card at the
              shipped config (bs2 704x1024, dropout 0.1): one epoch of 4 steps,
              eval, checkpoint, then a `--resume` epoch; the launch counts
              of each run are zeroed just before and read just after and
              must equal the numbers the link list gives; finite losses,
              output files, frozen stem bit-equal, trained weights moved;
              then the median ms/step, the host matcher's share and a
              torch.profiler split of one step;
  8. train card vs CPU  one train step's losses and every gradient tensor
              at the shipped widths on a 128x192 canvas, dropout 0, the
              same weights and batch on both devices: without the kernels
              (float32 throughout; no K1 or K2 launch), and with them
              (use_pallas; K1 4, K2 25 and 51 backward launches; held at
              fixed bf16-tap limits that a control, the CPU's step on
              images perturbed by 1e-7, must exceed threefold; the
              depth points each run samples are reported); see
              `phase_train_card_vs_cpu`;
  9. window attention  the entries that reach K3 (windowed MSA) and K4
              (layout fence), which no model path calls: one forward of
              the shipped model at 768x1024 bs1 and one at 704x1024 bs2
              record the q, k, v, bias and mask of every `swin.window_msa`
              site (9 at 768x1024) and the input of every class-attention
              module (5); with the launch counts zeroed just before and
              read just after, `swin.window_msa(use_pallas=True)` runs at
              the 9 serving sites (against the model's own result and the
              plain version) and `fused_window_attention` at the 5 serving
              class sites with each module's weights (against the module's
              projection output) and, forward and backward, at the 5 train
              sites (gradients against autograd through the plain
              version); K4 must launch once per fused call, K3 once per
              kernel or fused call; then kernel, plain, SDPA-library and
              bound times per site, and K4's device time per site beside
              `Tensor.copy_`'s, with the profiler's name for what `copy_`
              runs.
  10-12.    the depth-only model serving, the eval outputs and the
              line-only training (see `phase_depth_only`,
              `phase_eval_outputs`, `phase_line_only`);
  13. gated  (run right after phase 10) the gated model (`GATED_CFG`:
              group attention in every class block, token fusion in every
              class layer, line-depth tokens, three reference points a
              line) serving at 768x1024 bs1 with
              `use_pallas`: K1 9 launches (4 at 1/32, 2 at 1/16, 2 at 1/8,
              1 at 1/4), K2 25, no K3 or K4; card vs CPU at phase 4's
              limits; median forward time, device busy time and idle
              share; then one forward without point sampling (K1 6, K2 0).
Then one JSON line lists each kernel with its launches and times per
serving forward and, under `train_*`, per train step (K2's backward per
train step; K3 and K4: the phase-9 launches beside those counted in
phase 4's forward and phase 7's first train run, times summed over its
serving sites, `train_*` over its train sites), and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
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
from gwdepth_tpu_torch.models import build_glassrgbd, swin
from gwdepth_tpu_torch.ops import fused_conv
from gwdepth_tpu_torch.ops.fused_conv import (conv3x3_ln_act,
                                              conv3x3_ln_act_plain, link_key)
from gwdepth_tpu_torch.ops import window_msa as wm
from gwdepth_tpu_torch.ops.ref_attn_diffusion import (
    diffusion_torch, ref_attn_diffusion, ref_attn_diffusion_plain)

# H100 SXM data-sheet peaks (dense): float32 on the CUDA cores, bf16 on
# the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

# kernel vs plain version on the card, both summing float32 products (the
# plain version's matmuls without TF32; K2's products of bf16-rounded
# operands, exact in float32, on both sides): reassociation of sums of up
# to 2700 products after a LayerNorm, far below this
K1_TOL = 1e-4
K2_TOL = 1e-4
# K3 against its plain version and the model's einsum/softmax path, all
# float32 without TF32: reassociation of 49-term sums and of the softmax
K3_TOL = 1e-4
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


def bound_fields(flops: float, nbytes: float,
                 peak: float = PEAK_F32_FLOPS) -> dict:
    """Least time on the card: the larger of the arithmetic time at `peak`
    (float32 on the CUDA cores unless given) and the memory time, with
    both parts."""
    t_ops = flops / peak * 1e3
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


def library_device_ms(fn) -> float:
    """`graph_ms` of K2's cuDNN/ATen yardstick, autotuned in the warm-up
    calls before the capture."""
    with cudnn_autotuned():
        return graph_ms(fn)


def k2_library_inputs(x, w):
    """x (B, H, W, Ci) and w (3, 3, Ci, Co) as cuDNN takes them in float32:
    contiguous (B, Ci, H, W) and (Co, Ci, 3, 3)."""
    return (x.permute(0, 3, 1, 2).contiguous(),
            w.permute(3, 2, 0, 1).contiguous())


def k2_library(x_nchw, w_oihw, g, b, r, act):
    """cuDNN/ATen composition of K2's function in float32 (the earlier
    yardstick), on the inputs of `k2_library_inputs`; (B, H, W, Co)."""
    y = F.conv2d(x_nchw, w_oihw, padding=1).permute(0, 2, 3, 1)
    y = F.layer_norm(y, (w_oihw.shape[0],), g, b, eps=1e-5)
    y = fused_conv.apply_act(y, act)
    return y if r is None else y + r


def k2_bf16_weight(w):
    """w (3, 3, Ci, Co) float32 as cuDNN's bf16 channels-last conv takes
    it: (Co, Ci, 3, 3) bf16 in channels-last memory."""
    return w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


def k2_library_bf16(x, w_cl, g, b, r, act):
    """cuDNN/ATen composition of K2's function at K2's precision (the
    yardstick): the float32 NHWC x cast to bf16 (a channels-last NCHW view
    of it), cuDNN's bf16 conv on channels-last with float32 accumulation,
    its bf16 output back to float32 for F.layer_norm, act and residual;
    (B, H, W, Co) float32."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.bfloat16), w_cl, padding=1)
    y = F.layer_norm(y.permute(0, 2, 3, 1).float(), (w_cl.shape[0],), g, b,
                     eps=1e-5)
    y = fused_conv.apply_act(y, act)
    return y if r is None else y + r


# K1's planes: the serving forward's 1/32 plane first (the shipped model),
# then the gated forward's (`GATED_CFG`): the 1/32 plane with three
# reference points a line, the 1/16, 1/8 and 1/4 class planes (the band
# schedule takes the 1/32 planes, the device-memory schedule the others),
# and the 1/8 plane at B=2
K1_SITES = [(1, 980, 40, 16), (1, 980, 60, 16), (1, 3430, 60, 16),
            (1, 13034, 30, 16), (1, 50764, 80, 16), (2, 13034, 30, 16)]
# K1 launches of one gated forward by plane
GATED_K1 = {(1, 980, 60, 16): 4, (1, 3430, 60, 16): 2, (1, 13034, 30, 16): 2,
            (1, 50764, 80, 16): 1}


def k1_site(rng, dev, shape) -> dict:
    """K1 at one plane shape against its plain version (K1_TOL), two calls
    bit-equal, and its times: CUDA events (`*_ms`) and CUDA-graph replays
    (`*device_ms`) of the kernel, the plain version and `diffusion_torch`
    (the library yardstick), beside the bound."""
    from gwdepth_tpu_torch.ops import ref_attn_diffusion as k1_mod

    B, P, R, H = shape
    a = torch.from_numpy(rng.normal(size=(B, P, R, H)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, H, H))
                          / np.sqrt(9 * H)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(H,))).astype(np.float32))
    a, w, b = a.to(dev), w.to(dev), b.to(dev)
    plan = k1_mod.plan(B, P, R, H, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    got = ref_attn_diffusion(a, w, b)
    want = ref_attn_diffusion_plain(a, w, b)
    lib = diffusion_torch(a, w, b)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    lib_err = float((lib - want).abs().max())
    assert torch.isfinite(got).all(), f"K1 {shape} output not finite"
    assert err <= K1_TOL, f"K1 {shape} max abs err {err} > {K1_TOL}"
    again = ref_attn_diffusion(a, w, b)
    assert torch.equal(again, got), f"K1 {shape} is not deterministic"
    del want, lib, again
    flops = 3 * 2 * B * P * R * H * H * 9
    nbytes = 4 * (2 * B * P * R * H + 9 * H * H + H)
    rec = {"name": "K1", "shape": [B, P, R, H],
           "schedule": ("device-memory" if isinstance(plan, k1_mod.TilePlan)
                        else "band"),
           "blocks": B * plan.nbp, "max_err": err, "library_max_err": lib_err,
           "kernel_ms": time_ms(lambda: ref_attn_diffusion(a, w, b)),
           "plain_ms": time_ms(lambda: ref_attn_diffusion_plain(a, w, b),
                               reps=10),
           "library_ms": time_ms(lambda: diffusion_torch(a, w, b)),
           "device_ms": graph_ms(lambda: ref_attn_diffusion(a, w, b)),
           "library_device_ms": graph_ms(lambda: diffusion_torch(a, w, b)),
           **bound_fields(flops, nbytes)}
    log(json.dumps(rec))
    return rec


def phase_k1(rng, dev) -> dict:
    """`k1_site` at every plane of K1_SITES, keyed by shape."""
    return {tuple(shape): k1_site(rng, dev, shape) for shape in K1_SITES}


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


def k2_bounds(flops: float, nbytes: float) -> dict:
    """K2's bound (bf16 tensor-core FLOPs or float32 bytes) and, under
    `f32_*`, the float32 CUDA-core bound its earlier kernel was held to."""
    f32 = bound_fields(flops, nbytes)
    return {**bound_fields(flops, nbytes, PEAK_BF16_FLOPS),
            "f32_bound_ms": f32["bound_ms"], "f32_bound_by": f32["bound_by"]}


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
        wb = k2_bf16_weight(w)
        with cudnn_autotuned():
            lib = k2_library_bf16(x, wb, g, b, r, act)
            lib32 = k2_library(xl, wl, g, b, r, act)
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
               "tile": fused_conv.kernel_tile(1, H, W, Co),
               "library_max_err": float((lib - want).abs().max()),
               "library_f32_max_err": float((lib32 - want).abs().max()),
               "kernel_ms": time_ms(lambda: conv3x3_ln_act(x, w, g, b, r, act)),
               "plain_ms": time_ms(
                   lambda: conv3x3_ln_act_plain(x, w, g, b, r, act)),
               "library_ms": library_ms(
                   lambda: k2_library_bf16(x, wb, g, b, r, act)),
               "library_f32_ms": library_ms(
                   lambda: k2_library(xl, wl, g, b, r, act)),
               "device_ms": graph_ms(
                   lambda: conv3x3_ln_act(x, w, g, b, r, act)),
               "library_device_ms": library_device_ms(
                   lambda: k2_library_bf16(x, wb, g, b, r, act)),
               **k2_bounds(flops, nbytes)}
        log(json.dumps(rec))
        recs[link_key(x, w, g, r, act)] = rec
    return recs


# ---------------------------------------------------------------------------
# model phase
# ---------------------------------------------------------------------------

_K1_NAMES = ("diffusion_kernel", "diffusion_tiled_kernel")
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

    def count(keys):
        return sum(n for name, (_, n) in by_name.items()
                   if any(k in name for k in keys))

    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    rec = {label: wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "device_kernels": len(spans), "k1_ms": share(_K1_NAMES),
           "k1_kernels": count(_K1_NAMES), "k2_ms": share(_K2_NAMES),
           "k2_kernels": count(_K2_NAMES),
           "top": [[name[:90], t / 1e3, n] for name, (t, n) in top]}
    log(f"[{tag}] " + json.dumps(rec))
    return rec


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _forward_median_ms(model, x, n: int = 12, skip: int = 2) -> float:
    with torch.no_grad():
        times = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            if i >= skip:
                times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_model(card: str):
    cfg = GWDepthConfig(dropout=0.0, use_pallas=True)
    log(f"[model] GlassRGBD default config with use_pallas at "
        f"{H_IMG}x{W_IMG}, bs1, random weights from seed {SEED} (no "
        "checkpoint in the repo)")
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
        wm.reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        k1_n = ref_attn_diffusion.launches
        k2_n = conv3x3_ln_act.launches
        k2_links = dict(conv3x3_ln_act.shape_launches)
        k34_n = {"k3": wm.window_msa_kernel.launches,
                 "k4": wm.layout_fence.launches}
    log(f"[model] launches in one forward: K1 {k1_n}, K2 {k2_n}, "
        f"K3 {k34_n['k3']}, K4 {k34_n['k4']}")
    for key, n in sorted(k2_links.items(), key=str):
        log(f"[model]   K2 link {key}: {n}")
    assert k1_n == 4, f"K1 launched {k1_n} times, expected 4"
    assert k2_n == 25, f"K2 launched {k2_n} times, expected 25"
    # as in the JAX package, no model module calls K3 or K4
    assert k34_n == {"k3": 0, "k4": 0}, f"K3/K4 on the model path: {k34_n}"

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

    fwd_ms = _forward_median_ms(model, x)
    log(f"[model] forward bs1 {H_IMG}x{W_IMG}: median {fwd_ms:.3f} ms over "
        f"10 runs on {card}")
    with torch.no_grad():
        prof = profile_device(lambda: model(x), fwd_ms, "forward_ms",
                              "profile")
    # every K1 call is one CUDA kernel: all three steps in one launch
    assert not prof or prof["k1_kernels"] == K1_PER_FORWARD, prof

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

    # the same weights without the kernels, as use_pallas=False routes
    plain = build_glassrgbd(cfg.replace(use_pallas=False), SEED,
                            device="cpu").to("cuda")
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counts()
        out_plain = plain(x)
        torch.cuda.synchronize()
        n = _counts()
    log(f"[model] use_pallas=False forward launches: {n}")
    assert n["k1"] == n["k2"] == n["k2_bwd"] == 0, n
    plain_ms = _forward_median_ms(plain, x)
    gap = {k: _rel_l2(out_plain[k], out[k]) for k in
           ("pred_logits", "pred_lines", "pred_seg")}
    gap["pred_depth[-1]"] = _rel_l2(out_plain["pred_depth"][-1],
                                    out["pred_depth"][-1])
    log(f"[model] use_pallas=False forward: median {plain_ms:.3f} ms; "
        f"relative L2 from the kernels' forward {json.dumps(gap)}")
    with torch.no_grad():
        profile_device(lambda: plain(x), plain_ms, "forward_ms",
                       "profile-no-pallas")
    return k1_n, k2_n, k2_links, k34_n


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

SERVE_SIZES = {"wide": (720, 1280), "vga": (480, 640), "portrait": (1024, 768)}


def write_serve_images(src: str) -> dict:
    """The three seeded synthetic images of phase 5 (and phase 10's
    depth-only serving) in `src`; returns name -> (h, w)."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 2)
    os.makedirs(src)
    for name, (h, w) in SERVE_SIZES.items():
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(src, f"{name}.png"))
    return SERVE_SIZES


def phase_serve():
    from gwdepth_tpu_torch.predict import main as predict_main

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "images")
        dst = os.path.join(tmp, "out")
        sizes = write_serve_images(src)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        predict_main(["--images", src, "--output_dir", dst,
                      "--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = _counts()
        want = {"k1": K1_PER_FORWARD * len(sizes),
                "k2": K2_FWD_PER_FORWARD * len(sizes)}
        assert {k: n[k] for k in want} == want, (n, want)
        for name, (h, w) in sizes.items():
            for suffix in ("_depth.npy", "_depth.png", "_seg.png",
                           "_lines.json"):
                path = os.path.join(dst, name + suffix)
                assert os.path.exists(path), f"missing {path}"
            depth = np.load(os.path.join(dst, f"{name}_depth.npy"))
            assert depth.shape == (h, w) and np.isfinite(depth).all(), \
                f"{name}: depth {depth.shape}"
    log(f"[serve] {len(sizes)} images through predict.main in {secs:.1f} s; "
        f"launches {n}")


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
# gradients: kernel Function vs autograd through the plain version (whose
# conv carries the JAX package's VJP: dx from bf16-rounded dc and weights,
# dw in float32), both summing float32 products; the weight gradient sums
# B*H*W = up to 90k products per element in another order, so the
# tolerance scales with max(1, the call's largest |reference gradient|)
GRAD_TOL = 1e-4
# train step card vs CPU at the shipped widths: the losses pass through the
# host matcher and the top-k point choices, where a float near-tie could
# flip between devices; held by relative error
TRAIN_LOSS_REL_TOL = 1e-3
# every gradient tensor above a norm floor of 1e-6 x the largest
TRAIN_GRAD_REL_L2_TOL = 1e-3
# the same with K2's bf16 taps: both devices round each link's input (and
# the backward's cotangent) to bf16, but their float32 sums leave some
# values on opposite sides of a rounding boundary, which then round a bf16
# step apart along the 12-link trunks; on an H100 the point heads' input
# projections, at the end of the 1/8 trunk, read 1.05e-2 (median 5.7e-4),
# and these limits leave 2.4x and 2.6x room above that
BF16_GRAD_REL_L2_MAX_TOL = 2.5e-2
BF16_GRAD_REL_L2_MEDIAN_TOL = 1.5e-3
# the control, the CPU's bf16-tap step on images perturbed by 1e-7, must
# read at least this many times the limits
CONTROL_MARGIN = 3.0


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
        # bf16 yardstick: x (NHWC float32) and w (channels-last bf16) leaves
        lib16_leaves = [x.detach().clone().requires_grad_(),
                        k2_bf16_weight(w).requires_grad_(), *_leaves(g, b)]
        with cudnn_autotuned():
            y_lib = k2_library(*lib_leaves, None, act)
            dxl, dwl, dgl, dbl = torch.autograd.grad(y_lib, lib_leaves, ct,
                                                     retain_graph=True)
            y_lib16 = k2_library_bf16(*lib16_leaves, None, act)
            dx16, dw16, dg16, db16 = torch.autograd.grad(
                y_lib16, lib16_leaves, ct, retain_graph=True)
        lib = (dxl.permute(0, 2, 3, 1), dwl.permute(2, 3, 1, 0), dgl, dbl)
        lib16 = (dx16, dw16.float().permute(2, 3, 1, 0), dg16, db16)
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
        wb = k2_bf16_weight(w)
        with torch.no_grad():
            fwd = {"max_err": fwd_err,
                   "tile": fused_conv.kernel_tile(B, H, W, Co),
                   "kernel_ms": time_ms(
                       lambda: conv3x3_ln_act(x, w, g, b, None, act)),
                   "plain_ms": time_ms(
                       lambda: conv3x3_ln_act_plain(x, w, g, b, None, act),
                       reps=10),
                   "library_ms": library_ms(
                       lambda: k2_library_bf16(x, wb, g, b, None, act)),
                   "library_f32_ms": library_ms(
                       lambda: k2_library(xl, wl, g, b, None, act)),
                   "device_ms": graph_ms(
                       lambda: conv3x3_ln_act(x, w, g, b, None, act)),
                   "library_device_ms": library_device_ms(
                       lambda: k2_library_bf16(x, wb, g, b, None, act)),
                   **k2_bounds(conv_flops, fwd_bytes)}
            bwd_kernel_ms = time_ms(kernel_bwd)
            bwd_kernel_device_ms = graph_ms(kernel_bwd)
            bwd_plain_convs_ms = time_ms(plain_two_convs, reps=10)
            bwd_total_ms = time_ms(lambda: fused_conv.fused_backward(
                xd, wd, g, b, act, ct), reps=10)
        rec = {"name": "K2", "shape": [B, H, W, Ci, Co], "act": act,
               "fwd": fwd,
               "bwd": {"max_scaled_err": err,
                       "library_max_scaled_err": _max_scaled_err(lib16,
                                                                 want),
                       "library_f32_max_scaled_err": _max_scaled_err(lib,
                                                                     want),
                       "launches": n_bwd,
                       "kernel_ms": bwd_kernel_ms,
                       "kernel_device_ms": bwd_kernel_device_ms,
                       "plain_convs_ms": bwd_plain_convs_ms,
                       "backward_ms": bwd_total_ms,
                       "plain_ms": bwd_time_ms(y_plain, inputs, ct),
                       "library_ms": bwd_time_ms(y_lib16, lib16_leaves, ct,
                                                 library=True),
                       "library_f32_ms": bwd_time_ms(y_lib, lib_leaves, ct,
                                                     library=True),
                       **k2_bounds(2 * conv_flops, bwd_bytes)}}
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
               "device_ms": graph_ms(lambda: ref_attn_diffusion(a, w, b)),
               "library_device_ms": graph_ms(
                   lambda: diffusion_torch(a, w, b)),
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
            "k3": wm.window_msa_kernel.launches,
            "k4": wm.layout_fence.launches,
            "matcher_calls": match_lines.calls}


def _reset_counts():
    from gwdepth_tpu_torch.ops import ref_attn_diffusion as k1_mod
    from gwdepth_tpu_torch.ops.lap import match_lines
    k1_mod.reset_counts()
    fused_conv.reset_counts()
    wm.reset_counts()
    match_lines.calls = 0
    match_lines.solve_seconds = 0.0


def _expected_counts(steps: int, eval_forwards: int) -> dict:
    # no model module calls K3 or K4, as in the JAX package
    return {"k1": K1_PER_FORWARD * (steps + eval_forwards),
            "k2": K2_FWD_PER_FORWARD * (steps + eval_forwards),
            "k2_bwd": K2_BWD_PER_STEP * steps, "k3": 0, "k4": 0,
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
    args = ["--device", "cuda", "--use_pallas", "--with_line", "--with_dense",
            "--with_center", "--num_workers", "4", "--output_dir", out,
            "--data_path", f"{root}/rgb", "--gt_depth_path", f"{root}/depth",
            "--gt_seg_path", f"{root}/seg", "--gt_line_path", f"{root}/lines",
            "--filenames_file_train", f"{root}/train.txt",
            "--filenames_file_eval", f"{root}/val.txt"]
    cfg = train_main.config_from_args(train_main.build_argparser()
                                      .parse_args(args))
    assert cfg.train_hw == TRAIN_HW and cfg.batch_size == TRAIN_BS
    assert cfg.dropout == 0.1 and cfg.num_queries == 100 and cfg.use_pallas
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
                  "step_times": times, "profile": prof, "args": args,
                  "root": root, "out": out, "n_val": n_val}


def _train_grads(cfg, model, batch, dev, images=None):
    """One train step's losses, parameter gradients and sampled depth
    points (every `certain_sample` result, on the CPU) of `model` on `dev`
    (`images` in place of the batch's, on the CPU)."""
    from gwdepth_tpu_torch.models import dense_encoder
    from gwdepth_tpu_torch.parallel import compute_losses

    sample = dense_encoder.certain_sample
    points = []

    def spy(*args, **kw):
        out = sample(*args, **kw)
        points.append(out.detach().cpu())
        return out

    b = batch.to(dev)
    imgs = b.images if images is None else images.to(dev)
    dense_encoder.certain_sample = spy
    try:
        _, logs = compute_losses(cfg, model(imgs, b.valid), b)
    finally:
        dense_encoder.certain_sample = sample
    logs["loss"].backward()
    return ({k: float(v.detach()) for k, v in logs.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}, points)


def _grad_gaps(ga, gb) -> dict:
    """Relative L2 of ga against gb for every tensor of gb above a norm
    floor of 1e-6 x the largest."""
    top = max(float(v.norm()) for v in gb.values())
    return {n: _rel_l2(ga[n], gb[n]) for n in gb
            if float(gb[n].norm()) >= 1e-6 * top}


def _gap_stats(ga, gb) -> dict:
    gaps = _grad_gaps(ga, gb)
    worst = max(gaps, key=gaps.get)
    return {"max": gaps[worst], "median": float(np.median(list(gaps.values()))),
            "worst": worst}


def _points_moved(pa, pb) -> list:
    """Per `certain_sample` call (one per point head), the sampled pixels
    of run a that run b did not sample, counted as multisets per image."""
    assert len(pa) == len(pb)
    moved = []
    for a, b in zip(pa, pb):
        n = 0
        for ia, ib in zip(a, b):
            ca = collections.Counter(map(tuple, ia.reshape(-1, 2).tolist()))
            cb = collections.Counter(map(tuple, ib.reshape(-1, 2).tolist()))
            n += sum((ca - cb).values())
        moved.append(n)
    return moved


def phase_train_card_vs_cpu() -> dict:
    """One train step's losses and gradients on the card and on the CPU:
    the shipped widths on a 128x192 canvas, dropout 0, one batch, first
    without the kernels (float32 throughout on both devices), then with
    them (K1 and K2's bf16 taps on both devices).

    Each path also runs the CPU step on images scaled by 1 + 1e-7 noise
    (float32 resolution), and every run records the pixels that
    `certain_sample` picks per point head (reported: how many of one
    run's picks the other did not make), a discrete choice beside the
    rounding carried through the links. With the kernels that
    perturbation moves the point heads' gradients far more than the
    card-vs-CPU gap: it is the control, a run known to differ, and the
    bf16-tap limits must sit at least CONTROL_MARGIN below it."""
    from gwdepth_tpu_torch.data.batch import dummy_batch

    out, grads = {}, {}
    for use_pallas in (False, True):
        cfg = GWDepthConfig(dropout=0.0, train_hw=(128, 192),
                            use_pallas=use_pallas)
        batch = dummy_batch(cfg, TRAIN_BS, num_lines=6, seed=SEED)
        model_cpu = build_glassrgbd(cfg, SEED, device="cpu").train()
        model_gpu = copy.deepcopy(model_cpu).to("cuda")
        lc, gc, pc = _train_grads(cfg, copy.deepcopy(model_cpu), batch,
                                  "cpu")
        torch.cuda.synchronize()
        _reset_counts()
        lg, gg, pg = _train_grads(cfg, model_gpu, batch, "cuda")
        torch.cuda.synchronize()
        n = _counts()
        want = ({"k1": K1_PER_FORWARD, "k2": K2_FWD_PER_FORWARD,
                 "k2_bwd": K2_BWD_PER_STEP} if use_pallas
                else {"k1": 0, "k2": 0, "k2_bwd": 0})
        assert {k: n[k] for k in want} == want, (n, want)
        assert set(gg) == set(gc)
        gen = torch.Generator().manual_seed(SEED)
        noisy = batch.images * (1 + 1e-7 * torch.randn(
            batch.images.shape, generator=gen))
        _, gn, pn = _train_grads(cfg, model_cpu, batch, "cpu", images=noisy)
        rel = _grad_gaps(gg, gc)
        line = [k for k in rel if k.startswith(
            ("transformer.", "class_embed", "lines_embed", "query_embed",
             "input_proj"))]
        stats = _gap_stats(gg, gc)
        out["bf16_taps" if use_pallas else "float32"] = {
            "launches": n,
            "max_loss_rel": max(abs(lg[k] - lc[k]) / max(1.0, abs(lc[k]))
                                for k in lc),
            "grad_tensors": len(rel),
            "grad_rel_l2_max": stats["max"],
            "grad_rel_l2_median": stats["median"],
            "worst": sorted(rel.items(), key=lambda kv: -kv[1])[:3],
            "line_branch_rel_l2_max": max(rel[k] for k in line),
            "points": [int(t.shape[0] * t.shape[1]) for t in pc],
            "points_moved": _points_moved(pg, pc),
            "cpu_perturbed": {**_gap_stats(gn, gc),
                              "points_moved": _points_moved(pn, pc)}}
        grads[use_pallas] = (gc, gg)
    # how far K2's precision itself moves the step (reported, no limit)
    out["bf16_taps_vs_float32"] = _gap_stats(grads[True][1], grads[False][0])
    log("[train-cmp] card vs CPU: " + json.dumps(out))
    f32, bf = out["float32"], out["bf16_taps"]
    for path in (f32, bf):
        assert path["max_loss_rel"] <= TRAIN_LOSS_REL_TOL, path
        assert path["line_branch_rel_l2_max"] <= TRAIN_GRAD_REL_L2_TOL, path
    assert f32["grad_rel_l2_max"] <= TRAIN_GRAD_REL_L2_TOL, f32
    assert bf["grad_rel_l2_max"] <= BF16_GRAD_REL_L2_MAX_TOL, bf
    assert bf["grad_rel_l2_median"] <= BF16_GRAD_REL_L2_MEDIAN_TOL, bf
    ctl = bf["cpu_perturbed"]
    assert ctl["max"] >= CONTROL_MARGIN * BF16_GRAD_REL_L2_MAX_TOL and \
        ctl["median"] >= CONTROL_MARGIN * BF16_GRAD_REL_L2_MEDIAN_TOL, ctl
    return out


# ---------------------------------------------------------------------------
# depth-only serving, eval outputs, line-only training (phases 10-12)
# ---------------------------------------------------------------------------

def k2_links_per_forward(model) -> int:
    """K2 launches of one forward, counted from the model's modules: every
    PyramidLayer that fuses runs its 12 trunk links (2 firstconv, 2 per
    BasicBlock) and its `last0` where the concat is at most
    FUSE_LAST0_MAX_CI channels wide."""
    from gwdepth_tpu_torch.models import points

    n = 0
    for m in model.modules():
        if isinstance(m, points.PyramidLayer) and m.use_pallas:
            blocks = [b for layer in (m.layer1, m.layer2, m.layer3)
                      for b in layer]
            n += 2 + 2 * len(blocks) + int(
                m.lastconv[0].conv.in_channels <= points.FUSE_LAST0_MAX_CI)
    return n


def phase_depth_only(card: str) -> dict:
    """The depth-only model (`with_line=False`) serving at 768x1024 bs1
    with `use_pallas`: launch counts of one forward (no K1: its 1/32
    layer is plain Swin attention; K2 as counted from the modules; no K3
    or K4), outputs against the port's CPU run of the same weights, the
    median forward time and its device profile; then `predict --no_line
    --save_vis` on phase 5's three images."""
    from PIL import Image
    from gwdepth_tpu_torch.predict import main as predict_main

    cfg = GWDepthConfig(with_line=False, dropout=0.0, use_pallas=True)
    log(f"[depth-only] GlassRGBD with_line=False, use_pallas, at "
        f"{H_IMG}x{W_IMG} bs1, random weights from seed {SEED}")
    model_cpu = build_glassrgbd(cfg, SEED, device="cpu")
    model = copy.deepcopy(model_cpu).to("cuda")
    k2_want = k2_links_per_forward(model)
    rng = np.random.default_rng(SEED + 1)
    img = torch.from_numpy(
        rng.normal(size=(1, H_IMG, W_IMG, 3)).astype(np.float32))
    x = img.to("cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        n = _counts()
    log(f"[depth-only] launches in one forward: {n}; K2 counted from the "
        f"modules: {k2_want}")
    assert n["k1"] == 0 and n["k3"] == 0 and n["k4"] == 0, n
    assert n["k2"] == k2_want, (n, k2_want)
    assert out["pred_logits"] is None and out["pred_lines"] is None
    assert tuple(out["pred_seg"].shape) == (1, H_IMG, W_IMG, 2)
    depth_shapes = [(1, H_IMG // s, W_IMG // s) for s in (16, 8, 4, 1)]
    for d, shp in zip(out["pred_depth"], depth_shapes):
        assert tuple(d.shape) == shp and torch.isfinite(d).all(), d.shape
    assert torch.isfinite(out["pred_seg"]).all()

    fwd_ms = _forward_median_ms(model, x)
    log(f"[depth-only] forward bs1 {H_IMG}x{W_IMG}: median {fwd_ms:.3f} ms "
        f"over 10 runs on {card}")
    with torch.no_grad():
        prof = profile_device(lambda: model(x), fwd_ms, "forward_ms",
                              "depth-only-profile")
    assert not prof or prof["k1_kernels"] == 0, prof

    t0 = time.perf_counter()
    with torch.no_grad():
        out_cpu = model_cpu(img)
    log(f"[depth-only] CPU forward of the same port: "
        f"{time.perf_counter() - t0:.1f} s")
    cmp = {f"pred_depth[{i}]": _rel_l2(a.cpu(), b) for i, (a, b) in
           enumerate(zip(out["pred_depth"], out_cpu["pred_depth"]))}
    cmp["pred_seg"] = _rel_l2(out["pred_seg"].cpu(), out_cpu["pred_seg"])
    log("[depth-only] card vs CPU, relative L2: " + json.dumps(cmp))
    for k, v in cmp.items():
        assert v <= DENSE_REL_L2_TOL, f"{k}: card vs CPU {v} > " \
            f"{DENSE_REL_L2_TOL}"

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "images")
        dst = os.path.join(tmp, "out")
        sizes = write_serve_images(src)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        predict_main(["--images", src, "--output_dir", dst, "--device",
                      "cuda", "--no_line", "--save_vis"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        served = _counts()
        want = {"k1": 0, "k2": k2_want * len(sizes), "k3": 0, "k4": 0}
        assert {k: served[k] for k in want} == want, (served, want)
        for name, (h, w) in sizes.items():
            vis = np.asarray(Image.open(os.path.join(dst, f"{name}_vis.png")))
            assert vis.shape == (h, w, 3) and vis.dtype == np.uint8, \
                f"{name}_vis.png {vis.shape}"
            with open(os.path.join(dst, f"{name}_lines.json")) as f:
                assert json.load(f)["lines"] == []
            depth = np.load(os.path.join(dst, f"{name}_depth.npy"))
            assert depth.shape == (h, w) and np.isfinite(depth).all()
    log(f"[depth-only] {len(sizes)} images through predict.main --no_line "
        f"--save_vis in {secs:.1f} s; launches {served}")
    return {"launches": n, "k2_counted": k2_want, "forward_ms": fwd_ms,
            "profile": prof, "card_vs_cpu": cmp, "served": served}


# the gated serving forward: every dense-encoder gate the port builds
GATED_CFG = dict(group_attention_layers=((True, True), (True, True), (True,)),
                 class_tokenfuse_layers=(True, True, True),
                 with_line_depth=True, with_dense_center=True)


def phase_gated(card: str) -> dict:
    """The gated model (`GATED_CFG`, `use_pallas`) serving at 768x1024
    bs1, weights from the seed: launch counts of one forward (K1 9, by
    plane as GATED_K1; K2 25; no K3 or K4), outputs against the port's
    CPU run of the same weights at phase 4's limits, the median forward
    time and its device profile (each K1 call one CUDA kernel); then one
    forward without point sampling (`depth_sample_layers` all off), whose
    1/8 and 1/4 class blocks get no reference points: K1 6, K2 0."""
    cfg = GWDepthConfig(dropout=0.0, use_pallas=True, **GATED_CFG)
    log(f"[gated] GlassRGBD {json.dumps(GATED_CFG)}, use_pallas, at "
        f"{H_IMG}x{W_IMG} bs1, random weights from seed {SEED}")
    model_cpu = build_glassrgbd(cfg, SEED, device="cpu")
    model = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(SEED + 1)
    img = torch.from_numpy(
        rng.normal(size=(1, H_IMG, W_IMG, 3)).astype(np.float32))
    x = img.to("cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        n = _counts()
        planes = dict(ref_attn_diffusion.shape_launches)
    log(f"[gated] launches in one forward: {n}; K1 by plane "
        f"{sorted(planes.items())}")
    assert {k: n[k] for k in ("k1", "k2", "k3", "k4")} == \
        {"k1": sum(GATED_K1.values()), "k2": K2_FWD_PER_FORWARD,
         "k3": 0, "k4": 0}, n
    assert planes == GATED_K1, planes
    Q = cfg.num_queries
    expect = {"pred_logits": (1, Q, 2), "pred_lines": (1, Q, cfg.line_dim),
              "pred_seg": (1, H_IMG, W_IMG, 2)}
    for k, shp in expect.items():
        assert tuple(out[k].shape) == shp and torch.isfinite(out[k]).all(), k
    depth_shapes = [(1, H_IMG // s, W_IMG // s) for s in (16, 8, 4, 1)]
    for d, shp in zip(out["pred_depth"], depth_shapes):
        assert tuple(d.shape) == shp and torch.isfinite(d).all(), d.shape

    fwd_ms = _forward_median_ms(model, x)
    log(f"[gated] forward bs1 {H_IMG}x{W_IMG}: median {fwd_ms:.3f} ms over "
        f"10 runs on {card}")
    with torch.no_grad():
        prof = profile_device(lambda: model(x), fwd_ms, "forward_ms",
                              "gated-profile")
    assert not prof or prof["k1_kernels"] == sum(GATED_K1.values()), prof

    t0 = time.perf_counter()
    with torch.no_grad():
        out_cpu = model_cpu(img)
    log(f"[gated] CPU forward of the same port: "
        f"{time.perf_counter() - t0:.1f} s")
    cmp = {}
    for k in ("pred_logits", "pred_lines"):
        cmp[k] = float((out[k].cpu() - out_cpu[k]).abs().max())
        assert cmp[k] <= LINE_TOL, f"{k}: card vs CPU {cmp[k]} > {LINE_TOL}"
    for i, (a, b) in enumerate(zip(out["pred_depth"], out_cpu["pred_depth"])):
        cmp[f"pred_depth[{i}]"] = _rel_l2(a.cpu(), b)
    cmp["pred_seg"] = _rel_l2(out["pred_seg"].cpu(), out_cpu["pred_seg"])
    log("[gated] card vs CPU: " + json.dumps(cmp))
    for k, v in cmp.items():
        if k.startswith(("pred_depth", "pred_seg")):
            assert v <= DENSE_REL_L2_TOL, \
                f"{k}: card vs CPU rel L2 {v} > {DENSE_REL_L2_TOL}"
    del model_cpu, out_cpu

    # without point sampling: no point heads, no points below 1/16
    nos = cfg.replace(depth_sample_layers=(False, False, False))
    model = build_glassrgbd(nos, SEED, device="cpu").to("cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counts()
        out = model(x)
        torch.cuda.synchronize()
        n_nos = _counts()
    log(f"[gated] depth_sample_layers all off: launches {n_nos}")
    assert {k: n_nos[k] for k in ("k1", "k2", "k3", "k4")} == \
        {"k1": 6, "k2": 0, "k3": 0, "k4": 0}, n_nos
    for d, shp in zip(out["pred_depth"], depth_shapes):
        assert tuple(d.shape) == shp and torch.isfinite(d).all(), d.shape
    return {"launches": n, "planes": planes, "forward_ms": fwd_ms,
            "profile": prof, "card_vs_cpu": cmp,
            "no_sampling_launches": n_nos}


def phase_eval_outputs(train: dict) -> dict:
    """`main.main --eval --benchmark --dump_gt_lines --save_dense
    --save_line` on the card, from phase 7's checkpoint and validation
    scenes: one prediction npz, one GT npz, one dense grid and one line
    overlay per image; the GT written back as predictions scores sAP 100;
    prints the run's sAP, F-score and APH."""
    from PIL import Image
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.evaluation import (aph_score, fscore_score,
                                              sap_score)

    out, n_val = train["out"], train["n_val"]
    cfg = train_main.config_from_args(
        train_main.build_argparser().parse_args(train["args"]))
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    train_main.main(train["args"] + ["--eval", "--benchmark",
                                     "--dump_gt_lines", "--save_dense",
                                     "--save_line"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = _counts()
    want = {"k1": K1_PER_FORWARD * n_val, "k2": K2_FWD_PER_FORWARD * n_val,
            "k2_bwd": 0, "k3": 0, "k4": 0, "matcher_calls": n_val}
    log(f"[eval] main.main --eval with the outputs: {secs:.1f} s, launches "
        f"{n}")
    assert n == want, (n, want)

    with open(cfg.filenames_file_eval) as f:
        names = sorted(ln.split()[0] for ln in f if ln.strip())
    pred_dir = os.path.join(out, "benchmark", "benchmark_val")
    gt_dir = os.path.join(out, "lines_npz", "eval")
    for sub, ext in ((pred_dir, ".npz"), (gt_dir, ".npz"),
                     (os.path.join(out, "dense_pred"), ".png"),
                     (os.path.join(out, "line_pred"), ".png")):
        assert sorted(os.listdir(sub)) == [nm + ext for nm in names], sub
    ch, cw = cfg.eval_hw
    for nm in names:
        with np.load(os.path.join(pred_dir, nm + ".npz")) as z:
            assert set(z.files) == {"lines", "score"}, z.files
            assert z["lines"].shape == (cfg.num_queries, 2, 2)
            assert z["score"].shape == (cfg.num_queries,)
            assert np.isfinite(z["lines"]).all()
            assert (np.diff(z["score"]) <= 0).all(), "scores not descending"
        with np.load(os.path.join(gt_dir, nm + ".npz")) as z:
            assert set(z.files) == {"lpos", "file_name", "image_id"}
            assert z["lpos"].ndim == 3 and z["lpos"].shape[1:] == (2, 2)
            assert str(z["file_name"]) == nm
        dense = np.asarray(Image.open(os.path.join(out, "dense_pred",
                                                   nm + ".png")))
        assert dense.shape == (2 * ch, 3 * cw, 3), dense.shape
        line = np.asarray(Image.open(os.path.join(out, "line_pred",
                                                  nm + ".png")))
        assert line.shape == (ch, 2 * cw, 3), line.shape

    perfect = os.path.join(out, "perfect")
    os.makedirs(perfect)
    for nm in names:
        with np.load(os.path.join(gt_dir, nm + ".npz")) as z:
            np.savez(os.path.join(perfect, nm + ".npz"), lines=z["lpos"],
                     score=np.ones(len(z["lpos"])))
    ideal = sap_score(perfect, gt_dir)
    assert ideal == {5: 100.0, 10: 100.0, 15: 100.0}, ideal
    scores = {"sAP": sap_score(pred_dir, gt_dir),
              "F": fscore_score(pred_dir, gt_dir),
              "APH": aph_score(pred_dir, gt_dir)}
    log("[eval] line scores of the trained run: " + json.dumps(
        {k: ({str(t): v for t, v in s.items()} if isinstance(s, dict)
             else s) for k, s in scores.items()}))
    return {"seconds": secs, "launches": n, "scores": scores}


def phase_line_only(train: dict) -> dict:
    """A 2-step `main.main` run of the line-only model (`--with_line
    --with_center`, no `--with_dense`, `--use_pallas`) on the card on
    phase 7's scenes, then eval: no dense module is built, so no kernel
    launches; the logs carry the train line losses only (the eval of a
    line-only model reports nothing, as the JAX package's)."""
    from gwdepth_tpu_torch import main as train_main

    root, tmp = train["root"], os.path.dirname(train["out"])
    with open(os.path.join(root, "train.txt")) as f:
        names = [ln for ln in f if ln.strip()][:2 * TRAIN_BS]
    two_steps = os.path.join(tmp, "train_line_only.txt")
    with open(two_steps, "w") as f:
        f.writelines(names)
    out = os.path.join(tmp, "line_only")
    args = ["--device", "cuda", "--use_pallas", "--with_line",
            "--with_center", "--num_workers", "4", "--output_dir", out,
            "--data_path", f"{root}/rgb", "--gt_depth_path", f"{root}/depth",
            "--gt_seg_path", f"{root}/seg", "--gt_line_path", f"{root}/lines",
            "--filenames_file_train", two_steps,
            "--filenames_file_eval", f"{root}/val.txt", "--epochs", "1"]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    state = train_main.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = _counts()
    cfg = state.model.cfg
    assert cfg.with_line and not cfg.with_dense
    n_val = train["n_val"]
    want = {"k1": 0, "k2": 0, "k2_bwd": 0, "k3": 0, "k4": 0,
            "matcher_calls": 2 + n_val}
    log(f"[line-only] main.main 2 steps + eval: {secs:.1f} s, launches {n}")
    assert n == want and state.step == 2, (n, want, state.step)
    logs = [json.loads(ln) for ln in open(os.path.join(out, "log.txt"))]
    keys = {k for k in logs[0] if k.startswith("train_")}
    aux = range(cfg.dec_layers - 1)
    assert keys == {"train_loss", "train_loss_ce", "train_loss_line",
                    "train_cardinality_error",
                    *(f"train_loss_ce_{i}" for i in aux),
                    *(f"train_loss_line_{i}" for i in aux)}, keys
    assert not any(k.startswith("test_") for k in logs[0]), logs[0]
    assert all(np.isfinite(v) for v in logs[0].values()), logs[0]
    assert not any(k.startswith("dense") or k.startswith("depth_decoder")
                   for k in state.model.state_dict())
    assert os.path.exists(os.path.join(out, "input_log", "input_epoch0.png"))
    log(f"[line-only] log.txt: loss {logs[0]['train_loss']}, loss_ce "
        f"{logs[0]['train_loss_ce']}")
    return {"seconds": secs, "launches": n}


# ---------------------------------------------------------------------------
# window-attention phase (K3, K4)
# ---------------------------------------------------------------------------

# window_msa sites of one forward: the 1/32 ref layer (4 blocks) and the
# class layers at 1/16, 1/8 (2 blocks each) and 1/4 (1 block), every
# second block with the shift mask; the class blocks' windows at bs2
# 704x1024
SERVE_MSA_SITES = 9
CLASS_SITES = 5
TRAIN_CLASS_NW = (70, 70, 247, 247, 962)


def capture_window_sites(model, x):
    """One no-grad forward of `model` on x, recording the arguments and
    result of every `swin.window_msa` call and the module, input, mask and
    projection output of every `WindowClassAttention`."""
    msa, cls = [], []
    inner = swin.window_msa

    def record(q, k, v, bias, mask, use_pallas=False):
        out = inner(q, k, v, bias, mask, use_pallas)
        msa.append((q, k, v, bias, mask, out))
        return out

    hooks = [m.register_forward_hook(
        lambda mod, args, out: cls.append((mod, args[0], args[3], out[0])))
        for m in model.modules() if isinstance(m, swin.WindowClassAttention)]
    swin.window_msa = record
    try:
        with torch.no_grad():
            model(x)
        torch.cuda.synchronize()
    finally:
        swin.window_msa = inner
        for h in hooks:
            h.remove()
    return msa, cls


def _class_weights(mod):
    return (mod.qkv.weight, mod.qkv.bias, mod.proj.weight, mod.proj.bias,
            mod.rel_pos_bias())


def _scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def k3_bound(q, mask) -> dict:
    """K3's least time: per (window, head) 4 N^2 hd product FLOPs and 6
    softmax operations per logit (bias add, max, subtract, exp, sum,
    divide; 7 with the mask); q, k, v, bias, mask read once, out written
    once."""
    B, nW, H, N, hd = q.shape
    per_logit = 7 if mask is not None else 6
    flops = B * nW * H * N * N * (4 * hd + per_logit)
    nbytes = 4 * (4 * q.numel() + H * N * N
                  + (nW * N * N if mask is not None else 0))
    return bound_fields(flops, nbytes)


def fence_bound(x) -> dict:
    return bound_fields(0, 2 * x.numel() * x.element_size())


def device_kernel_names(fn) -> list:
    """The CUDA kernels (and memcpy/memset) one call of `fn` runs, as the
    profiler names them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def log_fence(tag, x, fence) -> None:
    log(f"[window] K4 {tag} {list(x.shape)} ({fence['bytes_ms'] * 1e3:.2f} "
        f"us bound): device us " + json.dumps(
            {"kernel": fence["kernel_device_ms"] * 1e3,
             "copy_": fence["library_device_ms"] * 1e3}))


def sdpa_inputs(q, k, v, bias, mask):
    """q, k, v as contiguous (B*nW, H, N, hd) and the float attn_mask
    bias (+ mask) as a contiguous (B*nW, H, N, N) for
    `F.scaled_dot_product_attention` (yardstick only)."""
    B, nW, H, N, hd = q.shape
    qkv = [t.reshape(B * nW, H, N, hd).contiguous() for t in (q, k, v)]
    am = bias[None] if mask is None else bias[None] + mask[:, None]
    return qkv, am.expand(B, nW, H, N, N).reshape(B * nW, H, N, N) \
        .contiguous()


def sdpa_backend(qs, ks, vs, am) -> str:
    """The backend SDPA's dispatcher picks for these inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(
        qs, ks, vs, attn_mask=am, dropout_p=0.0, is_causal=False,
        scale=1.0)).name.lower()


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one call of `fn` without the host's launch path:
    `reps` calls captured in one CUDA graph, the median replay time (CUDA
    events, as `time_ms`) divided by `reps`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return time_ms(g.replay, reps=10, warmup=2) / reps


# a write of this many bytes between timed calls evicts the 50 MB L2
FLUSH_BYTES = 128 << 20


def cold_ms(fn, reps: int = 10) -> float:
    """Device time of one call of `fn` on a cold L2: before each call a
    write of FLUSH_BYTES evicts its inputs, then a spin of about 0.5 ms
    keeps the card busy while the host queues the call; CUDA events around
    the call alone, median of `reps`."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def k3_device_fields(fn, bound: dict, device_ms: float) -> dict:
    """K3's share of its bound at a site, on the warm L2 of the CUDA-graph
    replays (`device_ms`) and on a cold L2 (`cold_ms`)."""
    cold = cold_ms(fn)
    return {"bound_frac": bound["bound_ms"] / device_ms,
            "cold_device_ms": cold,
            "cold_bound_frac": bound["bound_ms"] / cold}


def timed(kernel, plain, library) -> dict:
    """Event times per call (`time_ms`, the host's launch path included)
    and device times per call (`graph_ms`) of a kernel, its plain version
    and its library yardstick."""
    rec = {}
    for name, fn in (("kernel", kernel), ("plain", plain),
                     ("library", library)):
        rec[f"{name}_ms"] = time_ms(fn)
        rec[f"{name}_device_ms"] = graph_ms(fn)
    return rec


def _sdpa_out(o, B, nW):
    """SDPA's (B*nW, H, N, hd) as K3's (B, nW, N, H*hd)."""
    _, H, N, hd = o.shape
    return o.reshape(B, nW, H, N, hd).movedim(2, 3).reshape(B, nW, N, H * hd)


def phase_window_attention(rng):
    t0 = time.perf_counter()
    cfg = GWDepthConfig(dropout=0.0, use_pallas=True)
    model = build_glassrgbd(cfg, SEED, device="cuda")
    x_serve = torch.from_numpy(rng.normal(size=(1, H_IMG, W_IMG, 3))
                               .astype(np.float32)).to("cuda")
    x_train = torch.from_numpy(rng.normal(size=(TRAIN_BS, *TRAIN_HW, 3))
                               .astype(np.float32)).to("cuda")
    msa, cls = capture_window_sites(model, x_serve)
    _, cls_train = capture_window_sites(model, x_train)
    shapes = [tuple(s[0].shape) for s in msa]
    log(f"[window] sites of the {H_IMG}x{W_IMG} bs1 forward: "
        + json.dumps([[*sh, s[4] is not None] for sh, s in zip(shapes, msa)]))
    assert len(msa) == SERVE_MSA_SITES, len(msa)
    assert len(cls) == len(cls_train) == CLASS_SITES
    assert [c[1].shape[1] for c in cls_train] == list(TRAIN_CLASS_NW), \
        [tuple(c[1].shape) for c in cls_train]
    cts = [torch.from_numpy(rng.normal(size=tuple(c[1].shape))
                            .astype(np.float32)).to("cuda")
           for c in cls_train]
    x0 = cls[0][1]
    x0 = x0.reshape(-1, *x0.shape[2:])
    log(f"[window] a class site's x: {list(x0.shape)}, strides "
        f"{list(x0.stride())}")

    # the main path of this slice: counts zeroed just before, read after
    torch.cuda.synchronize()
    wm.reset_counts()
    with torch.no_grad():
        serve_out = [swin.window_msa(q, k, v, bias, mask, use_pallas=True)
                     for q, k, v, bias, mask, _ in msa]
        fused_out = [wm.fused_window_attention(x, *_class_weights(mod), mask,
                                               mod.num_heads)
                     for mod, x, mask, _ in cls]
    train = []
    for (mod, x, mask, _), ct in zip(cls_train, cts):
        leaves = _leaves(x, *_class_weights(mod))
        y = wm.fused_window_attention(*leaves, mask, mod.num_heads)
        assert y.grad_fn is not None, "fused entry output has no grad_fn"
        train.append((leaves, y, torch.autograd.grad(y, leaves, ct,
                                                     retain_graph=True)))
    torch.cuda.synchronize()
    n_k3 = wm.window_msa_kernel.launches
    n_k4 = wm.layout_fence.launches
    log(f"[window] launches: K3 {n_k3}, K4 {n_k4}")
    assert n_k4 == 2 * CLASS_SITES, n_k4
    assert n_k3 == SERVE_MSA_SITES + 2 * CLASS_SITES, n_k3

    sites = []
    with torch.no_grad():
        for (q, k, v, bias, mask, model_out), got in zip(msa, serve_out):
            plain = wm.window_msa_plain(q, k, v, bias, mask)
            (qs, ks, vs), am = sdpa_inputs(q, k, v, bias, mask)
            B, nW = q.shape[:2]

            def lib():
                return F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=am, scale=1.0)

            rec = {"site": list(q.shape), "mask": mask is not None,
                   "max_err": float((got - plain).abs().max()),
                   "model_max_err": float((got - model_out).abs().max()),
                   "library_max_err": float(
                       (_sdpa_out(lib(), B, nW) - plain).abs().max()),
                   "library_backend": sdpa_backend(qs, ks, vs, am),
                   **timed(lambda: wm.window_msa_kernel(q, k, v, bias, mask),
                           lambda: wm.window_msa_plain(q, k, v, bias, mask),
                           lib),
                   **k3_bound(q, mask)}
            rec.update(k3_device_fields(
                lambda: wm.window_msa_kernel(q, k, v, bias, mask), rec,
                rec["kernel_device_ms"]))
            assert torch.isfinite(got).all(), f"K3 {rec['site']} not finite"
            assert rec["max_err"] <= K3_TOL and \
                rec["model_max_err"] <= K3_TOL, rec
            log("[window] K3 " + json.dumps(rec))
            sites.append(rec)

        fused = []
        for (mod, x, mask, model_out), got in zip(cls, fused_out):
            w = _class_weights(mod)
            H = mod.num_heads
            xf = x.reshape(-1, *x.shape[2:])
            copy_to = torch.empty_like(xf)
            rec = {"x": list(x.shape), "mask": mask is not None,
                   "max_scaled_err": _scaled_err(got, model_out),
                   "plain_max_scaled_err": _scaled_err(
                       got, wm.fused_window_attention_plain(x, *w, mask,
                                                            H)),
                   "fused_ms": time_ms(lambda: wm.fused_window_attention(
                       x, *w, mask, H)),
                   "fused_plain_ms": time_ms(
                       lambda: wm.fused_window_attention_plain(x, *w, mask,
                                                               H)),
                   "fence": {"max_err": float(
                       (wm.layout_fence(xf) - xf).abs().max()),
                       **timed(lambda: wm.layout_fence(xf),
                               lambda: wm.layout_fence_plain(xf),
                               lambda: copy_to.copy_(xf)),
                       **fence_bound(xf)}}
            assert rec["max_scaled_err"] <= K3_TOL and \
                rec["plain_max_scaled_err"] <= K3_TOL, rec
            assert rec["fence"]["max_err"] == 0, "K4 is not the identity"
            log("[window] fused " + json.dumps(rec))
            log_fence("serve", xf, rec["fence"])
            fused.append(rec)

    train_recs = []
    for (mod, x, mask, _), ct, (leaves, y, got) in zip(cls_train, cts,
                                                       train):
        H = mod.num_heads
        y_plain = wm.fused_window_attention_plain(*leaves, mask, H)
        want = torch.autograd.grad(y_plain, leaves, ct, retain_graph=True)
        fwd_err = _scaled_err(y.detach(), y_plain.detach())
        err = _max_scaled_err(got, want)
        assert all(torch.isfinite(g).all() for g in got), "grad not finite"
        assert fwd_err <= K3_TOL, f"fused {tuple(x.shape)}: {fwd_err}"
        assert err <= GRAD_TOL, f"fused bwd {tuple(x.shape)}: {err}"
        B, nW, N, C = x.shape
        with torch.no_grad():
            xf = x.reshape(B * nW, N, C)
            q, k, v = wm._split_qkv(F.linear(xf, mod.qkv.weight,
                                             mod.qkv.bias), B, H)
            q = q * (C // H) ** -0.5
            bias = mod.rel_pos_bias()
            (qs, ks, vs), am = sdpa_inputs(q, k, v, bias, mask)
            copy_to = torch.empty_like(xf)
            w = _class_weights(mod)
            rec = {"x": list(x.shape), "mask": mask is not None,
                   "fwd_max_scaled_err": fwd_err, "bwd_max_scaled_err": err,
                   "library_backend": sdpa_backend(qs, ks, vs, am),
                   **timed(lambda: wm.window_msa_kernel(q, k, v, bias, mask),
                           lambda: wm.window_msa_plain(q, k, v, bias, mask),
                           lambda: F.scaled_dot_product_attention(
                               qs, ks, vs, attn_mask=am, scale=1.0)),
                   **k3_bound(q, mask),
                   "site": list(q.shape),
                   "fused_ms": time_ms(lambda: wm.fused_window_attention(
                       x, *w, mask, H)),
                   "fused_plain_ms": time_ms(
                       lambda: wm.fused_window_attention_plain(x, *w, mask,
                                                               H)),
                   "fence": {**timed(lambda: wm.layout_fence(xf),
                                     lambda: wm.layout_fence_plain(xf),
                                     lambda: copy_to.copy_(xf)),
                             **fence_bound(xf)}}
            rec.update(k3_device_fields(
                lambda: wm.window_msa_kernel(q, k, v, bias, mask), rec,
                rec["kernel_device_ms"]))
        rec["backward_ms"] = bwd_time_ms(y, leaves, ct)
        rec["backward_plain_ms"] = bwd_time_ms(y_plain, leaves, ct)
        log("[window] train " + json.dumps(rec))
        log_fence("train", xf, rec["fence"])
        train_recs.append(rec)
    log(f"[window] phase 9 took {time.perf_counter() - t0:.1f} s")
    return {"k3_launches": n_k3, "k4_launches": n_k4, "sites": sites,
            "fused": fused, "train": train_recs}


def copy_kernel_names() -> list:
    """What `Tensor.copy_`, K4's yardstick, runs on a view laid out as the
    first serving class site's x (a channel slice, 256 of 384 floats a
    row, of (70, 49) rows), as the profiler names it; run before the model
    phases, whose profiles leave the profiler without device events later
    in the process."""
    x = torch.zeros(70, 49, 384, device="cuda")[..., :256]
    dst = torch.empty(x.shape, device="cuda")
    names = [n[:120] for n in device_kernel_names(lambda: dst.copy_(x))]
    log("[kernels] copy_ of a (70, 49, 256) channel slice runs: "
        + (json.dumps(names) if names
           else "not measured (the profiler saw no device events)"))
    return names


# K3 at a 1/32 site (one window a block) and at the 1/4 site (many)
K3_PROFILE_SITES = (((1, 20, 16, 49, 32), True), ((1, 1036, 16, 49, 4), False))


def check_k3_one_kernel(rng) -> None:
    """One K3 call at each of two serving shapes, seeded inputs, must run
    exactly one CUDA kernel, its own, as the profiler names them. Run
    before the model phases, as `copy_kernel_names`."""
    def card(shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * scale).to("cuda")

    for shape, with_mask in K3_PROFILE_SITES:
        B, nW, H, N, hd = shape
        q, k, v = card(shape), card(shape), card(shape)
        bias = card((H, N, N))
        mask = (torch.from_numpy(np.where(rng.random((nW, N, N)) < 0.2,
                                          -100.0, 0.0).astype(np.float32))
                .to("cuda") if with_mask else None)
        got = device_kernel_names(
            lambda: wm.window_msa_kernel(q, k, v, bias, mask))
        log(f"[kernels] one K3 call at {list(shape)} runs: "
            + json.dumps([n[:120] for n in got]))
        assert len(got) == 1 and "window_msa_kernel" in got[0], \
            f"K3 at {shape}: {got}, expected one window_msa_kernel"


def window_kernel_entries(win, serve_n: dict, train_run: dict,
                          copy_kernels: list) -> list:
    """The `kernels` entries of K3 and K4 from phase 9's records, with the
    launches counted in the serving forward (`serve_n`) and the first
    main.main train run (`train_run`)."""

    def total(recs, field):
        return sum(r[field] for r in recs)

    def by(recs):
        return ("operations" if total(recs, "ops_ms") >= total(recs, "bytes_ms")
                else "bytes")

    def device_totals(recs, prefix=""):
        return {f"{prefix}device_ms": total(recs, "kernel_device_ms"),
                f"{prefix}plain_device_ms": total(recs, "plain_device_ms"),
                f"{prefix}library_device_ms": total(recs,
                                                    "library_device_ms")}

    sites, train = win["sites"], win["train"]
    fences = [r["fence"] for r in win["fused"]]
    train_fences = [r["fence"] for r in train]
    return [
        {"name": "window_msa", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/window_msa.cu",
         "replaces": "gwdepth_tpu/ops/pallas_kernels.py:232",
         "redesigned": "3xTF32 mma.sync, 4 warps a (window, head) pair",
         "launches": win["k3_launches"],
         "model_path_launches": serve_n["k3"],
         "train_launches": train_run["k3"],
         "max_abs_err": max(r["max_err"] for r in sites),
         "model_max_abs_err": max(r["model_max_err"] for r in sites),
         "fused_max_scaled_err": max(
             [r["max_scaled_err"] for r in win["fused"]]
             + [r["fwd_max_scaled_err"] for r in train]),
         "ms": total(sites, "kernel_ms"), "plain_ms": total(sites, "plain_ms"),
         "bound_ms": total(sites, "bound_ms"), "bound_by": by(sites),
         "library_ms": total(sites, "library_ms"),
         **device_totals(sites),
         "library_backends": sorted({r["library_backend"] for r in sites}),
         "cold_device_ms": total(sites, "cold_device_ms"),
         "bound_frac": total(sites, "bound_ms") / total(sites,
                                                        "kernel_device_ms"),
         "fused_ms": total(win["fused"], "fused_ms"),
         "fused_plain_ms": total(win["fused"], "fused_plain_ms"),
         "train_ms": total(train, "kernel_ms"),
         "train_plain_ms": total(train, "plain_ms"),
         "train_bound_ms": total(train, "bound_ms"),
         "train_bound_by": by(train),
         "train_library_ms": total(train, "library_ms"),
         **device_totals(train, "train_"),
         "train_cold_device_ms": total(train, "cold_device_ms"),
         "train_bound_frac": total(train, "bound_ms") / total(
             train, "kernel_device_ms"),
         "train_fused_ms": total(train, "fused_ms"),
         "train_fused_plain_ms": total(train, "fused_plain_ms"),
         # no backward kernel: the backward is plain PyTorch
         "train_backward_max_scaled_err": max(r["bwd_max_scaled_err"]
                                              for r in train),
         "train_backward_ms": total(train, "backward_ms"),
         "train_backward_plain_ms": total(train, "backward_plain_ms")},
        {"name": "layout_fence", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/layout_fence.cu",
         "replaces": "gwdepth_tpu/ops/pallas_kernels.py:264",
         "launches": win["k4_launches"],
         "model_path_launches": serve_n["k4"],
         "train_launches": train_run["k4"],
         "max_abs_err": max(f["max_err"] for f in fences),
         "ms": total(fences, "kernel_ms"), "plain_ms": total(fences, "plain_ms"),
         "bound_ms": total(fences, "bound_ms"), "bound_by": by(fences),
         "library_ms": total(fences, "library_ms"),
         **device_totals(fences),
         "library_kernels": copy_kernels,
         "train_ms": total(train_fences, "kernel_ms"),
         "train_plain_ms": total(train_fences, "plain_ms"),
         "train_bound_ms": total(train_fences, "bound_ms"),
         "train_bound_by": by(train_fences),
         "train_library_ms": total(train_fences, "library_ms"),
         **device_totals(train_fences, "train_")},
    ]


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    smi = probe()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    phase_build()
    copy_kernels = copy_kernel_names()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    check_k3_one_kernel(np.random.default_rng(SEED + 7))
    with torch.no_grad():
        k1_sites = phase_k1(rng, dev)
        k2 = phase_k2(rng, dev)
    k1 = k1_sites[tuple(K1_SITES[0])]
    k1_n, k2_n, k2_links, k34_n = phase_model(card)
    phase_serve()
    depth_only = phase_depth_only(card)
    gated = phase_gated(card)
    k2_train, k1_train = phase_backward(rng, dev)
    with tempfile.TemporaryDirectory() as tmp:
        runs, train = phase_train(card, tmp)
        evals = phase_eval_outputs(train)
        line_only = phase_line_only(train)
    phase_train_card_vs_cpu()
    win = phase_window_attention(rng)

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

    def gated_k1(field):
        """Sum over the gated forward's K1 planes of launches x `field`."""
        return sum(n * k1_sites[shape][field]
                   for shape, n in GATED_K1.items())

    k2_train_err = max(r["fwd"]["max_err"] for r in k2_train.values())
    k2_bwd_err = max(r["bwd"]["max_scaled_err"] for r in k2_train.values())
    run = runs["epoch0"]
    kernels = [
        {"name": "ref_attn_diffusion", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/ref_attn_diffusion.cu",
         "replaces": "gwdepth_tpu/ops/pallas_kernels.py:112",
         "launches": k1_n,
         "max_abs_err": max(k1_train["fwd"]["max_err"],
                            max(r["max_err"] for r in k1_sites.values())),
         "ms": k1_n * k1["kernel_ms"], "plain_ms": k1_n * k1["plain_ms"],
         "bound_ms": k1_n * k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1_n * k1["library_ms"],
         "device_ms": k1_n * k1["device_ms"],
         "library_device_ms": k1_n * k1["library_device_ms"],
         "train_launches": run["k1"],
         "train_launches_per_step": K1_PER_FORWARD,
         "train_ms": K1_PER_FORWARD * k1_train["fwd"]["kernel_ms"],
         "train_plain_ms": K1_PER_FORWARD * k1_train["fwd"]["plain_ms"],
         "train_bound_ms": K1_PER_FORWARD * k1_train["fwd"]["bound_ms"],
         "train_bound_by": k1_train["fwd"]["bound_by"],
         "train_library_ms": K1_PER_FORWARD * k1_train["fwd"]["library_ms"],
         "train_device_ms": K1_PER_FORWARD * k1_train["fwd"]["device_ms"],
         "train_library_device_ms":
             K1_PER_FORWARD * k1_train["fwd"]["library_device_ms"],
         # no backward kernel: the backward is plain PyTorch
         "train_backward_max_scaled_err": k1_train["bwd"]["max_scaled_err"],
         "train_backward_ms": K1_PER_FORWARD * k1_train["bwd"]["backward_ms"],
         "train_backward_plain_ms":
             K1_PER_FORWARD * k1_train["bwd"]["plain_ms"],
         "gated_ms": gated_k1("kernel_ms"),
         "gated_plain_ms": gated_k1("plain_ms"),
         "gated_bound_ms": gated_k1("bound_ms"),
         "gated_bound_by": bound_by(gated_k1),
         "gated_library_ms": gated_k1("library_ms"),
         "gated_device_ms": gated_k1("device_ms"),
         "gated_library_device_ms": gated_k1("library_device_ms"),
         "sites": [{k: r[k] for k in (
             "shape", "schedule", "blocks", "max_err", "kernel_ms",
             "device_ms", "plain_ms", "library_ms", "library_device_ms",
             "bound_ms", "bound_by")} for r in k1_sites.values()]},
        {"name": "conv3x3_ln_act", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/conv3x3_ln_act.cu",
         "replaces": "gwdepth_tpu/ops/fused_conv.py:378",
         "launches": k2_n,
         "max_abs_err": max(k2_train_err,
                            max(r["max_err"] for r in k2.values())),
         "ms": per_forward("kernel_ms"), "plain_ms": per_forward("plain_ms"),
         "bound_ms": per_forward("bound_ms"), "bound_by": bound_by(per_forward),
         "library_ms": per_forward("library_ms"),
         "library_f32_ms": per_forward("library_f32_ms"),
         "f32_bound_ms": per_forward("f32_bound_ms"),
         "device_ms": per_forward("device_ms"),
         "library_device_ms": per_forward("library_device_ms"),
         "train_launches": run["k2"],
         "train_launches_per_step": K2_FWD_PER_FORWARD,
         "train_ms": train_fwd("kernel_ms"),
         "train_plain_ms": train_fwd("plain_ms"),
         "train_bound_ms": train_fwd("bound_ms"),
         "train_bound_by": bound_by(train_fwd),
         "train_library_ms": train_fwd("library_ms"),
         "train_library_f32_ms": train_fwd("library_f32_ms"),
         "train_f32_bound_ms": train_fwd("f32_bound_ms"),
         "train_device_ms": train_fwd("device_ms"),
         "train_library_device_ms": train_fwd("library_device_ms")},
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
         "library_f32_ms": train_bwd("library_f32_ms"),
         "f32_bound_ms": train_bwd("f32_bound_ms"),
         "device_ms": train_bwd("kernel_device_ms"),
         "backward_ms": train_bwd("backward_ms"),
         "plain_convs_ms": train_bwd("plain_convs_ms")},
        *window_kernel_entries(win, k34_n, run, copy_kernels),
    ]
    # launches on this slice's paths, each counted from 0 over its run
    count_key = {"ref_attn_diffusion": "k1", "conv3x3_ln_act": "k2",
                 "conv3x3_ln_act_backward": "k2_bwd", "window_msa": "k3",
                 "layout_fence": "k4"}
    for entry in kernels:
        key = count_key[entry["name"]]
        entry["depth_only_launches"] = depth_only["launches"][key]
        entry["eval_outputs_launches"] = evals["launches"][key]
        entry["line_only_launches"] = line_only["launches"][key]
        entry["gated_launches"] = gated["launches"][key]
        entry["no_sampling_launches"] = gated["no_sampling_launches"][key]
    log("[kernels] K1 and K2: launches, ms, plain_ms, bound_ms and "
        "library_ms per 768x1024 bs1 serving forward (launches on that path "
        "x the per-call medians above); train_* per train step at bs2 "
        "704x1024, train_launches over the first main.main train run (4 "
        "steps, 2 eval forwards). K2 backward: launches over that run, the "
        "times per train step; ms = the recompute and dx launches, "
        "backward_ms = the whole Function backward (kernel, LayerNorm "
        "backward, dw matmuls), plain_ms = autograd through the plain "
        "version; K2's library_ms = cuDNN's bf16 conv on channels-last (x "
        "cast from float32 NHWC) + F.layer_norm + act, library_f32_ms = "
        "the float32 F.conv2d on contiguous NCHW + F.layer_norm + act, both "
        "autotuned; K2's bound_ms = bf16 FLOPs at 989 TFLOP/s or float32 "
        "bytes at 3.35 TB/s, f32_bound_ms with float32 FLOPs at 67 "
        "TFLOP/s; K1's and K2's device_ms / library_device_ms per call "
        "of 10 calls in a CUDA graph (K2's backward: its recompute and "
        "dx), times the launches per forward or step; "
        "the backward's max_abs_err is scaled by max(1, the "
        "call's largest reference gradient). "
        f"train step median {train['step_ms']:.3f} ms, host matcher "
        f"{train['matcher_ms']:.3f} ms. K3 and K4: launches over phase 9's "
        "driven calls, model_path_launches in the serving forward and "
        "train_launches in that train run (no model path calls them); "
        "ms, plain_ms, "
        "bound_ms, library_ms summed over its 9 serving window_msa sites "
        "(K4: the fence of its 5 serving fused calls), train_* over the 5 "
        "fused train sites (bs2 704x1024); *_ms by CUDA events around each "
        "call (the host's launch path included), *device_ms per call of "
        "10 calls captured in a CUDA graph; K3's library is "
        "F.scaled_dot_product_attention with a float attn_mask, K4's "
        "Tensor.copy_; K3's bound_frac = bound_ms / device_ms, "
        "cold_device_ms summed over the sites, each the median of 10 calls "
        "after a 128 MB write. depth_only_launches: one forward of the "
        "depth-only model (phase 10); eval_outputs_launches: main.main "
        "--eval with the benchmark, GT, dense and line outputs over 2 "
        "validation scenes (phase 11); line_only_launches: the line-only "
        "model's 2 train steps and eval (phase 12). gated_launches: one "
        "forward of the gated model (GATED_CFG), no_sampling_launches: one "
        "without point sampling; K1's gated_* = the gated forward's planes, "
        "launches x the per-call medians of its `sites` (phase 3, B=1; the "
        "1/32 planes in the band schedule, the class planes in the "
        "device-memory schedule).")
    dprof = depth_only["profile"]
    log(f"[depth-only] forward median {depth_only['forward_ms']:.3f} ms, "
        f"device busy {dprof.get('device_busy_ms', float('nan')):.3f} ms, "
        f"idle share {dprof.get('device_idle_share', float('nan')):.4f}, "
        f"K2 {depth_only['launches']['k2']} launches on {card}")
    gprof = gated["profile"]
    log(f"[gated] forward median {gated['forward_ms']:.3f} ms, device busy "
        f"{gprof.get('device_busy_ms', float('nan')):.3f} ms, idle share "
        f"{gprof.get('device_idle_share', float('nan')):.4f}, K1 "
        f"{gprof.get('k1_ms', float('nan')):.4f} ms in "
        f"{gprof.get('k1_kernels')} kernels on {card}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
