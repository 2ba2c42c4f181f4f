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
              same function (conv2d + layer_norm + activation) with CUDA
              events, medians of 30 runs after warm-up;
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
              output file must exist.
Then one JSON line lists each kernel with its launches on the main path,
its per-forward times and bound, and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
    ref_attn_diffusion, ref_attn_diffusion_plain)

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

def k1_library(a, w, b):
    """cuDNN/ATen composition of the same function (yardstick only)."""
    P, R = a.shape[1], a.shape[2]
    x = a.permute(0, 3, 1, 2)
    wt = w.permute(3, 2, 0, 1)
    for _ in range(3):
        u = F.conv2d(x, wt, b, padding=1)
        x = x + F.gelu(F.layer_norm(u, (P, R), eps=1e-5))
    return x.permute(0, 2, 3, 1)


def k2_library(x, w, g, b, r, act):
    """cuDNN/ATen composition of the same function (yardstick only)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = F.layer_norm(y.permute(0, 2, 3, 1), (w.shape[3],), g, b, eps=1e-5)
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
    lib = k1_library(a, w, b)
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
           "library_ms": time_ms(lambda: k1_library(a, w, b)),
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
        lib = k2_library(x, w, g, b, r, act)
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
               "library_ms": time_ms(lambda: k2_library(x, w, g, b, r, act)),
               **bound_fields(flops, nbytes)}
        log(json.dumps(rec))
        recs[link_key(x, w, g, r, act)] = rec
    return recs


# ---------------------------------------------------------------------------
# model phase
# ---------------------------------------------------------------------------

_K1_NAMES = ("conv_stats_kernel", "norm_act_kernel")
_K2_NAMES = ("conv3x3_ln_act_kernel",)


def profile_forward(model, x, fwd_ms: float) -> None:
    """Where one forward's device time goes: torch.profiler (CUPTI) over
    one forward, device kernels summed by name, and the device's idle
    share of the unprofiled median forward time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        model(x)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log("[profile] the profiler saw no device events: device time "
            "not measured")
        return
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
    log("[profile] " + json.dumps({
        "forward_ms": fwd_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / fwd_ms),
        "device_kernels": len(spans), "k1_ms": share(_K1_NAMES),
        "k2_ms": share(_K2_NAMES),
        "top": [[name[:90], t / 1e3, n] for name, (t, n) in top]}))


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
    profile_forward(model, x, fwd_ms)

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

    missing = [key for key in k2_links if key not in k2]
    assert not missing, f"main-path K2 links not timed: {missing}"

    def per_forward(field):
        return sum(n * k2[key][field] for key, n in k2_links.items())

    kernels = [
        {"name": "ref_attn_diffusion", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/ref_attn_diffusion.cu",
         "replaces": "gwdepth_tpu/ops/pallas_kernels.py:112",
         "launches": k1_n, "max_abs_err": k1["max_err"],
         "ms": k1_n * k1["kernel_ms"], "plain_ms": k1_n * k1["plain_ms"],
         "bound_ms": k1_n * k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1_n * k1["library_ms"]},
        {"name": "conv3x3_ln_act", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/conv3x3_ln_act.cu",
         "replaces": "gwdepth_tpu/ops/fused_conv.py:378",
         "launches": k2_n,
         "max_abs_err": max(r["max_err"] for r in k2.values()),
         "ms": per_forward("kernel_ms"), "plain_ms": per_forward("plain_ms"),
         "bound_ms": per_forward("bound_ms"),
         "bound_by": ("operations" if per_forward("ops_ms")
                      >= per_forward("bytes_ms") else "bytes"),
         "library_ms": per_forward("library_ms")},
    ]
    log("[kernels] ms, plain_ms, bound_ms and library_ms are per forward: "
        "launches on the main path x the per-call medians above")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
