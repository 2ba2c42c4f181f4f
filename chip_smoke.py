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
              forward's planes and the gated train step's (bs2, up to
              (2, 47138, 80, 16)), the class-layer ones in its
              device-memory schedule, two calls bit-equal); time the kernel, the plain
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
              and of K1 (the shipped step's plane and the gated step's
              four): each kernel's forward output and its
              autograd.Function's gradients of every input against the
              plain version and autograd through it, and forward and
              backward times of the kernel, the plain version, the
              cuDNN/ATen compositions, and the bound; K1's backward also
              its peak memory;
  7. train    8 train and 2 val synthetic scenes at 720x1280 through
              `gwdepth_tpu_torch.main.main --use_pallas` on the card at the
              shipped config (bs2 704x1024, dropout 0.1): one epoch of 4 steps,
              eval, checkpoint, then a `--resume` epoch, with the default
              `--matcher jax`; the launch counts of each run are zeroed
              just before and read just after and must equal the numbers
              the link list gives (lap_jv: 1 a step and an eval forward);
              finite losses, output files, frozen stem bit-equal, trained
              weights moved; then, from the trained state restored
              before each, `--matcher jax` and `--matcher scipy`: their
              losses on one forward's outputs within 1e-6 relative, and
              per backend the median ms/step, the scipy solve's host
              time and a torch.profiler split of one step (busy time,
              idle share);
  8. train card vs CPU  one train step's losses and every gradient tensor
              at the shipped widths on a 128x192 canvas, dropout 0, the
              same weights and batch on both devices: without the kernels
              (float32 throughout; no K1 or K2 launch), and with them
              (use_pallas; K1 4, K2 25 and 51 backward launches; the
              JV matcher on both devices, lap_jv once on the card; held at
              fixed bf16-tap limits that a control, the CPU's step on
              images perturbed by 1e-7, must exceed threefold; the
              depth points each run samples are reported); the same for
              the gated model (GATED_CFG with the plane-normal loss: K1
              9 launches; each gradient tensor within the larger of the
              limit and 3x the control's gap of that tensor); see
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
  14. gated training  `main.main --use_pallas` on GATED_CFG with
              --with_plane_norm_loss (group attention set in the config:
              neither CLI has a flag for it) on phase 7's scenes, without
              and with --remat: 4 steps and eval with the counts zeroed
              before and read after (per step K1 9, 18 with --remat, by
              plane as GATED_TRAIN_K1; K2 25 and 51 backward), a finite
              loss_plane in log.txt; the median of 6 steps after 2
              warm-ups, peak memory, a profiled step (busy time, idle
              share, kernels), K1's backward by events and its share of
              the busy time; the first step's losses and gradients with
              and without --remat from the same weights and batch, with
              deterministic algorithms (bit-equal on an H100);
  15. COCO-lines  `recipes/train_stage2_res101_wireframe.sh`'s flags
              (ResNet-101, --frozen_weights from phase 7's checkpoint,
              line-only, bs1) on a COCO-lines set written from phase 7's
              scenes: 2 steps, eval, then --eval --benchmark; no kernel
              launches; the tensors loaded and the step times.
  16. export  the shipped forward through `gwdepth_tpu_torch.export.main
              --resume` (seeded weights saved as a checkpoint) at
              768x1024 bs1 on the card: no launch while it traces, K1 x4
              and K2 x25 custom-op nodes in the artifact; a fresh process
              loads it (no `gwdepth_tpu_torch.models` imported) and
              serves phase 5's three images (K1 4, K2 25 launches an
              image), held against the eager forward of the same weights
              at phase 4's limits; export and load time, size, median
              latency, busy time and idle share beside eager's;
  17. bf16    `main.main --bf16 --use_pallas` for one epoch on phase 7's
              scenes (per step K1 4, K2 25 and 51 backward; every K1 and
              K2 input float32), the median of 8 steps after 2 warm-ups,
              busy time, idle share and peak memory beside phase 7's
              float32 step; the bf16 forward at 768x1024 bs1; the first
              bf16 step's loss within 0.1 |f32| + 0.05 of the float32
              step's; the bf16 forward card vs CPU at 128x192 (see
              `_bf16_card_vs_cpu`). Then full float32 precision again.
  18. data parallel  (a) `main.main --mesh -1 --use_pallas` for 1 epoch
              on phase 7's scenes, in a process of its own under
              `torch.distributed.run --standalone --nproc_per_node 1`
              (NCCL, one rank) and alone, both under deterministic
              algorithms: log.txt and every final parameter bit-equal;
              per step K1 4, K2 25 and 51 backward (the counts zeroed
              before main.main and read after, and per timed step); the
              NCCL, K1 and K2 kernels a profiled step runs, the median of
              6 steps and the busy time beside phase 7's. (b) two
              processes on the one card under torchrun over gloo (CUDA
              tensors), each the data-parallel train step on its image of
              3 global batches of 2 at 704x1024 (`use_pallas`, dropout 0),
              against one process's step on both images and a control
              (that process on images x (1 + 1e-7 noise)); the depth
              points forced to the one process's; K1 and K2 counted per
              rank; the first step's losses (1e-5) and gradients before
              the clip (1e-3 relative L2) held, later steps' losses and
              the parameters to 3x the control's gaps; peak memory per
              process. `chip_smoke.py --dp-role main|pair --dp-dir DIR`
              is how the phase starts those processes.
  19. tensor parallel  (a) `main.main --mesh 1,1 --use_pallas` for one
              epoch on phase 7's scenes under torchrun (NCCL, one rank)
              and alone, under deterministic algorithms: log.txt and every
              final parameter bit-equal; per step K1 4, K2 25 and 51
              backward. (b) a (1, 2) mesh of two processes on the one card
              over gloo (the split weights' all_gather through the host),
              each rank the train step on the whole of phase 18b's 3
              global batches with its half of every weight that
              `parallel/partition.py` splits, against one process in a
              process of its own (deterministic algorithms, dropout 0):
              first-step losses and the gradients before the clip
              bit-equal, later losses and the parameters within 1e-6 x
              max(1, |w|); K1 and K2 counted per rank; the parameter and
              AdamW bytes per rank beside one process's and the split
              share of the parameters. `--dp-role tp-main|tp-steps`
              starts those processes.
  20. matcher  (run after phase 3) the JV matcher kernel `lap_jv` at the
              shipped step's problems (6 layers x bs 2, 100 queries, 96
              slots) over seeded costs with n_valid from 0 to 96: floats,
              small integers (ties), the criterion's cost of repeated
              predictions, every n_valid = 96; the assignments must equal
              the plain version's; the criterion on the card: one launch
              a call, no sync under sync-debug mode "error", the CPU's
              losses; kernel time by events and in a CUDA graph beside
              the plain version and the scipy path (copy and solve), the
              bound, and the Dijkstra steps (time per serial step).
  21. loader (run after phase 7) the native loader on phase 7's scenes:
              every train and eval sample native against PIL bit for bit
              (decoded image, transformed image, depth, seg, lines,
              centers, the collated arrays); ms a sample of decode +
              train_transform and the Loader's images/s at bs2 on each
              path. Where the host has no libpng the library is built
              without its decoder and PIL decodes.
  22. library (run before phase 23) the library modules, which no model path
              builds, on the card at the shipped config's widths against
              the port's CPU run (see `phase_library`): TokenFuse, ConvGRU,
              PyramidConv, NonLocalPlannarGuidance (1/16, 48x64),
              ReflectionReduce (768x1024 hint), PointTokenAttention and
              OffsetGeneration (1/32, 24x32, dim 512, 16 heads, 40
              points), distance_map, _kmeans and sample_by_centers (100
              queries), the segment samplers and SNE (720x1280); phase 4's
              limits; discrete choices equal or moved by 1e-7 noise on the
              CPU too; no kernel launches; ms of each.
  23. dispatch  the asynchronous dispatch: 2 epochs of
              `engine.train_one_epoch` (prefetch from pinned batches, the
              log drain one window late) and of the plain loop (the batch
              copied in the step, each window drained at once) over phase
              7's scenes under deterministic algorithms: meters and final
              weights equal bit for bit; step period by CUDA events, busy
              time and idle share of each. Its census (the serving
              forward, the --matcher jax step and the gated step, after
              warm-up, each with a census in sync-debug mode "warn"
              (`tools/dispatch_census.py`) that counts 0 and a call under
              mode "error", where a synchronizing call raises; the
              forward's host-to-device copies in the profiler: its
              input's only) runs on the graphed paths in phase 24's
              process. Phase 7 asserts 0 synchronizing calls in its step
              too.
  24. graphs (run after phase 23, in a process of its own) the compiled
              entry points: the serving forward (bs1 768x1024,
              `use_pallas`), the eval step (bs1), and the float32
              (`--matcher jax`), `--bf16` and gated train steps (bs2
              704x1024), each as a replayed CUDA graph (`graphs.compiled`,
              the port's default on a card) against `graphs.disable()`:
              outputs and 3 steps' losses, parameters and AdamW moments
              bit for bit under deterministic algorithms (held for the
              forward, the eval step and the float32 step; reported for
              the others); then, on the same states, the median of 10
              graphed and 3 eager calls after warm-up (phases 4 and 7
              time the eager forward and step at length), busy time and
              idle share, the host's kernel and graph launches, 0
              synchronizing calls, peak memory, and K1, K2 and lap_jv
              counted by the profiler inside one replay; phase 23's
              census on the graphed forward, float32 and gated steps.
The forward, eval and train entry points run as CUDA graphs
on the card (`graphs.py`): a kernel's launches are counted when they run,
eagerly (the WARMUPS calls before each capture, and anything under
`graphs.disable()`) or at each replay of a graph that holds them, so a
run's counts are its calls plus the warm-ups of each capture
(`_graph_runs`). Phases 7's matcher rounds, 14's K1-backward events and
18b's and 19b's gloo steps run under `graphs.disable()`.
Then one JSON line lists each kernel with its launches and times per
serving forward and, under `train_*`, per train step (K2's backward per
train step; K3 and K4: the phase-9 launches beside those counted in
phase 4's forward and phase 7's first train run, times summed over its
serving sites, `train_*` over its train sites; every kernel also its
launches in phases 10-17), the total wall time, and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from gwdepth_tpu_torch import _build, graphs
from gwdepth_tpu_torch.config import GWDepthConfig
from gwdepth_tpu_torch.models import build_glassrgbd, swin
from gwdepth_tpu_torch.ops import fused_conv, lap
from gwdepth_tpu_torch.ops.fused_conv import (conv3x3_ln_act,
                                              conv3x3_ln_act_plain, link_key)
from gwdepth_tpu_torch.ops import window_msa as wm
from gwdepth_tpu_torch.ops.ref_attn_diffusion import (
    diffusion_torch, ref_attn_diffusion, ref_attn_diffusion_plain)

# Kineto tears CUPTI down after every profiling session and sets it up
# again at the next; after the CUDA graphs that the timing phases capture,
# later sessions came back without device events. Keep CUPTI up, as
# PyTorch does for its own CUDA-graph paths (torch.profiler,
# TEARDOWN_CUPTI).
os.environ.setdefault("TEARDOWN_CUPTI", "0")

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
# the 1/8 plane at B=2, and the gated train step's planes (bs2 704x1024,
# GATED_TRAIN_K1)
K1_SITES = [(1, 980, 40, 16), (1, 980, 60, 16), (1, 3430, 60, 16),
            (1, 13034, 30, 16), (1, 50764, 80, 16), (2, 13034, 30, 16),
            (2, 980, 60, 16), (2, 3430, 60, 16), (2, 12103, 30, 16),
            (2, 47138, 80, 16)]
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
# matcher phase (20)
# ---------------------------------------------------------------------------

# the shipped train step's matcher problems: 6 decoder layers x bs 2, 100
# queries, max_lines = 96 target slots
LAP_SHAPE = (6, 2, 100, 96)


def lap_problem_sets(rng):
    """Seeded (L, B, Q, T) float32 costs at LAP_SHAPE with n_valid drawn
    from 0..T (T and 0 always among them): normal floats; small integers
    (exact ties); the criterion's own cost (`build_match_cost`) of random
    predictions in which half the queries repeat the other half (tied
    columns); every problem at n_valid = T."""
    from gwdepth_tpu_torch.losses.criterion import build_match_cost

    L, B, Q, T = LAP_SHAPE

    def counts():
        nv = rng.integers(0, T + 1, size=(L, B))
        nv[0, 0], nv[-1, -1] = T, 0
        return torch.from_numpy(nv)

    floats = torch.from_numpy(rng.normal(size=LAP_SHAPE).astype(np.float32))
    ints = torch.from_numpy(rng.integers(0, 4, size=LAP_SHAPE)
                            .astype(np.float32))
    logits = rng.normal(size=(L, B, Q, 2)).astype(np.float32)
    lines = rng.uniform(size=(L, B, Q, 6)).astype(np.float32)
    logits[:, :, Q // 2:] = logits[:, :, :Q // 2]
    lines[:, :, Q // 2:] = lines[:, :, :Q // 2]
    tgt = torch.from_numpy(rng.uniform(size=(B, T, 6)).astype(np.float32))
    crit = build_match_cost(torch.from_numpy(logits), torch.from_numpy(lines),
                            tgt, 1.0, 5.0)
    return {"floats": (floats, counts()), "ints": (ints, counts()),
            "criterion_tied": (crit, counts()),
            "full": (floats, torch.full((L, B), T))}


def _criterion_inputs(rng, dev):
    """Random decoder outputs of the shipped step (6 layers, bs 2, 100
    queries) and targets with 37 and 96 of 96 slots valid."""
    L, B, Q, T = LAP_SHAPE

    def layer():
        return {"pred_logits": torch.from_numpy(rng.normal(
                    size=(B, Q, 2)).astype(np.float32)).to(dev),
                "pred_lines": torch.from_numpy(rng.uniform(
                    size=(B, Q, 6)).astype(np.float32)).to(dev)}

    out = layer()
    out["aux_outputs"] = [layer() for _ in range(L - 1)]
    lines = torch.from_numpy(rng.uniform(size=(B, T, 6)).astype(
        np.float32)).to(dev)
    mask = torch.zeros((B, T), dtype=torch.bool)
    mask[0, :37] = True
    mask[1] = True
    return out, lines, mask.to(dev)


def _plain_by_problem(cost, nv):
    """The plain version's tgt2query of (L, B, Q, T) problems, called
    problem by problem: (tgt2query, total steps, the Dijkstra steps of
    each problem, host ms)."""
    want = torch.zeros((*nv.shape, cost.shape[-1]), dtype=torch.int64)
    stats, per = {}, []
    t0 = time.perf_counter()
    for idx in np.ndindex(*nv.shape):
        before = stats.get("dijkstra_steps", 0)
        want[idx] = lap.jv_plain(cost[idx], nv[idx], stats)
        per.append(stats["dijkstra_steps"] - before)
    return want, stats, per, (time.perf_counter() - t0) * 1e3


def phase_matcher(rng, dev, card: str) -> dict:
    """Phase 20: the JV matcher kernel (`csrc/lap_jv.cu`) at the shipped
    step's shape. Its assignments against the plain version's on every
    set of `lap_problem_sets` (equal, index for index); the criterion on
    the card with the counts zeroed just before and read just after (one
    launch a call) and under sync-debug mode "error" (no device-to-host
    copy or sync), its losses against the CPU criterion's; then the
    kernel's time by events and as device time in a CUDA graph beside the
    plain version's and the scipy path's (its copy and host solve), the
    bound (the cost rows the problems read, and ~3 float32 operations a
    column a Dijkstra step), and the Dijkstra steps, total and of the
    longest problem, so the time of one serial step can be read."""
    from gwdepth_tpu_torch.losses import line_set_criterion

    L, B, Q, T = LAP_SHAPE
    sets = {}
    for name, (cost, nv) in lap_problem_sets(rng).items():
        want, stats, per, plain_ms = _plain_by_problem(cost, nv)
        cd, nd = cost.to(dev), nv.to(dev)
        torch.cuda.synchronize()
        lap.reset_counts()
        got = lap.lap_jv(cd, nd)
        torch.cuda.synchronize()
        assert lap.lap_jv.launches == 1, lap.lap_jv.launches
        err = int((got.cpu() - want).abs().max())
        sets[name] = {"equal": bool(torch.equal(got.cpu(), want)),
                      "max_abs_err": err, "plain_ms": plain_ms,
                      "n_valid_sum": int(nv.sum()),
                      "dijkstra_steps": stats["dijkstra_steps"],
                      "dijkstra_steps_max": max(per),
                      "augment_steps": stats["augment_steps"]}
        log(f"[matcher] {name}: {json.dumps(sets[name])}")
        assert sets[name]["equal"], (name, sets[name])

    # the criterion: one launch, no sync, the CPU's losses
    out, lines, mask = _criterion_inputs(rng, dev)
    kw = dict(eos_coef=0.1, set_cost_class=1.0, set_cost_line=5.0,
              matcher_backend="jax")
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        crit = line_set_criterion(out, lines, mask, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = lap.lap_jv.launches
    cpu = line_set_criterion(
        {"pred_logits": out["pred_logits"].cpu(),
         "pred_lines": out["pred_lines"].cpu(),
         "aux_outputs": [{k: v.cpu() for k, v in a.items()}
                         for a in out["aux_outputs"]]},
        lines.cpu(), mask.cpu(), **kw)
    crit_gap = max(abs(float(crit[k]) - float(v)) / max(abs(float(v)), 1e-12)
                   for k, v in cpu.items())
    log(f"[matcher] criterion at {LAP_SHAPE}: {launches} lap_jv launch, no "
        f"sync under sync-debug mode 'error', losses vs CPU max relative "
        f"gap {crit_gap:.3g}")
    assert launches == 1, launches
    assert crit_gap <= MATCHER_LOSS_REL_TOL, (crit, cpu)

    # times on the floats set
    cost, nv = lap_problem_sets(np.random.default_rng(SEED + 20))["floats"]
    cd, nd = cost.to(dev), nv.to(dev)
    kernel_ms = time_ms(lambda: lap.lap_jv(cd, nd))
    device_ms = graph_ms(lambda: lap.lap_jv(cd, nd))
    _, stats, per, plain_ms = _plain_by_problem(cost, nv)
    scipy, solve = [], []
    for _ in range(12):
        torch.cuda.synchronize()
        lap.reset_counts()
        t0 = time.perf_counter()
        lap.match_lines(cd, nd, "scipy")
        torch.cuda.synchronize()
        scipy.append((time.perf_counter() - t0) * 1e3)
        solve.append(lap.match_lines.solve_seconds * 1e3)
    scipy_ms, solve_ms = float(np.median(scipy[2:])), float(np.median(
        solve[2:]))
    nbytes = 4 * Q * int(nv.sum()) + 8 * L * B + 8 * L * B * T
    flops = 3 * Q * stats["dijkstra_steps"]
    res = {"kernel_ms": kernel_ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "scipy_ms": scipy_ms,
           "scipy_solve_ms": solve_ms, "scipy_copy_ms": scipy_ms - solve_ms,
           **bound_fields(flops, nbytes), "library_ms": None,
           "n_valid_sum": int(nv.sum()),
           "dijkstra_steps": stats["dijkstra_steps"],
           "dijkstra_steps_max": max(per),
           "augment_steps": stats["augment_steps"],
           "device_us_per_serial_step": device_ms * 1e3 / max(per),
           "max_abs_err": max(r["max_abs_err"] for r in sets.values()),
           "sets": sets, "criterion_launches": launches,
           "criterion_loss_rel_gap": crit_gap}
    log(f"[matcher] lap_jv at {LAP_SHAPE}, n_valid sum {res['n_valid_sum']}:"
        f" kernel {kernel_ms:.4f} ms by events, {device_ms:.4f} ms device "
        f"(CUDA graph), plain {plain_ms:.1f} ms (host), scipy path "
        f"{scipy_ms:.3f} ms ({solve_ms:.3f} solve, "
        f"{scipy_ms - solve_ms:.3f} copy), bound {res['bound_ms']:.6f} ms "
        f"({res['bound_by']}); Dijkstra steps {stats['dijkstra_steps']} "
        f"(longest problem {max(per)}): "
        f"{res['device_us_per_serial_step']:.3f} us a serial step on {card}")
    return res


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
    # the host's time in the CUDA runtime (launches, copies, syncs)
    api = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith("cuda"):
            t, n = api.get(ev.name, (0.0, 0))
            api[ev.name] = (t + ev.time_range.elapsed_us(), n + 1)
    api_top = sorted(api.items(), key=lambda kv: -kv[1][0])[:5]
    rec = {label: wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "device_kernels": len(spans), "k1_ms": share(_K1_NAMES),
           "k1_kernels": count(_K1_NAMES), "k2_ms": share(_K2_NAMES),
           "k2_kernels": count(_K2_NAMES),
           "top": [[name[:90], t / 1e3, n] for name, (t, n) in top],
           "host_cuda_api": [[name, t / 1e3, n]
                             for name, (t, n) in api_top]}
    log(f"[{tag}] " + json.dumps(rec))
    return rec


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


# the outputs that two forwards are held at, each with its limit: max-abs
# for the line heads, relative L2 for the full-resolution depth and the seg
FORWARD_LIMITS = {"pred_logits": LINE_TOL, "pred_lines": LINE_TOL,
                  "pred_depth[-1]": DENSE_REL_L2_TOL,
                  "pred_seg": DENSE_REL_L2_TOL}
# the same outputs in the order an exported program returns them
EXPORT_KEYS = ("pred_depth[-1]", "pred_seg", "pred_logits", "pred_lines")


def forward_outputs(out) -> dict:
    """The held outputs of a model forward, on the CPU."""
    return {k: (out["pred_depth"][-1] if k == "pred_depth[-1]"
                else out[k]).cpu() for k in FORWARD_LIMITS}


def forward_gaps(a: dict, b: dict) -> dict:
    """Each held output of `a` against `b`'s (b the reference)."""
    return {k: (float((a[k].cpu() - b[k].cpu()).abs().max())
                if FORWARD_LIMITS[k] == LINE_TOL else
                _rel_l2(a[k].cpu(), b[k].cpu())) for k in FORWARD_LIMITS}


def check_forward_gaps(gaps: dict, what: str) -> None:
    for k, v in gaps.items():
        assert v <= FORWARD_LIMITS[k], \
            f"{k}: {what} {v} > {FORWARD_LIMITS[k]} ({gaps})"


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
    cmp = forward_gaps(forward_outputs(out), forward_outputs(out_cpu))
    check_forward_gaps(cmp, "card vs CPU")
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
        runs = _graph_runs("forward", len(sizes))
        want = {"k1": K1_PER_FORWARD * runs, "k2": K2_FWD_PER_FORWARD * runs}
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
# the launches of one shipped train step (`use_pallas`, --matcher jax): the
# criterion matches every decoder layer's problems in one lap_jv launch
STEP_COUNTS = {"k1": K1_PER_FORWARD, "k2": K2_FWD_PER_FORWARD,
               "k2_bwd": K2_BWD_PER_STEP, "k3": 0, "k4": 0, "lap_jv": 1}
TRAIN_HW = (704, 1024)
TRAIN_BS = 2
K1_TRAIN_SHAPE = (TRAIN_BS, 980, 40, 16)
# K1's planes of one gated train step (GATED_CFG) at bs2 704x1024, by
# launches: the 1/32 ref layer with three reference points a line, then
# the class planes at 1/16, 1/8 and 1/4 (70, 247 and 962 windows of an
# image, x 49 tokens); twice as many launches with --remat
GATED_TRAIN_K1 = {(2, 980, 60, 16): 4, (2, 3430, 60, 16): 2,
                  (2, 12103, 30, 16): 2, (2, 47138, 80, 16): 1}
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

    k1 = k1_backward_site(rng, dev, K1_TRAIN_SHAPE)
    # the gated train step's planes; their forward times are phase 3's
    k1_gated = {shape: k1_backward_site(rng, dev, shape, forward_times=False)
                for shape in GATED_TRAIN_K1}
    return recs, k1, k1_gated


def k1_backward_site(rng, dev, shape, forward_times: bool = True) -> dict:
    """K1's Function at one plane: its output and the gradients of every
    input against autograd through the plain version, the forward's times
    (`forward_times`), and the backward's: events around
    `torch.autograd.grad` of the Function (a `diffusion_torch` recompute
    and its autograd), of the plain version and of `diffusion_torch`
    (the library), and the backward's peak device memory above what the
    three kept graphs hold."""
    B, P, R, H = shape
    a = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, H, H))
                          / np.sqrt(9 * H)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(H,))).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    a, w, b, ct = (t.to(dev) for t in (a, w, b, ct))
    inputs = _leaves(a, w, b)
    y = ref_attn_diffusion(*inputs)
    assert y.grad_fn is not None, "K1 output has no grad_fn"
    got = torch.autograd.grad(y, inputs, ct, retain_graph=True)
    y_plain = ref_attn_diffusion_plain(*inputs)
    want = torch.autograd.grad(y_plain, inputs, ct, retain_graph=True)
    y_lib = diffusion_torch(*inputs)
    fwd_err = float((y - y_plain).abs().max())
    assert torch.isfinite(y).all(), f"K1 {shape} output not finite"
    assert fwd_err <= K1_TOL, f"K1 {shape} max abs err {fwd_err} > {K1_TOL}"
    err = _max_scaled_err(got, want)
    assert all(torch.isfinite(g).all() for g in got), f"K1 {shape} grad"
    assert err <= GRAD_TOL, f"K1 bwd {shape} scaled err {err} > {GRAD_TOL}"
    del got, want
    conv = 2 * B * P * R * H * H * 9
    fwd = {"max_err": fwd_err}
    if forward_times:
        with torch.no_grad():
            fwd.update({
                "kernel_ms": time_ms(lambda: ref_attn_diffusion(a, w, b)),
                "plain_ms": time_ms(
                    lambda: ref_attn_diffusion_plain(a, w, b)),
                "library_ms": time_ms(lambda: diffusion_torch(a, w, b)),
                "device_ms": graph_ms(lambda: ref_attn_diffusion(a, w, b)),
                "library_device_ms": graph_ms(
                    lambda: diffusion_torch(a, w, b)),
                **bound_fields(3 * conv,
                               4 * (2 * a.numel() + 9 * H * H + H))})
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(y, inputs, ct, retain_graph=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    rec = {"name": "K1", "shape": list(shape), "fwd": fwd,
           "bwd": {"max_scaled_err": err,
                   "backward_ms": bwd_time_ms(y, inputs, ct),
                   "plain_ms": bwd_time_ms(y_plain, inputs, ct),
                   "library_ms": bwd_time_ms(y_lib, inputs, ct),
                   "peak_bytes": peak,
                   # recompute, dx and dw of each of the 3 convs
                   **bound_fields(3 * 3 * conv,
                                  4 * (3 * a.numel() + 2 * 9 * H * H))}}
    log("[backward] " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def _counts():
    return {"k1": ref_attn_diffusion.launches,
            "k2": conv3x3_ln_act.launches,
            "k2_bwd": conv3x3_ln_act.bwd_launches,
            "k3": wm.window_msa_kernel.launches,
            "k4": wm.layout_fence.launches,
            "lap_jv": lap.lap_jv.launches,
            "matcher_calls": lap.match_lines.calls}


def _reset_counts():
    from gwdepth_tpu_torch.ops import ref_attn_diffusion as k1_mod
    k1_mod.reset_counts()
    fused_conv.reset_counts()
    wm.reset_counts()
    lap.reset_counts()
    graphs.stats.clear()


def _graph_runs(name: str, calls: int, captures: int = 1) -> int:
    """The device runs of `calls` calls of the compiled entry point `name`
    ("forward", "train_step", "eval_step") since `_reset_counts()`: each
    of its `captures` captures first ran it graphs.WARMUPS times eagerly
    (launches counted as any), and every call replayed once (the graph's
    launches counted at each replay). Checks `graphs.stats` against
    that."""
    got = {k: graphs.stats[name, k]
           for k in ("captures", "replays", "eager_runs")}
    want = {"captures": captures, "replays": calls,
            "eager_runs": graphs.WARMUPS * captures}
    assert got == want, (name, got, want)
    return calls + graphs.WARMUPS * captures


def _first_call(counts: dict) -> dict:
    """The launches of a compiled entry point's first call on a card: its
    warm-ups and the replay of its capture."""
    return {k: (1 + graphs.WARMUPS) * v for k, v in counts.items()}


def _expected_counts(steps: int, eval_forwards: int) -> dict:
    # no model module calls K3 or K4, as in the JAX package
    return {"k1": K1_PER_FORWARD * (steps + eval_forwards),
            "k2": K2_FWD_PER_FORWARD * (steps + eval_forwards),
            "k2_bwd": K2_BWD_PER_STEP * steps, "k3": 0, "k4": 0,
            "lap_jv": steps + eval_forwards,
            "matcher_calls": steps + eval_forwards}


def phase_train(card: str, tmp: str):
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.tools.dispatch_census import train_args
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.tools.synthetic import generate_dataset

    n_train, n_val = 8, 2
    root = os.path.join(tmp, "ds")
    t0 = time.perf_counter()
    generate_dataset(root, n_train, n_val, height=720, width=1280, seed=SEED)
    log(f"[train] {n_train}+{n_val} synthetic scenes at 720x1280 in "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "exp")
    args = train_args(root, out)
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
        want = _expected_counts(_graph_runs("train_step", steps),
                                _graph_runs("eval_step", n_val))
        log(f"[train] main.main {label}: {secs:.1f} s, launches {got}, "
            f"expected {want} (the steps and eval forwards replayed, each "
            f"capture after {graphs.WARMUPS} eager warm-ups)")
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
    matchers = train_matchers(cfg, state, batches, card)
    del state
    torch.cuda.empty_cache()
    mj, ms = matchers["jax"], matchers["scipy"]
    return runs, {"step_ms": mj["step_ms"], "matcher_ms": ms["solve_ms"],
                  "step_times": mj["step_times"], "profile": mj["profile"],
                  "matchers": matchers, "args": args,
                  "peak_bytes": mj["peak_bytes"],
                  "root": root, "out": out, "n_train": n_train,
                  "n_val": n_val}


# the losses of --matcher jax and --matcher scipy on the same outputs: the
# matched cost is the same optimum, so only a float32 reassociation of the
# criterion's sums may part them (and assignments that differ on a tie)
MATCHER_LOSS_REL_TOL = 1e-6
MATCHER_STEPS = 3             # timed steps a round, after 2 warm-ups
# the rounds, each from the restored state: the host path (the parent's)
# and the kernel in turns, so that drift in the host's speed over the
# phase falls on both
MATCHER_ORDER = ("scipy", "jax", "jax_sync", "jax_sync", "jax", "scipy")
# "jax_sync": the kernel with a torch.cuda.synchronize() after each
# matcher call, where the scipy path's copy waits: it parts the matcher's
# own cost from that of the host running ahead of the card


def _matcher_round(cfg, state, batches, matcher, runs, solve, first, peak,
                   profs):
    """One round of `train_matchers`: 2 warm-ups and MATCHER_STEPS timed
    steps, each with its launches counted, then a profiled step on the
    round's first time for `matcher`; the records go to the dicts."""
    from gwdepth_tpu_torch.parallel import make_train_step

    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    want = dict(STEP_COUNTS, lap_jv=int(cfg.matcher == "jax"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2 + MATCHER_STEPS):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state, vec = step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
            solve[matcher].append(lap.match_lines.solve_seconds * 1e3)
        got = _counts()
        assert {k: got[k] for k in want} == want, (matcher, got, want)
        assert torch.isfinite(vec).all(), "non-finite train loss"
        first.setdefault(matcher, dict(zip(step.log_keys,
                                           vec.tolist()))["loss"])
    runs[matcher].append(times)
    peak[matcher] = torch.cuda.max_memory_allocated()
    if matcher not in profs:
        profs[matcher] = profile_device(
            lambda: step(state, batches[0], gen), float(np.median(times)),
            "step_ms", f"train-profile-{matcher}")
    return state


def sync_sites(cfg, state, batch) -> dict:
    """The synchronizing calls of one --matcher jax train step, a replay
    after its capture, that PyTorch's sync-debug mode sees, counted by
    the Python line that made them: the 12 commonest and the total
    (`tools/dispatch_census.py`)."""
    from gwdepth_tpu_torch.parallel import make_train_step
    from gwdepth_tpu_torch.tools.dispatch_census import sync_sites as census

    step = make_train_step(cfg.replace(matcher="jax"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step(state, batch, gen)         # the capture
    return census(lambda: step(state, batch, gen))


@contextlib.contextmanager
def synced_matcher():
    """The criterion's matcher followed by torch.cuda.synchronize()."""
    from gwdepth_tpu_torch.losses import criterion

    real = criterion.match_lines

    def synced(*a, **k):
        out = real(*a, **k)
        torch.cuda.synchronize()
        return out

    criterion.match_lines = synced
    try:
        yield
    finally:
        criterion.match_lines = real


def train_matchers(cfg, state, batches, card: str) -> dict:
    """Phase 7's step timing for each matcher backend, each round from
    the trained state as it came (restored in place) and on the same
    batches: --matcher jax (the default: one lap_jv launch a step, no
    sync) and --matcher scipy (one device-to-host copy and host solve a
    step). First both backends'
    losses on the outputs of one train-mode forward (dropout from one
    seeded generator), held to MATCHER_LOSS_REL_TOL; then rounds of
    MATCHER_STEPS steps in MATCHER_ORDER, the launches counted per step:
    per backend the median over its rounds and each round's, the scipy
    solve's host time, peak memory, and a profiled step (busy time; the
    idle share against that median)."""
    from gwdepth_tpu_torch.parallel.train_step import compute_losses

    saved = copy.deepcopy({"model": state.model.state_dict(),
                           "opt": state.optimizer.state_dict(),
                           "sched": state.scheduler.state_dict(),
                           "step": state.step})

    def restore():
        state.model.load_state_dict(saved["model"])
        state.load_optimizer_state(saved["opt"])
        state.scheduler.load_state_dict(saved["sched"])
        state.step = saved["step"]

    out = {}
    model = state.model.train()
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        outputs = model(batches[0].images, batches[0].valid, generator=gen)
        losses = {}
        for matcher in ("jax", "scipy"):
            _, logs = compute_losses(cfg.replace(matcher=matcher), outputs,
                                     batches[0])
            losses[matcher] = {k: float(v) for k, v in logs.items()}
        del outputs
    gap = max(abs(losses["jax"][k] - v) / max(abs(v), 1e-12)
              for k, v in losses["scipy"].items())
    log(f"[train] losses --matcher jax vs scipy on one forward's outputs: "
        f"max relative gap {gap:.3g}; jax {json.dumps(losses['jax'])}")
    assert gap <= MATCHER_LOSS_REL_TOL, losses
    runs = {m: [] for m in MATCHER_ORDER}
    solve = {m: [] for m in MATCHER_ORDER}
    first, peak, profs = {}, {}, {}
    for matcher in MATCHER_ORDER:
        restore()
        backend = "scipy" if matcher == "scipy" else "jax"
        # eager, as the matchers are compared: the scipy path's
        # host solve and jax_sync's syncs cannot be captured
        with graphs.disable(), (synced_matcher() if matcher == "jax_sync"
                                else contextlib.nullcontext()):
            state = _matcher_round(cfg.replace(matcher=backend), state,
                                   batches, matcher, runs, solve, first,
                                   peak, profs)
    for matcher in runs:
        times = [t for r in runs[matcher] for t in r]
        step_ms = float(np.median(times))
        prof = dict(profs[matcher], step_ms=step_ms)
        if "device_busy_ms" in prof:
            prof["device_idle_share"] = max(
                0.0, 1.0 - prof["device_busy_ms"] / step_ms)
        out[matcher] = {"step_ms": step_ms, "step_times": times,
                        "round_medians": [float(np.median(r))
                                          for r in runs[matcher]],
                        "solve_ms": float(np.median(solve[matcher])),
                        "peak_bytes": peak[matcher], "profile": prof,
                        "first_step_loss": first[matcher]}
        log(f"[train] --matcher {matcher}: train step bs{TRAIN_BS} "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]} median {step_ms:.3f} ms over "
            f"{len(times)} steps in rounds {MATCHER_ORDER} (round medians "
            f"{json.dumps(out[matcher]['round_medians'])}), device busy "
            f"{prof.get('device_busy_ms', float('nan')):.3f} ms, idle share "
            f"{prof.get('device_idle_share', float('nan')):.4f}, host solve "
            f"{out[matcher]['solve_ms']:.3f} ms/step, peak memory "
            f"{peak[matcher] / 2**30:.2f} GiB, first step loss "
            f"{first[matcher]} on {card}")
    out["sync_sites"] = sync_sites(cfg, state, batches[0])
    log(f"[train] --matcher jax: synchronizing calls of one step by "
        f"caller (sync-debug mode 'warn'): {json.dumps(out['sync_sites'])}")
    # the tables live on the card (ops/tables.py): none after warm-up
    assert out["sync_sites"]["total"] == 0, out["sync_sites"]
    del saved
    torch.cuda.empty_cache()
    out["loss_rel_gap"] = gap
    out["losses"] = losses
    return out


@contextlib.contextmanager
def pil_only():
    """The data pipeline's PIL paths inside (GWDEPTH_NO_NATIVE=1)."""
    old = os.environ.get("GWDEPTH_NO_NATIVE")
    os.environ["GWDEPTH_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["GWDEPTH_NO_NATIVE"]
        else:
            os.environ["GWDEPTH_NO_NATIVE"] = old


LOADER_ROUNDS = 2             # timing rounds a path, alternating


def phase_loader(card: str, train: dict) -> dict:
    """Phase 21: the native loader (`gwdepth_tpu_torch/native`) on phase
    7's scenes (720x1280) on the card machine's host. Every train sample
    (seeded augmentation) and eval sample through the native path and
    through PIL (GWDEPTH_NO_NATIVE=1): the decoded scene, the transformed
    image, depth, seg, lines and centers, and the collated arrays must be
    equal bit for bit. Then ms per train sample of decode plus
    `train_transform` on each path (medians over the scenes and
    LOADER_ROUNDS alternating rounds), and the `Loader`'s images/s over
    one epoch at bs 2 with 4 decode threads, on each path."""
    import random

    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch import native
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.data.transforms import (eval_transform,
                                                   train_transform)

    status = native.available()
    log(f"[loader] native status on this host: {status.describe()}")
    assert status.ok, status
    cfg = train_main.config_from_args(train_main.build_argparser()
                                      .parse_args(train["args"]))

    def sample(ds, idx, seed):
        raw, _ = ds.load_raw(idx)
        dec = np.asarray(raw.image).copy()
        if ds.split == "train":
            t = train_transform(raw, random.Random(seed), cfg.train_hw)
        else:
            t = eval_transform(raw, cfg.eval_hw)
        return ([dec, t.image, t.depth, t.seg, t.lines, t.centers],
                ds.__getitem__(idx, seed=seed))

    compared = 0
    for split in ("train", "val"):
        ds = GlassRGBDDataset(cfg, split)
        for idx in range(len(ds)):
            seed = SEED + idx
            nat = sample(ds, idx, seed)
            with pil_only():
                pil = sample(ds, idx, seed)
            for a, b in zip(nat[0], pil[0]):
                assert a.shape == b.shape and np.array_equal(a, b), \
                    (split, idx)
            for k, v in pil[1].items():
                assert k == "name" or np.array_equal(nat[1][k], v), \
                    (split, idx, k)
            compared += 1

    ds = GlassRGBDDataset(cfg, "train")

    def per_sample_ms():
        out = []
        for idx in range(len(ds)):
            t0 = time.perf_counter()
            raw, _ = ds.load_raw(idx)
            train_transform(raw, random.Random(SEED + idx), cfg.train_hw)
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def images_per_s():
        loader = Loader(ds, batch_size=TRAIN_BS, seed=SEED, num_workers=4)
        t0 = time.perf_counter()
        n = sum(b.images.shape[0] for b, _ in loader.epoch(0))
        return n / (time.perf_counter() - t0)

    times = {"native": [], "pil": []}
    rates = {"native": [], "pil": []}
    for _ in range(LOADER_ROUNDS):
        times["native"] += per_sample_ms()
        rates["native"].append(images_per_s())
        with pil_only():
            times["pil"] += per_sample_ms()
            rates["pil"].append(images_per_s())
    res = {"status": status.describe(), "samples_bit_equal": compared,
           "sample_ms": {k: float(np.median(v)) for k, v in times.items()},
           "loader_images_per_s": {k: float(np.median(v))
                                   for k, v in rates.items()},
           "cpu_count": os.cpu_count()}
    log(f"[loader] {compared} samples (train and eval) native == PIL bit for "
        f"bit; decode + train_transform ms a sample and Loader images/s at "
        f"bs{TRAIN_BS} (4 threads): {json.dumps(res)} on {card}")
    return res


@contextlib.contextmanager
def sampled_points(record: list, forced=None):
    """Every `certain_sample` result appended to `record` (on the CPU);
    with `forced` (an earlier run's list, in call order) each call returns
    that run's points in place of its own."""
    from gwdepth_tpu_torch.models import dense_encoder

    sample = dense_encoder.certain_sample

    def spy(*args, **kw):
        out = sample(*args, **kw)
        record.append(out.detach().cpu())
        if forced is not None:
            out = forced[len(record) - 1].to(out.device)
        return out

    dense_encoder.certain_sample = spy
    try:
        yield
    finally:
        dense_encoder.certain_sample = sample


def _train_grads(cfg, model, batch, dev, images=None, use_points=None):
    """One train step's losses, parameter gradients and sampled depth
    points (every `certain_sample` result, on the CPU) of `model` on `dev`
    (`images` in place of the batch's, on the CPU). With `use_points` (a
    list of earlier results) each `certain_sample` call returns the
    earlier run's points in place of its own (its own still recorded)."""
    from gwdepth_tpu_torch.parallel import compute_losses

    points = []
    b = batch.to(dev)
    imgs = b.images if images is None else images.to(dev)
    with sampled_points(points, use_points):
        _, logs = compute_losses(cfg, model(imgs, b.valid), b)
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
    them (K1 and K2's bf16 taps on both devices); for the shipped model
    and for the gated one (GATED_CFG with the plane-normal loss logged:
    K1 also at the class planes, 9 launches).

    Each path also runs the CPU step on images scaled by 1 + 1e-7 noise
    (float32 resolution), and every run records the pixels that
    `certain_sample` picks per point head (reported: how many of one
    run's picks the other did not make), a discrete choice beside the
    rounding carried through the links. With the kernels that
    perturbation moves the point heads' gradients far more than the
    card-vs-CPU gap: it is the control, a run known to differ, and the
    bf16-tap limits must sit at least CONTROL_MARGIN below it."""
    out = {"shipped": train_card_vs_cpu("shipped", {})}
    out["gated"] = train_card_vs_cpu(
        "gated", dict(GATED_CFG, with_plane_norm_loss=True), gated=True)
    return out


@torch.no_grad()
def perturb_weights(model, seed: int):
    """Every floating parameter a -> a (1 + 0.1 n1) + 0.01 n2, with n1, n2
    standard normal from `seed`, as the CPU tests perturb their weights
    (`tests/test_torch_model.py:_perturb`): no zero bias or unit LayerNorm
    weight of the seeded init is left."""
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        n = torch.randn((2, *p.shape), generator=gen)
        p.mul_(1 + 0.1 * n[0]).add_(0.01 * n[1])
    return model


def train_card_vs_cpu(model_name: str, gates: dict,
                      gated: bool = False) -> dict:
    """`phase_train_card_vs_cpu` for the model of `gates`.

    `gated` (the gated model) changes three things. The seeded weights
    are perturbed as the CPU tests perturb theirs (`perturb_weights`).
    The card step and the control take the CPU step's sampled depth
    points (`certain_sample`'s per-bin quotas and top-k sit next to ties
    at random weights: an H100 picked 11 of 60 and 41 of 160 points
    other than the CPU's, which the control's noise never moved, and the
    1/4 class layer's gradients, whose reference points they are, then
    differ by 5 %). And each gradient tensor is held to the larger of the
    path's limit and CONTROL_MARGIN x the control's gap of that same
    tensor, the medians to the path's limits: the gated dense branch
    moves the backbone's layer2 gradients by 2.3e-3 on the CPU alone
    under the 1e-7 noise, and a control that small cannot exceed the
    bf16 limits threefold (it is reported). ROADMAP.md section 3."""
    from gwdepth_tpu_torch.data.batch import dummy_batch

    k1_want = sum(GATED_K1.values()) if gated else K1_PER_FORWARD
    out, grads = {}, {}
    for use_pallas in (False, True):
        cfg = GWDepthConfig(dropout=0.0, train_hw=(128, 192),
                            use_pallas=use_pallas, **gates)
        batch = dummy_batch(cfg, TRAIN_BS, num_lines=6, seed=SEED)
        model_cpu = build_glassrgbd(cfg, SEED, device="cpu").train()
        if gated:
            perturb_weights(model_cpu, SEED + 3)
        model_gpu = copy.deepcopy(model_cpu).to("cuda")
        lc, gc, pc = _train_grads(cfg, copy.deepcopy(model_cpu), batch,
                                  "cpu")
        torch.cuda.synchronize()
        _reset_counts()
        lg, gg, pg = _train_grads(cfg, model_gpu, batch, "cuda",
                                  use_points=pc if gated else None)
        torch.cuda.synchronize()
        n = _counts()
        want = ({"k1": k1_want, "k2": K2_FWD_PER_FORWARD,
                 "k2_bwd": K2_BWD_PER_STEP, "lap_jv": 1} if use_pallas
                else {"k1": 0, "k2": 0, "k2_bwd": 0, "lap_jv": 1})
        assert {k: n[k] for k in want} == want, (n, want)
        assert set(gg) == set(gc) and set(lg) == set(lc)
        assert ("loss_plane" in lc) == bool(gates), sorted(lc)
        gen = torch.Generator().manual_seed(SEED)
        noisy = batch.images * (1 + 1e-7 * torch.randn(
            batch.images.shape, generator=gen))
        _, gn, pn = _train_grads(cfg, model_cpu, batch, "cpu", images=noisy,
                                 use_points=pc if gated else None)
        rel = _grad_gaps(gg, gc)
        line = [k for k in rel if k.startswith(
            ("transformer.", "class_embed", "lines_embed", "query_embed",
             "input_proj"))]
        stats = _gap_stats(gg, gc)
        ctl = _grad_gaps(gn, gc)
        limit = (BF16_GRAD_REL_L2_MAX_TOL if use_pallas
                 else TRAIN_GRAD_REL_L2_TOL)
        over = {k: v / max(limit, CONTROL_MARGIN * ctl.get(k, 0.0))
                for k, v in rel.items() if v > limit}
        out["bf16_taps" if use_pallas else "float32"] = {
            "launches": n,
            "max_loss_rel": max(abs(lg[k] - lc[k]) / max(1.0, abs(lc[k]))
                                for k in lc),
            "losses_cpu": lc,
            "grad_tensors": len(rel),
            "grad_rel_l2_max": stats["max"],
            "grad_rel_l2_median": stats["median"],
            "worst": sorted(rel.items(), key=lambda kv: -kv[1])[:3],
            "line_branch_rel_l2_max": max(rel[k] for k in line),
            "points": [int(t.shape[0] * t.shape[1]) for t in pc],
            "points_moved": _points_moved(pg, pc),
            "cpu_perturbed": {**_gap_stats(gn, gc),
                              "points_moved": _points_moved(pn, pc)},
            # tensors past the limit: gap / max(limit, margin x control)
            "past_limit": len(over),
            "past_limit_worst": sorted(over.items(),
                                       key=lambda kv: -kv[1])[:3]}
        grads[use_pallas] = (gc, gg)
        del model_cpu, model_gpu
    # how far K2's precision itself moves the step (reported, no limit)
    out["bf16_taps_vs_float32"] = _gap_stats(grads[True][1], grads[False][0])
    log(f"[train-cmp] {model_name} card vs CPU: " + json.dumps(out))
    f32, bf = out["float32"], out["bf16_taps"]
    for path in (f32, bf):
        assert path["max_loss_rel"] <= TRAIN_LOSS_REL_TOL, path
        assert path["line_branch_rel_l2_max"] <= TRAIN_GRAD_REL_L2_TOL, path
    if gated:
        for path, median in ((f32, TRAIN_GRAD_REL_L2_TOL),
                             (bf, BF16_GRAD_REL_L2_MEDIAN_TOL)):
            assert all(r <= 1.0 for _, r in path["past_limit_worst"]), path
            assert path["grad_rel_l2_median"] <= median, path
        return out
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
        want = {"k1": 0, "k2": k2_want * _graph_runs("forward", len(sizes)),
                "k3": 0, "k4": 0}
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
    runs = _graph_runs("eval_step", n_val)
    want = {"k1": K1_PER_FORWARD * runs, "k2": K2_FWD_PER_FORWARD * runs,
            "k2_bwd": 0, "k3": 0, "k4": 0, "lap_jv": runs,
            "matcher_calls": runs}
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
    runs = _graph_runs("train_step", 2) + _graph_runs("eval_step", n_val)
    want = {"k1": 0, "k2": 0, "k2_bwd": 0, "k3": 0, "k4": 0,
            "lap_jv": runs, "matcher_calls": runs}
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
# gated training, COCO-lines training (phases 14, 15)
# ---------------------------------------------------------------------------

# the gated train step: GATED_CFG with the plane-normal loss logged
GATED_TRAIN_FLAGS = ["--with_dense_center", "--with_line_depth",
                     "--class_tokenfuse_layers", "1,1,1",
                     "--with_plane_norm_loss"]
GATED_STEPS = 3               # timed train steps, after 2 warm-ups
REMAT_LOSS_REL_TOL = 1e-5
# the same kernels run with and without --remat; the comparison runs with
# PyTorch's deterministic algorithms, since by default the card's backward
# scatter-adds (the gathers' gradients) and cuDNN's convolutions sum in
# an order that changes from run to run, and K2's bf16 rounding in the
# point heads carries that past this limit even between two runs without
# --remat (phase 14 reports both)
REMAT_GRAD_REL_L2_TOL = 1e-4


@contextlib.contextmanager
def group_attention(train_main):
    """`main.main` with group attention in every class block, as
    GATED_CFG: neither CLI has a flag for it, so the config `main.main`
    builds from its flags gets it here."""
    orig = train_main.config_from_args
    train_main.config_from_args = lambda args: orig(args).replace(
        group_attention_layers=GATED_CFG["group_attention_layers"])
    try:
        yield
    finally:
        train_main.config_from_args = orig


@contextlib.contextmanager
def k1_backward_events():
    """CUDA events around every K1 backward (a `diffusion_torch` recompute
    and its autograd, on the kernel's saved inputs); yields the list of
    (start, end) pairs."""
    from gwdepth_tpu_torch.ops import ref_attn_diffusion as k1_mod

    orig = k1_mod.diffusion_vjp
    pairs = []

    def timed(*args):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig(*args)
        e.record()
        pairs.append((s, e))
        return out

    k1_mod.diffusion_vjp = timed
    try:
        yield pairs
    finally:
        k1_mod.diffusion_vjp = orig


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms (cuDNN's too) inside, warning on
    an operation that has none; the settings before it restored after."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        torch.backends.cudnn.deterministic = old[2]


def _with_args(args, **kv) -> list:
    """`args` with the value of each flag --k replaced by kv[k]."""
    args = list(args)
    for k, v in kv.items():
        args[args.index(f"--{k}") + 1] = v
    return args


def _gated_step_expected(remat: bool) -> dict:
    return {"k1": sum(GATED_TRAIN_K1.values()) * (2 if remat else 1),
            "k2": K2_FWD_PER_FORWARD, "k2_bwd": K2_BWD_PER_STEP,
            "k3": 0, "k4": 0, "lap_jv": 1}


def gated_train_run(card: str, train: dict, remat: bool) -> dict:
    """`main.main --use_pallas` on GATED_CFG with --with_plane_norm_loss
    (and --remat) for one epoch of 4 steps and its eval, on phase 7's
    scenes, the launch counts zeroed just before and read just after;
    then, from the trained state, GATED_STEPS timed steps after 2
    warm-ups (launches and K1 planes counted per step), the peak memory,
    a profiled step, and one step with K1's backward timed by events."""
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.parallel import make_train_step

    tag = "gated-train-remat" if remat else "gated-train"
    out = os.path.join(os.path.dirname(train["out"]), tag)
    args = _with_args(train["args"], output_dir=out) + GATED_TRAIN_FLAGS + \
        ["--epochs", "1"] + (["--remat"] if remat else [])
    steps, n_val = train["n_train"] // TRAIN_BS, train["n_val"]
    per_step = _gated_step_expected(remat)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with group_attention(train_main):
        state = train_main.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = _counts()
    steps, n_val = (_graph_runs("train_step", steps),
                    _graph_runs("eval_step", n_val))
    want = {k: v * steps for k, v in per_step.items()}
    want["k1"] += sum(GATED_K1.values()) * n_val
    want["k2"] += K2_FWD_PER_FORWARD * n_val
    want["lap_jv"] += n_val
    want["matcher_calls"] = steps + n_val
    log(f"[{tag}] main.main 4 steps + eval: {secs:.1f} s, launches {n}, "
        f"expected {want}")
    assert n == want, (n, want)
    cfg = state.model.cfg
    assert cfg.remat == remat and cfg.with_plane_norm_loss
    assert cfg.group_attention_layers == GATED_CFG["group_attention_layers"]
    logs = [json.loads(ln) for ln in open(os.path.join(out, "log.txt"))]
    assert len(logs) == 1 and all(np.isfinite(v) for v in logs[0].values())
    assert np.isfinite(logs[0]["train_loss_plane"]), logs[0]
    log(f"[{tag}] log.txt: loss {logs[0]['train_loss']}, loss_plane "
        f"{logs[0]['train_loss_plane']}")

    loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=TRAIN_BS,
                    seed=SEED, num_workers=4)
    batches = [b.to("cuda") for b, _ in loader.epoch(5)]
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2 + GATED_STEPS):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state, vec = step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
        got = _counts()
        # the first call captures: its warm-ups launch too
        runs = 1 + (graphs.WARMUPS if i == 0 else 0)
        assert {k: got[k] for k in per_step} == {
            k: runs * v for k, v in per_step.items()}, (got, per_step)
        planes = dict(ref_attn_diffusion.shape_launches)
        assert planes == {p: k * (2 if remat else 1) * runs
                          for p, k in GATED_TRAIN_K1.items()}, planes
        assert torch.isfinite(vec).all(), "non-finite gated train loss"
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(times))
    log(f"[{tag}] train step bs{TRAIN_BS} {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
        f"median {step_ms:.3f} ms over {len(times)} steps "
        f"({json.dumps(times)}) on {card}; launches a step {per_step}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    prof = profile_device(lambda: step(state, batches[0], gen), step_ms,
                          "step_ms", f"{tag}-profile")
    assert not prof or prof["k1_kernels"] == per_step["k1"], prof
    # the backward's Python runs eagerly only: a replay runs no hook
    with graphs.disable(), k1_backward_events() as pairs:
        step(state, batches[1], gen)
        torch.cuda.synchronize()
    bwd = [s.elapsed_time(e) for s, e in pairs]
    assert len(bwd) == sum(GATED_TRAIN_K1.values()), len(bwd)
    k1_bwd_ms = float(sum(bwd))
    busy = prof.get("device_busy_ms")
    log(f"[{tag}] K1 backward by events: {k1_bwd_ms:.3f} ms a step "
        f"({json.dumps(bwd)}), share of the busy time "
        f"{k1_bwd_ms / busy if busy else float('nan'):.4f}")
    return {"seconds": secs, "launches": n, "per_step": per_step,
            "step_ms": step_ms, "step_times": times, "peak_bytes": peak,
            "profile": prof, "k1_backward_ms": k1_bwd_ms,
            "k1_backward_calls_ms": bwd, "loss_plane":
                logs[0]["train_loss_plane"], "cfg": cfg, "batch": batches[0]}


def phase_gated_train(card: str, train: dict) -> dict:
    """Phase 14: `gated_train_run` without and with --remat, then one
    first step of each from the same seeded weights on the same batch,
    with deterministic algorithms: the losses equal to REMAT_LOSS_REL_TOL,
    every gradient tensor to REMAT_GRAD_REL_L2_TOL relative L2 (the
    tensors that are bit-equal counted)."""
    from gwdepth_tpu_torch.parallel import compute_losses

    runs = {}
    for remat in (False, True):
        runs[remat] = gated_train_run(card, train, remat)
        torch.cuda.empty_cache()
    b = runs[False]["batch"]

    def first_step(remat):
        cfg = runs[remat]["cfg"]
        model = build_glassrgbd(cfg, SEED, device="cpu").to("cuda").train()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        _, logs = compute_losses(cfg, model(b.images, b.valid,
                                            generator=gen), b)
        logs["loss"].backward()
        res = ({k: float(v.detach()) for k, v in logs.items()},
               {n: p.grad.detach() for n, p in model.named_parameters()
                if p.grad is not None})
        del model
        torch.cuda.empty_cache()
        return res

    with deterministic_algorithms(), warnings.catch_warnings(
            record=True) as caught:
        warnings.simplefilter("always")
        (l0, g0), (l1, g1) = first_step(False), first_step(True)
    nondeterministic = sorted({str(w.message)[:160] for w in caught
                               if "deterministic" in str(w.message)})
    assert set(l0) == set(l1) and set(g0) == set(g1)
    loss_rel = max(abs(l1[k] - l0[k]) / max(abs(l0[k]), 1e-12) for k in l0)
    gaps = _gap_stats(g1, g0)
    equal = sum(torch.equal(g0[n], g1[n]) for n in g0)
    # with the default algorithms (reported): remat against no remat, and
    # two runs without --remat
    d0 = first_step(False)[1]
    default = {"remat": _gap_stats(first_step(True)[1], d0),
               "rerun": _gap_stats(first_step(False)[1], d0)}
    log(f"[gated-train] remat vs no remat, first step (deterministic "
        f"algorithms; without one: {nondeterministic}): losses {l0}; max "
        f"relative loss gap {loss_rel}; gradients {json.dumps(gaps)}, "
        f"{equal} of {len(g0)} tensors bit-equal; by default algorithms: "
        f"{json.dumps(default)}")
    assert loss_rel <= REMAT_LOSS_REL_TOL, (loss_rel, l0, l1)
    assert gaps["max"] <= REMAT_GRAD_REL_L2_TOL, gaps
    for r in runs.values():
        r.pop("cfg")
        r.pop("batch")
    return {"runs": runs, "remat_loss_rel": loss_rel, "remat_grads": gaps,
            "remat_bit_equal": [equal, len(g0)], "default_algorithms":
                default}


def write_coco_lines(root: str, dst: str, per_split: int = 2) -> dict:
    """A COCO-lines set from phase 7's synthetic scenes: the first
    `per_split` train and val scenes as `lines_{train,val}2017.json` in
    `dst`, each polygon edge an annotation in offset form [x, y, dx, dy];
    the images stay in `root`/rgb. Returns split -> image count."""
    from PIL import Image
    from gwdepth_tpu_torch.data.dataset import lines_from_polygons

    counts = {}
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.txt")) as f:
            names = [ln.split()[0] for ln in f if ln.strip()][:per_split]
        images, anns = [], []
        for i, name in enumerate(names):
            w, h = Image.open(os.path.join(root, "rgb", name + ".png")).size
            images.append({"id": i, "file_name": name + ".png",
                           "width": w, "height": h})
            with open(os.path.join(root, "lines", name + ".json")) as f:
                lines, _, _ = lines_from_polygons(json.load(f))
            for x1, y1, x2, y2 in lines.tolist():
                anns.append({"id": len(anns), "image_id": i,
                             "category_id": 0, "area": 1, "iscrowd": 0,
                             "line": [x1, y1, x2 - x1, y2 - y1]})
        with open(os.path.join(dst, f"lines_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 0, "name": "line"}]}, f)
        counts[split] = len(images)
    return counts


def phase_coco_lines(train: dict) -> dict:
    """Phase 15: `main.main` with the flags of
    `recipes/train_stage2_res101_wireframe.sh` (--backbone resnet101
    --frozen_weights <phase 7's checkpoint> --num_queries 100 --with_line
    --with_center, bs1) on a COCO-lines set written from phase 7's
    scenes: 2 steps and the eval, then `--eval --benchmark` from its
    checkpoint. The line-only model runs no kernel (counted from 0 over
    each run); prints the tensors that --frozen_weights loaded and the
    step times."""
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch import parallel

    root, tmp = train["root"], os.path.dirname(train["out"])
    ann = os.path.join(tmp, "coco_ann")
    os.makedirs(ann)
    counts = write_coco_lines(root, ann)
    ckpt = os.path.join(train["out"], "checkpoints", "checkpoint.pth")
    out = os.path.join(tmp, "coco_res101")
    args = ["--device", "cuda", "--output_dir", out, "--backbone",
            "resnet101", "--frozen_weights", ckpt, "--batch_size", "1",
            "--epochs", "1", "--lr_drop", "120", "--num_queries", "100",
            "--with_line", "--with_center", "--num_workers", "4",
            "--coco_path", os.path.join(root, "rgb"),
            "--coco_ann_train", os.path.join(ann, "lines_train2017.json"),
            "--coco_ann_val", os.path.join(ann, "lines_val2017.json")]
    loaded, step_times = [], []
    load_frozen = train_main.load_frozen_weights
    make_step = parallel.make_train_step

    def counted_load(model, path):
        loaded.append(load_frozen(model, path))
        return loaded[-1]

    def timed_make_step(cfg):
        step = make_step(cfg)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(*a, **kw)
            torch.cuda.synchronize()
            step_times.append((time.perf_counter() - t0) * 1e3)
            return res
        timed.log_keys = step.log_keys
        return timed

    train_main.load_frozen_weights = counted_load
    parallel.make_train_step = timed_make_step
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state = train_main.main(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_train = _counts()
        graph_runs = (_graph_runs("train_step", counts["train"])
                      + _graph_runs("eval_step", counts["val"]))
        _reset_counts()
        t1 = time.perf_counter()
        stats = train_main.main(args + ["--eval", "--benchmark"])
        torch.cuda.synchronize()
        eval_secs = time.perf_counter() - t1
        n_eval = _counts()
    finally:
        train_main.load_frozen_weights = load_frozen
        parallel.make_train_step = make_step
    none = {"k1": 0, "k2": 0, "k2_bwd": 0, "k3": 0, "k4": 0}
    log(f"[coco-lines] main.main ResNet-101, 2 steps + eval: {secs:.1f} s, "
        f"launches {n_train}; --eval --benchmark: {eval_secs:.1f} s, "
        f"launches {n_eval}")
    assert {k: n_train[k] for k in none} == none, n_train
    assert {k: n_eval[k] for k in none} == none, n_eval
    assert n_train["matcher_calls"] == graph_runs, (n_train, graph_runs)
    assert n_train["lap_jv"] == n_train["matcher_calls"], n_train
    cfg = state.model.cfg
    assert cfg.backbone == "resnet101" and not cfg.with_dense
    assert len(state.model.backbone[0].body.layer3) == 23
    assert state.step == counts["train"] and len(step_times) == state.step

    # what --frozen_weights must load: each encoder/decoder/head tensor of
    # phase 7's checkpoint that the ResNet-101 line-only model holds
    own = build_glassrgbd(cfg, SEED, device="cpu").state_dict()
    src = torch.load(ckpt, map_location="cpu", weights_only=False)["model"]
    keep = ("encoder", "decoder", "class_embed", "lines_embed")
    want = sum(k in own and tuple(v.shape) == tuple(own[k].shape)
               and any(t in k for t in keep) for k, v in src.items())
    log(f"[coco-lines] --frozen_weights loaded {loaded} tensors (expected "
        f"{want} a run); step times {json.dumps(step_times)} ms on "
        f"{torch.cuda.get_device_name(0)}")
    assert loaded == [want, want] and want > 0, (loaded, want)
    logs = [json.loads(ln) for ln in open(os.path.join(out, "log.txt"))]
    assert all(np.isfinite(v) for v in logs[0].values()), logs[0]
    assert stats == {}, stats            # line-only: no eval metrics
    dumps = sorted(os.listdir(os.path.join(out, "benchmark",
                                           "benchmark_val")))
    assert len(dumps) == counts["val"], dumps
    return {"seconds": secs, "eval_seconds": eval_secs,
            "launches": n_train, "eval_launches": n_eval,
            "frozen_loaded": want, "step_times": step_times}


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


# ---------------------------------------------------------------------------
# export (phase 16) and the bf16 compute path (phase 17)
# ---------------------------------------------------------------------------

# phase 16's serving process: loads the artifact with nothing of the
# model code, runs it on the saved canvases with the launch counts zeroed
# just before each image and read just after, times it, and reports what
# it imported. argv: artifact, inputs npz, outputs npz, result json.
EXPORT_SERVER = r"""
import json, sys, time
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

art, inp, outp, resp = sys.argv[1:5]
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
cuda_init_s = time.perf_counter() - t0
t0 = time.perf_counter()
from gwdepth_tpu_torch.export import load_exported
call = load_exported(art)
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
k1 = sys.modules["gwdepth_tpu_torch.ops.ref_attn_diffusion"]
k2 = sys.modules["gwdepth_tpu_torch.ops.fused_conv"]
with np.load(inp) as z:
    xs = torch.from_numpy(z["x"]).cuda()
    vs = torch.from_numpy(z["valid"]).cuda()
outs, launches = [], []
for i in range(xs.shape[0]):
    torch.cuda.synchronize()
    k1.reset_counts()
    k2.reset_counts()
    o = call(xs[i:i + 1], vs[i:i + 1])
    torch.cuda.synchronize()
    launches.append({"k1": k1.ref_attn_diffusion.launches,
                     "k2": k2.conv3x3_ln_act.launches,
                     "k2_bwd": k2.conv3x3_ln_act.bwd_launches})
    outs.append([t.cpu().numpy() for t in o])
mods = sorted(m for m in sys.modules if m.startswith("gwdepth"))
times = []
for i in range(12):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(xs[:1], vs[:1])
    torch.cuda.synchronize()
    if i >= 2:
        times.append((time.perf_counter() - t0) * 1e3)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    call(xs[:1], vs[:1])
    torch.cuda.synchronize()
spans = sorted((e.time_range.start, e.time_range.end)
               for e in p.events() if e.device_type == DeviceType.CUDA)
busy, end = 0.0, -1.0
for s, e in spans:
    if e > end:
        busy += e - max(s, end)
        end = e
np.savez(outp, **{f"{i}_{j}": a for i, o in enumerate(outs)
                  for j, a in enumerate(o)})
from gwdepth_tpu_torch.ops import window_msa as wm
launches_k34 = {"k3": wm.window_msa_kernel.launches,
                "k4": wm.layout_fence.launches}
json.dump({"load_s": load_s, "cuda_init_s": cuda_init_s, "in_avals": [[list(s), str(d)]
                                          for s, d in call.in_avals],
           "launches": launches, "k34": launches_k34, "modules": mods,
           "times": times, "median_ms": float(np.median(times)),
           "busy_ms": busy / 1e3 if spans else None,
           "kernels": len(spans)}, open(resp, "w"))
"""


def op_dispatch_ms() -> dict:
    """What the custom-op binding adds to a call on the host: CUDA events
    around the public entry (through the op) and around the same launch
    without the op (`_launch`), medians of 30, at a serving K1 plane and
    a serving K2 link (1/4, 160 -> 160 channels, GELU, LayerNorm)."""
    from gwdepth_tpu_torch.ops import ref_attn_diffusion as k1_mod

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    a = torch.randn((1, 980, 40, 16), device="cuda", generator=g)
    w = 0.1 * torch.randn((3, 3, 16, 16), device="cuda", generator=g)
    b = 0.1 * torch.randn((16,), device="cuda", generator=g)
    x = torch.randn((1, 192, 256, 160), device="cuda", generator=g)
    w2 = 0.05 * torch.randn((3, 3, 160, 160), device="cuda", generator=g)
    g2 = torch.ones((160,), device="cuda")
    b2 = torch.zeros((160,), device="cuda")
    with torch.no_grad():
        res = {"k1_op_ms": time_ms(lambda: ref_attn_diffusion(a, w, b)),
               "k1_launch_ms": time_ms(lambda: k1_mod._launch(a, w, b)),
               "k2_op_ms": time_ms(lambda: conv3x3_ln_act(
                   x, w2, g2, b2, act="gelu")),
               "k2_launch_ms": time_ms(lambda: fused_conv._launch(
                   x, w2, g2, b2, None, "gelu", True))}
    log(f"[export] custom-op binding against a bare launch, by events: "
        f"{json.dumps(res)}")
    return res


def phase_export(card: str, tmp: str) -> dict:
    """Phase 16: the shipped forward exported on the card through
    `export.main --resume` (seeded weights saved as a checkpoint), no
    launch while it traces; the artifact's graph holds K1 x4 and K2 x25
    as custom-op nodes; a fresh process loads it without the model code
    and serves phase 5's three images (K1 4 and K2 25 launches an image),
    held against the eager forward of the same weights at phase 4's
    limits; latency, busy time and idle share beside eager's."""
    from gwdepth_tpu_torch import export
    from gwdepth_tpu_torch.predict import preprocess
    from PIL import Image

    cfg = GWDepthConfig(dropout=0.0, use_pallas=True)
    model = build_glassrgbd(cfg, SEED + 5, device="cpu")
    ckpt = os.path.join(tmp, "export_ckpt.pth")
    torch.save({"model": model.state_dict()}, ckpt)
    art = os.path.join(tmp, "model.pt2")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    export.main(["--output", art, "--resume", ckpt, "--device", "cuda"])
    export_s = time.perf_counter() - t0
    n = _counts()
    assert n["k1"] == n["k2"] == 0, f"a launch while tracing: {n}"
    program = torch.export.load(art)
    targets = [str(nd.target) for nd in program.graph.nodes
               if nd.op == "call_function"]
    nodes = {"k1": targets.count("gwdepth.ref_attn_diffusion.default"),
             "k2": targets.count("gwdepth.conv3x3_ln_act.default")}
    del program
    assert nodes == {"k1": K1_PER_FORWARD, "k2": K2_FWD_PER_FORWARD}, nodes
    size_mb = os.path.getsize(art) / 1e6

    src = os.path.join(tmp, "export_images")
    write_serve_images(src)
    xs, vs = [], []
    for name in SERVE_SIZES:
        canvas, valid, _ = preprocess(
            Image.open(os.path.join(src, f"{name}.png")), cfg.eval_hw)
        xs.append(canvas)
        vs.append(valid)
    inp = os.path.join(tmp, "export_inputs.npz")
    np.savez(inp, x=np.stack(xs), valid=np.stack(vs))
    outp = os.path.join(tmp, "export_outputs.npz")
    resp = os.path.join(tmp, "export_result.json")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    subprocess.run([sys.executable, "-c", EXPORT_SERVER, art, inp, outp,
                    resp], check=True, env=env, cwd=repo, timeout=600)
    res = json.load(open(resp))
    assert not [m for m in res["modules"]
                if m.startswith("gwdepth_tpu_torch.models")], res["modules"]
    per_image = {"k1": K1_PER_FORWARD, "k2": K2_FWD_PER_FORWARD,
                 "k2_bwd": 0}
    assert all(l == per_image for l in res["launches"]), res["launches"]
    assert res["k34"] == {"k3": 0, "k4": 0}, res["k34"]

    eager = model.to("cuda").eval()
    cmp = []
    with np.load(outp) as z, torch.no_grad():
        for i, (x, v) in enumerate(zip(xs, vs)):
            o = eager(torch.from_numpy(x[None]).cuda(),
                      torch.from_numpy(v[None]).cuda())
            got = {k: torch.from_numpy(z[f"{i}_{j}"])
                   for j, k in enumerate(EXPORT_KEYS)}
            cmp.append(forward_gaps(got, forward_outputs(o)))
            check_forward_gaps(cmp[-1], f"image {i}: artifact vs eager")
    x0 = torch.from_numpy(xs[0][None]).cuda()
    v0 = torch.from_numpy(vs[0][None]).cuda()
    # the eager forward against itself on the first image: what the card
    # moves from run to run, beside the artifact's gap
    with torch.no_grad():
        r = [eager(x0, v0) for _ in range(2)]
    rerun = forward_gaps(forward_outputs(r[1]), forward_outputs(r[0]))
    del r
    eager_ms = _forward_median_ms(lambda x: eager(x, v0), x0)
    with torch.no_grad():
        eprof = profile_device(lambda: eager(x0, v0), eager_ms, "forward_ms",
                               "export-eager-profile")
    # the artifact again in this process, timed and profiled beside eager
    # with the profiler in the same state
    call = export.load_exported(art)
    prog_ms = _forward_median_ms(lambda x: call(x, v0), x0)
    pprof = profile_device(lambda: call(x0, v0), prog_ms, "forward_ms",
                           "export-program-profile")
    del call
    busy = res["busy_ms"]
    dispatch = op_dispatch_ms()
    out = {"export_s": export_s, "load_s": res["load_s"],
           "op_dispatch": dispatch,
           "cuda_init_s": res["cuda_init_s"], "eager_rerun": rerun,
           "artifact_mb": size_mb, "nodes": nodes,
           "launches_per_image": res["launches"], "vs_eager": cmp,
           "exported_ms": res["median_ms"], "exported_busy_ms": busy,
           "exported_idle_share": (max(0.0, 1 - busy / res["median_ms"])
                                   if busy else None),
           "exported_kernels": res["kernels"], "eager_ms": eager_ms,
           "eager_busy_ms": eprof.get("device_busy_ms"),
           "eager_idle_share": eprof.get("device_idle_share"),
           "eager_kernels": eprof.get("device_kernels"),
           "program_here_ms": prog_ms,
           "program_here_busy_ms": pprof.get("device_busy_ms"),
           "program_here_idle_share": pprof.get("device_idle_share"),
           "program_here_kernels": pprof.get("device_kernels"),
           "in_avals": res["in_avals"]}
    log(f"[export] {json.dumps(out)} on {card}")
    log("[export] vs eager, full precision: " +
        "; ".join(", ".join(f"{k} {v!r}" for k, v in r.items())
                  for r in cmp))
    del eager
    torch.cuda.empty_cache()
    return {**out, "launches": {"k1": sum(l["k1"] for l in res["launches"]),
                                "k2": sum(l["k2"] for l in res["launches"]),
                                "k2_bwd": 0, **res["k34"],
                                # a forward runs no criterion
                                "lap_jv": 0}}


BF16_STEPS = 8                # timed bf16 train steps, after 2 warm-ups
# the bf16 step's first loss against the float32 step's: the JAX package's
# own bound (tests/test_train_step.py:273-274), 0.1 |f32| + 0.05
BF16_LOSS_REL = 0.1
BF16_LOSS_ABS = 0.05
# card vs CPU in bf16: the images are rounded to bf16 before the first
# conv, so a 1e-7 control vanishes there; the same control at one bf16
# step (2^-8 relative) is the one that moves the outputs
BF16_STEP = 2.0 ** -8


@contextlib.contextmanager
def kernel_input_dtypes():
    """The dtypes of the planes and activations that reach K1's and K2's
    launches inside, by a spy on each `_launch`."""
    from gwdepth_tpu_torch.ops import ref_attn_diffusion as k1_mod

    seen = set()
    origs = {k1_mod: k1_mod._launch, fused_conv: fused_conv._launch}

    def spy(orig, name):
        def f(x, *a, **kw):
            seen.add((name, str(x.dtype)))
            return orig(x, *a, **kw)
        return f

    k1_mod._launch = spy(origs[k1_mod], "k1")
    fused_conv._launch = spy(origs[fused_conv], "k2")
    try:
        yield seen
    finally:
        for mod, orig in origs.items():
            mod._launch = orig


def _bf16_card_vs_cpu() -> dict:
    """The bf16 forward at the shipped widths on a 128x192 canvas, card
    (use_pallas, TF32 for float32 matmuls and convs, as `--bf16` sets)
    against the CPU; the control: the CPU on images perturbed by 1e-7 and
    by one bf16 step (3 draws)."""
    cfg = GWDepthConfig(dropout=0.0, eval_hw=(128, 192), use_pallas=True,
                        dtype="bfloat16")
    model_cpu = build_glassrgbd(cfg, SEED, device="cpu")
    model = copy.deepcopy(model_cpu).to("cuda")
    gen = torch.Generator().manual_seed(SEED + 9)
    x = torch.randn((1, 128, 192, 3), generator=gen)

    with torch.no_grad():
        cpu = forward_outputs(model_cpu(x))
        card = forward_outputs(model(x.cuda()))
        ctl = {}
        for eps in (1e-7, BF16_STEP):
            draws = [forward_gaps(forward_outputs(model_cpu(x * (
                1 + eps * torch.randn(x.shape, generator=gen)))), cpu)
                for _ in range(3)]
            ctl[eps] = {k: max(d[k] for d in draws) for k in cpu}
    gap = forward_gaps(card, cpu)
    control = {k: CONTROL_MARGIN * max(ctl[e][k] for e in ctl) for k in cpu}
    held = {k: max(FORWARD_LIMITS[k], control[k]) for k in cpu}
    out = {"gap": gap, "limit": FORWARD_LIMITS, "control_1e-7": ctl[1e-7],
           "control_bf16_step": ctl[BF16_STEP], "held_at": held,
           "control_exceeds_limits": {k: control[k] > FORWARD_LIMITS[k]
                                      for k in cpu}}
    assert all(torch.isfinite(v).all() for v in card.values()), out
    for k in cpu:
        assert gap[k] <= held[k], (k, out)
    return out


def phase_bf16(card: str, train: dict) -> dict:
    """Phase 17: `main.main --bf16 --use_pallas` for one epoch on phase 7's
    scenes (K1 4, K2 25 and 51 launches a step; every K1 and K2 input
    float32), then BF16_STEPS timed steps after 2 warm-ups, peak memory
    and a profiled step beside phase 7's float32 step; the bf16 eval
    forward at 768x1024 bs1; the first bf16 step's loss against the
    float32 step's on the same weights and batch; the bf16 forward card
    vs CPU (`_bf16_card_vs_cpu`). Restores full float32 precision after."""
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.parallel import (create_train_state,
                                            make_train_step)

    out_dir = os.path.join(os.path.dirname(train["out"]), "bf16")
    args = _with_args(train["args"], output_dir=out_dir) + \
        ["--bf16", "--epochs", "1"]
    steps, n_val = train["n_train"] // TRAIN_BS, train["n_val"]
    per_step = dict(STEP_COUNTS)
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with kernel_input_dtypes() as dtypes:
            state = train_main.main(args)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = _counts()
        want = _expected_counts(_graph_runs("train_step", steps),
                                _graph_runs("eval_step", n_val))
        log(f"[bf16] main.main --bf16 4 steps + eval: {secs:.1f} s, "
            f"launches {n}, expected {want}; K1/K2 input dtypes "
            f"{sorted(dtypes)}")
        assert n == want, (n, want)
        assert dtypes == {("k1", "torch.float32"), ("k2", "torch.float32")}, \
            f"a bf16 tensor reached K1 or K2: {dtypes}"
        cfg = state.model.cfg
        assert cfg.dtype == "bfloat16" and cfg.use_pallas
        assert all(p.dtype == torch.float32
                   for p in state.model.parameters())
        assert torch.backends.cudnn.allow_tf32
        logs = [json.loads(ln) for ln in open(os.path.join(out_dir,
                                                           "log.txt"))]
        assert len(logs) == 1 and all(np.isfinite(v)
                                      for v in logs[0].values()), logs

        loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=TRAIN_BS,
                        seed=SEED, num_workers=4)
        batches = [b.to("cuda") for b, _ in loader.epoch(5)]
        step = make_train_step(cfg)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(2 + BF16_STEPS):
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            state, vec = step(state, batches[i % len(batches)], gen)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
            got = _counts()
            want = _first_call(per_step) if i == 0 else per_step
            assert {k: got[k] for k in per_step} == want, (got, want)
            assert torch.isfinite(vec).all(), "non-finite bf16 train loss"
        peak = torch.cuda.max_memory_allocated()
        step_ms = float(np.median(times))
        prof = profile_device(lambda: step(state, batches[0], gen), step_ms,
                              "step_ms", "bf16-train-profile")
        del state, step
        torch.cuda.empty_cache()

        # the first step of each dtype from the same weights and batch
        first = {}
        for dtype in ("float32", "bfloat16"):
            c = cfg.replace(dtype=dtype)
            c.set_matmul_precision()
            model = build_glassrgbd(c, SEED, device="cpu").to("cuda")
            st = make_train_step(c)
            _, vec = st(create_train_state(c, model), batches[0],
                        torch.Generator(device="cuda").manual_seed(SEED))
            first[dtype] = dict(zip(st.log_keys, vec.tolist()))["loss"]
            del model, st
            torch.cuda.empty_cache()
        f32, bf = first["float32"], first["bfloat16"]
        assert np.isfinite(bf) and abs(bf - f32) <= \
            BF16_LOSS_REL * abs(f32) + BF16_LOSS_ABS, first

        # the bf16 eval forward at the serving shape
        ecfg = GWDepthConfig(dropout=0.0, use_pallas=True, dtype="bfloat16")
        ecfg.set_matmul_precision()
        model = build_glassrgbd(ecfg, SEED, device="cuda")
        x = torch.from_numpy(np.random.default_rng(SEED + 1).normal(
            size=(1, H_IMG, W_IMG, 3)).astype(np.float32)).cuda()
        with torch.no_grad():
            torch.cuda.synchronize()
            _reset_counts()
            o = model(x)
            torch.cuda.synchronize()
            fn = _counts()
            assert {k: fn[k] for k in ("k1", "k2")} == {
                "k1": K1_PER_FORWARD, "k2": K2_FWD_PER_FORWARD}, fn
            assert all(torch.isfinite(t).all() for t in
                       (o["pred_logits"], o["pred_lines"], o["pred_seg"],
                        *o["pred_depth"]))
        fwd_ms = _forward_median_ms(model, x)
        with torch.no_grad():
            fprof = profile_device(lambda: model(x), fwd_ms, "forward_ms",
                                   "bf16-forward-profile")
        del model
        torch.cuda.empty_cache()
        cmp = _bf16_card_vs_cpu()
    finally:
        GWDepthConfig().set_matmul_precision()
    tprof = train["profile"]
    res = {"seconds": secs, "launches": n, "per_step": per_step,
           "step_ms": step_ms, "step_times": times, "peak_bytes": peak,
           "busy_ms": prof.get("device_busy_ms"),
           "idle_share": prof.get("device_idle_share"),
           "kernels": prof.get("device_kernels"),
           "f32_step_ms": train["step_ms"],
           "f32_busy_ms": tprof.get("device_busy_ms"),
           "f32_idle_share": tprof.get("device_idle_share"),
           "f32_peak_bytes": train["peak_bytes"],
           "first_loss": first, "forward_ms": fwd_ms,
           "forward_busy_ms": fprof.get("device_busy_ms"),
           "forward_idle_share": fprof.get("device_idle_share"),
           "card_vs_cpu": cmp}
    log(f"[bf16] {json.dumps(res)} on {card}")
    return res


# ---------------------------------------------------------------------------
# data parallelism (phase 18)
# ---------------------------------------------------------------------------

DP_STEPS = 3                  # phase 18b's train steps
DP_TIMED_STEPS = 3            # phase 18a's timed steps, after 2 warm-ups
DP_EPOCHS = 1                 # phase 18a's epochs of main.main
# 18b: two ranks (one image each) against one process (both images),
# from equal weights on equal images and depth points: the first step's
# losses to DP_LOSS_REL_TOL and its gradients (the sum over ranks before
# the clip, against one process's) to phase 8's float32 limit. Adam moves
# each element by about lr x the sign of its gradient, so an element
# whose gradient is float noise may move up to 2 lr a step the other way
# and the two runs part slowly; later steps' losses and the parameters
# are held to CONTROL_MARGIN x a control's gaps (that one process again
# on images x (1 + 1e-7 noise)), and every element to 2 lr a step. On an
# H100 80GB HBM3 at 700 W the first step read 4.9e-7 and 7.3e-5, the
# third 2.2e-5 against the control's 2.0e-5, and 0.47 % of the elements
# were past 1e-2 lr against the control's 1.5 %.
DP_LOSS_REL_TOL = 1e-5
_NCCL_NAMES = ("nccl",)


def _dp_spec(d: str) -> dict:
    with open(os.path.join(d, "spec.json")) as f:
        return json.load(f)


def _dp_write(d: str, name: str, rec: dict) -> None:
    with open(os.path.join(d, name), "w") as f:
        json.dump(rec, f)


def _device_kernels(fn) -> list:
    """(name, device us) of every CUDA kernel that one call of `fn` runs,
    as torch.profiler sees them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def dp_main_role(d: str) -> None:
    """Phase 18a in its own process (under torchrun, or not): `main.main`
    with the spec's flags under deterministic algorithms, the launch
    counts over it, its final parameters (rank 0); then, with the default
    algorithms, DP_TIMED_STEPS timed steps of the trained state with the
    counts per step, and one profiled step (NCCL, K1 and K2 kernels, busy
    time)."""
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.parallel import make_train_step
    from gwdepth_tpu_torch.parallel.mesh import launched

    spec = _dp_spec(d)
    probe()
    torch.cuda.synchronize()
    _reset_counts()
    with deterministic_algorithms():
        state = train_main.main(spec["args"])
    torch.cuda.synchronize()
    counts = _counts()
    captured = {n: [graphs.stats[n, "captures"], graphs.stats[n, "replays"]]
                for n in ("train_step", "eval_step")}
    mesh, cfg = state.mesh, state.model.cfg
    if mesh.is_main:
        torch.save({k: v.detach().cpu()
                    for k, v in state.model.state_dict().items()},
                   os.path.join(d, "params.pt"))
    loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=TRAIN_BS,
                    seed=SEED, num_workers=4, rank=mesh.rank,
                    world=mesh.world)
    batches = [b.to("cuda") for b, _ in loader.epoch(5)]
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + mesh.rank)
    times, per_step = [], []
    for i in range(2 + DP_TIMED_STEPS):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state, vec = step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v for k, v in _counts().items()
                         if k != "matcher_calls"})
        assert torch.isfinite(vec).all(), "non-finite train loss"
    spans = _device_kernels(lambda: step(state, batches[0], gen))

    def count(keys):
        return sum(any(k in n.lower() for k in keys) for n, _ in spans)

    _dp_write(d, f"result{mesh.rank}.json", {
        "launched": launched(), "world": mesh.world,
        "distributed": mesh.distributed,
        "backend": (torch.distributed.get_backend()
                    if mesh.distributed else None),
        "counts": counts, "graphs": captured, "per_step": per_step,
        "step_ms": float(np.median(times)), "step_times": times,
        "kernels": len(spans), "busy_ms": sum(t for _, t in spans) / 1e3,
        "nccl_kernels": count(_NCCL_NAMES),
        "nccl_names": sorted({n[:80] for n, _ in spans
                              if "nccl" in n.lower()}),
        "k1_kernels": count(_K1_NAMES), "k2_kernels": count(_K2_NAMES),
        "peak_bytes": torch.cuda.max_memory_allocated()})
    if mesh.distributed:
        torch.distributed.destroy_process_group()


def _dp_pair_setup(spec: dict, rank: int = 0, world: int = 1):
    """Phase 18b's config (phase 7's flags, dropout 0), seeded model on
    the card and this rank's part of the first DP_STEPS global batches."""
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader

    cfg = train_main.config_from_args(train_main.build_argparser(
        ).parse_args(spec["args"])).replace(dropout=0.0)
    # main.py's precision: float32 without TF32 (cuDNN allows TF32 by
    # default, which a rank's process would otherwise take)
    cfg.set_matmul_precision()
    loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=TRAIN_BS,
                    seed=SEED, num_workers=4, rank=rank, world=world)
    batches = [b for _, (b, _) in zip(range(DP_STEPS), loader.epoch(0))]
    model = build_glassrgbd(cfg, SEED, device="cpu").to("cuda")
    return cfg, model, batches


@contextlib.contextmanager
def first_clip_grads(record: dict):
    """The gradients that the first clip of the train state sees (after
    the reduction over ranks, before the clip; a split weight's shard),
    into `record` by id."""
    from gwdepth_tpu_torch.parallel import train_state

    clip = train_state.clip_grad_norm_

    def spy(params, *args, **kw):
        params = list(params)
        if not record:
            record.update({id(p): p.grad.detach().cpu() for p in params})
        return clip(params, *args, **kw)

    train_state.clip_grad_norm_ = spy
    try:
        yield
    finally:
        train_state.clip_grad_norm_ = clip


def dp_steps(cfg, model, batches, mesh=None, forced=None) -> dict:
    """DP_STEPS train steps under deterministic algorithms, run eagerly
    (`graphs.disable()`), with the launch counts of each, the sampled
    points (forced to `forced`'s, per step, when given), the log vectors,
    the first step's gradients before the clip and the final
    parameters."""
    from gwdepth_tpu_torch.parallel import (create_train_state,
                                            make_train_step)
    from gwdepth_tpu_torch.parallel.partition import unshard

    state = create_train_state(cfg, model, steps_per_epoch=4, mesh=mesh)
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + (mesh.data_rank if mesh else 0))
    torch.cuda.reset_peak_memory_stats()
    logs, counts, points, first = [], [], [], {}
    # eagerly: gloo's collectives cannot be captured, and the spies on the
    # depth points and the clip run in Python at every step
    with graphs.disable(), deterministic_algorithms(), \
            first_clip_grads(first):
        for i, batch in enumerate(batches):
            rec = []
            torch.cuda.synchronize()
            _reset_counts()
            with sampled_points(rec, None if forced is None else forced[i]):
                state, vec = step(state, batch.to("cuda"), gen)
            torch.cuda.synchronize()
            counts.append({k: v for k, v in _counts().items()
                           if k != "matcher_calls"})
            logs.append(vec.cpu().tolist())
            points.append(rec)
    peak = torch.cuda.max_memory_allocated()

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # what this rank holds: parameters (a split weight's shard) and AdamW's
    # moments; then the split tensors gathered whole (collectives)
    held = {"param_bytes": nbytes(model.parameters()),
            "adam_bytes": nbytes(t for st in state.optimizer.state.values()
                                 for t in st.values()
                                 if torch.is_tensor(t) and t.dim())}
    return {"keys": list(step.log_keys), "logs": logs, "counts": counts,
            "points": points, "peak_bytes": peak, **held,
            "grads": unshard(model, {n: first[id(p)] for n, p in
                                     model.named_parameters()
                                     if id(p) in first}),
            "params": unshard(model, {n: p.detach().cpu() for n, p in
                                      model.named_parameters()})}


def dp_pair_role(d: str) -> None:
    """Phase 18b, one of two ranks on the one card over gloo: the data-
    parallel train step on this rank's image of each global batch, the
    depth points forced to the one-process reference's for that image
    (its own picks recorded); rank 0 saves the final parameters."""
    from gwdepth_tpu_torch.parallel import make_mesh, setup

    setup("cuda:0", backend="gloo")
    mesh = make_mesh((-1,))
    spec = _dp_spec(d)
    ref = torch.load(os.path.join(d, "reference.pt"), weights_only=False)
    share = mesh.share(TRAIN_BS)
    forced = [[t[share] for t in step] for step in ref["points"]]
    cfg, model, batches = _dp_pair_setup(spec, mesh.rank, mesh.world)
    run = dp_steps(cfg, model, batches, mesh, forced)
    moved = [_points_moved(own, f) for own, f in zip(run["points"], forced)]
    if mesh.is_main:
        torch.save({k: run[k] for k in ("params", "grads")},
                   os.path.join(d, "pair_tensors.pt"))
    _dp_write(d, f"pair{mesh.rank}.json", {
        "keys": run["keys"], "logs": run["logs"], "counts": run["counts"],
        "points_moved": moved, "peak_bytes": run["peak_bytes"],
        "backend": torch.distributed.get_backend(), "world": mesh.world})
    torch.distributed.destroy_process_group()


def _run_role(role: str, d: str, nproc: int = 0, timeout: int = 600):
    """Run this script's `role` in a subprocess: under torchrun with
    `nproc` processes, or alone (nproc 0); CUBLAS_WORKSPACE_CONFIG lets
    cuBLAS run deterministically."""
    cmd = [os.path.abspath(__file__), "--dp-role", role, "--dp-dir", d]
    # the role's processes share the card with this one: hand back this
    # process's cached blocks first, so that a role finds the card as free
    # as the run it is held against (cuDNN picks its algorithms by the
    # workspace it can get; with 13-26 GiB held here phase 19b's ranks
    # parted from each other or from the one process). cuBLAS keeps a
    # workspace per stream, and one made inside a timing phase's capture
    # keeps that graph's pool from going back to the card: drop them.
    held = torch.cuda.memory_reserved()
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    log(f"[{role}] this process held {held / 2**30:.2f} GiB of the card, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB after gc, the "
        f"cuBLAS workspaces and empty_cache "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} allocated); "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")
    if nproc:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", *cmd]
    else:
        cmd = [sys.executable, *cmd]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.abspath(__file__))]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    t0 = time.perf_counter()
    # a session of its own, so that a timeout stops torchrun's workers too
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
    secs = time.perf_counter() - t0
    if proc.returncode:
        log(out[-4000:])
        log(err[-6000:])
        raise AssertionError(f"{role} (nproc {nproc}) exited "
                             f"{proc.returncode} after {secs:.0f} s")
    return secs


def phase_dp_nccl(card: str, train: dict, tmp: str) -> dict:
    """Phase 18a: `main.main --mesh -1 --use_pallas` for DP_EPOCHS epochs
    on phase 7's scenes under torchrun (one rank, NCCL) and alone, each in
    its own process under deterministic algorithms: log.txt and the final
    parameters bit-equal; launches over each run; per step (K1, K2 and
    NCCL kernels) and the step median and busy time beside phase 7's."""
    steps = train["n_train"] // TRAIN_BS
    # one capture of each step in main.main's epochs
    want = _expected_counts(DP_EPOCHS * steps + graphs.WARMUPS,
                            DP_EPOCHS * train["n_val"] + graphs.WARMUPS)
    res, secs = {}, {}
    for label, nproc in (("torchrun", 1), ("alone", 0)):
        d = os.path.join(tmp, f"dp-{label}")
        os.makedirs(d)
        args = _with_args(train["args"], output_dir=os.path.join(d, "exp")) \
            + ["--epochs", str(DP_EPOCHS), "--mesh", "-1"]
        _dp_write(d, "spec.json", {"args": args})
        secs[label] = _run_role("main", d, nproc)
        with open(os.path.join(d, "result0.json")) as f:
            res[label] = json.load(f)
        res[label]["log"] = [json.loads(ln) for ln in
                             open(os.path.join(d, "exp", "log.txt"))]
        res[label]["params"] = torch.load(os.path.join(d, "params.pt"))
    tr, al = res["torchrun"], res["alone"]
    assert tr["launched"] and tr["distributed"] and tr["world"] == 1 \
        and tr["backend"] == "nccl", tr
    assert not al["launched"] and not al["distributed"], al
    for r in (tr, al):
        assert r["counts"] == want, (r["counts"], want)
        assert r["graphs"] == {
            "train_step": [1, DP_EPOCHS * steps],
            "eval_step": [1, DP_EPOCHS * train["n_val"]]}, r
        # the timed loop's first call captures its own step
        assert r["per_step"][0] == _first_call(STEP_COUNTS), r["per_step"]
        for c in r["per_step"][1:]:
            assert c == STEP_COUNTS, c
    log_equal = tr["log"] == al["log"]
    unequal = [n for n in al["params"]
               if not torch.equal(tr["params"][n], al["params"][n])]
    prof = train["profile"]
    summary = {
        "seconds": secs, "launches": tr["counts"],
        "per_step": tr["per_step"][0],
        "nccl_kernels_per_step": tr["nccl_kernels"],
        "nccl_names": tr["nccl_names"],
        "alone_nccl_kernels_per_step": al["nccl_kernels"],
        "k1_kernels_per_step": tr["k1_kernels"],
        "k2_kernels_per_step": tr["k2_kernels"],
        "step_ms": tr["step_ms"], "alone_step_ms": al["step_ms"],
        "phase7_step_ms": train["step_ms"],
        "busy_ms": tr["busy_ms"], "alone_busy_ms": al["busy_ms"],
        "phase7_busy_ms": prof.get("device_busy_ms"),
        "peak_bytes": tr["peak_bytes"], "log_bit_equal": log_equal,
        "params_bit_equal": [len(al["params"]) - len(unequal),
                             len(al["params"])]}
    log(f"[dp-nccl] main.main --mesh -1 --use_pallas, {DP_EPOCHS} epochs, "
        f"under "
        f"torchrun (1 rank, NCCL) and alone: {json.dumps(summary)} on "
        f"{card}")
    assert log_equal, (tr["log"], al["log"])
    assert not unequal, unequal[:5]
    return summary


def _loss_gaps(logs, ref) -> np.ndarray:
    """Per step, the largest |a - b| / max(1, |b|) over the log keys."""
    a, b = np.asarray(logs), np.asarray(ref)
    return (np.abs(a - b) / np.maximum(1.0, np.abs(b))).max(axis=1)


def _params_far(got, ref, cfg) -> tuple:
    """(elements past 1e-2 lr, all elements, tensors past Adam's bound of
    2 lr a step)."""
    far = total = 0
    past = []
    for n, w in ref.items():
        lr = cfg.lr_backbone if n.startswith("backbone.") else cfg.lr
        diff = (got[n].double() - w.double()).abs()
        if float(diff.max()) > 2 * lr * DP_STEPS + 1e-6:
            past.append(n)
        far += int((diff > 1e-2 * lr).sum())
        total += diff.numel()
    return far, total, past


def phase_dp_pair(card: str, train: dict, tmp: str) -> dict:
    """Phase 18b: two processes on the one card over gloo, each the data-
    parallel train step on its image of each global batch of 2, for
    DP_STEPS steps, against one process's step on the 2 images, run here
    first under the same deterministic algorithms (its depth points are
    forced on the ranks, whose own picks are reported), and a control:
    that process again on images x (1 + 1e-7 noise), the same points."""
    from gwdepth_tpu_torch.data.batch import Batch

    d = os.path.join(tmp, "dp-pair")
    os.makedirs(d)
    spec = {"args": train["args"]}
    _dp_write(d, "spec.json", spec)
    cfg, model, batches = _dp_pair_setup(spec)
    ref = dp_steps(cfg, model, batches)
    gen = torch.Generator().manual_seed(SEED)
    noisy = [Batch(b.images * (1 + 1e-7 * torch.randn(
        b.images.shape, generator=gen)), *(getattr(b, f) for f in (
            "valid", "depth", "seg", "lines", "line_mask"))) for b in batches]
    model = build_glassrgbd(cfg, SEED, device="cpu").to("cuda")
    ctl = dp_steps(cfg, model, noisy, forced=ref["points"])
    del model
    torch.cuda.empty_cache()
    torch.save({"points": ref["points"]}, os.path.join(d, "reference.pt"))
    secs = _run_role("pair", d, nproc=2)
    pair = []
    for r in range(2):
        with open(os.path.join(d, f"pair{r}.json")) as f:
            pair.append(json.load(f))
    got = torch.load(os.path.join(d, "pair_tensors.pt"))
    per_step = dict(STEP_COUNTS)
    for p in [ref] + pair:
        assert p["counts"] == [per_step] * DP_STEPS, p["counts"]
    # what the ranks counted, each step of each rank the same
    counted = pair[0]["counts"][0]
    assert all(c == counted for p in pair for c in p["counts"]), pair
    assert pair[0]["logs"] == pair[1]["logs"] and pair[0]["keys"] == \
        ref["keys"] and {p["backend"] for p in pair} == {"gloo"}
    loss = _loss_gaps(pair[0]["logs"], ref["logs"])
    loss_ctl = _loss_gaps(ctl["logs"], ref["logs"])
    first = np.abs(np.asarray(pair[0]["logs"][0]) - np.asarray(
        ref["logs"][0])) / np.maximum(1.0, np.abs(np.asarray(
            ref["logs"][0])))
    grads, grads_ctl = (_gap_stats(g, ref["grads"])
                        for g in (got["grads"], ctl["grads"]))
    far, total, past = _params_far(got["params"], ref["params"], cfg)
    far_ctl, _, past_ctl = _params_far(ctl["params"], ref["params"], cfg)
    summary = {
        "seconds": secs, "loss_rel_per_step": loss.tolist(),
        "first_step_worst": ref["keys"][int(first.argmax())],
        "control_loss_rel_per_step": loss_ctl.tolist(),
        "first_step_grads": grads, "control_first_step_grads": grads_ctl,
        "params_far": [far, total], "control_params_far": [far_ctl, total],
        "past_sign_bound": past[:5] + past_ctl[:5],
        "points_moved": [p["points_moved"] for p in pair],
        "peak_bytes": [p["peak_bytes"] for p in pair],
        "one_process_peak_bytes": ref["peak_bytes"],
        "launches_per_step_per_rank": counted}
    log(f"[dp-pair] 2 ranks on one card over gloo, {DP_STEPS} steps, one "
        f"image each, against one process on both: {json.dumps(summary)} "
        f"on {card}")
    assert loss[0] <= DP_LOSS_REL_TOL, summary
    assert all(g <= max(DP_LOSS_REL_TOL, CONTROL_MARGIN * c)
               for g, c in zip(loss[1:], loss_ctl[1:])), summary
    assert grads["max"] <= TRAIN_GRAD_REL_L2_TOL, summary
    assert not past and not past_ctl, summary
    assert far <= CONTROL_MARGIN * far_ctl, summary
    return summary


def phase_data_parallel(card: str, train: dict, tmp: str) -> dict:
    """Phase 18: 18a, then 18b."""
    t0 = time.perf_counter()
    out = {"nccl": phase_dp_nccl(card, train, tmp),
           "pair": phase_dp_pair(card, train, tmp)}
    log(f"[dp] phase 18 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# tensor parallelism (phase 19)
# ---------------------------------------------------------------------------

TP_STEPS = DP_STEPS            # phase 19b's train steps
# 19b: a (1, 2) mesh of two processes against one process, from equal
# weights on equal batches, each under deterministic algorithms in a
# process of its own with the same environment: both model ranks run the
# whole batch with the whole (gathered) weights and the clip takes the
# one-process norm, so the losses, the gradients before the clip and the
# parameters are held to TP_PARAM_REL_TOL x max(1, |w|), and reported
# bit for bit
TP_PARAM_REL_TOL = 1e-6


def tp_main_role(d: str) -> None:
    """Phase 19a in its own process (under torchrun, or not): `main.main`
    with the spec's flags (`--mesh 1,1`) under deterministic algorithms,
    the launch counts over it and over one more step, the final
    parameters (rank 0)."""
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.parallel import make_train_step
    from gwdepth_tpu_torch.parallel.mesh import launched
    from gwdepth_tpu_torch.parallel.partition import full_state_dict

    spec = _dp_spec(d)
    probe()
    torch.cuda.synchronize()
    _reset_counts()
    with deterministic_algorithms():
        state = train_main.main(spec["args"])
        torch.cuda.synchronize()
        counts = _counts()
        mesh, cfg = state.mesh, state.model.cfg
        loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=TRAIN_BS,
                        seed=SEED, num_workers=4, rank=mesh.data_rank,
                        world=mesh.data_size)
        batch = [b for b, _ in loader.epoch(5)][0].to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        _reset_counts()
        make_train_step(cfg)(state, batch, gen)
        torch.cuda.synchronize()
        per_step = {k: v for k, v in _counts().items()
                    if k != "matcher_calls"}
    params = full_state_dict(state.model)
    if mesh.is_main:
        torch.save({k: v.detach().cpu() for k, v in params.items()},
                   os.path.join(d, "params.pt"))
    _dp_write(d, f"result{mesh.rank}.json", {
        "launched": launched(), "world": mesh.world,
        "distributed": mesh.distributed, "shape": list(mesh.shape),
        "axes": list(mesh.axes),
        "backend": (torch.distributed.get_backend()
                    if mesh.distributed else None),
        "counts": counts, "per_step": per_step})
    if mesh.distributed:
        torch.distributed.destroy_process_group()


def tp_steps_role(d: str) -> None:
    """Phase 19b, one process: under torchrun, a rank of the (1, 2) mesh
    over gloo on the one card; alone, the one-process reference. Each
    runs TP_STEPS train steps (`dp_steps`) on the whole global batches;
    rank 0 (or the reference) saves the whole gradients and parameters."""
    from gwdepth_tpu_torch.parallel import make_mesh, setup
    from gwdepth_tpu_torch.parallel.mesh import launched
    from gwdepth_tpu_torch.parallel.partition import spec_for

    spec = _dp_spec(d)
    if launched():
        setup("cuda:0", backend="gloo")
        mesh = make_mesh((1, 2), ("data", "model"))
    else:
        mesh = None
    cfg, model, batches = _dp_pair_setup(spec)
    full_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    split = sum(p.numel() for n, p in model.named_parameters()
                if spec_for(n, p.shape, 2) is not None)
    run = dp_steps(cfg, model, batches, mesh)
    name = "tp_one" if mesh is None else f"tp_rank{mesh.rank}"
    if mesh is None or mesh.is_main:
        torch.save({k: run[k] for k in ("params", "grads", "points")},
                   os.path.join(d, f"{name}.pt"))
    _dp_write(d, f"{name}.json", {
        "keys": run["keys"], "logs": run["logs"], "counts": run["counts"],
        "peak_bytes": run["peak_bytes"], "param_bytes": run["param_bytes"],
        "adam_bytes": run["adam_bytes"], "full_param_bytes": full_bytes,
        "n_params": n_params, "split_at_2": split,
        "mesh": None if mesh is None else [list(mesh.shape),
                                           mesh.data_rank, mesh.model_rank],
        "backend": (torch.distributed.get_backend() if mesh else None)})
    if mesh is not None:
        torch.distributed.destroy_process_group()


def phase_tp_mesh1(card: str, train: dict, tmp: str) -> dict:
    """Phase 19a: `main.main --mesh 1,1 --use_pallas` for one epoch on
    phase 7's scenes under torchrun (one rank, NCCL) and alone, each in
    its own process under deterministic algorithms: log.txt and the final
    parameters bit-equal; launches over each run and per step."""
    steps = train["n_train"] // TRAIN_BS
    want = _expected_counts(steps + graphs.WARMUPS,
                            train["n_val"] + graphs.WARMUPS)
    # one more step of a fresh step function: its capture
    per_step = _first_call(STEP_COUNTS)
    res, secs = {}, {}
    for label, nproc in (("torchrun", 1), ("alone", 0)):
        d = os.path.join(tmp, f"tp-{label}")
        os.makedirs(d)
        args = _with_args(train["args"], output_dir=os.path.join(d, "exp")) \
            + ["--epochs", "1", "--mesh", "1,1"]
        _dp_write(d, "spec.json", {"args": args})
        secs[label] = _run_role("tp-main", d, nproc)
        with open(os.path.join(d, "result0.json")) as f:
            res[label] = json.load(f)
        res[label]["log"] = [json.loads(ln) for ln in
                             open(os.path.join(d, "exp", "log.txt"))]
        res[label]["params"] = torch.load(os.path.join(d, "params.pt"))
    tr, al = res["torchrun"], res["alone"]
    assert tr["launched"] and tr["distributed"] and tr["world"] == 1 \
        and tr["backend"] == "nccl", tr
    assert not al["launched"] and not al["distributed"], al
    for r in (tr, al):
        assert r["shape"] == [1, 1] and r["axes"] == ["data", "model"], r
        assert r["counts"] == want, (r["counts"], want)
        assert r["per_step"] == per_step, r["per_step"]
    log_equal = tr["log"] == al["log"]
    unequal = [n for n in al["params"]
               if not torch.equal(tr["params"][n], al["params"][n])]
    summary = {"seconds": secs, "launches": tr["counts"],
               "per_step": tr["per_step"], "log_bit_equal": log_equal,
               "params_bit_equal": [len(al["params"]) - len(unequal),
                                    len(al["params"])]}
    log(f"[tp-mesh1] main.main --mesh 1,1 --use_pallas, 1 epoch, under "
        f"torchrun (1 rank, NCCL) and alone: {json.dumps(summary)} on "
        f"{card}")
    assert log_equal, (tr["log"], al["log"])
    assert not unequal, unequal[:5]
    return summary


def _rel_gap(got: dict, ref: dict) -> float:
    """Largest |a - b| / max(1, |b|) over every element of the tensors."""
    return max(float(((got[n].double() - w.double()).abs()
                      / w.double().abs().clamp(min=1.0)).max())
               for n, w in ref.items())


def phase_tp_pair(card: str, train: dict, tmp: str) -> dict:
    """Phase 19b: a (1, 2) mesh of two processes on the one card over
    gloo (the split weights' all_gather staged through the host, the
    all_reduce and broadcast on CUDA tensors), TP_STEPS steps of the
    shipped config on phase 18b's batches (dropout 0, `use_pallas`),
    against one process in a process of its own: losses, gradients
    before the clip and parameters, the launches per rank and step, and
    the parameter and AdamW bytes each rank holds."""
    d = os.path.join(tmp, "tp-pair")
    os.makedirs(d)
    _dp_write(d, "spec.json", {"args": train["args"]})
    secs = {"one": _run_role("tp-steps", d, 0),
            "pair": _run_role("tp-steps", d, nproc=2)}

    def load(name):
        with open(os.path.join(d, f"{name}.json")) as f:
            return json.load(f)

    one, ranks = load("tp_one"), [load(f"tp_rank{r}") for r in range(2)]
    ref = torch.load(os.path.join(d, "tp_one.pt"))
    got = torch.load(os.path.join(d, "tp_rank0.pt"))
    per_step = dict(STEP_COUNTS)
    for p in [one] + ranks:
        assert p["counts"] == [per_step] * TP_STEPS, p["counts"]
    assert [r["mesh"] for r in ranks] == [[[1, 2], 0, 0], [[1, 2], 0, 1]]
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert ranks[0]["logs"] == ranks[1]["logs"]
    assert ranks[0]["keys"] == one["keys"]
    loss = _loss_gaps(ranks[0]["logs"], one["logs"])
    first_equal = ranks[0]["logs"][0] == one["logs"][0]
    grads_equal = sum(torch.equal(got["grads"][n], w)
                      for n, w in ref["grads"].items())
    params_equal = sum(torch.equal(got["params"][n], w)
                       for n, w in ref["params"].items())
    points_equal = all(torch.equal(a, b) for sa, sb in zip(
        got["points"], ref["points"]) for a, b in zip(sa, sb))
    summary = {
        "seconds": secs, "loss_rel_per_step": loss.tolist(),
        "first_step_losses_bit_equal": first_equal,
        "grads_bit_equal": [grads_equal, len(ref["grads"])],
        "grads_rel_gap": _rel_gap(got["grads"], ref["grads"]),
        "params_bit_equal": [params_equal, len(ref["params"])],
        "params_rel_gap": _rel_gap(got["params"], ref["params"]),
        "points_equal": points_equal,
        "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
        "adam_bytes_per_rank": [r["adam_bytes"] for r in ranks],
        "one_process_param_bytes": one["param_bytes"],
        "one_process_adam_bytes": one["adam_bytes"],
        "params": one["n_params"], "split_at_2": one["split_at_2"],
        "split_share": one["split_at_2"] / one["n_params"],
        "peak_bytes": [r["peak_bytes"] for r in ranks],
        "one_process_peak_bytes": one["peak_bytes"],
        "gloo_staged_through_host": ["all_gather"],
        "launches_per_step_per_rank": ranks[0]["counts"][0]}
    log(f"[tp-pair] (1, 2) mesh, 2 ranks on one card over gloo, {TP_STEPS} "
        f"steps on the whole batch each, against one process: "
        f"{json.dumps(summary)} on {card}")
    assert first_equal, (ranks[0]["logs"][0], one["logs"][0])
    assert grads_equal == len(ref["grads"]), summary
    assert max(loss) <= TP_PARAM_REL_TOL, summary
    assert summary["params_rel_gap"] <= TP_PARAM_REL_TOL, summary
    # each rank holds about half of the split weights and their moments
    for r in ranks:
        assert r["param_bytes"] < one["param_bytes"], summary
        assert r["adam_bytes"] < one["adam_bytes"], summary
    return summary


def phase_tensor_parallel(card: str, train: dict, tmp: str) -> dict:
    """Phase 19: 19a, then 19b."""
    t0 = time.perf_counter()
    out = {"mesh1": phase_tp_mesh1(card, train, tmp),
           "pair": phase_tp_pair(card, train, tmp)}
    log(f"[tp] phase 19 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: the library modules
# ---------------------------------------------------------------------------

# the shipped config's widths, at the grids of the modules' call sites
LIB_CFG = GWDepthConfig()
LIB_TC = LIB_CFG.class_token_dim                      # 64
LIB_LINES = LIB_CFG.num_ref                           # 20 lines
LIB_P = LIB_CFG.ref_points_per_line                   # 2 points a line
LIB_CB = LIB_CFG.backbone_channels[2]                 # 1024 ch at 1/16
LIB_DIM = LIB_CFG.dense_trans_dim                     # 512 at 1/32
LIB_HEADS = LIB_CFG.dense_trans_heads                 # 16
LIB_16 = (H_IMG // 16, W_IMG // 16)                   # 48 x 64
LIB_32 = (H_IMG // 32, W_IMG // 32)                   # 24 x 32
LIB_QUERIES = 100                                     # sample_by_centers
SNE_HW = (720, 1280)         # a RealSense frame (tools/raw_capture.py)
LIB_REPS = 10


def _flat_outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out if o is not None for t in _flat_outputs(o)]


def _lib_gaps(card, cpu) -> dict:
    """Max-abs and relative L2 of every output tensor, card against CPU,
    at phase 4's limits (LINE_TOL, DENSE_REL_L2_TOL)."""
    card, cpu = _flat_outputs(card), _flat_outputs(cpu)
    assert len(card) == len(cpu)
    gaps = {"max_abs": 0.0, "rel_l2": 0.0}
    for a, b in zip(card, cpu):
        a = a.detach().cpu().float()
        b = b.detach().float()
        assert a.shape == b.shape and torch.isfinite(a).all()
        gaps["max_abs"] = max(gaps["max_abs"], float((a - b).abs().max()))
        gaps["rel_l2"] = max(gaps["rel_l2"], _rel_l2(a, b))
    return gaps


def _held(name: str, card, cpu, control) -> dict:
    """A discrete choice: equal on the card and the CPU, or, where not,
    moved on the CPU too by 1e-7 noise on its inputs (the control)."""
    card, cpu, control = (torch.as_tensor(t).cpu() for t in
                          (card, cpu, control))
    rec = {"equal": bool(torch.equal(card, cpu)),
           "differ": int((card != cpu).sum()),
           "control_differ": int((control != cpu).sum())}
    assert rec["equal"] or rec["control_differ"] > 0, \
        f"[library] {name}: card and CPU choose differently, and 1e-7 " \
        f"noise moves no choice on the CPU: {rec}"
    return rec


def _noisy(t: torch.Tensor, gen) -> torch.Tensor:
    return t * (1 + 1e-7 * torch.randn(t.shape, generator=gen))


def _lib_module(name, module, args, shapes: str, kwargs=None,
                reps: int = LIB_REPS) -> dict:
    """`module` (seeded, perturbed) on the CPU and a copy on the card on
    the same inputs: every output within phase 4's limits, and the card's
    median ms by CUDA events."""
    kwargs = kwargs or {}
    module = perturb_weights(module.eval(), SEED + 22)
    card_mod = copy.deepcopy(module).to("cuda")
    dev_args = [a.to("cuda") if isinstance(a, torch.Tensor) else a
                for a in args]
    with torch.no_grad():
        want = module(*args, **kwargs)
        got = card_mod(*dev_args, **kwargs)
        torch.cuda.synchronize()
        ms = time_ms(lambda: card_mod(*dev_args, **kwargs), reps=reps,
                     warmup=2)
    gaps = _lib_gaps(got, want)
    assert gaps["max_abs"] <= LINE_TOL and gaps["rel_l2"] <= \
        DENSE_REL_L2_TOL, f"[library] {name} card vs CPU {gaps}"
    rec = {"name": name, "shapes": shapes, "ms": ms, **gaps}
    return rec, card_mod, want, got


def sne_depth(rng):
    """A RealSense-size frame (SNE_HW): a slanted plane in metres with
    noise, 5 % zero holes and a zero glass pane; intrinsics with the
    principal point at the centre, so the upper half has Y <= 0."""
    H, W = SNE_HW
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    depth = 1.5 + 1e-3 * xx + 2e-3 * yy + 1e-3 * rng.normal(size=(H, W))
    depth[rng.uniform(size=(H, W)) < 0.05] = 0.0
    depth[H // 2 + 40:H // 2 + 160, W // 3:W // 2] = 0.0
    cam = np.array([[910.0, 0, W / 2], [0, 905.0, H / 2], [0, 0, 1]],
                   np.float32)
    return torch.from_numpy(depth.astype(np.float32)), torch.from_numpy(cam)


def phase_library(card: str) -> dict:
    """Phase 22: every device module of the library half, which no model
    path builds, on the card at the shipped config's widths against the
    port's CPU run of the same seeded, perturbed weights and inputs, TF32
    off: TokenFuse, ConvGRU, PyramidConv and NonLocalPlannarGuidance at
    the 1/16 grid (backbone 1024 ch, depth_pred at 1/32),
    ReflectionReduce on a 768x1024 hint, PointTokenAttention and
    OffsetGeneration at 1/32 (dim 512, 16 heads, 40 points),
    distance_map at 1/16, _kmeans and sample_by_centers on 100 queries,
    sample_along_seg / sample_mid_seg on the 20 lines, and SNE on a
    720x1280 frame. Float outputs at phase 4's limits (max-abs LINE_TOL,
    relative L2 DENSE_REL_L2_TOL); discrete choices (k-means labels,
    selected lines, OffsetGeneration's hull choice, SNE's fallback
    pixels and ny > 0 flips) equal, or moved by 1e-7 noise on the CPU
    too. No kernel launches (OffsetGeneration's pyramid runs unfused).
    The card's ms by CUDA events, medians of LIB_REPS calls."""
    from gwdepth_tpu_torch.models import geometry, points
    from gwdepth_tpu_torch.tools.sne import sne_normals

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    gen = torch.Generator().manual_seed(SEED + 22)
    torch.manual_seed(SEED + 22)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def refs(L=LIB_LINES):
        return torch.from_numpy(rng.uniform(
            -1, 1, size=(1, L, LIB_P, 2)).astype(np.float32))

    tC, nP = LIB_TC, LIB_LINES * LIB_P
    h16, h32 = LIB_16, LIB_32
    recs = []
    _reset_counts()
    tok16 = [normal(1, *h16, tC) for _ in range(3)]
    recs.append(_lib_module(
        "TokenFuse", geometry.TokenFuse(tC),
        (tok16[0], tok16[1], refs(), tok16[2]),
        f"tokens (1, {h16[0]}, {h16[1]}, {tC}), {LIB_LINES}x{LIB_P} "
        "reference points")[0])
    recs.append(_lib_module(
        "ConvGRU", geometry.ConvGRU(tC, nP + 1),
        (normal(1, *h16, tC), normal(1, *h16, nP + 1)),
        f"h (1, {h16[0]}, {h16[1]}, {tC}), x {nP + 1} ch")[0])
    recs.append(_lib_module(
        "PyramidConv", geometry.PyramidConv(1, 1, 32, 2),
        (normal(1, *h32, 1),),
        f"depth (1, {h32[0]}, {h32[1]}, 1) -> {h16}", {"size": h16})[0])
    recs.append(_lib_module(
        "NonLocalPlannarGuidance",
        geometry.NonLocalPlannarGuidance(LIB_CB, tC, nP),
        (normal(1, *h16, LIB_CB), tok16[0], tok16[1], refs(), tok16[2],
         torch.sigmoid(normal(1, *h32, 1))),
        f"backbone (1, {h16[0]}, {h16[1]}, {LIB_CB}), tokens {tC} ch, "
        f"{nP} points, depth_pred (1, {h32[0]}, {h32[1]}, 1)")[0])
    sizes = ((H_IMG // 16, W_IMG // 16), (H_IMG // 8, W_IMG // 8),
             (H_IMG // 4, W_IMG // 4))
    recs.append(_lib_module(
        "ReflectionReduce", geometry.ReflectionReduce(),
        (torch.sigmoid(normal(1, H_IMG, W_IMG, 3)), sizes),
        f"hint (1, {H_IMG}, {W_IMG}, 3) -> {list(sizes)}")[0])
    recs.append(_lib_module(
        "PointTokenAttention",
        geometry.PointTokenAttention(LIB_DIM, LIB_HEADS, tC),
        (normal(1, *h32, LIB_DIM), normal(1, nP, tC)),
        f"x (1, {h32[0]}, {h32[1]}, {LIB_DIM}), {LIB_HEADS} heads, "
        f"{nP} point tokens of {tC}")[0])

    # OffsetGeneration: the proposals at the float limits, the hull choice
    # discrete
    og_args = (normal(1, *h32, LIB_DIM), normal(1, *h32, tC), refs(),
               normal(1, *h32, LIB_DIM))
    rec, og_card, want, got = _lib_module(
        "OffsetGeneration", points.OffsetGeneration(LIB_DIM, tC, nP),
        og_args, f"x (1, {h32[0]}, {h32[1]}, {LIB_DIM}), tokens {tC} ch, "
        f"{nP} points, SPP pools (32, 16, 8, 4)")
    og_cpu = copy.deepcopy(og_card).cpu()
    with torch.no_grad():
        card_prop = og_card.proposals(*[a.cuda() for a in og_args])
        cpu_prop = og_cpu.proposals(*og_args)
        ctl_prop = og_cpu.proposals(*[_noisy(a, gen) for a in og_args])
        rec["hull_choice"] = _held(
            "OffsetGeneration hull choice", og_card.largest_hull(card_prop),
            og_cpu.largest_hull(cpu_prop), og_cpu.largest_hull(ctl_prop))
        rec["proposals"] = _lib_gaps(card_prop, cpu_prop)
        rec["chosen"] = int(og_cpu.largest_hull(cpu_prop)[0])
        torch.cuda.synchronize()
        rec["proposals_ms"] = time_ms(lambda: og_card.proposals(
            *[a.cuda() for a in og_args]), reps=LIB_REPS, warmup=2)
    assert rec["proposals"]["max_abs"] <= LINE_TOL, rec
    recs.append(rec)

    # the pure functions; a discrete result is held as a choice, its
    # control the CPU on inputs x (1 + 1e-7 noise)
    def pure(name, fn, args, shapes, choice=None):
        with torch.no_grad():
            want = fn(*args)
            dev_args = [a.cuda() for a in args]
            got = fn(*dev_args)
            torch.cuda.synchronize()
            ms = time_ms(lambda: fn(*dev_args), reps=LIB_REPS, warmup=2)
            r = {"name": name, "shapes": shapes, "ms": ms}
            if choice is None:
                r.update(_lib_gaps(got, want))
                assert r["max_abs"] <= LINE_TOL and \
                    r["rel_l2"] <= DENSE_REL_L2_TOL, r
            else:
                noisy = [_noisy(a, gen) for a in args]
                r["choice"] = _held(name, choice(got, args),
                                    choice(want, args),
                                    choice(fn(*noisy), noisy))
        recs.append(r)

    with torch.no_grad():
        want = geometry.distance_map(*h16)
        got = geometry.distance_map(*h16, device="cuda")
        torch.cuda.synchronize()
        ms = time_ms(lambda: geometry.distance_map(*h16, device="cuda"),
                     reps=LIB_REPS, warmup=2)
    rec = {"name": "distance_map", "shapes": f"{h16} grid", "ms": ms,
           **_lib_gaps(got, want)}
    assert rec["max_abs"] <= LINE_TOL, rec
    recs.append(rec)

    def selected(out, args):
        """The indices of the selected lines among the input lines."""
        lines = args[1].to(out.device)
        d = (out[:, :, None, :] - lines[:, None, :, :]).abs().sum(-1)
        return d.argmin(-1).cpu()

    Q = LIB_QUERIES
    centers = torch.from_numpy(rng.uniform(size=(1, Q, 2)).astype(
        np.float32))
    lines = torch.from_numpy(rng.uniform(size=(1, Q, 4)).astype(np.float32))
    pure("_kmeans", lambda c: geometry._kmeans(c, 16), (centers[0],),
         f"{Q} points, 16 clusters, 20 iterations",
         choice=lambda out, args: out.cpu())
    pure("sample_by_centers",
         lambda c, li, lo: geometry.sample_by_centers(c, li, lo, H_IMG,
                                                      W_IMG),
         (centers, lines, normal(1, Q, 2)),
         f"{Q} queries at {H_IMG}x{W_IMG}: 16 clusters, top 6, 50 lines",
         choice=selected)
    seg = refs()
    pure("sample_along_seg",
         lambda s: points.sample_along_seg(s, H_IMG, W_IMG), (seg,),
         f"{LIB_LINES} lines, 10 points each, {H_IMG}x{W_IMG}")
    pure("sample_mid_seg", points.sample_mid_seg, (seg,),
         f"{LIB_LINES} lines")

    n = _counts()
    assert all(n[k] == 0 for k in ("k1", "k2", "k2_bwd", "k3", "k4",
                                   "lap_jv")), \
        f"[library] the library modules launched kernels: {n}"

    # SNE on a RealSense frame: the fallback pixels and the ny > 0 flips
    # are discrete choices, the normals floats
    depth, cam = sne_depth(rng)
    with torch.no_grad():
        want = sne_normals(depth, cam)
        d_card, cam_card = depth.cuda(), cam.cuda()
        got = sne_normals(d_card, cam_card)
        ctl = sne_normals(_noisy(depth, gen), cam)
        torch.cuda.synchronize()
        ms = time_ms(lambda: sne_normals(d_card, cam_card), reps=LIB_REPS,
                     warmup=2)

    def fallback(n):
        return ((n[0] == 0) & (n[1] == 0) & (n[2] == -1)).cpu()

    def flipped(a, b):
        """Pixels where one normal is the other's negation (the ny > 0
        flip taken on one side only)."""
        a, b = a.cpu(), b.cpu()
        return ((a + b).abs().amax(0) <= LINE_TOL) & \
            ((a - b).abs().amax(0) > LINE_TOL)

    got_c = got.cpu()
    flips = flipped(got_c, want)
    rec = {"name": "sne_normals", "ms": ms,
           "shapes": f"depth {SNE_HW[0]}x{SNE_HW[1]}, 5 % holes, the "
                     "upper half Y <= 0",
           "fallback_pixels": int(fallback(want).sum()),
           "fallback": _held("sne fallback pixels", fallback(got),
                             fallback(want), fallback(ctl)),
           "flips": int(flips.sum()),
           "control_flips": int(flipped(ctl, want).sum())}
    assert rec["flips"] == 0 or rec["control_flips"] > 0, rec
    keep = ~flips
    rec.update(_lib_gaps(got_c[:, keep], want[:, keep]))
    assert rec["max_abs"] <= LINE_TOL and \
        rec["rel_l2"] <= DENSE_REL_L2_TOL, rec
    recs.append(rec)

    secs = time.perf_counter() - t0
    for r in recs:
        log("[library] " + json.dumps(r))
    log(f"[library] phase 22 took {secs:.1f} s; ms by CUDA events on "
        f"{card}")
    return {"modules": recs, "seconds": secs, "launches": n}


# ---------------------------------------------------------------------------
# phase 23: the asynchronous dispatch
# ---------------------------------------------------------------------------

DISPATCH_EPOCHS = 2


def plain_epoch(state, train_step, loader, epoch, generator, device,
                logger):
    """The train loop without the asynchronous dispatch, as the CPU test
    `tests/test_torch_dispatch.py` writes it: each batch copied to the
    device in the step, each print window drained at once."""
    pending = []

    def flush():
        mat = torch.stack(pending).cpu().numpy() if pending else []
        pending.clear()
        for row in mat:
            scal = dict(zip(train_step.log_keys, row.tolist()))
            if not np.isfinite(scal["loss"]):
                raise FloatingPointError(scal["loss"])
            logger.update(**scal)

    for batch, _ in logger.log_every(loader.epoch(epoch), "plain",
                                     total=len(loader), before_print=flush):
        state, vec = train_step(state, batch.to(device), generator)
        pending.append(vec.clone())     # the next call overwrites `vec`
    flush()
    return state, {k: m.global_avg for k, m in logger.meters.items()}


def dispatch_epochs(cfg, cpu_model, loop: str) -> dict:
    """DISPATCH_EPOCHS epochs of `loop` ("engine": `engine.train_one_epoch`
    with prefetch and the late drain; "plain": `plain_epoch`) over phase
    7's scenes from `cpu_model`'s weights, a print window a step: the
    meters, the final weights, the step period on the device (CUDA events
    after each step, without a sync), and a profile of the last epoch."""
    from gwdepth_tpu_torch import engine
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.parallel import create_train_state, make_train_step
    from gwdepth_tpu_torch.tools.dispatch_census import profiled
    from gwdepth_tpu_torch.utils.logging import MetricLogger

    loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=TRAIN_BS,
                    seed=SEED, num_workers=4)
    holder = [create_train_state(cfg, copy.deepcopy(cpu_model).to("cuda"),
                                 steps_per_epoch=len(loader))]
    step = make_train_step(cfg)
    ends = []

    def timed_step(state, batch, gen):
        out = step(state, batch, gen)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends[-1].append(ev)
        return out

    timed_step.log_keys = step.log_keys
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    logger = MetricLogger(print_freq=1)
    dev = torch.device("cuda")
    prof = {}
    for epoch in range(DISPATCH_EPOCHS):
        ends.append([])

        def run():
            if loop == "engine":
                holder[0], _ = engine.train_one_epoch(
                    holder[0], timed_step, loader, epoch, gen, dev,
                    logger=logger)
            else:
                holder[0], _ = plain_epoch(holder[0], timed_step, loader,
                                           epoch, gen, dev, logger)

        if epoch == DISPATCH_EPOCHS - 1:
            prof = profiled(run, host=False)
        else:
            run()
    torch.cuda.synchronize()
    periods = [a.elapsed_time(b) for ep in ends for a, b in zip(ep, ep[1:])]
    steps = len(ends[-1])
    step_ms = float(np.median(periods))
    rec = {"step_ms": step_ms, "periods_ms": periods,
           "busy_ms_per_step": prof.get("device_busy_ms", float("nan"))
           / steps}
    rec["idle_share"] = max(0.0, 1.0 - rec["busy_ms_per_step"] / step_ms)
    meters = {k: (list(m.deque), m.total, m.count)
              for k, m in logger.meters.items()}
    weights = {k: v.detach().clone()
               for k, v in holder[0].model.state_dict().items()}
    return {"record": rec, "meters": meters, "weights": weights,
            "state": holder[0]}


def phase_dispatch(card: str, train: dict) -> dict:
    """Phase 23: DISPATCH_EPOCHS epochs of `engine.train_one_epoch`
    (prefetch, the late drain) and of the plain loop over phase 7's 8
    scenes, both under deterministic algorithms: the same meters and final
    weights, bit for bit; the step period, busy time and idle share of
    each. The census of synchronizing calls (the serving forward, the
    --matcher jax step and the gated step, each after a warm-up: a census
    in sync-debug mode "warn" that must count 0, then a call under mode
    "error", where a synchronizing call raises and nothing catches it)
    runs on the graphed paths in phase 24's process, with the forward's
    host-to-device copies (its input's only)."""
    from gwdepth_tpu_torch.tools import dispatch_census as dc

    t0 = time.perf_counter()
    cfg, cpu_model, _ = dc.train_setup(train["args"])
    with deterministic_algorithms(), warnings.catch_warnings(
            record=True) as caught:
        warnings.simplefilter("always")
        loops = {loop: dispatch_epochs(cfg, cpu_model, loop)
                 for loop in ("engine", "plain")}
    nondeterministic = sorted({str(w.message)[:160] for w in caught
                               if "deterministic" in str(w.message)})
    for loop in loops.values():
        del loop["state"]
    torch.cuda.empty_cache()
    e, p = loops["engine"], loops["plain"]
    same_weights = all(torch.equal(e["weights"][k], p["weights"][k])
                       for k in p["weights"])
    log(f"[dispatch] {DISPATCH_EPOCHS} epochs, engine.train_one_epoch vs "
        f"the plain loop (deterministic algorithms; without one: "
        f"{nondeterministic}): meters equal {e['meters'] == p['meters']}, "
        f"final weights equal {same_weights}; engine "
        f"{json.dumps(e['record'])}; plain {json.dumps(p['record'])} on "
        f"{card}")
    assert e["meters"] == p["meters"], (e["meters"], p["meters"])
    assert same_weights
    secs = time.perf_counter() - t0
    log(f"[dispatch] phase 23 took {secs:.1f} s")
    return {"engine": e["record"], "plain": p["record"], "seconds": secs}


# ---------------------------------------------------------------------------
# compiled entry points: CUDA graphs (phase 24)
# ---------------------------------------------------------------------------

GRAPH_RUNS = 10               # timed graphed calls a path, after warm-up
GRAPH_EAGER_RUNS = 3          # timed eager calls a path (phases 4 and 7
                              # time the eager forward and step at length)
GRAPH_STEPS = 3               # steps held bit for bit, graphed vs eager
# what the profiler counts in one call, the same graphed or eager: K1,
# K2 (forward and its backward's dx) and lap_jv by device kernel name
GRAPH_KERNELS = {
    "forward": {"k1": K1_PER_FORWARD, "k2": K2_FWD_PER_FORWARD, "lap_jv": 0},
    "eval_step": {"k1": K1_PER_FORWARD, "k2": K2_FWD_PER_FORWARD,
                  "lap_jv": 1},
    "train_f32": {"k1": K1_PER_FORWARD,
                  "k2": K2_FWD_PER_FORWARD + K2_BWD_PER_STEP, "lap_jv": 1},
    "train_bf16": {"k1": K1_PER_FORWARD,
                   "k2": K2_FWD_PER_FORWARD + K2_BWD_PER_STEP, "lap_jv": 1},
    "train_gated": {"k1": sum(GATED_TRAIN_K1.values()),
                    "k2": K2_FWD_PER_FORWARD + K2_BWD_PER_STEP,
                    "lap_jv": 1},
}
# the paths whose graphed run must equal the eager one bit for bit; the
# --bf16 and gated steps are reported
GRAPH_BIT_EQUAL = ("forward", "eval_step", "train_f32")


def _clone_tree(out):
    if isinstance(out, torch.Tensor):
        return out.detach().clone()
    if isinstance(out, dict):
        return {k: _clone_tree(v) for k, v in out.items()}
    return out


def _tree_equal(a: dict, b: dict) -> dict:
    return {k: bool(torch.equal(a[k], b[k])) for k in a}


def _graphed_vs_eager_calls(fn, n: int = 2) -> dict:
    """`fn()` (a forward or eval step) graphed n times (the capture, then
    replays) and once under `graphs.disable()`, under deterministic
    algorithms: each output tensor equal or not."""
    with deterministic_algorithms():
        got = [_clone_tree(fn()) for _ in range(n)]
        with graphs.disable():
            want = _clone_tree(fn())
    return {"equal": {k: all(_tree_equal(g, want)[k] for g in got)
                      for k in want},
            "max_abs": {k: max(float((g[k].double() - want[k].double())
                                     .abs().max()) if want[k].numel()
                               and want[k].is_floating_point() else 0.0
                               for g in got) for k in want}}


def _graph_train_path(cfg, cpu_model, batches, strict: bool,
                      eager_census: bool = True) -> dict:
    """One train state a mode from `cpu_model`'s weights, graphed and
    under `graphs.disable()`: first GRAPH_STEPS steps from one seeded
    dropout generator and one default generator state under
    deterministic algorithms (the log vectors, every parameter and both
    AdamW moments bit for bit, as counts of equal tensors; the
    generators' final states; the kernels the Python counters saw at
    each call), then the census of `dispatch_census._record` on the same
    state with the default algorithms (a key of its own, so the graphed
    step captures again): GRAPH_RUNS timed steps graphed,
    GRAPH_EAGER_RUNS eager (without `eager_census`, the graphed census
    alone); with `strict`, one more graphed step under sync-debug mode
    "error"."""
    from gwdepth_tpu_torch.parallel import create_train_state, make_train_step
    from gwdepth_tpu_torch.tools import dispatch_census as dc

    runs, records = {}, {}
    for mode in ("graphed", "eager"):
        graphed = mode == "graphed"
        state = create_train_state(
            cfg, copy.deepcopy(cpu_model).to("cuda"), steps_per_epoch=2)
        step = make_train_step(cfg)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.manual_seed(SEED)
        logs, counts = [], []
        with deterministic_algorithms():
            for i in range(GRAPH_STEPS):
                _reset_counts()
                with (contextlib.nullcontext() if graphed
                      else graphs.disable()):
                    state, vec = step(state, batches[i % len(batches)], gen)
                logs.append(vec.clone())
                counts.append({k: v for k, v in _counts().items()
                               if k != "matcher_calls"})
        # on the host: the census's peak memory counts the state alone
        runs[mode] = {
            "logs": logs, "counts": counts, "keys": list(step.log_keys),
            "params": [p.detach().cpu() for p in state.model.parameters()],
            "moments": [t.cpu() for p in state.trainable
                        for k, t in state.optimizer.state[p].items()
                        if k in ("exp_avg", "exp_avg_sq")],
            "gen": gen.get_state(), "default_gen": torch.cuda.get_rng_state()}
        holder = [state]

        def one():
            holder[0], _ = step(holder[0], batches[0], gen)

        # one warm-up with the default algorithms: the graphed step's
        # captures (with its own warm-ups)
        if graphed or eager_census:
            records[mode] = dc._record(
                one, GRAPH_RUNS if graphed else GRAPH_EAGER_RUNS,
                must_not_sync=strict and graphed, graphed=graphed,
                warmups=1)
        holder.clear()
        del state, step, one
        torch.cuda.empty_cache()
    g, e = runs["graphed"], runs["eager"]

    def n_equal(key):
        return [sum(torch.equal(a, b) for a, b in zip(g[key], e[key])),
                len(e[key])]

    def worst(key):
        return max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(g[key], e[key]))

    bit = {"losses": [[float(v) for v in vec] for vec in g["logs"]],
           "log_keys": g["keys"],
           "logs_equal": n_equal("logs"), "params_equal": n_equal("params"),
           "moments_equal": n_equal("moments"),
           "logs_max_abs": worst("logs"), "params_max_abs": worst("params"),
           "moments_max_abs": worst("moments"),
           "dropout_generator_equal": bool(torch.equal(g["gen"], e["gen"])),
           "default_generator_equal": bool(torch.equal(g["default_gen"],
                                                       e["default_gen"])),
           "graphed_counts": g["counts"], "eager_counts": e["counts"]}
    return {"bit": bit, "records": records}


def _graph_train_setup(args: list, edit=None):
    """(cfg, CPU model with seeded weights, the first GRAPH_STEPS train
    batches on the card) of `main.py` run with `args`; `edit(cfg)` may
    change the config."""
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader

    cfg = train_main.config_from_args(
        train_main.build_argparser().parse_args(args))
    if edit is not None:
        cfg = edit(cfg)
    loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=TRAIN_BS,
                    seed=SEED, num_workers=4)
    batches = [b.to("cuda") for _, (b, _) in zip(range(GRAPH_STEPS),
                                                  loader.epoch(5))]
    return cfg, build_glassrgbd(cfg, cfg.seed, device="cpu"), batches


def graphs_role(d: str) -> None:
    """Phase 24 in a process of its own (the profiler records device
    events there): every path graphed and under `graphs.disable()`,
    written to `graphs.json` in `d` with the seconds of each path."""
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.parallel import make_eval_step
    from gwdepth_tpu_torch.predict import make_forward
    from gwdepth_tpu_torch.tools import dispatch_census as dc

    spec = _dp_spec(d)
    probe()
    t0 = time.perf_counter()
    res, secs = {}, {}

    def records(call, eager_runs):
        return {mode: dc._record(call, GRAPH_RUNS if mode == "graphed"
                                 else eager_runs, graphed=mode == "graphed")
                for mode in ("graphed", "eager")}

    # the serving forward, bs1 768x1024, use_pallas
    t = time.perf_counter()
    model, img = dc.serve_model()
    x = img.to("cuda")
    valid = torch.ones(x.shape[:3], dtype=torch.bool, device="cuda")
    fwd = make_forward(model)
    with torch.no_grad():
        res["forward"] = {"bit": _graphed_vs_eager_calls(
            lambda: fwd(x, valid))}
    del fwd
    # graphed, also phase 23's census: one call under sync-debug mode
    # "error"
    res["forward"]["records"] = {
        mode: dc.serve_census(model, img, must_not_sync=mode == "graphed",
                              runs=GRAPH_RUNS if mode == "graphed"
                              else GRAPH_EAGER_RUNS,
                              graphed=mode == "graphed")
        for mode in ("graphed", "eager")}
    del model, x, valid
    torch.cuda.empty_cache()
    secs["forward"] = time.perf_counter() - t

    # the eval step, bs1 on the eval canvas, and the float32 train step
    # (--matcher jax): phase 7's config, a validation scene
    t = time.perf_counter()
    cfg, cpu_model, batches = _graph_train_setup(spec["args"])
    model = copy.deepcopy(cpu_model).to("cuda")
    vbatch = next(iter(Loader(GlassRGBDDataset(cfg, "val"), batch_size=1,
                              shuffle=False, num_workers=1).epoch(0)))[0]
    vbatch = vbatch.to("cuda")
    step = make_eval_step(cfg)
    res["eval_step"] = {"bit": _graphed_vs_eager_calls(
        lambda: step(model, vbatch))}
    res["eval_step"]["records"] = records(lambda: step(model, vbatch),
                                          GRAPH_EAGER_RUNS)
    del model, step, vbatch
    torch.cuda.empty_cache()
    secs["eval_step"] = time.perf_counter() - t

    # the train steps: float32 (--matcher jax), --bf16, gated; the first
    # and last also phase 23's census
    paths = (("train_f32", None, None),
             ("train_bf16", spec["args"] + ["--bf16"], None),
             ("train_gated", spec["args"] + GATED_TRAIN_FLAGS,
              lambda c: c.replace(group_attention_layers=GATED_CFG[
                  "group_attention_layers"])))
    for name, args, edit in paths:
        t = time.perf_counter()
        if args is not None:
            cfg, cpu_model, batches = _graph_train_setup(args, edit)
        cfg.set_matmul_precision()
        try:
            # the gated step's eager census, the costliest, is left out
            # (phase 24's time); its bit check runs eagerly all the same
            res[name] = _graph_train_path(
                cfg, cpu_model, batches, strict=name != "train_bf16",
                eager_census=name != "train_gated")
        finally:
            GWDepthConfig().set_matmul_precision()
        del batches
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t
    res["seconds"] = time.perf_counter() - t0
    res["path_seconds"] = secs
    _dp_write(d, "graphs.json", res)


def phase_graphs(card: str, train: dict, tmp: str) -> dict:
    """Phase 24: the serving forward (bs1 768x1024, `use_pallas`), the eval
    step (phase 7's config, bs1), and the float32 (`--matcher jax`),
    `--bf16` and gated train steps (bs2 704x1024) as the port runs them
    on a card, replayed CUDA graphs, against the same calls under
    `graphs.disable()`, in a process of its own (`graphs_role`): outputs
    (the forward, the eval step) and GRAPH_STEPS steps (losses,
    parameters, AdamW moments) bit for bit under deterministic
    algorithms, held for GRAPH_BIT_EQUAL and reported for the others;
    then for each mode (a train step on the state of those steps) the
    median of GRAPH_RUNS graphed or GRAPH_EAGER_RUNS eager calls after
    warm-up, the device busy time and idle share, the kernels the host
    launched and its graph launches, the synchronizing calls (0 held),
    the peak of allocated memory, and K1, K2 and lap_jv counted by the
    profiler inside one call (held to GRAPH_KERNELS, graphed and eager
    alike)."""
    t0 = time.perf_counter()
    d = os.path.join(tmp, "graphs")
    os.makedirs(d)
    _dp_write(d, "spec.json", {"args": train["args"]})
    _run_role("graphs", d, timeout=900)
    with open(os.path.join(d, "graphs.json")) as f:
        res = json.load(f)
    for name, want in GRAPH_KERNELS.items():
        r = res[name]
        bit = r["bit"]
        if "equal" in bit:
            equal = all(bit["equal"].values())
        else:
            equal = all(a == b for a, b in (bit["logs_equal"],
                                            bit["params_equal"],
                                            bit["moments_equal"]))
        r["bit_equal"] = equal
        for mode, rec in r["records"].items():
            keep = {k: rec.get(k) for k in (
                "median_ms", "device_busy_ms", "device_idle_share",
                "device_kernels", "host_launches", "graph_launches",
                "memcpy_calls", "h2d_copies", "kernels_by_name",
                "peak_bytes", "stream_syncs")}
            keep["sync_calls"] = rec["sync_sites"]["total"]
            log(f"[graphs] {name} {mode}: {json.dumps(keep)} on {card}")
            assert rec["sync_sites"]["total"] == 0, (name, mode,
                                                     rec["sync_sites"])
            if "kernels_by_name" in rec:
                assert rec["kernels_by_name"] == want, (name, mode, rec[
                    "kernels_by_name"], want)
            if mode == "graphed" and "graph_launches" in rec:
                assert rec["graph_launches"] == 1, (name, rec)
            if name == "forward" and mode == "graphed":
                # the profiled call copies its input in: the only copy
                assert not rec.get("device_busy_ms") or \
                    rec["h2d_copies"] == 1, rec
        log(f"[graphs] {name} graphed vs graphs.disable(), deterministic "
            f"algorithms: bit-equal {equal}; {json.dumps(bit)}")
        if name in GRAPH_BIT_EQUAL:
            assert equal, (name, bit)
        if name.startswith("train"):
            # a replay counts what the graph holds, once a step
            per_step = dict(STEP_COUNTS, k1=GRAPH_KERNELS[name]["k1"])
            assert bit["graphed_counts"][0] == _first_call(per_step), bit
            for c in bit["graphed_counts"][1:] + bit["eager_counts"]:
                assert c == per_step, (name, c, per_step)
    secs = time.perf_counter() - t0
    log(f"[graphs] phase 24 took {secs:.1f} s ({res['seconds']:.1f} s in "
        f"its process; by path {json.dumps(res['path_seconds'])})")
    res["wall_seconds"] = secs
    return res


def _phase_clock(t_start: float):
    """`mark(name)` logs the wall time since the last mark (or `t_start`)
    and since `t_start`: where the smoke's time limit goes."""
    last = [t_start]

    def mark(name: str) -> None:
        now = time.perf_counter()
        log(f"[time] {name}: {now - last[0]:.1f} s, {now - t_start:.1f} s "
            f"in all")
        last[0] = now

    return mark


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dp-role",
                   choices=("main", "pair", "tp-main", "tp-steps", "graphs"),
                   help="phase 18's, 19's and 24's own processes (started "
                        "by the smoke)")
    p.add_argument("--dp-dir")
    args = p.parse_args(argv)
    if args.dp_role:
        {"main": dp_main_role, "pair": dp_pair_role,
         "tp-main": tp_main_role, "tp-steps": tp_steps_role,
         "graphs": graphs_role}[args.dp_role](args.dp_dir)
        return
    t_start = time.perf_counter()
    mark = _phase_clock(t_start)
    smi = probe()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    phase_build()
    mark("build")
    copy_kernels = copy_kernel_names()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    check_k3_one_kernel(np.random.default_rng(SEED + 7))
    with torch.no_grad():
        k1_sites = phase_k1(rng, dev)
        k2 = phase_k2(rng, dev)
    mark("kernels")
    matcher = phase_matcher(np.random.default_rng(SEED + 20), dev, card)
    mark("matcher")
    k1 = k1_sites[tuple(K1_SITES[0])]
    k1_n, k2_n, k2_links, k34_n = phase_model(card)
    mark("model")
    phase_serve()
    mark("serve")
    depth_only = phase_depth_only(card)
    mark("depth_only")
    gated = phase_gated(card)
    mark("gated")
    k2_train, k1_train, k1_gated_bwd = phase_backward(rng, dev)
    mark("backward")
    with tempfile.TemporaryDirectory() as tmp:
        runs, train = phase_train(card, tmp)
        mark("train")
        loader = phase_loader(card, train)
        mark("loader")
        evals = phase_eval_outputs(train)
        mark("eval_outputs")
        line_only = phase_line_only(train)
        mark("line_only")
        gated_train = phase_gated_train(card, train)
        mark("gated_train")
        coco = phase_coco_lines(train)
        mark("coco_lines")
        exported = phase_export(card, tmp)
        mark("export")
        bf16 = phase_bf16(card, train)
        mark("bf16")
        dp = phase_data_parallel(card, train, tmp)
        mark("data_parallel")
        tp = phase_tensor_parallel(card, train, tmp)
        mark("tensor_parallel")
        phase_train_card_vs_cpu()
        mark("train_card_vs_cpu")
        win = phase_window_attention(rng)
        mark("window_attention")
        library = phase_library(card)
        mark("library")
        dispatch = phase_dispatch(card, train)
        mark("dispatch")
        graphed = phase_graphs(card, train, tmp)
        mark("graphs")

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

    def gated_train_k1(field):
        """Sum over the gated train step's K1 planes of forward launches
        (without --remat) x `field` of phase 3."""
        return sum(n * k1_sites[shape][field]
                   for shape, n in GATED_TRAIN_K1.items())

    def gated_train_k1_bwd(field):
        """The same for the backward's `field` of phase 6."""
        return sum(n * k1_gated_bwd[shape]["bwd"][field]
                   for shape, n in GATED_TRAIN_K1.items())

    g_runs = gated_train["runs"]

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
         # the gated train step (phase 14): forward launches a step,
         # without and with --remat, the per-plane times of phases 3 and 6
         # x the launches, and what the step's own run measured
         "train_gated_launches_per_step": g_runs[False]["per_step"]["k1"],
         "train_gated_remat_launches_per_step":
             g_runs[True]["per_step"]["k1"],
         "train_gated_ms": gated_train_k1("kernel_ms"),
         "train_gated_device_ms": gated_train_k1("device_ms"),
         "train_gated_plain_ms": gated_train_k1("plain_ms"),
         "train_gated_library_ms": gated_train_k1("library_ms"),
         "train_gated_library_device_ms":
             gated_train_k1("library_device_ms"),
         "train_gated_bound_ms": gated_train_k1("bound_ms"),
         "train_gated_bound_by": bound_by(gated_train_k1),
         "train_gated_profile_ms": g_runs[False]["profile"].get("k1_ms"),
         "train_gated_backward_max_scaled_err": max(
             r["bwd"]["max_scaled_err"] for r in k1_gated_bwd.values()),
         "train_gated_backward_ms": gated_train_k1_bwd("backward_ms"),
         "train_gated_backward_plain_ms": gated_train_k1_bwd("plain_ms"),
         "train_gated_backward_library_ms":
             gated_train_k1_bwd("library_ms"),
         "train_gated_backward_bound_ms": gated_train_k1_bwd("bound_ms"),
         "train_gated_backward_step_ms": g_runs[False]["k1_backward_ms"],
         "train_gated_backward_peak_bytes": max(
             r["bwd"]["peak_bytes"] for r in k1_gated_bwd.values()),
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
         "train_library_device_ms": train_fwd("library_device_ms"),
         # the gated train step runs the shipped step's 25 links (its
         # point heads do not change), so the per-link times are phase 6's;
         # the profile's is the step's own
         "train_gated_launches_per_step": g_runs[False]["per_step"]["k2"],
         "train_gated_ms": train_fwd("kernel_ms"),
         "train_gated_device_ms": train_fwd("device_ms"),
         "train_gated_profile_ms": g_runs[False]["profile"].get("k2_ms"),
         "train_gated_backward_launches_per_step":
             g_runs[False]["per_step"]["k2_bwd"],
         "train_gated_backward_ms": train_bwd("kernel_ms"),
         "train_gated_backward_device_ms": train_bwd("kernel_device_ms")},
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
        {"name": "lap_jv", "route": "cuda",
         "source": "gwdepth_tpu_torch/csrc/lap_jv.cu",
         "replaces": "gwdepth_tpu/ops/lap.py:105",
         "launches": run["lap_jv"], "launches_per_step": 1,
         "max_abs_err": matcher["max_abs_err"],
         "ms": matcher["kernel_ms"], "plain_ms": matcher["plain_ms"],
         "bound_ms": matcher["bound_ms"], "bound_by": matcher["bound_by"],
         "library_ms": None, "device_ms": matcher["device_ms"],
         "scipy_ms": matcher["scipy_ms"],
         "scipy_solve_ms": matcher["scipy_solve_ms"],
         "scipy_copy_ms": matcher["scipy_copy_ms"],
         "dijkstra_steps": matcher["dijkstra_steps"],
         "dijkstra_steps_max": matcher["dijkstra_steps_max"],
         "device_us_per_serial_step": matcher["device_us_per_serial_step"],
         "criterion_launches": matcher["criterion_launches"],
         "train_step_ms": {k: train["matchers"][k]["step_ms"]
                           for k in MATCHER_ORDER},
         "train_busy_ms": {k: train["matchers"][k]["profile"].get(
             "device_busy_ms") for k in MATCHER_ORDER},
         "train_idle_share": {k: train["matchers"][k]["profile"].get(
             "device_idle_share") for k in MATCHER_ORDER},
         "train_loss_rel_gap": train["matchers"]["loss_rel_gap"]},
    ]
    # launches on this slice's paths, each counted from 0 over its run
    count_key = {"ref_attn_diffusion": "k1", "conv3x3_ln_act": "k2",
                 "conv3x3_ln_act_backward": "k2_bwd", "window_msa": "k3",
                 "layout_fence": "k4", "lap_jv": "lap_jv"}
    for entry in kernels:
        key = count_key[entry["name"]]
        entry["depth_only_launches"] = depth_only["launches"][key]
        entry["eval_outputs_launches"] = evals["launches"][key]
        entry["line_only_launches"] = line_only["launches"][key]
        entry["gated_launches"] = gated["launches"][key]
        entry["no_sampling_launches"] = gated["no_sampling_launches"][key]
        entry["train_gated_run_launches"] = g_runs[False]["launches"][key]
        entry["train_gated_remat_run_launches"] = \
            g_runs[True]["launches"][key]
        entry["coco_lines_launches"] = coco["launches"][key]
        entry["exported_launches"] = exported["launches"][key]
        entry["bf16_train_run_launches"] = bf16["launches"][key]
        entry["bf16_train_launches_per_step"] = bf16["per_step"][key]
        entry["dp_nccl_run_launches"] = dp["nccl"]["launches"][key]
        entry["dp_nccl_launches_per_step"] = dp["nccl"]["per_step"][key]
        entry["dp_pair_launches_per_step_per_rank"] = \
            dp["pair"]["launches_per_step_per_rank"][key]
        entry["tp_mesh1_run_launches"] = tp["mesh1"]["launches"][key]
        entry["tp_mesh1_launches_per_step"] = tp["mesh1"]["per_step"][key]
        entry["tp_pair_launches_per_step_per_rank"] = \
            tp["pair"]["launches_per_step_per_rank"][key]
        # phase 24: device kernels of this name the profiler saw in one
        # replay of each graph (K2's forward and backward together)
        if key in ("k1", "k2", "lap_jv"):
            entry["graph_replay_kernels"] = {
                path: graphed[path]["records"]["graphed"].get(
                    "kernels_by_name", {}).get(key)
                for path in GRAPH_KERNELS}
    log("[kernels] K1 and K2: launches, ms, plain_ms, bound_ms and "
        "library_ms per 768x1024 bs1 serving forward (launches on that path "
        "x the per-call medians above); train_* per train step at bs2 "
        "704x1024, train_launches over the first main.main train run (4 "
        "steps, 2 eval forwards, replayed, and the 2 eager warm-ups before "
        "each of the two captures). K2 backward: launches over that run, the "
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
        f"train step median {train['step_ms']:.3f} ms (--matcher jax), "
        f"host matcher {train['matcher_ms']:.3f} ms (--matcher scipy). "
        "lap_jv: launches over the first main.main train run (1 a step "
        "and an eval forward), ms by events and device_ms in a CUDA graph "
        "per call at 6 layers x bs2 x 100 queries x 96 slots (phase 20), "
        "plain_ms the plain version on the host, scipy_ms the scipy path "
        "(copy and host solve), bound_ms the cost rows read; "
        "train_step_ms / busy / idle with each --matcher, and jax_sync "
        "(the kernel, then a sync where the scipy path's copy waits) "
        "(phase 7); "
        "library_ms null: no PyTorch call solves an assignment. "
        "K3 and K4: launches over phase 9's "
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
        "device-memory schedule). train_gated_*: the gated train step "
        "(phase 14, GATED_CFG with the plane-normal loss, bs2 704x1024): "
        "K1's = its planes' launches a step without --remat x the per-call "
        "medians of phase 3 (forward) and phase 6 (backward: the "
        "diffusion_torch recompute and autograd on the kernel's saved "
        "inputs; _peak_bytes its largest peak above the kept graphs), "
        "train_gated_backward_step_ms = K1's backwards of one step by "
        "events, *_profile_ms = the kernel's device time in the step's "
        "profile; K2's = phase 6's train links (the same 25). "
        "train_gated_run_launches / _remat_run_launches: main.main's 4 "
        "steps and 2 eval forwards without / with --remat; "
        "coco_lines_launches: the ResNet-101 COCO-lines run (phase 15); "
        "exported_launches: the exported forward loaded in a fresh "
        "process, over phase 5's 3 images (phase 16); "
        "bf16_train_run_launches / _per_step: main.main --bf16 "
        "--use_pallas, 4 steps and 2 eval forwards / one timed step "
        "(phase 17). dp_nccl_run_launches / _per_step: main.main --mesh -1 "
        "under torchrun over NCCL, 4 steps and 2 eval forwards / one "
        "timed step; dp_pair_launches_per_step_per_rank: a rank's step of "
        "the two gloo ranks on the card (phase 18). tp_mesh1_run_launches / "
        "_per_step: main.main --mesh 1,1 under torchrun over NCCL, 4 steps "
        "and 2 eval forwards / one more step; "
        "tp_pair_launches_per_step_per_rank: a rank's step of the (1, 2) "
        "mesh over gloo on the card, with the split weights gathered whole "
        "(phase 19).")
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
    for remat, r in g_runs.items():
        p = r["profile"]
        busy = p.get("device_busy_ms", float("nan"))
        log(f"[gated-train{'-remat' if remat else ''}] step median "
            f"{r['step_ms']:.3f} ms, device busy {busy:.3f} ms, idle share "
            f"{p.get('device_idle_share', float('nan')):.4f}, "
            f"{p.get('device_kernels')} kernels, peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, launches a step "
            f"{r['per_step']}, K1 forward {p.get('k1_ms', float('nan')):.3f}"
            f" ms in {p.get('k1_kernels')} kernels, K1 backward "
            f"{r['k1_backward_ms']:.3f} ms by events (share "
            f"{r['k1_backward_ms'] / busy:.4f}), loss_plane "
            f"{r['loss_plane']} on {card}")
    log(f"[gated-train] remat vs no remat (deterministic algorithms): "
        f"losses {gated_train['remat_loss_rel']:.3g} relative, gradients "
        f"{json.dumps(gated_train['remat_grads'])}, bit-equal tensors "
        f"{gated_train['remat_bit_equal']}; default algorithms "
        f"{json.dumps(gated_train['default_algorithms'])}")
    log(f"[coco-lines] ResNet-101 line-only: {coco['frozen_loaded']} "
        f"tensors from --frozen_weights, step times "
        f"{json.dumps(coco['step_times'])} ms, train run "
        f"{coco['seconds']:.1f} s, eval {coco['eval_seconds']:.1f} s")
    log(f"[export] exported forward median {exported['exported_ms']:.3f} "
        f"ms (busy {exported['exported_busy_ms']}) in its own process, "
        f"{exported['program_here_ms']:.3f} ms (busy "
        f"{exported['program_here_busy_ms']}) beside eager "
        f"{exported['eager_ms']:.3f} ms (busy {exported['eager_busy_ms']}); "
        f"export {exported['export_s']:.1f} s, load {exported['load_s']:.1f}"
        f" s, {exported['artifact_mb']:.1f} MB on {card}")
    log(f"[bf16] step median {bf16['step_ms']:.3f} ms (float32 "
        f"{bf16['f32_step_ms']:.3f}), busy {bf16['busy_ms']} (float32 "
        f"{bf16['f32_busy_ms']}), idle {bf16['idle_share']} (float32 "
        f"{bf16['f32_idle_share']}), peak {bf16['peak_bytes'] / 2**30:.2f} "
        f"GiB (float32 {bf16['f32_peak_bytes'] / 2**30:.2f}); forward "
        f"{bf16['forward_ms']:.3f} ms, busy {bf16['forward_busy_ms']}; "
        f"first loss {json.dumps(bf16['first_loss'])} on {card}")
    log(f"[library] {len(library['modules'])} library modules and "
        f"functions held against the CPU in {library['seconds']:.1f} s, "
        f"launches {json.dumps(library['launches'])}; ms: " + json.dumps(
            {r["name"]: r["ms"] for r in library["modules"]}) + f" on {card}")
    for name, path in (("forward", "forward"), ("train_step", "train_f32"),
                       ("gated_step", "train_gated")):
        rec = graphed[path]["records"]["graphed"]
        log(f"[dispatch] {name} (graphed, phase 24's process): "
            f"synchronizing calls {rec['sync_sites']['total']} (none under "
            f"sync-debug mode 'error'), device busy "
            f"{rec.get('device_busy_ms')} ms, host cudaStreamSynchronize "
            f"{rec.get('stream_sync_ms')} ms, host-to-device copies "
            f"{rec.get('h2d_copies')} on {card}")
    for loop in ("engine", "plain"):
        r = dispatch[loop]
        log(f"[dispatch] {loop} loop: step period median {r['step_ms']:.3f}"
            f" ms, busy {r['busy_ms_per_step']:.3f} ms a step, idle share "
            f"{r['idle_share']:.4f} on {card}")
    for name in GRAPH_KERNELS:
        recs = graphed[name]["records"]
        g, e = recs["graphed"], recs.get("eager", {})

        def both(key, scale=1.0):
            return " / ".join("not measured" if r.get(key) is None else
                              f"{r[key] / scale:.3f}" for r in (g, e))

        log(f"[graphs] {name}: median {both('median_ms')} ms graphed / "
            f"eager, busy {both('device_busy_ms')} ms, idle "
            f"{both('device_idle_share')}, host kernel launches "
            f"{g.get('host_launches')} / {e.get('host_launches')}, graph "
            f"launches {g.get('graph_launches')}, peak "
            f"{both('peak_bytes', 2**30)} GiB, bit-equal "
            f"{graphed[name]['bit_equal']} on {card}")
    log(f"[total] chip_smoke wall time "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
