"""A/B of two builds of K2 on one card, in one process.

`csrc/conv3x3_ln_act.cu` against another source with the same C
interface (an earlier revision, say `git show REV:gwdepth_tpu_torch/csrc/
conv3x3_ln_act.cu > /tmp/k2_old.cu`), at every K2 link of the serving
forward (bs1 768x1024) and of the train step (bs2 704x1024), the forward
links and the dx shapes of their backward:

    python -m gwdepth_tpu_torch.tools.k2_ab /tmp/k2_old.cu

Per link it prints one JSON line: both builds' largest difference (the
two must agree within the kernel's tolerance against its plain version),
this build's against the plain version, and device times in us (10 calls
captured in a CUDA graph, median replay; the other build, this one, this
one, the other, so drift shows). Times are only comparable within one
run: write the card's name and power limit beside them.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from gwdepth_tpu_torch import _build
from gwdepth_tpu_torch.ops import fused_conv as fc

# (B, H, W, Ci, Co, act, LN) of the main path: the 1/8 and 1/4 trunks,
# the 1/8 head's last0, and the dx convs of their backward (no LN; the
# 300-channel dx in two 150-channel pieces)
SCALES = ((1, (96, 128), (192, 256)), (2, (88, 128), (176, 256)))
LINKS = [(B, *hw8, ci, co, act, ln) if s == 8 else (B, *hw4, ci, co, act, ln)
         for B, hw8, hw4 in SCALES
         for s, ci, co, act, ln in (
             (8, 30, 30, "gelu", True), (8, 30, 60, "gelu", True),
             (8, 60, 60, "gelu", True), (8, 60, 60, None, True),
             (8, 300, 120, "gelu", True), (4, 80, 80, "gelu", True),
             (4, 80, 160, "gelu", True), (4, 160, 160, "gelu", True),
             (4, 160, 160, None, True), (8, 60, 30, None, False),
             (8, 120, 150, None, False), (4, 160, 80, None, False))]


def build_other(src: Path) -> ctypes.CDLL:
    """Compile `src` with the kernels' own flags and bind it as `_lib`."""
    data = src.read_bytes()
    h = hashlib.sha256(data + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"libk2_other-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
    return fc.bind(ctypes.CDLL(str(out)))


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """Route the K2 wrapper's launches through `lib` inside the block."""
    keep = _build._loaded.get("conv3x3_ln_act")
    _build._loaded["conv3x3_ln_act"] = lib
    try:
        yield
    finally:
        _build._loaded["conv3x3_ln_act"] = keep


def device_us(fn, reps: int = 10) -> float:
    """Median replay time of `reps` calls captured in one CUDA graph, per
    call, in us."""
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
    times = []
    for _ in range(12):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return 1e3 * float(np.median(times[2:])) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other K2 source (.cu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_ab: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build(["conv3x3_ln_act"])
    this, other = fc._lib(), build_other(args.other)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    for B, H, W, ci, co, act, ln in LINKS:
        x = torch.from_numpy(rng.normal(size=(B, H, W, ci))
                             .astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.normal(size=(3, 3, ci, co))
                              / np.sqrt(9 * ci)).astype(np.float32)).to(dev)
        g = torch.ones(co, device=dev) if ln else None
        b = torch.zeros(co, device=dev) if ln else None

        def run():
            return fc._launch(x, w, g, b, None, act, True)

        with using(other):
            y_other = run()
            t_other = [device_us(run)]
        with using(this):
            y_this = run()
            t_this = [device_us(run), device_us(run)]
        with using(other):
            t_other.append(device_us(run))
        want = fc.conv3x3_ln_act_plain(x, w, g, b, None, act)
        flops = 2 * B * H * W * ci * co * 9
        print(json.dumps({
            "shape": [B, H, W, ci, co], "act": act, "ln": ln,
            "tile": fc.kernel_tile(B, H, W, co),
            "this_vs_other": float((y_this - y_other).abs().max()),
            "this_vs_plain": float((y_this - want).abs().max()),
            "other_us": t_other, "this_us": t_this,
            "bound_us": 1e6 * max(flops / 989e12,
                                  4 * B * H * W * (ci + co) / 3.35e12)}),
            flush=True)


if __name__ == "__main__":
    main()
