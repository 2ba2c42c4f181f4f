"""K3's device times at the window sites, and an A/B of two builds of it.

Times `csrc/window_msa.cu` at each (shape, mask) of the window sites of
the serving forward (bs1 768x1024) and of the class layers at bs2
704x1024, on seeded q, k, v read in place from a (W, N, 3C) qkv product as
the fused entry reads them, beside memory-efficient SDPA with a float
mask and the bound; with source paths, also other builds with the same
C interface, in one process:

    python -m gwdepth_tpu_torch.tools.k3_ab [/tmp/k3_other.cu ...]

Per site one JSON line: this build's launch plan, the largest difference
from the plain version (each build; the kernel's tolerance is 1e-4),
device times in us (10 calls captured in a CUDA graph, median replay, per
call: the others, this build twice, the others in reverse, so drift
shows; each build by its file name), this build's time on a
cold L2 (a 128 MB write before each call), SDPA's, the bound at 3.35 TB/s
and this build's share of it. Times are only comparable within one run:
write the card's name and power limit beside them.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gwdepth_tpu_torch import _build
from gwdepth_tpu_torch.ops import window_msa as wm

# (B, nW, H, N, hd, mask) of the window sites: the serving forward's 1/32
# ref layer and 1/16, 1/8, 1/4 class layers, then the class layers at bs2
SITES = [(1, 20, 16, 49, 32, False), (1, 20, 16, 49, 32, True),
         (1, 70, 16, 49, 16, False), (1, 70, 16, 49, 16, True),
         (1, 266, 16, 49, 8, False), (1, 266, 16, 49, 8, True),
         (1, 1036, 16, 49, 4, False),
         (2, 70, 16, 49, 16, False), (2, 70, 16, 49, 16, True),
         (2, 247, 16, 49, 8, False), (2, 247, 16, 49, 8, True),
         (2, 962, 16, 49, 4, False)]
PEAK_BYTES_S = 3.35e12
FLUSH_BYTES = 128 << 20


def build_other(src: Path) -> ctypes.CDLL:
    """Compile `src` with the kernels' own flags."""
    data = src.read_bytes()
    h = hashlib.sha256(data + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"libk3_other-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        print(proc.stdout + proc.stderr, flush=True)
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def using(lib):
    """Route K3's launches (and its occupancy query, so the plan follows the
    build's registers) through `lib` inside the block."""
    keep = _build._loaded.get("window_msa")
    if lib is not None:
        _build._loaded["window_msa"] = lib
    wm._blocks_per_sm.cache_clear()
    wm.launch_plan.cache_clear()
    try:
        yield
    finally:
        _build._loaded["window_msa"] = keep
        wm._blocks_per_sm.cache_clear()
        wm.launch_plan.cache_clear()


def device_us(fn, reps: int = 10) -> float:
    """Median replay time of `reps` calls captured in one CUDA graph, per
    call, in us."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(10):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) * 1e3 / reps)
    return float(np.median(times))


def cold_us(fn, reps: int = 10) -> float:
    """Median time of one call after a write of FLUSH_BYTES (the L2 holds
    none of its inputs), a spin keeping the card busy while the host queues
    the call, CUDA events around the call alone, in us."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    times = []
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    return float(np.median(times))


def site_inputs(rng, B, nW, H, N, hd, with_mask):
    """q, k, v as views of one (B * nW, N, 3C) product, bias, mask (20 %
    of the entries at -100), on the card."""
    C = H * hd

    def card(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to("cuda")

    qkv = card(rng.normal(size=(B * nW, N, 3 * C)))
    q, k, v = wm._split_qkv(qkv, B, H)
    bias = card(rng.normal(size=(H, N, N)))
    mask = (card(np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0))
            if with_mask else None)
    return q, k, v, bias, mask


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", type=Path,
                    help="other K3 sources with the same C interface")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    others = [(p.stem, build_other(p)) for p in args.others]
    index = torch.cuda.current_device()
    rng = np.random.default_rng(0)
    for B, nW, H, N, hd, with_mask in SITES:
        q, k, v, bias, mask = site_inputs(rng, B, nW, H, N, hd, with_mask)
        scale = hd ** -0.5
        want = wm.window_msa_plain(q * scale, k, v, bias, mask)

        def call():
            return torch.ops.gwdepth.window_msa(q, k, v, bias, mask, scale)

        with using(None):
            per_sm = wm._blocks_per_sm(index, N, hd, wm.smem_bytes(
                N, wm.head_pad(hd), with_mask, 2))
            plan = wm.launch_plan(B, nW, H, N, hd, with_mask, wm._sms(index),
                                  per_sm)
        rec = {"site": [B, nW, H, N, hd], "mask": with_mask,
               "blocks_per_sm": per_sm, "grid": plan.grid,
               "windows": plan.windows, "stages": plan.stages,
               "smem": plan.smem}
        for name, lib in [("this", None)] + others:
            with using(lib):
                rec[f"{name}_max_err"] = float((call() - want).abs().max())
        for name, lib in [*others, ("this", None), ("this", None),
                          *others[::-1]]:
            with using(lib):
                rec.setdefault(f"{name}_us", []).append(device_us(call))
        rec["this_cold_us"] = cold_us(call)
        qs, ks, vs = (t.reshape(B * nW, H, N, hd).contiguous()
                      for t in (q * scale, k, v))
        am = bias[None] if mask is None else bias[None] + mask[:, None]
        am = am.expand(B, nW, H, N, N).reshape(B * nW, H, N, N).contiguous()
        rec["sdpa_us"] = device_us(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=am, scale=1.0))
        nbytes = 4 * (4 * q.numel() + H * N * N
                      + (nW * N * N if with_mask else 0))
        rec["bound_us"] = nbytes / PEAK_BYTES_S * 1e6
        rec["bound_frac"] = rec["bound_us"] / min(rec["this_us"])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
