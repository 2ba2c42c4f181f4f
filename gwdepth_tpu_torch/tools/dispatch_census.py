"""Where the serving forward and the train step wait for the card.

    python gwdepth_tpu_torch/tools/dispatch_census.py [--root DIR]

On one NVIDIA card, at the shipped `GWDepthConfig()` with `use_pallas`
and seeded weights, in full float32 (no TF32), it measures

- the bs1 768x1024 serving forward (no grad; `predict.make_forward`) and
- one bs2 704x1024 train step (`--matcher jax`, dropout 0.1, the first
  batch of two synthetic 720x1280 scenes, already on the card),

each as the port runs it on a card, a replayed CUDA graph
(`graphs.compiled`: `forward`, `train_step`), and eagerly under
`graphs.disable()` (`forward_eager`, `train_step_eager`), each after 2
warm-up calls (the graphed path's first call captures): the
synchronizing calls of one call that PyTorch's sync-debug mode "warn"
reports, by the Python line that made them; one call under
torch.profiler (device busy time, device kernels and K1's, K2's and
lap_jv's among them, host-to-device copies, and on the host the kernel
launches it issued, its graph launches, its copy calls and its time in
`cudaStreamSynchronize`); the median wall time of 10 forwards or 6
steps, host clock to `torch.cuda.synchronize()`, whence the device's
idle share; and the peak of allocated device memory over the path's
calls. The forward's profiled call copies its input from pinned memory
inside it, so its host-to-device copies include the input's. Prints one
JSON line.

`--root DIR` puts DIR first on `sys.path` before the package is
imported, so that another checkout (a parent commit unpacked with `git
archive`) is measured by this same code in the same call; its kernels
build under DIR. `--forward` takes the graphed forward alone, without
its median, and runs it once more under sync-debug mode "error", in a
process of its own, where the profiler still records copies
(`chip_smoke.py` phase 24 runs the same census in its own process).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import tempfile
import time
import warnings

FORWARD_HW = (768, 1024)
FORWARD_RUNS, STEP_RUNS, WARMUPS = 10, 6, 2
SEED = 0
# device kernel names of K1, K2 (its forward and its backward's dx) and
# the JV matcher
KERNEL_NAMES = {"k1": ("diffusion_kernel", "diffusion_tiled_kernel"),
                "k2": ("conv3x3_ln_act_kernel",), "lap_jv": ("lap_jv_kernel",)}
# the host's kernel launches among the CUDA API calls the profiler records
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def sync_sites(fn) -> dict:
    """The synchronizing calls of `fn()` that sync-debug mode "warn"
    reports, counted by caller: the total, the 12 commonest and the
    distinct messages. The mode is switched on and off once before, with
    nothing run, since the first switch of a process warned once by
    itself (attributed to `torch/cuda/__init__.py`)."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                                for w in syncs)
    return {"total": sum(sites.values()), "top": sites.most_common(12),
            "messages": sorted({str(w.message)[:120] for w in syncs})}


def profiled(fn, host: bool = True) -> dict:
    """One call of `fn` under torch.profiler: the union of its device
    intervals, its device kernels and host-to-device copies, and (with
    `host`) the host's time in the CUDA runtime's synchronizing calls.
    Empty if the profiler saw no device events. Without `host` only
    device activity is recorded, which costs far less to collect over
    many steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host else [])) as prof:
        fn()
        torch.cuda.synchronize()
    # the raw events: building the profiler's event tree over a few train
    # steps (tens of thousands of kernels) took seconds
    events = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in events if e.device_type() == DeviceType.CUDA)
    if not spans:
        return {}
    busy_ns, end = 0, -1
    for s, e, _ in spans:
        if e > end:
            busy_ns += e - max(s, end)
            end = e
    api = collections.defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.device_type() == DeviceType.CPU and ev.name().startswith("cu"):
            api[ev.name()][0] += ev.duration_ns() / 1e6
            api[ev.name()][1] += 1
    rec = {"device_busy_ms": busy_ns / 1e6,
           "device_kernels": sum("Memcpy" not in n and "Memset" not in n
                                 for *_, n in spans),
           "h2d_copies": sum("HtoD" in n for *_, n in spans),
           "kernels_by_name": {k: sum(any(m in n for m in names)
                                      for *_, n in spans)
                               for k, names in KERNEL_NAMES.items()}}
    if host:
        rec.update(stream_sync_ms=api["cudaStreamSynchronize"][0],
                   stream_syncs=api["cudaStreamSynchronize"][1],
                   memcpy_calls=api["cudaMemcpyAsync"][1]
                   + api["cudaMemcpy"][1],
                   host_launches=sum(api[n][1] for n in LAUNCH_CALLS),
                   graph_launches=api["cudaGraphLaunch"][1])
    return rec


def median_ms(fn, runs: int) -> tuple:
    """(median, all) wall ms of `runs` calls, each synchronized."""
    import numpy as np
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def strict(fn) -> None:
    """`fn()` under sync-debug mode "error": a synchronizing call raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def no_sync_after_warmup(fn) -> dict:
    """One warm-up call of `fn`, the sync census of the next, and one
    more under `strict`: the census (total 0 where `strict` passed)."""
    fn()
    sites = sync_sites(fn)
    strict(fn)
    return sites


def _record(fn, runs: int, profiled_fn=None, must_not_sync=False,
            graphed: bool = True, warmups: int = WARMUPS) -> dict:
    """`warmups` calls, the sync census, a profiled call and (with `runs`)
    the median; with `must_not_sync`, one more call under `strict`. Without
    `graphed` every call runs under `graphs.disable()`. The peak of
    allocated memory spans them all."""
    import torch

    from gwdepth_tpu_torch import graphs

    def mode():
        return contextlib.nullcontext() if graphed else graphs.disable()

    def call():
        with mode():
            fn()

    def call_profiled():
        with mode():
            (profiled_fn or fn)()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warmups):
        call()
    rec = {"graphed": graphed, "sync_sites": sync_sites(call)}
    if must_not_sync:
        strict(call)
    rec.update(profiled(call_profiled))
    if runs:
        rec["median_ms"], rec["times_ms"] = median_ms(call, runs)
        if "device_busy_ms" in rec:
            rec["device_idle_share"] = max(
                0.0, 1.0 - rec["device_busy_ms"] / rec["median_ms"])
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    return rec


def serve_model():
    """The shipped serving model on the card and a seeded bs1 input in
    pinned host memory."""
    import numpy as np
    import torch

    from gwdepth_tpu_torch.config import GWDepthConfig
    from gwdepth_tpu_torch.models import build_glassrgbd

    cfg = GWDepthConfig(dropout=0.0, use_pallas=True)
    model = build_glassrgbd(cfg, SEED, device="cpu").to("cuda").eval()
    img = np.random.default_rng(SEED + 1).normal(
        size=(1, *FORWARD_HW, 3)).astype(np.float32)
    return model, torch.from_numpy(img).pin_memory()


def serve_census(model, img, must_not_sync=False,
                 runs: int = FORWARD_RUNS, graphed: bool = True) -> dict:
    """The forward's record (`_record`) through `predict.make_forward`;
    the profiled call copies `img` to the card inside it."""
    import torch

    from gwdepth_tpu_torch.predict import make_forward

    forward = make_forward(model)
    x = img.to("cuda")
    valid = torch.ones(x.shape[:3], dtype=torch.bool, device="cuda")

    def fwd():
        with torch.no_grad():
            forward(x, valid)

    def fwd_with_input():
        with torch.no_grad():
            forward(img.to("cuda", non_blocking=True), valid)

    return _record(fwd, runs, fwd_with_input, must_not_sync, graphed)


def train_args(root: str, out: str) -> list:
    """`main.py`'s flags for the shipped config on the scenes in `root`
    (`tools.synthetic.generate_dataset`), as `chip_smoke.py` phase 7."""
    return ["--device", "cuda", "--use_pallas", "--with_line",
            "--with_dense", "--with_center", "--num_workers", "4",
            "--output_dir", out, "--data_path", f"{root}/rgb",
            "--gt_depth_path", f"{root}/depth", "--gt_seg_path",
            f"{root}/seg", "--gt_line_path", f"{root}/lines",
            "--filenames_file_train", f"{root}/train.txt",
            "--filenames_file_eval", f"{root}/val.txt"]


def train_setup(args: list, cfg_edit=None):
    """(cfg, CPU model with seeded weights, first train batch on the card)
    of `main.py` run with `args`; `cfg_edit(cfg)` may change the config."""
    from gwdepth_tpu_torch import main as train_main
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.models import build_glassrgbd

    cfg = train_main.config_from_args(
        train_main.build_argparser().parse_args(args))
    if cfg_edit is not None:
        cfg = cfg_edit(cfg)
    model = build_glassrgbd(cfg, cfg.seed, device="cpu")
    loader = Loader(GlassRGBDDataset(cfg, "train"), batch_size=cfg.batch_size,
                    seed=SEED, num_workers=2)
    batch, _ = next(iter(loader.epoch(5)))
    return cfg, model, batch.to("cuda")


def train_census(cfg, model, batch, graphed: bool = True,
                 runs: int = STEP_RUNS) -> dict:
    """The train step's record (`_record`, the median of `runs` steps),
    from `model`'s weights (a copy on the card) and a fresh AdamW
    state."""
    import copy

    import torch

    from gwdepth_tpu_torch.parallel import create_train_state, make_train_step

    state = create_train_state(cfg, copy.deepcopy(model).to("cuda"))
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    holder = [state]

    def one():
        holder[0], _ = step(holder[0], batch, gen)

    rec = _record(one, runs, graphed=graphed)
    del holder[0], state
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."),
        help="checkout whose package is measured (default: this one)")
    p.add_argument("--forward", action="store_true",
                   help="only the forward, without its median, with one "
                        "more call under sync-debug mode \"error\"")
    a = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from gwdepth_tpu_torch import _build
    from gwdepth_tpu_torch.tools.synthetic import generate_dataset

    if not torch.cuda.is_available():
        raise SystemExit("dispatch_census needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    out = {"package": os.path.dirname(_build.__file__),
           "build_s": time.perf_counter() - t0}
    model, img = serve_model()
    out["forward"] = serve_census(model, img, must_not_sync=a.forward,
                                  runs=0 if a.forward else FORWARD_RUNS)
    if a.forward:
        print(json.dumps(out), flush=True)
        return
    out["forward_eager"] = serve_census(model, img, graphed=False)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ds")
        generate_dataset(root, 2, 1, height=720, width=1280, seed=SEED)
        setup = train_setup(train_args(root, os.path.join(tmp, "exp")))
        out["train_step"] = train_census(*setup)
        out["train_step_eager"] = train_census(*setup, graphed=False)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
