"""Build the CUDA kernels in `csrc/` at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) under `build/kernels/` at the repo root. The file name carries a
hash of the source and the flags, so an edited source is rebuilt. Every C
entry returns `cudaGetLastError()`; `check` raises when it is not 0.

A source named in `PARTS` holds many template instances: it is compiled
as that many translation units at once (`-DGW_PARTS=n -DGW_PART=i`, each
unit its share of the instances) and the objects are linked into the one
library, so its build takes about the time of its largest part.

    python -m gwdepth_tpu_torch._build     # build every kernel, print ptxas
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]
KERNELS = ("ref_attn_diffusion", "conv3x3_ln_act", "window_msa",
           "layout_fence", "lap_jv")
# sources built as several translation units (see the module docstring)
PARTS = {"ref_attn_diffusion": 4}

_loaded: Dict[str, ctypes.CDLL] = {}


def refuse_dtensor(op: str, *tensors) -> None:
    """Raise TypeError when one of `tensors` is a DTensor: the kernels,
    their custom ops and their plain versions take plain tensors only, so
    a sharded weight must be gathered whole before it reaches them
    (`parallel/partition.py`), never fall back to another path. A DTensor
    exists only once its module is imported, so nothing is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return
    for t in tensors:
        if isinstance(t, mod.DTensor):
            raise TypeError(f"{op}: a DTensor input; gather it to a plain "
                            "tensor first (parallel/partition.py)")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CPU tensors take the plain versions)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS) + f" parts={PARTS.get(name, 1)}"
    h = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _popen(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start(name: str):
    """Start nvcc for one kernel (for each part of it); None when the
    library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    src = str(CSRC / f"{name}.cu")
    n = PARTS.get(name, 1)
    if n == 1:
        return [_popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src])], tmp, out
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    # nvcc links only files it knows by their suffix
    objs = [out.with_suffix(f".part{i}.tmp{os.getpid()}.o") for i in range(n)]
    procs = [_popen([_nvcc(), *flags, f"-DGW_PARTS={n}", f"-DGW_PART={i}",
                     "-c", "-o", str(o), src]) for i, o in enumerate(objs)]
    return procs, tmp, out, objs


def _finish(name: str, job) -> None:
    procs, tmp, out, *objs = job
    logs = []
    for proc in procs:
        log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    if objs:
        link = _popen([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                       *map(str, objs[0])])
        log, _ = link.communicate()
        logs.append(log)
        for o in objs[0]:
            o.unlink()
        if link.returncode != 0:
            raise RuntimeError(f"linking {name}.cu's parts failed:\n{log}")
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel that is not built yet, one nvcc each (one
    for each part of a source in `PARTS`), all started together. Returns
    the seconds spent."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The nvcc/ptxas output of the last build of `name` ('' if none)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


if __name__ == "__main__":
    print(f"built in {build():.1f} s")
    for n in KERNELS:
        print(build_log(n))
