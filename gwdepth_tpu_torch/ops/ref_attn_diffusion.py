"""K1: the 3-step line-reference attention diffusion.

`ref_attn_diffusion(a, w, b)` keeps the JAX layout: a (B, P, R, H) planes
(P = windows x tokens, R = reference points, H = heads as channels),
w (3, 3, H, H) HWIO, b (H,). Three times: 3x3 SAME conv + bias, LayerNorm
without parameters over the whole (P, R) plane of each (batch, head),
exact GELU, residual add.

A CUDA tensor launches the hand-written kernel
`csrc/ref_attn_diffusion.cu` (it replaces the Pallas TPU kernel
`gwdepth_tpu/ops/pallas_kernels.py:ref_attn_diffusion_pallas`): all three
steps in one cooperative launch of a persistent grid, each block owning a
band of rows of one plane. `plan` chooses the schedule from the shapes
alone: the band schedule (`band_partition`: the band stays in shared
memory) where the bands fit a block, as at the 1/32 layer, else the
device-memory schedule (`tile_partition`: the plane stays in device
memory and each block sweeps its band in chunks), as at the class
layers. A CPU tensor takes `ref_attn_diffusion_plain`. Nothing falls
back: a CUDA tensor that neither schedule takes raises.

Binding: the kernel is the custom op `gwdepth::ref_attn_diffusion`
(`torch.library`), so `torch.export` and other tracers record it as one
node of the graph. Its real implementation dispatches by device (the
plain version on the CPU, `_launch` on CUDA) and is the only code that
reads device properties, streams or pointers; its fake implementation
gives the float32 result's shape to a tracer without touching the
device. The launch counts are kept inside the real implementation, so
they count the launches of an exported program too.

Gradients, registered on the op: the backward recomputes from the saved
inputs and differentiates the 3-step diffusion formulation
(`diffusion_torch`: `F.conv2d`, parameter-free LayerNorm, exact GELU),
as the JAX package's `_diff_bwd` differentiates `swin.py:diffusion_xla`
(`gwdepth_tpu/ops/pallas_kernels.py:151-155`). The JAX package has no
backward kernel for K1, so the port has none either: the backward is
plain PyTorch on every device. On the card its convolutions run at
cuDNN's precision setting (`torch.backends.cudnn.allow_tf32`), which the
entry points set from the config's dtype: full float32 for the shipped
config (`GWDepthConfig.set_matmul_precision`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
from collections import Counter
from pathlib import Path

import torch
import torch.nn.functional as F

from gwdepth_tpu_torch import graphs
from gwdepth_tpu_torch._build import refuse_dtensor

_HEADS = (2, 4, 8, 16, 32)


def _conv3x3_taps(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of (B, P, R, Ci) by HWIO w as 9 shifted-slice
    contractions, the kernel's own arithmetic."""
    B, P, R, _ = a.shape
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("bprc,cd->bprd", ap[:, dy:dy + P, dx:dx + R],
                             w[dy, dx])
            out = t if out is None else out + t
    return out


def ref_attn_diffusion_plain(a: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (float32 arithmetic)."""
    dtype = a.dtype
    a = a.float()
    w = w.float()
    b = b.float()
    for _ in range(3):
        upd = _conv3x3_taps(a, w) + b
        mean = upd.mean(dim=(1, 2), keepdim=True)
        var = ((upd - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        upd = (upd - mean) * torch.rsqrt(var + 1e-5)
        a = a + F.gelu(upd)
    return a.to(dtype)


# shared memory a block can use on an H100 (232,448 bytes) and the
# kernel's block: 8 warps, two per scheduler of the SM, which hides the
# latency of the steps between the convs
SMEM_MAX = 232448
THREADS_MAX = 256
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / \
    "ref_attn_diffusion.cu"


@functools.lru_cache(maxsize=2)
def _instances(schedule: str = "band") -> tuple:
    """The (H, KS, PT) the kernel is built for, per schedule: the
    `GW_K1_INSTANCES` ("band") or `GW_K1_TILED_INSTANCES` ("tiled") list
    of the CUDA source, read from there so that it is written once."""
    name = {"band": "GW_K1_INSTANCES", "tiled": "GW_K1_TILED_INSTANCES"}[
        schedule]
    src = _SOURCE.read_text()
    body = src[src.index(f"#define {name}(X)"):]
    body = body[:body.index("\n\n")]
    return tuple(tuple(int(v) for v in m)
                 for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", body))


def kernel_configs(H: int, schedule: str = "band") -> tuple:
    """The (KS, PT) built at H heads for `schedule`, KS threads on each
    group of PT positions: widest KS first, then PT ascending."""
    return tuple(sorted(((ks, pt) for h, ks, pt in _instances(schedule)
                         if h == H), key=lambda c: (-c[0], c[1])))


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """How the kernel's persistent grid splits the planes: `nbp` blocks per
    plane, block k owning rows `bands[k] = (b, p0, rows)`; `threads`
    threads, `ks` of them on each group of `pt` positions; `smem` bytes of
    shared memory a block. The band schedule holds a block's whole band
    (at most `rows_max` rows) in shared memory."""
    nbp: int
    bands: tuple
    rows_max: int
    threads: int
    ks: int
    pt: int
    smem: int


@dataclasses.dataclass(frozen=True)
class TilePlan(BandPlan):
    """The device-memory schedule: the bands of `BandPlan`, each swept in
    chunks of at most `chunk_rows` rows (the tile in shared memory)."""
    chunk_rows: int = 0


def _bands(B: int, P: int, sms: int):
    """Every plane gets the same number of blocks, nbp (at most P, so no
    band is empty), each block a contiguous band of whole rows of one
    plane, the bands of a plane differing by at most one row (block j of a
    plane starts at row j * P // nbp, as `band_start` in the CUDA
    source). Returns nbp, the bands and the widest band's rows."""
    nbp = max(1, min(P, sms // B))
    starts = [j * P // nbp for j in range(nbp + 1)]
    bands = tuple((b, starts[j], starts[j + 1] - starts[j])
                  for b in range(B) for j in range(nbp))
    return nbp, bands, _ceil(P, nbp)


def _smem(H: int, nbp: int, rows: int, R: int, ks: int,
          threads: int) -> int:
    """Bytes of the kernel's shared-memory carve-up (`carve` in the CUDA
    source): weights, block partials, block counts, a tile of `rows` rows
    with halo, warp sums, lane sums, four vectors of H."""
    return 4 * (9 * H * (H + 4) + 2 * nbp * H + nbp
                + (rows + 2) * (R + 2) * (H + ks)
                + (threads // 32) * H + threads + 4 * H)


def _check_smem(smem: int, what: str) -> None:
    if smem > SMEM_MAX:
        raise ValueError(f"ref_attn_diffusion kernel: {what} needs {smem} "
                         f"bytes of shared memory, more than {SMEM_MAX}")


@functools.lru_cache(maxsize=64)
def band_partition(B: int, P: int, R: int, H: int, sms: int) -> BandPlan:
    """The band schedule's partition of B planes of P rows over `sms` SMs,
    one block of up to THREADS_MAX threads each (cached: the wrapper asks
    for every call), the bands as `_bands` cuts them. `smem` is the
    kernel's carve-up of shared memory, which the launch passes on. Raises
    ValueError when a band does not fit in one block's shared memory or
    threads."""
    nbp, bands, rows_max = _bands(B, P, sms)
    npos = rows_max * R
    # the most threads on a group of positions (each weight read from
    # shared memory then feeds the most positions) with which the groups
    # cover the band
    threads = min(THREADS_MAX, 32 * _ceil(npos, 32))
    configs = kernel_configs(H)
    for ks in sorted({k for k, _ in configs}, reverse=True):
        need = _ceil(npos, threads // ks)
        pts = [p for k, p in configs if k == ks and p >= need]
        if pts:
            pt = pts[0]
            break
    else:
        raise ValueError(
            f"ref_attn_diffusion kernel: a band of {rows_max} rows x R={R} "
            f"needs more than {threads} threads of at most "
            f"{max(p for _, p in configs)} positions")
    smem = _smem(H, nbp, rows_max, R, ks, threads)
    _check_smem(smem, f"a band of {rows_max} rows x R={R} x H={H}")
    return BandPlan(nbp, bands, rows_max, threads, ks, pt, smem)


@functools.lru_cache(maxsize=64)
def tile_partition(B: int, P: int, R: int, H: int, sms: int) -> TilePlan:
    """The device-memory schedule's partition: the bands of `_bands`, each
    swept in chunks of the most whole rows that THREADS_MAX threads cover
    (KS threads on each group of PT positions, the one instance built at
    H). Raises ValueError when one row of R positions is more than the
    threads cover, or a chunk more than a block's shared memory."""
    nbp, bands, rows_max = _bands(B, P, sms)
    (ks, pt), = kernel_configs(H, "tiled")
    threads = THREADS_MAX
    cover = threads // ks * pt
    chunk = min(rows_max, cover // R)
    if chunk < 1:
        raise ValueError(
            f"ref_attn_diffusion kernel: a row of R={R} positions needs "
            f"more than {threads} threads of {pt} positions ({cover})")
    smem = _smem(H, nbp, chunk, R, ks, threads)
    _check_smem(smem, f"a chunk of {chunk} rows x R={R} x H={H}")
    return TilePlan(nbp, bands, rows_max, threads, ks, pt, smem, chunk)


def plan(B: int, P: int, R: int, H: int, sms: int) -> BandPlan:
    """The schedule for B planes (P, R, H) on `sms` SMs, from the shapes
    alone: the band schedule where `band_partition` succeeds, else the
    device-memory schedule (`tile_partition`), which raises ValueError
    when it cannot take the planes either."""
    try:
        return band_partition(B, P, R, H, sms)
    except ValueError:
        return tile_partition(B, P, R, H, sms)


def _ceil(n: int, d: int) -> int:
    return -(-n // d)


_barriers = {}


def _barrier(device: torch.device, stream: int) -> torch.Tensor:
    """The grid barrier's counter for calls on `stream` of `device`, zeroed
    once; every call that ends leaves it ready for the next. Calls on one
    stream run one after another, so they share it; calls on two streams
    may run at once, so they never do.

    A call captured in a CUDA graph gets a counter of its own instead,
    allocated inside the capture from the graph's pool and zeroed by a node
    captured just before the kernel, so every replay starts it at 0. A
    replay runs on the stream it is launched on, not the one it was
    captured on, so a stream's counter would be shared by a replay and a
    direct call on the capture stream, or by replays of two graphs
    captured on one stream, running at once; replays of one graph run one
    after another, so its own counter is never shared."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(1, dtype=torch.int32, device=device)
    bar = _barriers.get((device, stream))
    if bar is None:
        bar = torch.zeros(1, dtype=torch.int32, device=device)
        _barriers[device, stream] = bar
    return bar


def _launch(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    from gwdepth_tpu_torch import _build

    if not a.is_cuda:
        raise ValueError(f"ref_attn_diffusion: no kernel for device {a.device}")
    B, P, R, H = a.shape
    if H not in _HEADS:
        raise ValueError(f"ref_attn_diffusion kernel takes H in {_HEADS}, "
                         f"got {H}")
    if tuple(w.shape) != (3, 3, H, H) or tuple(b.shape) != (H,):
        raise ValueError(f"bad weight shapes {tuple(w.shape)}, "
                         f"{tuple(b.shape)} for H={H}")
    for name, t in (("w", w), ("b", b)):
        if t.device != a.device:
            raise ValueError(f"{name} on {t.device}, planes on {a.device}")
    pl = plan(B, P, R, H, torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    tiled = isinstance(pl, TilePlan)
    a32 = a.float().contiguous()
    w32 = w.float().contiguous()
    b32 = b.float().contiguous()
    out = torch.empty_like(a32)
    upd = torch.empty_like(a32) if tiled else None
    stats = torch.empty((B * pl.nbp, H, 2), dtype=torch.float32,
                        device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().gw_ref_attn_diffusion(
        a32.data_ptr(), out.data_ptr(), upd.data_ptr() if tiled else None,
        stats.data_ptr(), _barrier(a.device, stream).data_ptr(),
        w32.data_ptr(), b32.data_ptr(), B, P, R, H, pl.nbp,
        pl.chunk_rows if tiled else pl.rows_max, pl.threads, pl.ks, pl.pt,
        pl.smem, stream)
    _build.check(err, "ref_attn_diffusion launch")
    graphs.count(ref_attn_diffusion, "launches")
    graphs.count(ref_attn_diffusion, "shape_launches", (B, P, R, H))
    return out


def _lib():
    from gwdepth_tpu_torch import _build

    lib = _build.load("ref_attn_diffusion")
    fn = lib.gw_ref_attn_diffusion
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                       ctypes.c_longlong, P]
        fn.restype = ctypes.c_int
    return lib


def diffusion_torch(a: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The diffusion in PyTorch's own ops (the backward's formulation):
    NCHW `F.conv2d`, `F.layer_norm` over the (P, R) plane, exact GELU."""
    P, R = a.shape[1], a.shape[2]
    x = a.float().permute(0, 3, 1, 2)
    wt = w.float().permute(3, 2, 0, 1)
    for _ in range(3):
        u = F.conv2d(x, wt, b.float(), padding=1)
        x = x + F.gelu(F.layer_norm(u, (P, R), eps=1e-5))
    return x.permute(0, 2, 3, 1)


@torch.library.custom_op("gwdepth::ref_attn_diffusion", mutates_args=())
def _op(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The op's real implementation: float32 diffused planes."""
    if a.device.type == "cpu":
        return ref_attn_diffusion_plain(a.float(), w, b)
    return _launch(a, w, b)


@_op.register_fake
def _(a, w, b):
    return a.new_empty(a.shape, dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def diffusion_vjp(a, w, b, ct):
    """The gradients of `diffusion_torch` at (a, w, b) for the cotangent
    `ct`, recomputed from the inputs, in their dtypes."""
    with torch.enable_grad():
        prim = [t.detach().requires_grad_() for t in (a, w, b)]
        y = diffusion_torch(*prim)
        grads = torch.autograd.grad(y, prim, ct.float())
    return tuple(g.to(t.dtype) for g, t in zip(grads, (a, w, b)))


def _backward(ctx, ct):
    return diffusion_vjp(*ctx.saved_tensors, ct)


_op.register_autograd(_backward, setup_context=_setup_context)


def ref_attn_diffusion(a: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """a (B, P, R, H), w (3, 3, H, H), b (H,) -> diffused a in a's dtype,
    differentiable, through the custom op. CPU tensors take the plain
    version; CUDA tensors launch the kernel; others raise (the op's fake
    implementation would otherwise answer for a meta tensor), as does a
    DTensor operand."""
    refuse_dtensor("ref_attn_diffusion", a, w, b)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ref_attn_diffusion: no kernel for device "
                         f"{a.device}")
    return _op(a, w, b).to(a.dtype)


ref_attn_diffusion.launches = 0
ref_attn_diffusion.shape_launches = Counter()   # (B, P, R, H) -> launches


def reset_counts() -> None:
    ref_attn_diffusion.launches = 0
    ref_attn_diffusion.shape_launches.clear()
