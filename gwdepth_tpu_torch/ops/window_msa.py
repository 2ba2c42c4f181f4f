"""K3 and K4: windowed multi-head attention and the layout fence.

The counterpart of the K3/K4 half of `gwdepth_tpu/ops/pallas_kernels.py`
(K1's half is `ref_attn_diffusion.py`):

- `window_msa_kernel(q, k, v, bias, mask)`, the counterpart of
  `window_msa_pallas`: for every window and head,
  softmax(q kᵀ + bias[h] (+ mask[w mod nW])) v with float32 logits and a
  max-subtracted softmax. q/k/v (B, nW, H, N, hd), q pre-scaled; bias
  (H, N, N); mask (nW, N, N) additive or None. Returns (B, nW, N, H*hd)
  float32. A CUDA tensor launches `csrc/window_msa.cu` once (it replaces
  the Pallas kernel `_window_msa_pallas`: 3xTF32 `mma.sync` products, four
  warps a (window, head) pair, a grid that `launch_plan` sizes to one
  wave from the SM count and the kernel's occupancy, both asked once per
  device); a CPU tensor takes `window_msa_plain`.
- `layout_fence(x)`, the counterpart of `layout_fence`: an identity copy;
  `ndim < 2` returns x itself, as there. A CUDA tensor launches
  `csrc/layout_fence.cu` once, whether x is contiguous or a strided view
  of rows (`fence_rows`; the fused entry's x is a channel slice of wider
  rows); a CPU tensor takes a contiguous copy. PyTorch has no layout
  assignment for the fence to stop, so it only computes what the TPU
  kernel computes.
- `fused_window_attention(x, wqkv, bqkv, wproj, bproj, bias, mask,
  num_heads)`, the counterpart of `fused_window_attention`: the fence on
  x, the qkv projection, K3 (with q scaled by hd^-0.5 inside the kernel,
  which reads q, k and v in place from the qkv product), the output
  projection. The weights are in `nn.Linear` layout, wqkv (3C, C) and
  wproj (C, C), so a port module's `attn.qkv.weight` goes straight in;
  the JAX entry takes the flax kernels (C, 3C) and (C, C). The two
  projections are `F.linear`, as the JAX package leaves them to XLA.

Nothing falls back: a CUDA tensor the kernel cannot take (N > 64,
hd > 32) raises, as does a tensor on any other device.

Binding: K3 and K4 are the `torch.library` custom ops
`gwdepth::window_msa` (q, k, v, bias, mask, q_scale) and
`gwdepth::layout_fence` (x), as K1 and K2 are bound, so `torch.export` of
an entry records them as op nodes (JAX's `jax.export` of the same entry
carries the `pallas_call`). Each op dispatches by its inputs' device;
`window_msa_kernel`, `layout_fence` and `fused_window_attention` call
them, and no launch happens outside an op's implementation.

Gradients: K3's op recomputes from its saved inputs and differentiates
the plain formulation (`window_msa_plain`, einsum and softmax), as the
JAX package's `_fwa_bwd` differentiates `_attention_xla_reference`
(`gwdepth_tpu/ops/pallas_kernels.py:394-404`); the fused entry's two
linears are differentiated by autograd around it. The JAX package has no
backward kernel for K3, so the port has none either. The fence passes
its gradient through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from gwdepth_tpu_torch import graphs

MAX_N = 64
MAX_HD = 32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def window_msa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic: float32 logits,
    + bias, + mask[w mod nW], max-subtracted exp, divided by the sum, then
    the weighted sum over v."""
    q, k, v = q.float(), k.float(), v.float()
    s = torch.einsum("bwhnd,bwhmd->bwhnm", q, k) + bias.float()[None, None]
    if mask is not None:
        s = s + mask.float()[None, :, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    attn = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bwhnm,bwhmd->bwhnd", attn, v)
    B, nW, H, N, hd = out.shape
    return out.movedim(2, 3).reshape(B, nW, N, H * hd)


def layout_fence_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


def _split_qkv(qkv: torch.Tensor, B: int, H: int):
    """(W, N, 3C) -> q, k, v views (B, nW, H, N, hd) into it."""
    W, N, C3 = qkv.shape
    C = C3 // 3
    return [t.reshape(B, W // B, N, H, C // H).transpose(2, 3)
            for t in qkv.split(C, dim=-1)]


def fused_window_attention_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                 num_heads: int) -> torch.Tensor:
    """The fused entry with the plain versions of K3 and K4 (the JAX
    package's `_attention_xla_reference`, the fence's copy included). Its
    autograd is the fused entry's backward."""
    B, nW, N, C = x.shape
    xf = layout_fence_plain(x.reshape(B * nW, N, C).float())
    q, k, v = _split_qkv(F.linear(xf, wqkv.float(), bqkv.float()), B,
                         num_heads)
    out = window_msa_plain(q * (C // num_heads) ** -0.5, k, v, bias, mask)
    return F.linear(out, wproj.float(), bproj.float())


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _lib(name: str, argtypes, source: Optional[str] = None):
    """The C entry `gw_<name>` of `csrc/<source or name>.cu`."""
    from gwdepth_tpu_torch import _build

    lib = _build.load(source or name)
    fn = getattr(lib, f"gw_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(B, nW, H, N, hd, bias, mask) -> None:
    """Raise ValueError unless the K3 kernel takes these sizes."""
    if not (1 <= N <= MAX_N and 1 <= hd <= MAX_HD):
        raise ValueError(f"window_msa kernel takes N <= {MAX_N} and "
                         f"1 <= hd <= {MAX_HD}, got N={N}, hd={hd}")
    if tuple(bias.shape) != (H, N, N):
        raise ValueError(f"bias {tuple(bias.shape)}, expected {(H, N, N)}")
    if mask is not None and tuple(mask.shape) != (nW, N, N):
        raise ValueError(f"mask {tuple(mask.shape)}, expected {(nW, N, N)}")


# shared memory a block can use on an H100
SMEM_MAX = 232448


def head_pad(hd: int) -> int:
    """hd padded to the mma's k steps of 8 (8, 16, 24 or 32)."""
    return 8 * _ceil(hd, 8)


def key_tiles(N: int) -> int:
    """Key tiles of 8 of the kernel instance that takes N tokens (2, 4, 7
    or 8; `key_tiles` in `csrc/window_msa.cu`)."""
    return 2 if N <= 16 else 4 if N <= 32 else 7 if N <= 56 else 8


def smem_layout(N: int, hdp: int, has_mask: bool) -> dict:
    """K3's shared-memory carve-up in floats (`Tile` in
    `csrc/window_msa.cu`): bias[h] (`bias` floats, rows of `bs`), then each
    stage of q and k (rows of `qs`), v (rows of `vs`) and the window's mask
    as it lies in memory (N x N floats from the 16-byte boundary at or
    below its start, at most np16 x np8 + 8 floats), `stage` floats a
    stage. Keys are padded to `np8` = 8 key_tiles(N), query rows to
    `np16`. q, k and bias rows are read as float2 by 8 rows x 4 lanes, so
    their strides are 8 or 24 mod 32; v rows are read as floats by rows
    2t, 2t + 1 x 8 lanes, so its stride is 4 or 12 mod 16."""
    nt = key_tiles(N)
    np8, np16 = 8 * nt, 16 * _ceil(nt, 2)
    bs = np8 if np8 % 16 == 8 else np8 + 8
    qs = hdp if hdp % 16 == 8 else hdp + 8
    vs = hdp + 4
    stage = (np16 + np8) * qs + np8 * vs + (np16 * np8 + 8 if has_mask
                                            else 0)
    return {"np8": np8, "np16": np16, "bs": bs, "qs": qs, "vs": vs,
            "stage": stage, "bias": np16 * bs}


def smem_bytes(N: int, hdp: int, has_mask: bool, stages: int) -> int:
    lay = smem_layout(N, hdp, has_mask)
    return 4 * (lay["bias"] + stages * lay["stage"])


@dataclasses.dataclass(frozen=True)
class MsaPlan:
    """K3's launch: `grid` = G x H blocks, block g * H + h owning head h of
    windows g, g + G, ... (at most `windows` of them); `stages` windows of
    q/k/v (and mask) in shared memory at once (2: the next window's copies
    run under this one's products); `smem` bytes a block."""
    grid: int
    windows: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, nW: int, H: int, N: int, hd: int, has_mask: bool,
                sms: int, per_sm: int) -> MsaPlan:
    """K3's grid for B * nW windows of H heads on `sms` SMs that hold
    `per_sm` blocks each at the two-stage carve-up (cached: the wrapper asks
    on every call). Each head gets the same G blocks, as many as one wave
    leaves it, and every block the same number of windows to within one:
    the fewest windows a block that fill the wave, then the fewest blocks
    that cover the windows at that count. A block that owns one window
    needs one stage."""
    W = B * nW
    slots = max(1, sms * per_sm // H)
    windows = _ceil(W, slots)
    G = _ceil(W, windows)
    stages = 2 if windows > 1 else 1
    return MsaPlan(G * H, windows, stages,
                   smem_bytes(N, head_pad(hd), has_mask, stages))


def rows_aligned(t: torch.Tensor) -> bool:
    """Every (b, w, h, n) row of t starts 16-byte aligned, so K3 stages it
    with 16-byte copies (4-byte copies for the hd % 4 tail); otherwise
    every element takes a 4-byte copy."""
    return t.data_ptr() % 16 == 0 and all(
        s % 4 == 0 for s in t.stride()[:4])


def _ceil(n: int, d: int) -> int:
    return -(-n // d)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, N: int, hd: int, smem: int) -> int:
    """Blocks of K3's instance for N and hd that an SM of device `index`
    holds (the kernel's registers and `smem`), asked of the CUDA runtime
    once, which also opts the instance in to a block's whole shared memory
    on that device."""
    from gwdepth_tpu_torch import _build

    I = ctypes.c_int
    fn = _lib("window_msa_blocks_per_sm",
              [I, I, ctypes.c_longlong, ctypes.c_void_p], "window_msa")
    blocks = I(0)
    with torch.cuda.device(index):
        _build.check(fn(N, hd, smem, ctypes.byref(blocks)),
                     "window_msa occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"window_msa kernel: no block fits an SM at "
                           f"{smem} bytes of shared memory")
    return blocks.value


def _launch_msa(q, k, v, bias, mask, q_scale: float) -> torch.Tensor:
    """Launch K3 on (B, nW, H, N, hd) views with a dense last axis (other
    views are made contiguous) and return (B, nW, N, H*hd) float32."""
    from gwdepth_tpu_torch import _build

    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window_msa kernel: q/k/v must be (B, nW, H, N, hd)"
                         f" of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_shapes(*q.shape, bias, mask)
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias),
                    ("mask", mask)):
        if t is not None and (not t.is_cuda or t.device != q.device):
            raise ValueError(f"window_msa kernel: {name} on {t.device}, "
                             f"q on {q.device}")
    B, nW, H, N, hd = q.shape
    ops = []
    for t in (q, k, v):
        t = t.float()
        ops.append(t if t.stride(-1) == 1 else t.contiguous())
    strides = (ctypes.c_longlong * 12)(*[s for t in ops
                                         for s in t.stride()[:4]])
    bias32 = bias.float().contiguous()
    mask32 = None if mask is None else mask.float().contiguous()
    out = torch.empty((B, nW, N, H * hd), dtype=torch.float32,
                      device=q.device)
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    per_sm = _blocks_per_sm(index, N, hd, smem_bytes(
        N, head_pad(hd), mask is not None, 2))
    plan = launch_plan(B, nW, H, N, hd, mask is not None, _sms(index),
                       per_sm)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _lib("window_msa", [P, P, P, P, P, P, P, I, I, I, I, I,
                             ctypes.c_float, I, I, I, ctypes.c_longlong, P])
    err = fn(ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
             ctypes.cast(strides, P), bias32.data_ptr(),
             None if mask32 is None else mask32.data_ptr(), out.data_ptr(),
             B, nW, H, N, hd, float(q_scale), plan.grid, plan.stages,
             int(all(rows_aligned(t) for t in ops)), plan.smem,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "window_msa launch")
    graphs.count(window_msa_kernel, "launches")
    return out


FENCE_MAX_DIMS = 4


def fence_rows(x: torch.Tensor):
    """x's bytes as the fence kernel reads them: (row_bytes, dims), where
    dims are (size, byte stride) of the rows, outermost first, each row
    `row_bytes` contiguous bytes; dims == [] when x is contiguous. Size-1
    dims are dropped and dims that step evenly are merged."""
    es = x.element_size()
    sizes = [(n, st * es) for n, st in zip(x.shape, x.stride()) if n != 1]
    run = es
    while sizes and sizes[-1][1] == run:
        run *= sizes.pop()[0]
    dims = []
    for n, st in sizes:
        if dims and dims[-1][1] == st * n:
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    return run, dims


def _launch_fence(x: torch.Tensor) -> torch.Tensor:
    from gwdepth_tpu_torch import _build

    if not x.is_cuda:
        raise ValueError(f"layout_fence: no kernel for device {x.device}")
    row_bytes, dims = fence_rows(x)
    if len(dims) > FENCE_MAX_DIMS:
        raise ValueError(f"layout_fence kernel: a view of {len(dims)} "
                         f"strided row dims, more than {FENCE_MAX_DIMS}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return out
    L, P = ctypes.c_longlong, ctypes.c_void_p
    shape = (L * FENCE_MAX_DIMS)(*[n for n, _ in dims])
    stride = (L * FENCE_MAX_DIMS)(*[st for _, st in dims])
    fn = _lib("layout_fence", [P, P, L, L, ctypes.c_int, P, P, P])
    err = fn(x.data_ptr(), out.data_ptr(), nbytes, row_bytes if dims else 0,
             len(dims), ctypes.cast(shape, P), ctypes.cast(stride, P),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "layout_fence launch")
    graphs.count(layout_fence, "launches")
    return out


# ---------------------------------------------------------------------------
# custom ops and entry points
# ---------------------------------------------------------------------------

def _grads_through(fn, inputs, needs, ct):
    """Gradients of fn(*inputs) for the inputs in `needs`, by autograd
    through fn on detached copies; None for the others."""
    with torch.enable_grad():
        leaves = [t if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        want = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*leaves), want, ct))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


def _scaled_plain(q_scale: float):
    def plain(q, k, v, bias, mask):
        return window_msa_plain(q * q_scale, k, v, bias, mask)

    return plain


@torch.library.custom_op("gwdepth::window_msa", mutates_args=())
def _msa_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, mask: Optional[torch.Tensor],
            q_scale: float) -> torch.Tensor:
    """K3's op: softmax((q_scale q) kᵀ + bias (+ mask)) v, float32
    (B, nW, N, H*hd)."""
    if q.device.type == "cpu":
        return _scaled_plain(q_scale)(q, k, v, bias, mask)
    return _launch_msa(q, k, v, bias, mask, q_scale)


@_msa_op.register_fake
def _(q, k, v, bias, mask, q_scale):
    B, nW, H, N, hd = q.shape
    return q.new_empty((B, nW, N, H * hd), dtype=torch.float32)


def _msa_setup_context(ctx, inputs, output):
    *tensors, ctx.q_scale = inputs
    ctx.save_for_backward(*tensors)


def _msa_backward(ctx, ct):
    """Autograd through the plain formulation, recomputed from the saved
    inputs, as the JAX package differentiates its XLA reference."""
    grads = _grads_through(_scaled_plain(ctx.q_scale), ctx.saved_tensors,
                           ctx.needs_input_grad[:5], ct)
    return (*grads, None)


_msa_op.register_autograd(_msa_backward, setup_context=_msa_setup_context)


@torch.library.custom_op("gwdepth::layout_fence", mutates_args=())
def _fence_op(x: torch.Tensor) -> torch.Tensor:
    """K4's op: a contiguous copy of x."""
    if x.device.type == "cpu":
        return layout_fence_plain(x)
    return _launch_fence(x)


@_fence_op.register_fake
def _(x):
    return x.new_empty(x.shape)


_fence_op.register_autograd(lambda ctx, ct: ct)


def _refuse_device(name: str, t: torch.Tensor) -> None:
    """CPU tensors take the plain version and CUDA tensors the kernel;
    any other device raises (the op's fake implementation would
    otherwise answer for a meta tensor)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")


def window_msa_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q/k/v (B, nW, H, N, hd) with q pre-scaled, bias (H, N, N), mask
    (nW, N, N) or None -> (B, nW, N, H*hd) float32, differentiable,
    through the custom op `gwdepth::window_msa`. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _refuse_device("window_msa", q)
    return _msa_op(q, k, v, bias, mask, 1.0)


window_msa_kernel.launches = 0


def layout_fence(x: torch.Tensor) -> torch.Tensor:
    """Identity copy of x (x itself when x.dim() < 2), differentiable,
    through the custom op `gwdepth::layout_fence`. CPU tensors are
    copied; CUDA tensors launch the copy kernel."""
    if x.dim() < 2:
        return x
    _refuse_device("layout_fence", x)
    return _fence_op(x)


layout_fence.launches = 0


def fused_window_attention(x: torch.Tensor, wqkv: torch.Tensor,
                           bqkv: torch.Tensor, wproj: torch.Tensor,
                           bproj: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor],
                           num_heads: int) -> torch.Tensor:
    """x (B, nW, N, C); wqkv (3C, C), bqkv (3C,), wproj (C, C), bproj (C,)
    in `nn.Linear` layout; bias (H, N, N); mask (nW, N, N) or None.
    Returns (B, nW, N, C) in x's dtype, differentiable: the fence and K3
    are the two custom ops, the projections `F.linear`. On a CUDA tensor
    it launches K4 once and K3 once."""
    _refuse_device("fused_window_attention", x)
    B, nW, N, C = x.shape
    if x.is_cuda:
        _check_shapes(B, nW, num_heads, N, C // num_heads, bias, mask)
    xf = layout_fence(x.reshape(B * nW, N, C).float())
    q, k, v = _split_qkv(F.linear(xf, wqkv.float(), bqkv.float()), B,
                         num_heads)
    out = _msa_op(q, k, v, bias, mask, (C // num_heads) ** -0.5)
    return F.linear(out, wproj.float(), bproj.float()).to(x.dtype)


def reset_counts() -> None:
    window_msa_kernel.launches = 0
    layout_fence.launches = 0
