"""K1: the 3-step line-reference attention diffusion.

`ref_attn_diffusion(a, w, b)` keeps the JAX layout: a (B, P, R, H) planes
(P = windows x tokens, R = reference points, H = heads as channels),
w (3, 3, H, H) HWIO, b (H,). Three times: 3x3 SAME conv + bias, LayerNorm
without parameters over the whole (P, R) plane of each (batch, head),
exact GELU, residual add.

A CUDA tensor launches the hand-written kernel
`csrc/ref_attn_diffusion.cu` (it replaces the Pallas TPU kernel
`gwdepth_tpu/ops/pallas_kernels.py:ref_attn_diffusion_pallas`); a CPU
tensor takes `ref_attn_diffusion_plain`. Nothing falls back: a CUDA
tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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


def tile_rows(P: int, R: int) -> int:
    """Rows of P one conv block owns: one thread per (row, r) position."""
    if R > 1024:
        raise ValueError(f"ref_attn_diffusion kernel takes R <= 1024, got {R}")
    return max(1, min(P, 256 // R))


def _launch(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
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
    dtype = a.dtype
    a32 = a.float().contiguous()
    w32 = w.float().contiguous()
    b32 = b.float().contiguous()
    TP = tile_rows(P, R)
    nT = -(-P // TP)
    out = torch.empty_like(a32)
    tmp = torch.empty_like(a32)
    upd = torch.empty_like(a32)
    stats = torch.empty((B, nT, H, 2), dtype=torch.float32, device=a.device)
    lib = _lib()
    err = lib.gw_ref_attn_diffusion(
        a32.data_ptr(), out.data_ptr(), tmp.data_ptr(), upd.data_ptr(),
        stats.data_ptr(), w32.data_ptr(), b32.data_ptr(), B, P, R, H, TP,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ref_attn_diffusion launch")
    ref_attn_diffusion.launches += 1
    return out.to(dtype)


def _lib():
    from gwdepth_tpu_torch import _build

    lib = _build.load("ref_attn_diffusion")
    fn = lib.gw_ref_attn_diffusion
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def ref_attn_diffusion(a: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """a (B, P, R, H), w (3, 3, H, H), b (H,) -> diffused a. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return ref_attn_diffusion_plain(a, w, b)
    return _launch(a, w, b)


ref_attn_diffusion.launches = 0
