"""K2: fused 3x3 conv + channel LayerNorm + activation (+ residual).

`conv3x3_ln_act(x, w, ln_scale, ln_bias, residual, act)` keeps the JAX
layout: x (B, H, W, Ci) NHWC, w (3, 3, Ci, Co) HWIO, bias-free, stride 1,
SAME zero borders; LayerNorm over Co (eps 1e-5, affine), skipped when
`ln_scale` is None; act None | 'gelu' (exact) | 'elu'; the residual is
added after the activation.

A CUDA tensor launches the hand-written kernel `csrc/conv3x3_ln_act.cu`
(it replaces the Pallas TPU kernel
`gwdepth_tpu/ops/fused_conv.py:conv3x3_ln_act`); a CPU tensor takes
`conv3x3_ln_act_plain`. Nothing falls back: a CUDA tensor the kernel
cannot take raises. The kernel multiplies float32 operands on the CUDA
cores, so it matches the float32 plain version to reassociation.

Gradients: `conv3x3_ln_act` is a `torch.autograd.Function` whose backward
mirrors the JAX package's `_fused_bwd` (`gwdepth_tpu/ops/fused_conv.py:
444-489`): it recomputes the pre-LN conv with the same kernel (no LN, no
activation), runs the per-pixel LayerNorm and activation backward in
plain torch, computes dx with the kernel on the rotated, io-transposed
weights (3, 3, Co, Ci), and dw as 9 shifted-slice matmuls. dx has Ci
output channels; above the kernel's `MAX_CO` it is split into equal
channel pieces, which is exact without a LayerNorm. On a CPU tensor the
same backward runs with the plain conv in place of the kernel. The
residual's gradient passes straight through.

Counters: `conv3x3_ln_act.launches` counts forward launches and
`.shape_launches` them by `link_key`; `.bwd_launches` counts backward
ones (the recompute and each dx piece).

Chains of links need no frame layout here: each link reads NHWC and masks
its SAME borders itself, which is what the TPU frame chain
(`fused_conv_ln_act_frame`) achieves by zeroing its junk columns.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

_ACTS = {None: 0, "gelu": 1, "elu": 2}
MAX_CO = 256


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(y)
    if act == "elu":
        return F.elu(y)
    if act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return y


def act_grad_at(act: Optional[str], n: torch.Tensor) -> torch.Tensor:
    """d act(n) / dn at the pre-activation n."""
    if act == "gelu":          # exact: Phi(n) + n * phi(n)
        phi = torch.exp(-0.5 * n * n) * (1.0 / math.sqrt(2.0 * math.pi))
        Phi = 0.5 * (1.0 + torch.erf(n * (2.0 ** -0.5)))
        return Phi + n * phi
    if act == "elu":
        return torch.where(n > 0, torch.ones_like(n),
                           torch.exp(torch.clamp(n, max=0.0)))
    return torch.ones_like(n)


def conv3x3_ln_act_plain(x, w, ln_scale=None, ln_bias=None, residual=None,
                         act=None):
    """Plain PyTorch version of the kernel: the conv as 9 shifted-slice
    contractions, then LayerNorm, activation, residual, in float32."""
    B, H, W, _ = x.shape
    dtype = x.dtype
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    w = w.float()
    y = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("bhwc,cd->bhwd", xp[:, dy:dy + H, dx:dx + W],
                             w[dy, dx])
            y = t if y is None else y + t
    if ln_scale is not None:
        mean = y.mean(dim=-1, keepdim=True)
        d = y - mean
        var = (d * d).mean(dim=-1, keepdim=True)
        y = d * torch.rsqrt(var + 1e-5) * ln_scale.float() + ln_bias.float()
    y = apply_act(y, act)
    if residual is not None:
        y = y + residual.float()
    return y.to(dtype)


def _lib():
    from gwdepth_tpu_torch import _build

    lib = _build.load("conv3x3_ln_act")
    fn = lib.gw_conv3x3_ln_act
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, w, ln_scale, ln_bias, residual, act, backward=False):
    from gwdepth_tpu_torch import _build

    if not x.is_cuda:
        raise ValueError(f"conv3x3_ln_act: no kernel for device {x.device}")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    B, H, W, Ci = x.shape
    if tuple(w.shape[:3]) != (3, 3, Ci):
        raise ValueError(f"w {tuple(w.shape)} does not fit x {tuple(x.shape)}")
    Co = w.shape[3]
    if Co > MAX_CO or H > 65535:
        raise ValueError(f"conv3x3_ln_act kernel takes Co <= {MAX_CO} and "
                         f"H <= 65535, got Co={Co}, H={H}")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias go together")
    if residual is not None and tuple(residual.shape) != (B, H, W, Co):
        raise ValueError(f"residual {tuple(residual.shape)} != output "
                         f"{(B, H, W, Co)}")
    args = [t for t in (w, ln_scale, ln_bias, residual) if t is not None]
    for t in args:
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")

    def ptr(t):
        return None if t is None else t.float().contiguous()

    x32, w32, g32, b32, r32 = (ptr(x), ptr(w), ptr(ln_scale), ptr(ln_bias),
                               ptr(residual))
    y = torch.empty((B, H, W, Co), dtype=torch.float32, device=x.device)
    err = _lib().gw_conv3x3_ln_act(
        x32.data_ptr(), w32.data_ptr(),
        None if g32 is None else g32.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        None if r32 is None else r32.data_ptr(),
        y.data_ptr(), B, H, W, Ci, Co, _ACTS[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_ln_act launch")
    if backward:
        conv3x3_ln_act.bwd_launches += 1
    else:
        conv3x3_ln_act.launches += 1
        conv3x3_ln_act.shape_launches[link_key(x, w, ln_scale, residual,
                                               act)] += 1
    return y


def link_key(x, w, ln_scale=None, residual=None, act=None):
    """(B, H, W, Ci, Co, act, has_ln, has_residual) of one call."""
    B, H, W, Ci = x.shape
    return (B, H, W, Ci, w.shape[3], act, ln_scale is not None,
            residual is not None)


def _forward(x, w, g, b, r, act):
    """One forward through the device's implementation."""
    if x.device.type == "cpu":
        return conv3x3_ln_act_plain(x, w, g, b, r, act)
    return _launch(x, w, g, b, r, act)


def _conv_bwd(x, w):
    """Bias-free conv for the backward (no LN, no act): the kernel on the
    card, in pieces of at most MAX_CO output channels; the plain version
    on the CPU."""
    if x.device.type == "cpu":
        return conv3x3_ln_act_plain(x, w)
    Co = w.shape[3]
    n = -(-Co // MAX_CO)
    if n == 1:
        return _launch(x, w, None, None, None, None, backward=True)
    step = -(-Co // n)
    return torch.cat([_launch(x, w[..., c0:c0 + step].contiguous(), None,
                              None, None, None, backward=True)
                      for c0 in range(0, Co, step)], dim=-1)


def fused_backward(x, w, g, b, act, ct, need_dx=True):
    """(dx, dw, dg, db) of act(LN(conv3x3(x, w))) for the cotangent ct,
    all float32 (dg/db None without LN, dx None when not needed)."""
    x = x.float()
    w = w.float()
    ct = ct.float()
    c = _conv_bwd(x, w)                               # pre-LN conv
    if g is None:
        dc = ct * act_grad_at(act, c)
        dg = db = None
    else:
        mu = c.mean(dim=-1, keepdim=True)
        d0 = c - mu
        inv = torch.rsqrt((d0 * d0).mean(dim=-1, keepdim=True) + 1e-5)
        xhat = d0 * inv
        n = xhat * g.float() + b.float()
        dn = ct * act_grad_at(act, n)
        dg = (dn * xhat).sum(dim=(0, 1, 2))
        db = dn.sum(dim=(0, 1, 2))
        dxh = dn * g.float()
        dc = inv * (dxh - dxh.mean(dim=-1, keepdim=True)
                    - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    dx = None
    if need_dx:
        w_flip = w.flip(0, 1).transpose(2, 3).contiguous()   # (3,3,Co,Ci)
        dx = _conv_bwd(dc, w_flip)
    B, H, W, Ci = x.shape
    Co = w.shape[3]
    xpad = F.pad(x, (0, 0, 1, 1, 1, 1))
    dcm = dc.reshape(-1, Co)
    dw = torch.stack([
        torch.stack([xpad[:, ky:ky + H, kx:kx + W].reshape(-1, Ci).t() @ dcm
                     for kx in range(3)])
        for ky in range(3)])                                 # (3,3,Ci,Co)
    return dx, dw, dg, db


class _Conv3x3LnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g, b, r, act):
        ctx.act = act
        ctx.has_r = r is not None
        ctx.save_for_backward(x, w, g, b)
        return _forward(x, w, g, b, r, act).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        x, w, g, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, dg, db = fused_backward(x, w, g, b, ctx.act, ct,
                                        need_dx=need[0])
        return (None if dx is None else dx.to(x.dtype), dw.to(w.dtype),
                None if dg is None else dg.to(g.dtype),
                None if db is None else db.to(b.dtype),
                ct if ctx.has_r and need[4] else None, None)


def conv3x3_ln_act(x: torch.Tensor, w: torch.Tensor,
                   ln_scale: Optional[torch.Tensor] = None,
                   ln_bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """y = act(LN(conv3x3(x))) [+ residual], differentiable. CPU tensors
    take the plain version; CUDA tensors launch the kernel, forward and
    backward."""
    return _Conv3x3LnAct.apply(x, w, ln_scale, ln_bias, residual, act)


conv3x3_ln_act.launches = 0
conv3x3_ln_act.shape_launches = Counter()       # link_key -> launches
conv3x3_ln_act.bwd_launches = 0


def reset_counts() -> None:
    conv3x3_ln_act.launches = 0
    conv3x3_ln_act.shape_launches.clear()
    conv3x3_ln_act.bwd_launches = 0
