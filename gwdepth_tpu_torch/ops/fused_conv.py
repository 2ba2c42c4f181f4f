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

Chains of links need no frame layout here: each link reads NHWC and masks
its SAME borders itself, which is what the TPU frame chain
(`fused_conv_ln_act_frame`) achieves by zeroing its junk columns.
"""

from __future__ import annotations

import ctypes
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


def _launch(x, w, ln_scale, ln_bias, residual, act):
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
    conv3x3_ln_act.launches += 1
    conv3x3_ln_act.shape_launches[link_key(x, w, ln_scale, residual, act)] += 1
    return y.to(x.dtype)


def link_key(x, w, ln_scale=None, residual=None, act=None):
    """(H, W, Ci, Co, act, has_ln, has_residual) of one call."""
    _, H, W, Ci = x.shape
    return (H, W, Ci, w.shape[3], act, ln_scale is not None,
            residual is not None)


def conv3x3_ln_act(x: torch.Tensor, w: torch.Tensor,
                   ln_scale: Optional[torch.Tensor] = None,
                   ln_bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """y = act(LN(conv3x3(x))) [+ residual]. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return conv3x3_ln_act_plain(x, w, ln_scale, ln_bias, residual, act)
    return _launch(x, w, ln_scale, ln_bias, residual, act)


conv3x3_ln_act.launches = 0
conv3x3_ln_act.shape_launches = Counter()   # link_key -> launches


def reset_counts() -> None:
    conv3x3_ln_act.launches = 0
    conv3x3_ln_act.shape_launches.clear()
