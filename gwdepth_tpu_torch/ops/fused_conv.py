"""K2: fused 3x3 conv + channel LayerNorm + activation (+ residual).

`conv3x3_ln_act(x, w, ln_scale, ln_bias, residual, act, fast=True)` keeps
the JAX layout: x (B, H, W, Ci) NHWC, w (3, 3, Ci, Co) HWIO, bias-free,
stride 1, SAME zero borders; LayerNorm over Co (eps 1e-5, affine),
skipped when `ln_scale` is None; act None | 'gelu' (exact) | 'elu'; the
residual is added after the activation.

Precision, as in the JAX package's `conv3x3_ln_act`: `fast=True` (what
the model path runs there, `fused_conv_ln_act` and its backward) rounds x
and w to bfloat16, round to nearest even as `astype`, and contracts in
float32. The product of two bf16 numbers is exact in float32, so two
implementations of it differ only by the order of the float32 sums.
`fast=False` contracts the float32 operands.

A CUDA tensor launches the hand-written kernel `csrc/conv3x3_ln_act.cu`
(bf16 tensor cores, float32 accumulation; it replaces the Pallas TPU
kernel `gwdepth_tpu/ops/fused_conv.py:conv3x3_ln_act`); a CPU tensor
takes `conv3x3_ln_act_plain`. Nothing falls back: a CUDA tensor the
kernel cannot take raises, `fast=False` among them.

Binding: the kernel is the custom op `gwdepth::conv3x3_ln_act`
(`torch.library`; `act` "none" for None), so `torch.export` records it
as one node of the graph. Its real implementation dispatches by device
and is the only code that reads streams or pointers; its fake
implementation gives a tracer the float32 (B, H, W, Co) result.

Gradients, registered on the op, mirror the JAX package's `_fused_bwd`
(`gwdepth_tpu/ops/fused_conv.py:444-489`): the backward recomputes the
pre-LN conv with the same kernel (no LN, no activation), runs the
per-pixel LayerNorm and activation backward in plain torch, computes dx
with the kernel on the rotated, io-transposed weights (3, 3, Co, Ci),
both in the forward's precision, and dw as 9 shifted-slice float32
matmuls over the unrounded x. dx has Ci output channels; above the
kernel's `MAX_CO` it is split into equal channel pieces, which is exact
without a LayerNorm. On a CPU tensor the same backward runs with the
plain conv in place of the kernel. The residual's gradient passes
straight through. The backward's launches go through `_launch`
directly: they are not yet nodes a tracer of the backward can record.

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

from gwdepth_tpu_torch import graphs
from gwdepth_tpu_torch._build import refuse_dtensor

_ACTS = {None: 0, "gelu": 1, "elu": 2}
MAX_CO = 256
# output widths the kernel is built for (Co is padded up to one): the N
# of its wgmma.m64nNk16 instances
CO_PADS = (16, 32, 48, 64, 80, 96, 128, 160, 192, 256)
KC = 16            # input channels per K chunk of the kernel


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


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (round to nearest even), back in float32."""
    return t.float().to(torch.bfloat16).float()


def _taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free 3x3 SAME conv, NHWC x HWIO, as 9 shifted-slice float32
    contractions."""
    B, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    y = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("bhwc,cd->bhwd", xp[:, dy:dy + H, dx:dx + W],
                             w[dy, dx])
            y = t if y is None else y + t
    return y


def _weight_grad(x: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """dw (3, 3, Ci, Co) of the conv for the cotangent dc of its output:
    per tap, the shifted x contracted with dc over every pixel."""
    B, H, W, Ci = x.shape
    xpad = F.pad(x, (0, 0, 1, 1, 1, 1))
    dcm = dc.reshape(-1, dc.shape[-1])
    return torch.stack([
        torch.stack([xpad[:, ky:ky + H, kx:kx + W].reshape(-1, Ci).t() @ dcm
                     for kx in range(3)])
        for ky in range(3)])


class _PlainConv(torch.autograd.Function):
    """The plain version's conv, x and w rounded to bf16 when `fast`, with
    the JAX package's VJP of it (`_fused_bwd`): dx is the same conv of the
    cotangent on the rotated, io-transposed weights (both rounded when
    `fast`), dw the float32 contraction over the unrounded x."""

    @staticmethod
    def forward(ctx, x, w, fast):
        ctx.save_for_backward(x, w)
        ctx.fast = fast
        rnd = round_bf16 if fast else torch.Tensor.float
        return _taps(rnd(x), rnd(w))

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        rnd = round_bf16 if ctx.fast else torch.Tensor.float
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _taps(rnd(dc), rnd(w.flip(0, 1).transpose(2, 3)))
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x.float(), dc.float()).to(w.dtype)
        return dx, dw, None


def conv3x3_ln_act_plain(x, w, ln_scale=None, ln_bias=None, residual=None,
                         act=None, fast=True):
    """Plain PyTorch version of the kernel: the conv of x and w rounded to
    bf16 when `fast`, as 9 shifted-slice float32 contractions, then
    LayerNorm, activation, residual, in float32. Differentiable with the
    JAX package's VJP (`_PlainConv`), so autograd through it is the plain
    version of K2's backward too."""
    dtype = x.dtype
    y = _PlainConv.apply(x, w, fast)
    if ln_scale is not None:
        mean = y.mean(dim=-1, keepdim=True)
        d = y - mean
        var = (d * d).mean(dim=-1, keepdim=True)
        y = d * torch.rsqrt(var + 1e-5) * ln_scale.float() + ln_bias.float()
    y = apply_act(y, act)
    if residual is not None:
        y = y + residual.float()
    return y.to(dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of `csrc/conv3x3_ln_act.cu`."""
    if lib.gw_conv3x3_ln_act.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        L = ctypes.c_longlong
        lib.gw_conv3x3_ln_act.argtypes = [P] * 6 + [I] * 8 + [P]
        lib.gw_conv3x3_ln_act.restype = I
        lib.gw_conv3x3_tile_weights.argtypes = [P] + [L] * 5 + [I] * 3 + [P,
                                                                          P]
        lib.gw_conv3x3_tile_weights.restype = I
        lib.gw_conv3x3_ln_act_tile.argtypes = [I] * 4
        lib.gw_conv3x3_ln_act_tile.restype = I
    return lib


def _lib():
    from gwdepth_tpu_torch import _build

    return bind(_build.load("conv3x3_ln_act"))


def co_pad(co: int) -> int:
    """The kernel's padded output width for Co channels."""
    for p in CO_PADS:
        if co <= p:
            return p
    raise ValueError(f"conv3x3_ln_act kernel takes Co <= {MAX_CO}, got {co}")


def weight_view(w: torch.Tensor, flip: bool = False):
    """(Ci, Co, offset, strides) of the conv weight the kernel multiplies:
    w (3, 3, Ci, Co) itself, or with `flip` the backward's rotated,
    io-transposed w[2 - ky, 2 - kx, co, ci], read in place through
    (possibly negative) element strides from w's first element."""
    s0, s1, s2, s3 = w.stride()
    if not flip:
        return w.shape[2], w.shape[3], 0, (s0, s1, s2, s3)
    return w.shape[3], w.shape[2], 2 * s0 + 2 * s1, (-s0, -s1, s3, s2)


def tile_weights(w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The kernel's bf16 copy of a CUDA weight (see `weight_view`):
    (ceil(Ci / 16), 9, co_pad(Co), 16), zero past Ci and Co; K chunk c
    holds input channels 16 c .. 16 c + 15, k innermost. Rounded to
    nearest even, as `astype`, by one launch of the library's tiling
    kernel."""
    from gwdepth_tpu_torch import _build

    w = w.float()
    Ci, Co, off, st = weight_view(w, flip)
    cp = co_pad(Co)
    wt = torch.empty((-(-Ci // KC), 9, cp, KC), dtype=torch.bfloat16,
                     device=w.device)
    err = _lib().gw_conv3x3_tile_weights(
        w.data_ptr(), off, *st, Ci, Co, cp, wt.data_ptr(),
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "conv3x3_ln_act weight tiling")
    return wt


def kernel_tile(B: int, H: int, W: int, co: int):
    """(m16 tiles per warp, warps) of the kernel's block for this plane:
    a block covers MT * warps / 2 rows of 32 pixels."""
    code = _lib().gw_conv3x3_ln_act_tile(B, H, W, co_pad(co))
    return code // 100, code % 100


def _launch(x, w, ln_scale, ln_bias, residual, act, fast, backward=False,
            flip=False):
    """One kernel launch for the conv of x with w, or with `flip` with w's
    rotated, io-transposed view (the backward's dx conv)."""
    from gwdepth_tpu_torch import _build

    if not x.is_cuda:
        raise ValueError(f"conv3x3_ln_act: no kernel for device {x.device}")
    if not fast:
        raise ValueError("conv3x3_ln_act kernel multiplies bf16 taps "
                         "(fast=True); fast=False has no kernel")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    B, H, W, Ci = x.shape
    wCi, Co, _, _ = weight_view(w, flip)
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or wCi != Ci:
        raise ValueError(f"w {tuple(w.shape)} does not fit x {tuple(x.shape)}")
    if Co > MAX_CO or H > 65535 or B > 65535:
        raise ValueError(f"conv3x3_ln_act kernel takes Co <= {MAX_CO}, "
                         f"H <= 65535 and B <= 65535, got Co={Co}, H={H}, "
                         f"B={B}")
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

    x32, g32, b32, r32 = (ptr(x), ptr(ln_scale), ptr(ln_bias),
                          ptr(residual))
    wt = tile_weights(w, flip)
    # widest load of x (4, 2 or 1 floats) its alignment and Ci allow
    vec = next(v for v in (4, 2, 1)
               if Ci % v == 0 and x32.data_ptr() % (4 * v) == 0)
    y = torch.empty((B, H, W, Co), dtype=torch.float32, device=x.device)
    err = _lib().gw_conv3x3_ln_act(
        x32.data_ptr(), wt.data_ptr(),
        None if g32 is None else g32.data_ptr(),
        None if b32 is None else b32.data_ptr(),
        None if r32 is None else r32.data_ptr(),
        y.data_ptr(), B, H, W, Ci, Co, wt.shape[2], _ACTS[act], vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_ln_act launch")
    if backward:
        graphs.count(conv3x3_ln_act, "bwd_launches")
    else:
        graphs.count(conv3x3_ln_act, "launches")
        graphs.count(conv3x3_ln_act, "shape_launches",
                     link_key(x, w, ln_scale, residual, act))
    return y


def link_key(x, w, ln_scale=None, residual=None, act=None):
    """(B, H, W, Ci, Co, act, has_ln, has_residual) of one call."""
    B, H, W, Ci = x.shape
    return (B, H, W, Ci, w.shape[3], act, ln_scale is not None,
            residual is not None)


def _conv_bwd(x, w, fast=True, flip=False):
    """Bias-free conv for the backward (no LN, no act) of x with w, or with
    `flip` with w's rotated, io-transposed view (dx): the kernel on the
    card, in pieces of at most MAX_CO output channels; the plain version
    on the CPU."""
    if x.device.type == "cpu":
        return conv3x3_ln_act_plain(
            x, w.flip(0, 1).transpose(2, 3) if flip else w, fast=fast)
    Co = weight_view(w, flip)[1]
    n = -(-Co // MAX_CO)
    if n == 1:
        return _launch(x, w, None, None, None, None, fast, backward=True,
                       flip=flip)
    step = -(-Co // n)

    def piece(c0):                 # output channels c0 .. c0 + step
        wp = w[:, :, c0:c0 + step] if flip else w[..., c0:c0 + step]
        return _launch(x, wp, None, None, None, None, fast, backward=True,
                       flip=flip)

    return torch.cat([piece(c0) for c0 in range(0, Co, step)], dim=-1)


def fused_backward(x, w, g, b, act, ct, need_dx=True, fast=True):
    """(dx, dw, dg, db) of act(LN(conv3x3(x, w))) for the cotangent ct,
    all float32 (dg/db None without LN, dx None when not needed). The
    recompute and dx run in the forward's precision (`fast`: bf16 taps,
    so dc and the flipped weights are rounded too); dw contracts the
    unrounded float32 x and dc, as the JAX package does outside Pallas."""
    x = x.float()
    w = w.float()
    ct = ct.float()
    c = _conv_bwd(x, w, fast)                         # pre-LN conv
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
        dx = _conv_bwd(dc, w, fast, flip=True)   # w rotated, io-transposed
    return dx, _weight_grad(x, dc), dg, db


@torch.library.custom_op("gwdepth::conv3x3_ln_act", mutates_args=())
def _op(x: torch.Tensor, w: torch.Tensor, ln_scale: Optional[torch.Tensor],
        ln_bias: Optional[torch.Tensor], residual: Optional[torch.Tensor],
        act: str, fast: bool) -> torch.Tensor:
    """The op's real implementation: the float32 (B, H, W, Co) output;
    `act` is "none" where the Python entry takes None."""
    args = (x, w, ln_scale, ln_bias, residual,
            None if act == "none" else act, fast)
    if x.device.type == "cpu":
        return conv3x3_ln_act_plain(*args).float()
    return _launch(*args)


@_op.register_fake
def _(x, w, ln_scale, ln_bias, residual, act, fast):
    return x.new_empty((*x.shape[:3], w.shape[3]), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    x, w, g, b, r, act, fast = inputs
    ctx.act = None if act == "none" else act
    ctx.fast = fast
    ctx.has_r = r is not None
    ctx.save_for_backward(x, w, g, b)


def _backward(ctx, ct):
    x, w, g, b = ctx.saved_tensors
    need = ctx.needs_input_grad
    dx, dw, dg, db = fused_backward(x, w, g, b, ctx.act, ct,
                                    need_dx=need[0], fast=ctx.fast)
    return (None if dx is None else dx.to(x.dtype), dw.to(w.dtype),
            None if dg is None else dg.to(g.dtype),
            None if db is None else db.to(b.dtype),
            ct if ctx.has_r and need[4] else None, None, None)


_op.register_autograd(_backward, setup_context=_setup_context)


def conv3x3_ln_act(x: torch.Tensor, w: torch.Tensor,
                   ln_scale: Optional[torch.Tensor] = None,
                   ln_bias: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   act: Optional[str] = None,
                   fast: bool = True) -> torch.Tensor:
    """y = act(LN(conv3x3(x))) [+ residual] in x's dtype, differentiable,
    through the custom op; bf16 taps with float32 accumulation when
    `fast`. CPU tensors take the plain version; CUDA tensors launch the
    kernel, forward and backward, and raise for `fast=False`; other
    devices, and a DTensor operand, raise."""
    refuse_dtensor("conv3x3_ln_act", x, w, ln_scale, ln_bias, residual)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_ln_act: no kernel for device {x.device}")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return _op(x, w, ln_scale, ln_bias, residual,
               "none" if act is None else act, fast).to(x.dtype)


conv3x3_ln_act.launches = 0
conv3x3_ln_act.shape_launches = Counter()       # link_key -> launches
conv3x3_ln_act.bwd_launches = 0


def reset_counts() -> None:
    conv3x3_ln_act.launches = 0
    conv3x3_ln_act.shape_launches.clear()
    conv3x3_ln_act.bwd_launches = 0
