"""Shifted-window transformer blocks with line-reference attention, NHWC.

- `RefWindowAttention`: Swin W-MSA whose query is replaced by an
  attention-weighted mix of line-reference features; the query->reference
  attention map is diffused by kernel K1 (`ops/ref_attn_diffusion.py`)
  with `use_pallas`, as in the JAX package, else by `diffusion_torch`.
- `WindowClassAttention`: W-MSA plus per-pixel depth/seg class-token
  channel cross-attention; with `group_attention` its queries are first
  replaced by the same reference mixture (K1 at the class-layer planes).
- `PlainWindowAttention`: vanilla Swin attention (line branch off).
- `SwinBlock` / `SwinLayer`: pad -> cyclic shift -> window partition ->
  attention -> reverse, with the reference-point coordinate roll; with
  `token_fuse` a class block ends with `geometry.PointGuidedTokenFuse`.

Kept quirks of the original code:
- shifted ref coords below -1 are *reflected* (new = -2 - old), not
  wrapped (`roll_ref_coords`);
- ref features are sampled from the padded map, ref pos-embeds from the
  unpadded one;
- both depth and seg tokens go through the same `proj_dth` projection.

Parameter names follow the original PyTorch code (`attn.qkv`,
`attn.ref_qk`, `attn.ref_attn_diffusion`, `attn.proj_dth`, ...): the JAX
package's `ref` sub-module is flattened into `attn`, as there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gwdepth_tpu_torch.ops.grid_sample import grid_sample_nhwc
from gwdepth_tpu_torch.ops.ref_attn_diffusion import (diffusion_torch,
                                                      ref_attn_diffusion)
from gwdepth_tpu_torch.ops.window_msa import window_msa_kernel
from gwdepth_tpu_torch.ops.window import (shifted_window_attn_mask,
                                          window_partition, window_reverse)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


class RelPosBias(nn.Module):
    """Owns `relative_position_bias_table` and the integer
    `relative_position_index` buffer; mixed into each attention module so
    the names sit directly under `attn`."""

    def _init_rel_pos(self, ws: int, heads: int) -> None:
        self.window_size = ws
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(ws).astype(np.int64)))

    def rel_pos_bias(self) -> torch.Tensor:
        """(heads, N, N)."""
        N = self.window_size ** 2
        idx = self.relative_position_index.reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(N, N, -1)
        return bias.permute(2, 0, 1)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., N, C) -> (..., heads, N, C/heads)"""
    *lead, N, C = x.shape
    return x.reshape(*lead, N, heads, C // heads).movedim(-2, -3)


def window_msa(q, k, v, bias: torch.Tensor, mask: Optional[torch.Tensor],
               use_pallas: bool = False) -> torch.Tensor:
    """q/k/v (B, nW, nH, N, hd); bias (nH, N, N); mask (nW, N, N) additive
    or None. Returns (B, nW, N, nH*hd). Softmax in float32.

    `use_pallas` (the JAX package's name for the flag) routes through
    kernel K3, `ops/window_msa.py:window_msa_kernel`: a CUDA tensor
    launches the CUDA kernel (and raises for N > 64 or hd > 32), a CPU
    tensor takes its plain version; the result is float32. No module
    passes it, as in the JAX package."""
    if use_pallas:
        return window_msa_kernel(q, k, v, bias, mask)
    logits = torch.einsum("bwhnd,bwhmd->bwhnm", q, k).float()
    logits = logits + bias[None, None]
    if mask is not None:
        logits = logits + mask[None, :, None]
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bwhnm,bwhmd->bwhnd", attn, v)
    B, nW, nH, N, hd = out.shape
    return out.movedim(2, 3).reshape(B, nW, N, nH * hd)


class RefAttnDiffusion(nn.Module):
    """3-step conv diffusion of the query->reference attention map (kernel
    K1 with `use_pallas`, else `diffusion_torch`). `weight` (H, H, 3, 3)
    and `bias` (H,) as the original's `nn.Conv2d(heads, heads, 3,
    padding=1)`."""

    def __init__(self, heads: int, use_pallas: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.weight = nn.Parameter(torch.zeros(heads, heads, 3, 3))
        self.bias = nn.Parameter(torch.zeros(heads))

    def forward(self, ref_attn: torch.Tensor) -> torch.Tensor:
        """ref_attn (B, nW, H, N, R) -> same."""
        B, nW, H, N, R = ref_attn.shape
        a = ref_attn.permute(0, 1, 3, 4, 2).reshape(B, nW * N, R, H)
        diffuse = ref_attn_diffusion if self.use_pallas else diffusion_torch
        a = diffuse(a, self.weight.permute(2, 3, 1, 0), self.bias).to(a.dtype)
        return a.reshape(B, nW, N, R, H).permute(0, 1, 4, 2, 3)


class RefQuery:
    """Owns the reference-mixture parameters (`ref_qk`, `diff_mu`,
    `diff_logsigma`, `ref_attn_diffusion`), mixed into the attention
    modules that replace their queries, so the names sit directly under
    `attn`."""

    def _init_ref_query(self, dim: int, heads: int,
                        use_pallas: bool) -> None:
        self.ref_qk = nn.Linear(dim, 2 * dim)
        self.diff_mu = nn.Parameter(torch.zeros(1, 1, dim))
        self.diff_logsigma = nn.Parameter(torch.zeros(1, 1, dim))
        self.ref_attn_diffusion = RefAttnDiffusion(heads, use_pallas)


def ref_query_mixture(attn: RefQuery, q: torch.Tensor,
                      x_ref: torch.Tensor) -> torch.Tensor:
    """Replace window queries by an attention-weighted mixture of line
    reference tokens: mu/sigma reparameterized ref queries, K1 diffusion of
    the query->ref attention map, softmax mix.
    q (B, nW, H, N, hd), already scaled; x_ref (B, n_rf, C)."""
    H = attn.num_heads
    C = x_ref.shape[-1]
    ref_q, ref_v = attn.ref_qk(x_ref).split(C, dim=-1)
    ref_q = attn.diff_mu + torch.exp(attn.diff_logsigma) * ref_q
    ref_q = _split_heads(ref_q, H)                   # (B, H, n_rf, hd)
    ref_v = _split_heads(ref_v, H)
    ref_attn = torch.einsum("bwhnd,bhrd->bwhnr", q, ref_q)
    ref_attn = attn.ref_attn_diffusion(ref_attn.to(x_ref.dtype))
    ref_attn = torch.softmax(ref_attn.float(), dim=-1).to(x_ref.dtype)
    return torch.einsum("bwhnr,bhrd->bwhnd", ref_attn, ref_v)


class RefWindowAttention(RelPosBias, RefQuery):
    """Line-referenced W-MSA."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self._init_rel_pos(window_size, num_heads)
        self._init_ref_query(dim, num_heads, use_pallas)

    def forward(self, x, x_ref, mask):
        """x (B, nW, N, C); x_ref (B, n_rf, C); mask (nW, N, N) or None."""
        C = x.shape[-1]
        H = self.num_heads
        scale = (C // H) ** -0.5
        q, k, v = (_split_heads(t, H) for t in self.qkv(x).split(C, dim=-1))
        q_new = ref_query_mixture(self, q * scale, x_ref)
        out = window_msa(q_new * scale, k, v, self.rel_pos_bias(), mask)
        return self.proj(out)


class PlainWindowAttention(RelPosBias):
    """Vanilla Swin W-MSA, for the 1/32 layer when the line branch is off."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self._init_rel_pos(window_size, num_heads)

    def forward(self, x, mask):
        C = x.shape[-1]
        H = self.num_heads
        q, k, v = (_split_heads(t, H) for t in self.qkv(x).split(C, dim=-1))
        out = window_msa(q * (C // H) ** -0.5, k, v, self.rel_pos_bias(), mask)
        return self.proj(out)


class WindowClassAttention(RelPosBias, RefQuery):
    """W-MSA plus depth/seg class-token channel cross-attention: each token
    stream queries, over its channel groups, the concat of the window
    features and both token streams. With `group_attention` the scaled
    queries are replaced by the reference mixture (`ref_query_mixture`),
    scaled again."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 token_dim: int, group_attention: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.token_dim = token_dim
        self.group_attention = group_attention
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self._init_rel_pos(window_size, num_heads)
        if group_attention:
            self._init_ref_query(dim, num_heads, use_pallas)
        tx = dim + 2 * token_dim
        self.cls_dth_q = nn.Linear(token_dim, token_dim)
        self.cls_seg_q = nn.Linear(token_dim, token_dim)
        self.global_k = nn.Linear(tx, tx)
        self.global_v = nn.Linear(tx, tx)
        self.proj_dth = nn.Linear(token_dim, token_dim)

    def forward(self, x, depth_token, seg_token, mask, x_ref=None):
        """x (B, nW, N, C); tokens (B, nW, N, tC); x_ref (B, n_rf, C) with
        group_attention."""
        B, nW, N, C = x.shape
        H = self.num_heads
        tC = self.token_dim
        scale = (C // H) ** -0.5
        q, k, v = (_split_heads(t, H) for t in self.qkv(x).split(C, dim=-1))
        q = q * scale
        if self.group_attention and x_ref is not None:
            q = ref_query_mixture(self, q, x_ref) * scale
        out = window_msa(q, k, v, self.rel_pos_bias(), mask)
        x_out = self.proj(out)

        dq = _split_heads(self.cls_dth_q(depth_token), H) * scale
        sq = _split_heads(self.cls_seg_q(seg_token), H) * scale
        t_x = torch.cat([x_out, depth_token, seg_token], dim=-1)
        tk = _split_heads(self.global_k(t_x), H)
        tv = _split_heads(self.global_v(t_x), H)
        # both streams attend over the same tk/tv, channel groups as rows
        d_tok = tC // H
        q2 = torch.cat([dq, sq], dim=-1)                 # (B,nW,H,N,2d)
        a = torch.einsum("bwhnd,bwhne->bwhde", q2, tk).float()
        a = torch.softmax(a, dim=-1).to(tv.dtype)
        t2 = torch.einsum("bwhde,bwhne->bwhdn", a, tv)

        def finish(t):
            t = t.reshape(B, nW, H * d_tok, N).movedim(2, 3)
            return self.proj_dth(t)     # the original uses proj_dth for both

        return x_out, finish(t2[..., :d_tok, :]), finish(t2[..., d_tok:, :])


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def roll_ref_coords(ref: torch.Tensor, shift: int, Hp: int,
                    Wp: int) -> torch.Tensor:
    """Shift normalized [-1, 1] coords with the cyclic shift; values below
    -1 are reflected (new = -2 - old), as the original does."""
    rx = ref[..., 0] - (shift / (Wp - 1)) * 2.0
    ry = ref[..., 1] - (shift / (Hp - 1)) * 2.0
    rolled = torch.stack([rx, ry], dim=-1)
    return torch.where(rolled < -1.0, -2.0 - rolled, rolled)


def _pad_hw(x: torch.Tensor, Hp: int, Wp: int) -> torch.Tensor:
    _, H, W, _ = x.shape
    if H == Hp and W == Wp:
        return x
    return F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))


class SwinBlock(nn.Module):
    """One (shifted-)window block over an NHWC map, with line-reference
    attention ('ref'), class-token streams ('class', with the reference
    mixture where `group_attention`, and the point-guided depth-token
    fusion where `token_fuse`) or plain attention."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float, attn_kind: str,
                 token_dim: int = 0, group_attention: bool = False,
                 use_pallas: bool = False, token_fuse: bool = False):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.shift_size = shift_size
        self.attn_kind = attn_kind
        self.token_dim = token_dim
        self.token_fuse = token_fuse
        # the blocks that sample reference features
        self.need_ref = attn_kind == "ref" or (attn_kind == "class"
                                               and group_attention)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        if attn_kind == "ref":
            self.attn = RefWindowAttention(dim, window_size, num_heads,
                                           use_pallas)
        elif attn_kind == "class":
            self.attn = WindowClassAttention(dim, window_size, num_heads,
                                             token_dim, group_attention,
                                             use_pallas)
        else:
            self.attn = PlainWindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        if attn_kind == "class":
            tC = token_dim
            self.norm_depth1 = nn.LayerNorm(tC, eps=1e-5)
            self.norm_seg1 = nn.LayerNorm(tC, eps=1e-5)
            self.norm_depth2 = nn.LayerNorm(tC, eps=1e-5)
            self.norm_seg2 = nn.LayerNorm(tC, eps=1e-5)
            self.mlp_depth = Mlp(tC, int(tC * mlp_ratio), tC)
            self.mlp_seg = Mlp(tC, int(tC * mlp_ratio), tC)
        if token_fuse:
            from gwdepth_tpu_torch.models.geometry import PointGuidedTokenFuse
            self.token_relation = PointGuidedTokenFuse(dim, token_dim)

    def forward(self, x, ref_coords=None, ref_pos=None, depth_token=None,
                seg_token=None, token_pos=None):
        """x (B, H, W, C); ref_coords (B, L, P, 2) in [-1, 1]; ref_pos
        (B, H, W, C); tokens (B, H, W, tC); token_pos (B, H, W, tC), read
        by the token fusion."""
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift_size
        Hp = -(-H // ws) * ws
        Wp = -(-W // ws) * ws
        has_tokens = depth_token is not None
        tC = self.token_dim

        shortcut = x
        x = self.norm1(x)
        if has_tokens:
            d_shortcut, s_shortcut = depth_token, seg_token
            x = torch.cat([x, self.norm_depth1(depth_token),
                           self.norm_seg1(seg_token)], dim=-1)
        x = _pad_hw(x, Hp, Wp)
        # the reference features and the token fusion read the points
        use_ref = self.need_ref and ref_coords is not None
        fuse = self.token_fuse and ref_coords is not None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            attn_mask = shifted_window_attn_mask(Hp, Wp, ws, shift,
                                                 device=x.device)
            if use_ref or fuse:
                ref_coords = roll_ref_coords(ref_coords, shift, Hp, Wp)
                if use_ref and ref_pos is not None:
                    ref_pos = torch.roll(ref_pos, (-shift, -shift),
                                         dims=(1, 2))
        else:
            attn_mask = None

        x_ref = None
        if use_ref:
            x_ref = grid_sample_nhwc(x[..., :C], ref_coords, mode="nearest")
            if ref_pos is not None:
                x_ref = x_ref + grid_sample_nhwc(ref_pos, ref_coords,
                                                 mode="nearest")
            x_ref = x_ref.reshape(B, -1, C)

        nW = (Hp // ws) * (Wp // ws)
        xw = window_partition(x, ws).reshape(B, nW, ws * ws, x.shape[-1])
        if self.attn_kind == "ref":
            out = self.attn(xw, x_ref, attn_mask)
        elif self.attn_kind == "class":
            out, dw, sw = self.attn(xw[..., :C], xw[..., C:C + tC],
                                    xw[..., C + tC:], attn_mask, x_ref)
            out = torch.cat([out, dw, sw], dim=-1)
        else:
            out = self.attn(xw, attn_mask)

        out = window_reverse(out.reshape(-1, ws * ws, out.shape[-1]), ws,
                             Hp, Wp)
        if shift > 0:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        out = out[:, :H, :W]
        x = shortcut + out[..., :C]
        x = x + self.mlp(self.norm2(x))
        if has_tokens:
            depth_token = d_shortcut + out[..., C:C + tC]
            depth_token = depth_token + self.mlp_depth(
                self.norm_depth2(depth_token))
            seg_token = s_shortcut + out[..., C + tC:]
            seg_token = seg_token + self.mlp_seg(self.norm_seg2(seg_token))
            if fuse:
                # with the rolled coordinates, as the original
                depth_token = self.token_relation(x, seg_token, depth_token,
                                                  ref_coords, token_pos)
        return x, depth_token, seg_token


class SwinLayer(nn.Module):
    """`blocks.N`: SwinBlocks with alternating shift 0 / ws//2, block i
    with group attention where `group_blocks[i]`; `use_pallas` reaches the
    blocks' diffusion (K1)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, attn_kind: str,
                 token_dim: int = 0, group_blocks: Tuple[bool, ...] = (),
                 use_pallas: bool = False, token_fuse: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      attn_kind, token_dim,
                      i < len(group_blocks) and group_blocks[i], use_pallas,
                      token_fuse)
            for i in range(depth))

    def forward(self, x, ref_coords=None, ref_pos=None, depth_token=None,
                seg_token=None, token_pos=None):
        for blk in self.blocks:
            x, depth_token, seg_token = blk(x, ref_coords, ref_pos,
                                            depth_token, seg_token, token_pos)
        return x, depth_token, seg_token
