"""DETR-style line-query transformer (the line branch), post-norm.

Names follow the original PyTorch code: `encoder.layers.N.*`,
`decoder.layers.N.*`, `decoder.norm`, attention in torch's
`in_proj_weight` / `in_proj_bias` / `out_proj` layout. Padding is a
key-validity mask (True = real token).

Dropout sits at the JAX package's sites (`gwdepth_tpu/models/detr.py:57,
77,80,82,100,105,108,110`): attention weights, each residual branch and
the FFN hidden layer. It is active only in `train()` mode and draws its
masks from the `torch.Generator` the caller passes (the train step owns
one), as flax draws from its "dropout" key.

Precision, as the JAX package's `dtype` (`cfg.compute_dtype`): only the
attention's `out_proj` and the layers' `linear1` and `linear2` run in
it (`dense`). In bfloat16 their outputs are bf16, and each residual add
onto the float32 stream promotes back to float32, so the q/k/v
projections, the attention, every LayerNorm and `hs` stay float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_NEG = -1e9


def dropout(x: torch.Tensor, p: float, active: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - p, scale by 1/(1-p)."""
    if not active or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)`: in bfloat16, x and the float32 weight
    cast to bf16, the product rounded to bf16, then the bias cast to bf16
    and added in bf16 (two roundings, as flax); in float32 the layer."""
    if dtype == torch.float32:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + \
        layer.bias.to(dtype)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention-compatible in/out projections around
    scaled dot-product attention with an optional key-validity mask."""

    def __init__(self, d_model: int, nheads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nheads = nheads
        self.dropout = dropout
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query, key, value,
                key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query (B, Nq, C), key/value (B, Nk, C), key_valid (B, Nk) bool."""
        C = query.shape[-1]
        H = self.nheads
        hd = C // H
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:C], b[:C])
        k = F.linear(key, w[C:2 * C], b[C:2 * C])
        v = F.linear(value, w[2 * C:], b[2 * C:])
        B, Nq, _ = q.shape
        Nk = k.shape[1]
        q = q.reshape(B, Nq, H, hd).transpose(1, 2)
        k = k.reshape(B, Nk, H, hd).transpose(1, 2)
        v = v.reshape(B, Nk, H, hd).transpose(1, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (hd ** -0.5)
        if key_valid is not None:
            logits = torch.where(key_valid[:, None, None, :], logits,
                                 torch.full_like(logits, _NEG))
        attn = dropout(torch.softmax(logits, dim=-1), self.dropout,
                       self.training, generator)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return dense(self.out_proj, out.transpose(1, 2).reshape(B, Nq, C),
                     self.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nheads: int, dim_ff: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.self_attn = MultiheadAttention(d_model, nheads, dropout, dtype)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, key_valid, generator=None):
        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        qk = src + pos
        src = self.norm1(src + drop(self.self_attn(qk, qk, src, key_valid,
                                                   generator)))
        src2 = dense(self.linear2,
                     drop(F.relu(dense(self.linear1, src, self.dtype))),
                     self.dtype)
        return self.norm2(src + drop(src2))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nheads: int, dim_ff: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.self_attn = MultiheadAttention(d_model, nheads, dropout, dtype)
        self.multihead_attn = MultiheadAttention(d_model, nheads, dropout,
                                                 dtype)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, pos, query_pos, key_valid,
                generator=None):
        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        qk = tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(qk, qk, tgt, None,
                                                   generator)))
        tgt2 = self.multihead_attn(tgt + query_pos, memory + pos, memory,
                                   key_valid, generator)
        tgt = self.norm2(tgt + drop(tgt2))
        tgt2 = dense(self.linear2,
                     drop(F.relu(dense(self.linear1, tgt, self.dtype))),
                     self.dtype)
        return self.norm3(tgt + drop(tgt2))


class _Stack(nn.Module):
    """`layers` (+ optional final `norm`), the original module layout."""

    def __init__(self, layers, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class DETRTransformer(nn.Module):
    """Encoder over flattened 1/32 tokens, decoder over the line queries;
    returns every decoder layer's normed state and the encoder memory."""

    def __init__(self, d_model: int, nheads: int, enc_layers: int,
                 dec_layers: int, dim_ff: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = _Stack([EncoderLayer(d_model, nheads, dim_ff, dropout,
                                            dtype)
                               for _ in range(enc_layers)])
        self.decoder = _Stack([DecoderLayer(d_model, nheads, dim_ff, dropout,
                                            dtype)
                               for _ in range(dec_layers)],
                              nn.LayerNorm(d_model, eps=1e-5))

    def forward(self, src, pos, key_valid, query_embed,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """src/pos (B, N, C); key_valid (B, N) bool; query_embed (Q, C).
        Returns hs (L, B, Q, C) and memory (B, N, C)."""
        B = src.shape[0]
        memory = src
        for layer in self.encoder.layers:
            memory = layer(memory, pos, key_valid, generator)
        query_pos = query_embed[None].expand(B, -1, -1)
        out = torch.zeros_like(query_pos)
        inter = []
        for layer in self.decoder.layers:
            out = layer(out, memory, pos, query_pos, key_valid, generator)
            inter.append(self.decoder.norm(out))
        return torch.stack(inter, dim=0), memory


class MLP(nn.Module):
    """ReLU MLP head; `layers.N` as in the original."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(d, o) for d, o in zip(dims, [hidden] * (num_layers - 1)
                                            + [out_dim]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
