"""Shifted-window helpers as reshapes/permutes, and the SW-MSA mask."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gwdepth_tpu_torch.ops.tables import device_table


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C). H, W multiples of ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int,
                   W: int) -> torch.Tensor:
    """(B * nH * nW, ws*ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def _region_ids(size: int, ws: int, shift: int) -> np.ndarray:
    """Region index (0/1/2) along one axis: [0, size-ws), [size-ws,
    size-shift), [size-shift, size)."""
    idx = np.arange(size)
    region = np.zeros(size, dtype=np.int32)
    region[(idx >= size - ws) & (idx < size - shift)] = 1
    region[idx >= size - shift] = 2
    return region


@functools.lru_cache(maxsize=None)
def _mask_np(Hp: int, Wp: int, ws: int, shift: int, neg: float) -> np.ndarray:
    rh = _region_ids(Hp, ws, shift)
    rw = _region_ids(Wp, ws, shift)
    img = (rh[:, None] * 3 + rw[None, :]).astype(np.float32)
    win = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)                       # (nW, ws*ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, np.float32(neg), np.float32(0.0))


def shifted_window_attn_mask(Hp: int, Wp: int, ws: int, shift: int,
                             neg: float = -100.0,
                             device=None) -> torch.Tensor:
    """Additive attention bias (nW, ws*ws, ws*ws): 0 within one shifted
    region, `neg` across regions; built once per shape and device
    (`ops/tables.py`)."""
    return device_table(("sw_mask", Hp, Wp, ws, shift, neg),
                        lambda: _mask_np(Hp, Wp, ws, shift, neg), device)


def pad_to_window_multiple(x: torch.Tensor, ws: int) -> torch.Tensor:
    """Pad (B, H, W, C) on the bottom/right to multiples of `ws`."""
    _, H, W, _ = x.shape
    pad_b = (ws - H % ws) % ws
    pad_r = (ws - W % ws) % ws
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
