"""Hungarian matching of predicted lines to padded ground-truth slots.

`match_lines(cost, n_valid, backend)` keeps the JAX package's convention
(`gwdepth_tpu/ops/lap.py:match_lines`): the result is `tgt2query`, the
matched query of each target slot, and slots at or past `n_valid` get
query 0, as JAX clips them. The cost is detached first, as the original
code's `@torch.no_grad` matcher.

backend "jax" (the default, as in the JAX package) is the
Jonker-Volgenant shortest-augmenting-path solver of JAX's
`hungarian_rect`: on CUDA tensors one launch of `csrc/lap_jv.cu` solves
every (layer, image) problem on the card, with no copy to the host; on
CPU tensors `jv_plain` runs the same algorithm in PyTorch. Both keep
JAX's float32 arithmetic in its order (`r = minval + cost[i] - u[i] -
v`), its dual updates and its gate on rows >= n_valid, and take the
lowest column on ties, as `jnp.argmin` does, so their assignments equal
JAX's bit for bit on the same float32 cost.

backend "scipy" copies every cost of the call to the host in ONE copy
(cost and target counts packed into one tensor) and solves each problem
with scipy's `linear_sum_assignment` in float64: one device sync per
call. Where the optimum is tied it may pick another assignment than the
JV solver; the matched cost, and so the loss, is the same.

Counters: `match_lines.calls` counts calls of either backend,
`match_lines.solve_seconds` sums the scipy backend's host time after its
copy, and `lap_jv.launches` counts launches of the CUDA kernel.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

import numpy as np
import torch

from gwdepth_tpu_torch import graphs

_INF = 1e30


def hungarian_rect(cost: torch.Tensor, n_rows: int,
                   stats: Optional[dict] = None) -> torch.Tensor:
    """Rectangular JV on a CPU tensor, JAX's `hungarian_rect`: assign
    the first `n_rows` rows of a (T, Q) cost (T <= Q) to distinct
    columns at least total cost. Returns col4row (T,) int64, -1 for the
    rows it skips. `stats`, when given, gains the serial work done:
    "dijkstra_steps" (columns scanned) and "augment_steps".

    With finite costs a row's search ends within Q steps and its augment
    walk within T; where NaN or infinite costs would send JAX's loops
    round forever, those caps stop the solve and the remaining rows stay
    at -1 (`csrc/lap_jv.cu` stops at the same places)."""
    if cost.device.type != "cpu":
        raise ValueError(f"hungarian_rect is the plain version, for CPU "
                         f"tensors; {cost.device} costs go through "
                         "lap_jv")
    T, Q = cost.shape
    cost = cost.float()
    inf = torch.tensor(_INF, dtype=torch.float32)
    u = torch.zeros(T, dtype=torch.float32)
    v = torch.zeros(Q, dtype=torch.float32)
    col4row = [-1] * T
    row4col = [-1] * Q
    n_dij = n_aug = 0
    for cur in range(min(max(int(n_rows), 0), T)):
        # Dijkstra over the columns for the shortest augmenting path
        SR = torch.zeros(T, dtype=torch.bool)
        SC = torch.zeros(Q, dtype=torch.bool)
        spc = torch.full((Q,), _INF, dtype=torch.float32)
        path = torch.zeros(Q, dtype=torch.int64)
        i, minval, sink = cur, torch.zeros((), dtype=torch.float32), -1
        for _ in range(Q):
            SR[i] = True
            r = minval + cost[i] - u[i] - v
            upd = (r < spc) & ~SC
            path = torch.where(upd, i, path)
            spc = torch.where(upd, r, spc)
            masked = torch.where(SC, inf, spc)
            j = int(torch.argmin(masked))        # the lowest index on ties
            minval = masked[j]
            SC[j] = True
            n_dij += 1
            if row4col[j] < 0:
                sink = j
                break
            i = row4col[j]
        if sink < 0:
            break          # non-finite costs: stop, as the kernel does
        # dual updates (scipy rectangular_lsap.cpp semantics, JAX's order)
        spc_at = spc[torch.tensor([max(c, 0) for c in col4row])]
        others = SR.clone()
        others[cur] = False
        u[cur] = u[cur] + minval
        u = torch.where(others, u + minval - spc_at, u)
        v = torch.where(SC, v - (minval - spc), v)
        # augment along the alternating path
        j, ok = sink, False
        for _ in range(T):
            i = int(path[j])
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            n_aug += 1
            if i == cur:
                ok = True
                break
            if j < 0:
                break
        if not ok:
            break          # non-finite costs: stop, as the kernel does
    if stats is not None:
        stats["dijkstra_steps"] = stats.get("dijkstra_steps", 0) + n_dij
        stats["augment_steps"] = stats.get("augment_steps", 0) + n_aug
    return torch.tensor(col4row, dtype=torch.int64)


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost perfect matching on a square (n, n) CPU cost, JAX's
    `hungarian`: the rectangular solver with every row active. Returns
    col4row (n,) int64."""
    return hungarian_rect(cost, cost.shape[0])


def jv_plain(cost: torch.Tensor, n_valid: torch.Tensor,
             stats: Optional[dict] = None) -> torch.Tensor:
    """The kernel's plain version: cost (..., Q, T) with T <= Q, n_valid
    (...) -> tgt2query (..., T) int64, JAX's `match_lines(backend="jax")`
    per problem: the JV solver on the (T, Q) transpose, rows >= n_valid
    at query 0."""
    lead = cost.shape[:-2]
    Q, T = cost.shape[-2:]
    flat = cost.detach().float().reshape(-1, Q, T)
    counts = n_valid.reshape(-1).tolist()
    out = torch.zeros((flat.shape[0], T), dtype=torch.int64)
    for p, n in enumerate(counts):
        out[p] = hungarian_rect(flat[p].T, int(n), stats).clamp(0, Q - 1)
    return out.reshape(*lead, T)


def _lib():
    from gwdepth_tpu_torch import _build

    lib = _build.load("lap_jv")
    fn = lib.gw_lap_jv
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, P]
        fn.restype = I
    return lib


def _launch(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    from gwdepth_tpu_torch import _build

    if not cost.is_cuda:
        raise ValueError(f"lap_jv: no kernel for device {cost.device}")
    if n_valid.device != cost.device:
        raise ValueError(f"n_valid on {n_valid.device}, cost on "
                         f"{cost.device}")
    lead = cost.shape[:-2]
    Q, T = cost.shape[-2:]
    if tuple(n_valid.shape) != tuple(lead):
        raise ValueError(f"n_valid {tuple(n_valid.shape)} does not fit "
                         f"cost {tuple(cost.shape)}")
    if T > Q:
        raise ValueError(f"lap_jv matches T <= Q targets, got T={T}, Q={Q}")
    n = int(np.prod(lead)) if lead else 1
    c = cost.float().contiguous()
    nv = n_valid.to(torch.int64).contiguous()
    out = torch.empty((*lead, T), dtype=torch.int64, device=cost.device)
    if n == 0 or T == 0:
        return out
    err = _lib().gw_lap_jv(c.data_ptr(), nv.data_ptr(), out.data_ptr(), n,
                           Q, T, torch.cuda.current_stream(
                               cost.device).cuda_stream)
    _build.check(err, "lap_jv launch")
    graphs.count(lap_jv, "launches")
    return out


@torch.library.custom_op("gwdepth::lap_jv", mutates_args=())
def _op(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """The op's real implementation; no autograd: the output is integers
    and the cost is detached."""
    if cost.device.type == "cpu":
        return jv_plain(cost, n_valid)
    return _launch(cost, n_valid)


@_op.register_fake
def _(cost, n_valid):
    return cost.new_empty((*cost.shape[:-2], cost.shape[-1]),
                          dtype=torch.int64)


def lap_jv(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """cost (..., Q, T) with T <= Q, n_valid (...) -> tgt2query (..., T)
    int64 on cost's device, through the custom op: CPU tensors take
    `jv_plain`, CUDA tensors launch the kernel (every problem in one
    launch, no sync), other devices raise."""
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lap_jv: no kernel for device {cost.device}")
    return _op(cost.detach(), n_valid.detach())


lap_jv.launches = 0


def reset_counts() -> None:
    lap_jv.launches = 0
    match_lines.calls = 0
    match_lines.solve_seconds = 0.0


def _scipy(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    lead = cost.shape[:-2]
    Q, T = cost.shape[-2:]
    n = int(np.prod(lead)) if lead else 1
    packed = torch.cat([cost.detach().float().reshape(n, Q * T),
                        n_valid.detach().float().reshape(n, 1)],
                       dim=1).cpu().numpy()
    t0 = time.perf_counter()
    from scipy.optimize import linear_sum_assignment

    out = np.zeros((n, T), np.int64)
    for i in range(n):
        k = int(packed[i, -1])
        if k == 0:
            continue
        c = packed[i, :-1].reshape(Q, T)[:, :k].astype(np.float64)
        rows, cols = linear_sum_assignment(c)
        out[i, cols] = rows
    match_lines.solve_seconds += time.perf_counter() - t0
    return torch.from_numpy(out.reshape(*lead, T)).to(cost.device)


def match_lines(cost: torch.Tensor, n_valid: torch.Tensor,
                backend: str = "jax") -> torch.Tensor:
    """cost (..., Q, T) with T <= Q, n_valid (...) real targets per
    problem -> tgt2query (..., T) int64 on cost's device; `backend` "jax"
    (the JV solver: `lap_jv`) or "scipy" (the host path)."""
    if backend == "jax":
        out = lap_jv(cost, n_valid)
    elif backend == "scipy":
        out = _scipy(cost, n_valid)
    else:
        raise ValueError(f"matcher backend must be 'jax' or 'scipy', got "
                         f"{backend!r}")
    graphs.count(match_lines, "calls")
    return out


match_lines.calls = 0
match_lines.solve_seconds = 0.0
