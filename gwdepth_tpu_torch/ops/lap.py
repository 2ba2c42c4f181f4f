"""Hungarian matching of predicted lines to padded ground-truth slots.

`match_lines` solves every (layer, image) assignment on the host with
scipy's `linear_sum_assignment`, on the cost detached from the graph, as
the original code's `@torch.no_grad` matcher does. It keeps the JAX
package's convention (`gwdepth_tpu/ops/lap.py:match_lines`): the result
is `tgt2query`, the matched query of each target slot, and slots at or
past `n_valid` are ignored (they get query 0). Where the optimum is tied,
scipy may pick another assignment than the JAX package's on-device JV
solver; the matched cost, and so the loss, is the same.

All costs of a step cross to the host in ONE copy (cost and target
counts packed into one tensor), so the matcher costs one device sync per
criterion call. `match_lines.calls` counts the calls and
`match_lines.solve_seconds` sums the host time spent after that copy (the
scipy solves), so a run can report the matcher's share of a step.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def match_lines(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """cost (..., Q, T) with T <= Q, n_valid (...) real targets per
    problem -> tgt2query (..., T) int64 on cost's device."""
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
    match_lines.calls += 1
    match_lines.solve_seconds += time.perf_counter() - t0
    return torch.from_numpy(out.reshape(*lead, T)).to(cost.device)


match_lines.calls = 0
match_lines.solve_seconds = 0.0
