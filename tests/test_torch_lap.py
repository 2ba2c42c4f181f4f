"""The port's line matcher (`gwdepth_tpu_torch/ops/lap.py`) against the
JAX package's, on the CPU.

The plain JV solver runs JAX's `hungarian_rect` in the same float32
arithmetic and order, with the lowest column on ties, so its assignments
must equal JAX's (under `jax.jit`) exactly, ties included. The matched
cost is held to scipy's `linear_sum_assignment` at 1e-5 (scipy sums in
float64), and the criterion with `matcher_backend="jax"` to JAX's at
1e-6 (the same assignments; the losses reassociate float32 sums). The
CUDA kernel's checks are in tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from gwdepth_tpu.losses import criterion as jcrit
from gwdepth_tpu.ops import lap as jlap

from gwdepth_tpu_torch import main as port_main
from gwdepth_tpu_torch.losses import criterion as pcrit
from gwdepth_tpu_torch.ops import lap as plap
from gwdepth_tpu_torch.parallel.train_step import compute_losses

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import KW, _line_outputs, _t, _targets, _to_jax, \
    _to_port

# two shapes only, so JAX compiles hungarian_rect twice: T = Q and T < Q
SHAPES = {"square": (6, 6), "rect": (5, 9)}


@functools.lru_cache(maxsize=None)
def _jax_rect():
    return jax.jit(jlap.hungarian_rect)


def _costs(kind: str, T: int, Q: int, n: int, seed: int):
    """`n` seeded (T, Q) float32 costs: normal floats, or small integers
    (many exact ties), or one value repeated (every assignment tied)."""
    rng = np.random.default_rng(seed)
    if kind == "float":
        return rng.normal(size=(n, T, Q)).astype(np.float32)
    if kind == "int":
        return rng.integers(0, 3, size=(n, T, Q)).astype(np.float32)
    return np.full((n, T, Q), 0.25, np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["float", "int", "const"])
def test_plain_jv_assignments_equal_jax_hungarian_rect(shape, kind):
    T, Q = SHAPES[shape]
    costs = _costs(kind, T, Q, 12, seed=len(kind) * 10 + T)
    for k, c in enumerate(costs):
        for n_rows in (0, 1, T, k % (T + 1)):
            want = np.asarray(_jax_rect()(jnp.asarray(c), n_rows))
            got = plap.hungarian_rect(torch.from_numpy(c), n_rows)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{k} n={n_rows}")


@pytest.mark.parametrize("kind", ["float", "int"])
def test_plain_hungarian_equals_jax_hungarian(kind):
    T, Q = SHAPES["square"]
    jfn = jax.jit(jlap.hungarian)
    for k, c in enumerate(_costs(kind, T, Q, 8, seed=3)):
        np.testing.assert_array_equal(
            plap.hungarian(torch.from_numpy(c)).numpy(),
            np.asarray(jfn(jnp.asarray(c))), err_msg=str(k))


@pytest.mark.parametrize("kind", ["float", "int"])
def test_plain_jv_matched_cost_equals_scipy(kind):
    T, Q = 7, 11
    for k, c in enumerate(_costs(kind, T, Q, 10, seed=5)):
        n = 1 + k % T
        col = plap.hungarian_rect(torch.from_numpy(c), n).numpy()
        assert (col[n:] == -1).all() and len(set(col[:n])) == n
        rows, cols = linear_sum_assignment(c[:n].astype(np.float64))
        np.testing.assert_allclose(c[np.arange(n), col[:n]].sum(),
                                   c[rows, cols].sum(), rtol=1e-5, atol=1e-5)


def test_jv_plain_follows_jax_match_lines_with_padded_slots():
    """(L, B, Q, T) problems with n_valid from 0 to T: every slot past
    n_valid maps to query 0, the rest as JAX's vmapped match_lines."""
    rng = np.random.default_rng(6)
    L, B, Q, T = 2, 3, 9, 5
    cost = rng.normal(size=(L, B, Q, T)).astype(np.float32)
    cost[1, 2] = np.round(cost[1, 2])                  # ties
    n_valid = np.array([[0, 1, 5], [3, 5, 2]], np.int64)
    jfn = jax.jit(jax.vmap(jax.vmap(jlap.match_lines)))
    want = np.asarray(jfn(jnp.asarray(cost), jnp.asarray(n_valid)))
    stats = {}
    got = plap.jv_plain(torch.from_numpy(cost), torch.from_numpy(n_valid),
                        stats)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 0] == 0).all() and (got[0, 1, 1:] == 0).all()
    assert stats["dijkstra_steps"] >= int(n_valid.sum())
    assert stats["augment_steps"] >= int(n_valid.sum())


@pytest.mark.parametrize("backend", ["jax", "scipy"])
def test_match_lines_backends(backend):
    rng = np.random.default_rng(7)
    cost = torch.from_numpy(rng.normal(size=(2, 4, 8, 6)).astype(np.float32))
    n_valid = torch.tensor([[6, 0, 3, 1], [2, 5, 6, 4]])
    calls = plap.match_lines.calls
    solve = plap.match_lines.solve_seconds
    launches = plap.lap_jv.launches
    got = plap.match_lines(cost, n_valid, backend)
    assert plap.match_lines.calls == calls + 1
    assert plap.lap_jv.launches == launches       # no kernel on the CPU
    assert (plap.match_lines.solve_seconds > solve) == (backend == "scipy")
    assert got.shape == (2, 4, 6) and got.dtype == torch.int64
    jv = plap.jv_plain(cost, n_valid)
    for idx in np.ndindex(2, 4):
        n = int(n_valid[idx])
        c = cost[idx].numpy()
        assert (got[idx][n:] == 0).all()
        assert len(set(got[idx][:n].tolist())) == n
        np.testing.assert_allclose(
            c[got[idx][:n].numpy(), np.arange(n)].sum(),
            c[jv[idx][:n].numpy(), np.arange(n)].sum(), rtol=1e-5, atol=1e-6)
    if backend == "jax":
        assert torch.equal(got, jv)
    with pytest.raises(ValueError, match="backend"):
        plap.match_lines(cost, n_valid, "hungarian")


def test_jv_stops_on_non_finite_costs():
    """NaN costs would send JAX's loops round forever: the plain version
    (and the kernel) stop the problem and leave its rows at query 0."""
    cost = torch.full((1, 6, 4), float("nan"))
    got = plap.jv_plain(cost, torch.tensor([4]))
    assert got.shape == (1, 4) and ((got >= 0) & (got < 6)).all()
    inf = torch.full((5, 5), float("inf"))
    assert plap.hungarian_rect(inf, 5).shape == (5,)


def test_lap_jv_op_and_refusals():
    rng = np.random.default_rng(8)
    cost = torch.from_numpy(rng.normal(size=(3, 7, 4)).astype(np.float32))
    n_valid = torch.tensor([4, 0, 2])
    torch.library.opcheck(torch.ops.gwdepth.lap_jv.default, (cost, n_valid),
                          test_utils=("test_schema", "test_faketensor"))
    assert torch.equal(plap.lap_jv(cost, n_valid),
                       plap.jv_plain(cost, n_valid))
    with pytest.raises(ValueError, match="no kernel"):
        plap.lap_jv(cost.to("meta"), n_valid.to("meta"))
    with pytest.raises(ValueError, match="plain version"):
        plap.hungarian_rect(cost[0].T.to("meta"), 2)


def _tied_outputs():
    """`test_torch_train.py::test_criterion_on_tied_costs_equals_jv_losses`'s
    inputs: identical predictions and a repeated target, so the costs tie."""
    rng = np.random.default_rng(1)
    out = _line_outputs(rng, n_aux=1)
    for o in [out] + out["aux_outputs"]:
        o["pred_lines"][:, 6:] = o["pred_lines"][:, :6]
        o["pred_logits"][:, 6:] = o["pred_logits"][:, :6]
    lines, mask = _targets(rng, counts=(6, 4))
    lines[:, 1] = lines[:, 0]
    return out, lines, mask


@pytest.mark.parametrize("focal", [False, True])
def test_criterion_jv_matcher_equals_jax_on_tied_costs(focal):
    out, lines, mask = _tied_outputs()
    want = jax.jit(functools.partial(
        jcrit.line_set_criterion, matcher_backend="jax", focal=focal,
        **KW))(_to_jax(out), jnp.asarray(lines), jnp.asarray(mask))
    got = pcrit.line_set_criterion(_to_port(out), _t(lines),
                                   torch.from_numpy(mask),
                                   matcher_backend="jax", focal=focal, **KW)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("matcher", ["jax", "scipy"])
def test_train_losses_route_by_cfg_matcher(matcher, monkeypatch):
    """`--matcher` reaches the config, and `compute_losses` (both criterion
    sites of the train and eval steps call it or the criterion with
    `cfg.matcher`) hands it to the matcher."""
    from gwdepth_tpu_torch.data.batch import dummy_batch

    args = port_main.build_argparser().parse_args(
        ["--tiny", "--matcher", matcher])
    cfg = port_main.config_from_args(args).replace(with_dense=False)
    assert cfg.matcher == matcher
    seen = []
    real = plap.match_lines

    def spy(cost, n_valid, backend="jax"):
        seen.append(backend)
        return real(cost, n_valid, backend)

    monkeypatch.setattr(pcrit, "match_lines", spy)
    batch = dummy_batch(cfg, 2, num_lines=3, seed=0)
    rng = np.random.default_rng(9)
    B, Q, D = 2, cfg.num_queries, cfg.line_dim
    outputs = {"pred_logits": _t(rng.normal(size=(B, Q, 2))),
               "pred_lines": _t(rng.uniform(size=(B, Q, D))),
               "aux_outputs": []}
    total, _ = compute_losses(cfg, outputs, batch)
    assert seen == [matcher] and torch.isfinite(total)
