"""The port's plane-normal loss (`gwdepth_tpu_torch/losses/plane.py`)
against the JAX package's (`gwdepth_tpu.losses.plane`), on the CPU, on
the same seeded numpy inputs: the Sobel gradients, the triangle masks,
the top-`num_ref` order on tied logits, and the loss, with triangles
whose corners fall on a rounding midpoint (round half to even on both
sides). Tolerance: 1e-5, scaled by max(1, |JAX value|); masks and
indices exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.losses import plane as jplane

from gwdepth_tpu_torch.losses import plane

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("B,H,W", [(1, 5, 7), (2, 17, 23), (2, 64, 96)])
def test_sobel_grad_matches_jax(B, H, W):
    depth = np.random.default_rng(H).uniform(0.5, 9.5, (B, H, W)).astype(
        np.float32)
    got = plane.sobel_grad(torch.from_numpy(depth))
    want = jplane.sobel_grad(jnp.asarray(depth))
    for g, w in zip(got, want):
        _close(g, w)


def test_point_in_triangle_matches_jax():
    rng = np.random.default_rng(0)
    H, W = 24, 31
    tri = rng.uniform(-3, 34, (2, 5, 3, 2)).astype(np.float32)
    tri[0, 0] = [[1, 1], [1, 1], [1, 1]]             # a point
    tri[0, 1] = [[0, 0], [10, 10], [20, 20]]         # a segment
    tri[1, 0] = np.round(tri[1, 0])                  # corners on pixels
    got = plane.point_in_triangle(torch.from_numpy(tri), H, W)
    want = np.asarray(jplane.point_in_triangle(jnp.asarray(tri), H, W))
    assert got.dtype == torch.bool and tuple(got.shape) == (2, 5, H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_top_ids_breaks_ties_as_lax_top_k():
    x = np.array([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5, 0.5, 2.0],
                  [1.0] * 8, [3.0, 1.0, 3.0, 1.0, 3.0, 1.0, 0.0, 1.0]],
                 np.float32)
    for k in (1, 3, 5, 8):
        got = plane.top_ids(torch.from_numpy(x), k)
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        plane.top_ids(torch.from_numpy(x), 9)


def _loss_inputs(seed, B=2, H=48, W=64, Q=40):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 5.0, (B, H, W)).astype(np.float32)
    # a smooth ramp on part of image 0, so some triangles have small
    # variance
    depth[0, :, :32] = np.linspace(1, 2, 32, dtype=np.float32)[None]
    lines = rng.uniform(0, 1, (B, Q, 6)).astype(np.float32)
    # corners on rounding midpoints: x * W = k + 0.5 and y * H = k + 0.5
    lines[:, :6, 0::2] = (np.arange(6)[None, :, None] * 7 + 2.5) / W
    lines[:, :6, 1::2] = (np.arange(6)[None, :, None] * 5 + 3.5) / H
    lines[1, 6] = [0.0, 0.0, 1.0, 0.0, 0.5, 1.0]     # clipped to W-1, H-1
    logits = rng.normal(0, 2, (B, Q, 2)).astype(np.float32)
    # ties across the top-28 boundary: 6 equal logits, some inside, some
    # out
    order = np.argsort(-logits[..., 0], axis=1, kind="stable")
    for b in range(B):
        tied = order[b, 25:31]
        logits[b, tied, 0] = logits[b, order[b, 25], 0]
    valid = np.ones((B, H, W), bool)
    valid[1, 40:] = False
    valid[1, :, 50:] = False
    return depth, lines, logits, valid


@pytest.mark.parametrize("kw", [{}, dict(score_thresh=0.3, min_area=20),
                                dict(num_ref=12, score_thresh=0.0,
                                     min_area=0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_plane_norm_loss_matches_jax(seed, kw):
    depth, lines, logits, valid = _loss_inputs(seed)
    got = plane.plane_norm_loss(torch.from_numpy(depth),
                                torch.from_numpy(lines),
                                torch.from_numpy(logits),
                                torch.from_numpy(valid), **kw)
    want = float(jplane.plane_norm_loss(jnp.asarray(depth),
                                        jnp.asarray(lines),
                                        jnp.asarray(logits),
                                        jnp.asarray(valid), **kw))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= TOL * max(1.0, abs(want)), \
        (float(got), want)
    if kw.get("min_area") == 0:
        assert want > 0          # every triangle counts: a real comparison


def test_plane_norm_loss_needs_num_ref_queries():
    """Fewer queries than `num_ref` (28) stop the loss, as `lax.top_k`
    stops the JAX one."""
    depth, lines, logits, valid = _loss_inputs(0)
    with pytest.raises(ValueError):
        plane.plane_norm_loss(torch.from_numpy(depth),
                              torch.from_numpy(lines[:, :20]),
                              torch.from_numpy(logits[:, :20]),
                              torch.from_numpy(valid))
