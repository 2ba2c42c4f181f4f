"""The port's modules against their JAX counterparts, on the CPU.

Each test builds the JAX module, initializes it (or converts the port's
seeded weights with the JAX package's own importer), moves the weights
into the port module through `gwdepth_tpu_torch.convert.from_jax` with
`strict=True`, and runs both on the same numpy inputs. Tolerance: float32
reassociation (atol 1e-5..1e-4 scaled to the output) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.models import detr as jdetr
from gwdepth_tpu.models import points as jpoints
from gwdepth_tpu.models import resnet as jresnet
from gwdepth_tpu.models import swin as jswin
from gwdepth_tpu.models.decoder import DensePrediction as JDensePrediction
from gwdepth_tpu.models.dense_encoder import DenseEncoder as JDenseEncoder
from gwdepth_tpu.models.dense_encoder import \
    select_reference_points as j_select_ref
from gwdepth_tpu.ops.grid_sample import grid_sample_nhwc as j_grid_sample
from gwdepth_tpu.ops import interpolate as jinterp
from gwdepth_tpu.ops import posemb as jposemb
from gwdepth_tpu.ops import window as jwindow

from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.models import detr, points, resnet, swin
from gwdepth_tpu_torch.models.decoder import DensePrediction
from gwdepth_tpu_torch.models.dense_encoder import (DenseEncoder,
                                                    select_reference_points)
from gwdepth_tpu_torch.models.glassrgbd import init_weights
from gwdepth_tpu_torch.ops import grid_sample, interpolate, posemb, window

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _np(x):
    return np.asarray(x)


def _load(module, prefix: str, params, wrap):
    """Load a JAX param subtree into `module`, whose names sit under
    `prefix` in the full model; `wrap` nests the subtree at its full-model
    path."""
    template = {prefix + k: v for k, v in module.state_dict().items()}
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, wrap(params)),
                                  template)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * scale)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_resizes_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    xc = rng.normal(size=(2, 5, 7)).astype(np.float32)
    for size in [(10, 14), (3, 4)]:
        _close(interpolate.resize_nearest_nhwc(_t(x), size),
               jinterp.resize_nearest_nhwc(jnp.asarray(x), size), 0)
        _close(interpolate.resize_nearest(_t(xc), size),
               jinterp.resize_nearest(jnp.asarray(xc), size), 0)
        for ac in (True, False):
            _close(interpolate.resize_bilinear(_t(xc), size, ac),
                   jinterp.resize_bilinear(jnp.asarray(xc), size, ac))
            _close(interpolate.resize_bilinear_nhwc(_t(x), size, ac),
                   jinterp.resize_bilinear_nhwc(jnp.asarray(x), size, ac))
            _close(interpolate.resize_bilinear_matmul_nhwc(_t(x), size, ac),
                   jinterp.resize_bilinear_matmul_nhwc(jnp.asarray(x), size,
                                                       ac))
    x = rng.normal(size=(1, 17, 12, 4)).astype(np.float32)
    for k in (2, 4, 8):
        _close(interpolate.avg_pool_matmul_nhwc(_t(x), k),
               jinterp.avg_pool_matmul_nhwc(jnp.asarray(x), k))
        # the matmul pool equals torch's own average pool
        _close(interpolate.avg_pool_matmul_nhwc(_t(x), k),
               torch.nn.functional.avg_pool2d(_t(x).permute(0, 3, 1, 2), k)
               .permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("mode,ac", [("nearest", False), ("bilinear", False),
                                     ("bilinear", True)])
def test_grid_sample_matches(mode, ac):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 9, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 7, 3, 2)).astype(np.float32)
    grid[0, 0, 0] = [0.0, 0.0]             # exact centre: round-half-even
    got = grid_sample.grid_sample_nhwc(_t(x), _t(grid), mode, ac)
    _close(got, j_grid_sample(jnp.asarray(x), jnp.asarray(grid),
                                     mode, ac))
    # and torch's own grid_sample agrees with the written-out formula
    want = torch.nn.functional.grid_sample(
        _t(x).permute(0, 3, 1, 2), _t(grid), mode=mode, padding_mode="zeros",
        align_corners=ac).permute(0, 2, 3, 1)
    _close(got, want.numpy())


def test_posemb_and_windows_match():
    rng = np.random.default_rng(2)
    mask = np.ones((2, 5, 7), bool)
    mask[1, 3:, :] = False
    mask[1, :, 5:] = False
    for norm in (True, False):
        _close(posemb.sine_posemb_from_mask_nhwc(_t(mask), 8, normalize=norm),
               jposemb.sine_posemb_from_mask_nhwc(jnp.asarray(mask), 8,
                                                  normalize=norm), 1e-6)
    x = rng.normal(size=(2, 14, 21, 3)).astype(np.float32)
    w = window.window_partition(_t(x), 7)
    _close(w, jwindow.window_partition(jnp.asarray(x), 7), 0)
    _close(window.window_reverse(w, 7, 14, 21), x, 0)
    _close(window.shifted_window_attn_mask(14, 21, 7, 3),
           jwindow.shifted_window_attn_mask(14, 21, 7, 3), 0)
    xp = rng.normal(size=(1, 9, 11, 2)).astype(np.float32)
    _close(window.pad_to_window_multiple(_t(xp), 7),
           jwindow.pad_to_window_multiple(jnp.asarray(xp), 7), 0)


# ---------------------------------------------------------------------------
# backbone and line branch
# ---------------------------------------------------------------------------

def test_resnet_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    jm = jresnet.ResNetBackbone("resnet50")
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    m = _load(resnet.ResNetBackbone("resnet50"), "backbone.0.body.", params,
              lambda p: {"backbone": p})
    with torch.no_grad():
        got = m(_t(x))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    valid = np.ones((1, 64, 96), bool)
    valid[:, 50:] = False
    for g, w in zip(resnet.pyramid_masks(_t(valid), got),
                    jresnet.pyramid_masks(jnp.asarray(valid), want)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_resnet101_matches_jax():
    """The ResNet-101 backbone of the `--backbone resnet101` recipes at
    full width (23 blocks in layer3), its JAX-initialized weights through
    the bridge, held at 1e-4."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    jm = jresnet.ResNetBackbone("resnet101")
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    m = _load(resnet.ResNetBackbone("resnet101"), "backbone.0.body.", params,
              lambda p: {"backbone": p})
    assert len(m.layer3) == 23 and sum(
        p.numel() for p in m.parameters()) > 42e6
    with torch.no_grad():
        got = m(_t(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-4)


def test_detr_transformer_matches():
    rng = np.random.default_rng(4)
    B, N, C, Q = 2, 12, 32, 6
    src = rng.normal(size=(B, N, C)).astype(np.float32)
    pos = rng.normal(size=(B, N, C)).astype(np.float32)
    valid = np.ones((B, N), bool)
    valid[1, 9:] = False
    qe = rng.normal(size=(Q, C)).astype(np.float32)
    jm = jdetr.DETRTransformer(C, 4, 2, 2, 64, 0.0)
    args = tuple(map(jnp.asarray, (src, pos, valid, qe)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *args)["params"]
    hs_w, mem_w = jax.jit(jm.apply)({"params": params}, *args)
    m = _load(detr.DETRTransformer(C, 4, 2, 2, 64), "transformer.", params,
              lambda p: {"transformer": p})
    with torch.no_grad():
        hs, mem = m(*map(_t, (src, pos, valid, qe)))
    _close(hs, hs_w, 1e-5)
    _close(mem, mem_w, 1e-5)


def test_select_reference_points_with_ties():
    rng = np.random.default_rng(5)
    lines = rng.uniform(size=(2, 12, 6)).astype(np.float32)
    logits = rng.integers(0, 3, size=(2, 12, 2)).astype(np.float32)  # ties
    got = select_reference_points(_t(lines), _t(logits), 4, 2)
    want = j_select_ref(jnp.asarray(lines), jnp.asarray(logits), 4, 2)
    _close(got, want, 0)


# ---------------------------------------------------------------------------
# swin layers (kernel K1 inside the ref layer)
# ---------------------------------------------------------------------------

def test_ref_swin_layer_matches():
    rng = np.random.default_rng(6)
    B, H, W, C = 1, 9, 11, 32
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    ref = rng.uniform(-1, 1, size=(B, 4, 2, 2)).astype(np.float32)
    pos = rng.normal(size=(B, H, W, C)).astype(np.float32)
    jm = jswin.SwinLayer(C, 2, 4, 7, 2.0, "ref")
    args = tuple(map(jnp.asarray, (x, ref, pos)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), *args)["params"]
    want, _, _ = jax.jit(jm.apply)({"params": params}, *args)
    m = _load(swin.SwinLayer(C, 2, 4, 7, 2.0, "ref"),
              "dense_encoder.dense_transformer.", params,
              lambda p: {"dense_encoder": {"dense_transformer": p}})
    with torch.no_grad():
        got, _, _ = m(_t(x), _t(ref), _t(pos))
    _close(got, want, 1e-5)


def test_class_swin_layer_matches():
    rng = np.random.default_rng(7)
    B, H, W, C, tC = 1, 9, 11, 16, 8
    x, dt, st = (rng.normal(size=(B, H, W, c)).astype(np.float32)
                 for c in (C, tC, tC))
    jm = jswin.SwinLayer(C, 2, 4, 7, 2.0, "class", tC)
    kw = dict(depth_token=jnp.asarray(dt), seg_token=jnp.asarray(st))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x),
                              **kw)["params"]
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), **kw)
    m = _load(swin.SwinLayer(C, 2, 4, 7, 2.0, "class", tC),
              "dense_encoder.class_transformer1.", params,
              lambda p: {"dense_encoder": {"class_transformer1": p}})
    with torch.no_grad():
        got = m(_t(x), depth_token=_t(dt), seg_token=_t(st))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_roll_ref_coords_reflects():
    ref = np.array([[[[-0.95, 0.2], [0.5, -0.99]]]], np.float32)
    got = swin.roll_ref_coords(_t(ref), 3, 14, 21)
    _close(got, jswin.roll_ref_coords(jnp.asarray(ref), 3, 14, 21), 0)
    assert (got >= -1.0).all()


# ---------------------------------------------------------------------------
# points (kernel K2 inside the pyramid)
# ---------------------------------------------------------------------------

def test_topk_flat_with_ties():
    rng = np.random.default_rng(17)
    for total, S in [(12288, 30), (500, 30), (2048, 80), (4096, 160)]:
        v = rng.normal(size=(total,)).astype(np.float32)
        v[::7] = 2.0            # heavy ties
        v[5::11] = 2.0
        got = points._topk_flat(_t(v), S).numpy()
        want = np.asarray(jax.lax.top_k(jnp.asarray(v), S)[1])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(jpoints._topk_flat(jnp.asarray(v), S)))


@pytest.mark.parametrize("S", [10, 40])
def test_certain_sample_with_ties(S):
    rng = np.random.default_rng(S)
    small = rng.uniform(size=(2, 4, 6)).astype(np.float32)
    # quantized depths: many equal variances, several empty intervals
    large = (np.round(rng.uniform(size=(2, 8, 12)) * 4) / 4).astype(np.float32)
    large[1] = 0.0                        # no interval holds a pixel
    args = ((0.1, 0.3, 0.5, 0.7, 0.9), S, 1e-4)
    got = points.certain_sample(_t(small), _t(large), *args)
    want = jpoints.certain_sample(jnp.asarray(small), jnp.asarray(large),
                                  *args)
    _close(got, want, 0)


def _pyramid_params(P, x, use_pallas):
    jm = jpoints.PyramidLayer(P, (16, 8, 4, 2), use_pallas=use_pallas)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    return jm, params


@pytest.mark.parametrize("use_pallas,tol", [(False, 1e-5), (True, 5e-2)])
def test_pyramid_layer_matches(use_pallas, tol):
    """The port module with the JAX module's `use_pallas`: True runs the
    JAX fused frame chain in interpret mode and the port's trunk through
    K2, both with bf16 taps, held at the bf16-tap tolerance of
    tests/test_fused_conv.py."""
    rng = np.random.default_rng(8)
    P = 6
    x = rng.normal(size=(1, 8, 12, P)).astype(np.float32)
    jm, params = _pyramid_params(P, x, use_pallas)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    m = _load(points.PyramidLayer(P, (16, 8, 4, 2), use_pallas),
              "dense_encoder.point_based_pred1.pyramid.", params,
              lambda p: {"dense_encoder": {"point_based_pred1":
                                           {"pyramid": p}}})
    with torch.no_grad():
        got = m(_t(x))
    _close(got, want, tol)


def test_pyramid_wide_last0_stays_plain(monkeypatch):
    """A concat wider than 400 channels runs last0 as plain conv + LN,
    with the trunk fused (`use_pallas`)."""
    m = points.PyramidLayer(41, (4, 2, 2, 2), use_pallas=True).eval()
    init_weights(m, 0)
    from gwdepth_tpu_torch.ops import fused_conv
    seen = []
    orig = fused_conv.conv3x3_ln_act_plain

    def spy(x, w, *a, **k):
        seen.append(x.shape[-1])
        return orig(x, w, *a, **k)

    monkeypatch.setattr(fused_conv, "conv3x3_ln_act_plain", spy)
    with torch.no_grad():
        m(torch.zeros(1, 4, 4, 41))
    assert len(seen) == 12 and max(seen) == 82


def test_point_based_pred_matches():
    rng = np.random.default_rng(9)
    B, H, W, C, tC, S = 1, 16, 16, 8, 4, 5
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    dt = rng.normal(size=(B, H, W, tC)).astype(np.float32)
    pre = rng.uniform(size=(B, H, W)).astype(np.float32)
    coords = rng.uniform(-1, 1, size=(B, S, 1, 2)).astype(np.float32)
    pos = rng.normal(size=(B, H, W, C)).astype(np.float32)
    jm = jpoints.PointBasedPred(C, tC, (16, 8, 4, 2), S)
    args = tuple(map(jnp.asarray, (x, dt, pre, coords, pos)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), *args)["params"]
    want = jax.jit(jm.apply)({"params": params}, *args)
    m = _load(points.PointBasedPred(C, tC, (16, 8, 4, 2), S),
              "dense_encoder.point_based_pred1.", params,
              lambda p: {"dense_encoder": {"point_based_pred1": p}})
    with torch.no_grad():
        got = m(*map(_t, (x, dt, pre, coords, pos)))
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# dense encoder and decoder
# ---------------------------------------------------------------------------

def test_dense_encoder_matches():
    """Weights: the port's seeded init, carried to JAX by the JAX
    package's importer and back by from_jax."""
    cfg = tiny_test_config()
    rng = np.random.default_rng(10)
    shapes = [(1, 16, 24, 256), (1, 8, 12, 512), (1, 4, 6, 1024),
              (1, 2, 3, 2048)]
    pyr = [rng.normal(size=s).astype(np.float32) for s in shapes]
    top = rng.normal(size=(1, 2, 3, cfg.dense_trans_dim)).astype(np.float32)
    masks = [np.ones(s[:3], bool) for s in shapes]
    lines = rng.uniform(size=(1, cfg.num_queries, 6)).astype(np.float32)
    logits = rng.normal(size=(1, cfg.num_queries, 2)).astype(np.float32)

    m = init_weights(DenseEncoder(cfg), 5).eval()
    sd = {"dense_encoder." + k: v.numpy() for k, v in m.state_dict().items()}
    params = glassrgbd_torch_to_flax(sd)
    _load(m, "dense_encoder.", params["dense_encoder"],
          lambda p: {"dense_encoder": p})
    jm = JDenseEncoder(jax_tiny())
    want = jax.jit(jm.apply)({"params": params["dense_encoder"]},
                             jnp.asarray(top), [jnp.asarray(p) for p in pyr],
                             [jnp.asarray(k) for k in masks],
                             jnp.asarray(lines), jnp.asarray(logits))
    with torch.no_grad():
        got = m(_t(top), [_t(p) for p in pyr], [_t(k) for k in masks],
                _t(lines), _t(logits))
    for g, w in zip(got[0], want[0]):
        _close(g, w, 1e-4)
    _close(got[1], want[1], 1e-4)
    _close(got[2], want[2], 1e-4)
    for g, w in zip(got[3], want[3]):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("blockconv", [True, False])
def test_dense_prediction_matches(blockconv):
    """The port's direct tail equals both JAX tails (the block tail is an
    exact re-layout)."""
    rng = np.random.default_rng(11)
    B, h, w, C, tC = 1, 4, 6, 16, 8
    feat = rng.normal(size=(B, h, w, C)).astype(np.float32)
    d4 = rng.uniform(size=(B, h, w)).astype(np.float32)
    dt, st = (rng.normal(size=(B, h, w, tC)).astype(np.float32)
              for _ in range(2))
    jm = JDensePrediction(10.0, tC, blockconv=blockconv)
    args = tuple(map(jnp.asarray, (feat, d4, dt, st)))
    params = jax.jit(lambda k: jm.init(k, *args, (4 * h, 4 * w)))(
        jax.random.PRNGKey(6))["params"]
    want = jax.jit(lambda p: jm.apply({"params": p}, *args, (4 * h, 4 * w)))(
        params)
    m = _load(DensePrediction(C, 10.0, tC), "depth_decoder.", params,
              lambda p: {"depth_decoder": p})
    with torch.no_grad():
        got = m(*map(_t, (feat, d4, dt, st)), (4 * h, 4 * w))
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
