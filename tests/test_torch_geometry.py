"""The dense encoder's gated paths of the port against the JAX package, on
the CPU.

- The whole tiny GlassRGBD at each of the dense encoder's gates
  (`test_torch_model.ENCODER_GATES`: group attention in every class
  block, token fusion in every class layer, line-depth tokens, three
  reference points a line, no point sampling, and all but the last
  together), through the shared checks of `tests/test_torch_model.py`:
  every output against JAX with both `use_pallas` values (F32_TOL 1e-4;
  with K2's bf16 taps, the JAX Pallas kernels in interpret mode, the
  dense outputs to the larger of BF16_FLIP_TOL 3e-4 and 3x JAX's own
  spread under 1e-7 input noise), the kernel routes, and the weight
  bridge against the JAX exporter.
- The modules: `geometry.PointGuidedTokenFuse` and
  `geometry.Global2PointGraph`, and a class Swin layer with group
  attention (and with token fusion), against the JAX modules at F32_TOL.
- K1's planner: which schedule each plane of the gated forward gets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.models import geometry as jgeometry
from gwdepth_tpu.models import swin as jswin

from gwdepth_tpu_torch.models import geometry, swin
from gwdepth_tpu_torch.ops import ref_attn_diffusion as port_k1

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import (ENCODER_GATES, F32_TOL, check_bridge,
                              check_matches_jax, check_routes)
from test_torch_modules import _close, _load, _t


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("gate", sorted(ENCODER_GATES))
def test_encoder_gate_matches_jax(gate, use_pallas):
    """Every output against JAX's, as `test_glassrgbd_matches_jax`; with
    K2's bf16 taps the dense outputs within BF16_FLIP_TOL or FLIP_MARGIN x
    JAX's own spread under input noise (`test_torch_model.ENCODER_GATES`)."""
    check_matches_jax(gate, use_pallas, flip_control=True)


@pytest.mark.parametrize("gate", sorted(ENCODER_GATES))
def test_encoder_gate_routes_kernels_by_use_pallas(gate):
    """K1 also in each class block with group attention and reference
    points; no K2 without point heads."""
    check_routes(gate)


@pytest.mark.parametrize("gate", sorted(ENCODER_GATES))
def test_encoder_gate_from_jax_matches_export_torch(gate):
    """The bridge maps every gated tensor as the JAX exporter does."""
    check_bridge(gate)


def _maps(rng, B, H, W, *channels):
    return [rng.normal(size=(B, H, W, c)).astype(np.float32)
            for c in channels]


@pytest.mark.parametrize("hw", [(6, 9), (20, 27)])
def test_point_guided_token_fuse_matches(hw):
    """Both pooling scales, on a map smaller than two windows (padded) and
    on one larger than them; coordinates past the map's edge sample
    zeros."""
    rng = np.random.default_rng(10)
    B, C, tC = 2, 16, 8
    x, st, dt, pos = _maps(rng, B, *hw, C, tC, tC, tC)
    ref = rng.uniform(-1.1, 1.1, size=(B, 3, 2, 2)).astype(np.float32)
    args = tuple(map(jnp.asarray, (x, st, dt, ref, pos)))
    jm = jgeometry.PointGuidedTokenFuse(C, tC)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), *args)["params"]
    want = jax.jit(jm.apply)({"params": params}, *args)
    m = _load(geometry.PointGuidedTokenFuse(C, tC),
              "dense_encoder.class_transformer1.blocks.0.token_relation.",
              params, lambda p: {"dense_encoder": {"class_transformer1": {
                  "block0": {"token_relation": p}}}})
    with torch.no_grad():
        got = m(*map(_t, (x, st, dt, ref, pos)))
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("is_init,ratio,hw", [(True, 1, (5, 7)),
                                              (False, 2, (9, 13))])
def test_global2point_graph_matches(is_init, ratio, hw):
    """The first graph (the init grid resized to the map) and a later one
    (the last map upsampled twice, then to init_size * ratio a side)."""
    rng = np.random.default_rng(11)
    B, tC, nP, cis = 2, 8, 6, 4
    grid = (cis, cis) if is_init else (5, 6)
    tokens = _maps(rng, B, *grid, tC)[0]
    point = rng.normal(size=(B, nP, tC)).astype(np.float32)
    jm = jgeometry.Global2PointGraph(tC, nP, cis, ratio)
    args = (jnp.asarray(tokens), jnp.asarray(point), *hw)
    params = jm.init(jax.random.PRNGKey(5), *args, is_init=is_init)["params"]
    want = jm.apply({"params": params}, *args, is_init=is_init)
    m = _load(geometry.Global2PointGraph(tC, nP, cis, ratio),
              "dense_encoder.gpg2.", params,
              lambda p: {"dense_encoder": {"gpg2": p}})
    with torch.no_grad():
        got = m(_t(tokens), _t(point), *hw, is_init=is_init)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("token_fuse", [False, True])
def test_class_layer_with_group_attention_matches(token_fuse, use_pallas):
    """Two class blocks (the second shifted, its reference points rolled)
    with group attention over sampled reference points: the queries
    replaced by the reference mixture (K1's plain version on the CPU
    tensor; the JAX Pallas kernel in interpret mode with `use_pallas`),
    and with `token_fuse` the point-guided fusion after each block."""
    rng = np.random.default_rng(12)
    B, H, W, C, tC = 2, 9, 11, 16, 8
    x, dt, st, pos, tpos = _maps(rng, B, H, W, C, tC, tC, C, tC)
    ref = rng.uniform(-1, 1, size=(B, 5, 1, 2)).astype(np.float32)
    jm = jswin.SwinLayer(C, 2, 4, 7, 2.0, "class", tC, (True, True),
                         use_pallas=use_pallas, token_fuse=token_fuse)
    kw = dict(ref_coords=jnp.asarray(ref), ref_pos=jnp.asarray(pos),
              depth_token=jnp.asarray(dt), seg_token=jnp.asarray(st),
              token_pos=jnp.asarray(tpos))
    params = jax.jit(jm.init)(jax.random.PRNGKey(6), jnp.asarray(x),
                              **kw)["params"]
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), **kw)
    m = _load(swin.SwinLayer(C, 2, 4, 7, 2.0, "class", tC, (True, True),
                             use_pallas=use_pallas, token_fuse=token_fuse),
              "dense_encoder.class_transformer2.", params,
              lambda p: {"dense_encoder": {"class_transformer2": p}})
    with torch.no_grad():
        got = m(_t(x), ref_coords=_t(ref), ref_pos=_t(pos),
                depth_token=_t(dt), seg_token=_t(st), token_pos=_t(tpos))
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


# the K1 planes of the gated forward at 768x1024: the 1/32 ref layer
# (R = 40 lines' endpoints, 60 with the centers) and the 1/16, 1/8 and
# 1/4 class layers (R = the lines' points, then the 30 and 80 sampled
# depth points)
K1_SITES = {(980, 40): "band", (980, 60): "band", (3430, 40): "tiled",
            (3430, 60): "tiled", (13034, 30): "tiled", (50764, 80): "tiled"}


@pytest.mark.parametrize("B", [1, 2])
def test_k1_plan_takes_every_plane_of_the_gated_forward(B):
    """On a 132-SM card the 1/32 planes keep the band schedule and the
    class-layer planes, whose bands do not fit a block, take the
    device-memory schedule: the bands of `band_partition`, each swept in
    chunks of whole rows that the block's threads cover."""
    for (P, R), schedule in K1_SITES.items():
        plan = port_k1.plan(B, P, R, 16, sms=132)
        assert isinstance(plan, port_k1.TilePlan) == (schedule == "tiled")
        if schedule == "band":
            assert plan == port_k1.band_partition(B, P, R, 16, sms=132)
            continue
        with pytest.raises(ValueError):
            port_k1.band_partition(B, P, R, 16, sms=132)
        assert plan.nbp == 132 // B and len(plan.bands) == B * plan.nbp
        assert plan.rows_max == -(-P // plan.nbp)
        assert (plan.ks, plan.pt) in port_k1.kernel_configs(16, "tiled")
        assert 1 <= plan.chunk_rows <= plan.rows_max
        cover = plan.threads // plan.ks * plan.pt
        assert plan.chunk_rows * R <= cover < (plan.chunk_rows + 1) * R
        assert plan.smem <= port_k1.SMEM_MAX


def test_k1_plan_raises_where_no_schedule_takes_the_planes():
    """A row of more positions than a block's threads cover raises, in
    both schedules."""
    with pytest.raises(ValueError, match="R=2000"):
        port_k1.plan(1, 10, 2000, 16, sms=132)
    with pytest.raises(ValueError, match="R=300"):
        port_k1.plan(1, 100000, 300, 32, sms=132)
