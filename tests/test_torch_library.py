"""The library modules of the port (those no model path builds) against
the JAX package's, on the CPU.

- `models/geometry.py`: `ConvGRU`, `PyramidConv`, `NonLocalPlannarGuidance`,
  `TokenFuse`, `ReflectionReduce` and `PointTokenAttention`, each with the
  JAX module's perturbed parameters carried over by
  `convert.from_jax.library_params_to_state_dict`, to REL_TOL relative L2;
  `distance_map` likewise; `_kmeans` and `sample_by_centers` give equal
  labels and selections, on ties too.
- `models/points.py`: `OffsetGeneration` (dilated convs at grids smaller
  than the dilation; the same hull choice as JAX, also where every
  proposal is degenerate) and `sample_along_seg` / `sample_mid_seg`.

Each module's JAX parameters are built once (module-scoped fixtures).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.models import geometry as jgeometry
from gwdepth_tpu.models import points as jpoints

from gwdepth_tpu_torch.convert.from_jax import library_params_to_state_dict
from gwdepth_tpu_torch.models import geometry, points
from gwdepth_tpu_torch.ops import fused_conv
from gwdepth_tpu_torch.ops import ref_attn_diffusion as port_k1

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

REL_TOL = 1e-5
B, H, W, C, TC = 2, 6, 9, 16, 8


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want):
    assert _rel_l2(got, want) <= REL_TOL


def _random_params(shapes, rng):
    """Seeded parameters of a flax param tree's shapes, without running
    its init: norm scales 1 + 0.1 n, biases 0.1 n, kernels n / sqrt(fan
    in) (n standard normal)."""
    def leaf(path, s):
        n = rng.normal(size=s.shape).astype(np.float32)
        name = path[-1].key
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "bias":
            return 0.1 * n
        return n / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


class _Pair:
    """A JAX module with seeded parameters and the port module loaded
    from them through the bridge."""

    def __init__(self, jm, m, seed, *args, **kw):
        self.jm = jm
        ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args]
        shapes = jax.eval_shape(functools.partial(jm.init, **kw),
                                jax.random.PRNGKey(seed), *ja)["params"]
        self.params = _random_params(shapes, _rng(seed))
        self.apply = jax.jit(jm.apply, static_argnames=tuple(kw))
        self.m = m
        m.load_state_dict(library_params_to_state_dict(self.params, m),
                          strict=True)
        m.eval()

    def both(self, *args, **kw):
        ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args]
        want = self.apply({"params": self.params}, *ja, **kw)
        ta = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
        with torch.no_grad():
            got = self.m(*ta, **kw)
        return got, want


def _refs(rng, L=3, P=2, lo=-1.1, hi=1.1):
    return rng.uniform(lo, hi, size=(B, L, P, 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# geometry: the float modules
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gru():
    rng = _rng(1)
    args = (_normal(rng, B, H, W, TC), _normal(rng, B, H, W, 5))
    return _Pair(jgeometry.ConvGRU(TC), geometry.ConvGRU(TC, 5), 1, *args)


def test_conv_gru_matches(gru):
    rng = _rng(2)
    _close(*gru.both(_normal(rng, B, H, W, TC), _normal(rng, B, H, W, 5)))


@pytest.fixture(scope="module")
def pyramid_conv():
    x = _normal(_rng(3), B, 3, 5, 2)
    return _Pair(jgeometry.PyramidConv(4, 12, 2),
                 geometry.PyramidConv(2, 4, 12, 2), 3, x, size=(H, W))


@pytest.mark.parametrize("hw,size", [((3, 5), (6, 9)), ((10, 13), (12, 16)),
                                     ((9, 11), (5, 7))])
def test_pyramid_conv_matches(pyramid_conv, hw, size):
    """Inputs smaller than two pools (padded below and right), larger,
    and resized down."""
    x = _normal(_rng(4), B, *hw, 2)
    _close(*pyramid_conv.both(x, size=size))


def test_one_channel_pyramid_conv_ignores_its_input():
    """`NonLocalPlannarGuidance`'s `pre_depth_upsample`: each level's
    LayerNorm over one channel gives its bias alone, so two depth maps
    give one output, in JAX and in the port."""
    rng = _rng(41)
    x1, x2 = _normal(rng, B, 3, 5, 1), _normal(rng, B, 3, 5, 1)
    pair = _Pair(jgeometry.PyramidConv(1, 32, 2),
                 geometry.PyramidConv(1, 1, 32, 2), 41, x1, size=(H, W))
    (g1, w1), (g2, w2) = (pair.both(x, size=(H, W)) for x in (x1, x2))
    _close(g1, w1)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())
    assert float(np.abs(np.asarray(w1)).max()) > 0


@pytest.fixture(scope="module")
def non_local():
    rng = _rng(5)
    args = (_normal(rng, B, H, W, C), _normal(rng, B, H, W, TC),
            _normal(rng, B, H, W, TC), _refs(rng),
            _normal(rng, B, H, W, TC), _normal(rng, B, 3, 5, 1))
    return _Pair(jgeometry.NonLocalPlannarGuidance(C, TC, 6),
                 geometry.NonLocalPlannarGuidance(C, TC, 6), 5, *args)


@pytest.mark.parametrize("with_pos", [True, False])
def test_non_local_plannar_guidance_matches(non_local, with_pos):
    rng = _rng(6)
    bx, st, dt, ref, pos, dp = (
        _normal(rng, B, H, W, C), _normal(rng, B, H, W, TC),
        _normal(rng, B, H, W, TC), _refs(rng), _normal(rng, B, H, W, TC),
        _normal(rng, B, 3, 5, 1))
    want, none = non_local.apply(
        {"params": non_local.params}, *map(jnp.asarray, (bx, st, dt, ref)),
        jnp.asarray(pos) if with_pos else None, jnp.asarray(dp))
    with torch.no_grad():
        got, gnone = non_local.m(_t(bx), _t(st), _t(dt), _t(ref),
                                 _t(pos) if with_pos else None, _t(dp))
    assert none is None and gnone is None
    assert got.shape == (B, H, W, 1)
    _close(got, want)


@pytest.fixture(scope="module")
def token_fuse():
    rng = _rng(7)
    args = (_normal(rng, B, H, W, TC), _normal(rng, B, H, W, TC),
            _refs(rng), _normal(rng, B, H, W, TC))
    return _Pair(jgeometry.TokenFuse(TC), geometry.TokenFuse(TC), 7, *args)


@pytest.mark.parametrize("L,P", [(3, 2), (5, 3)])
def test_token_fuse_matches(token_fuse, L, P):
    """Reference points inside and past the map's edge (those sample
    zeros)."""
    rng = _rng(8)
    _close(*token_fuse.both(_normal(rng, B, H, W, TC),
                            _normal(rng, B, H, W, TC), _refs(rng, L, P),
                            _normal(rng, B, H, W, TC)))


@pytest.fixture(scope="module")
def reflection():
    x = _normal(_rng(9), 1, 32, 48, 3)
    return _Pair(jgeometry.ReflectionReduce(), geometry.ReflectionReduce(),
                 9, x, layers_size=((2, 3), (4, 6), (8, 12)))


@pytest.mark.parametrize("hw,sizes", [
    ((32, 48), ((2, 3), (4, 6), (8, 12))),
    ((30, 44), ((2, 3), (4, 6), (8, 11)))])
def test_reflection_reduce_matches(reflection, hw, sizes):
    """The three maps, 1/16 (256 ch), 1/8 (128) and 1/4 (64); the first
    stage's ratio 0 taken as no resize."""
    got, want = reflection.both(_normal(_rng(10), 1, *hw, 3),
                                layers_size=sizes)
    assert [g.shape[-1] for g in got] == [256, 128, 64]
    for g, w in zip(got, want):
        _close(g, w)
    assert [tuple(g.shape[1:3]) for g in got] == [tuple(s) for s in sizes]


@pytest.fixture(scope="module")
def point_attention():
    rng = _rng(11)
    args = (_normal(rng, B, H, W, C), _normal(rng, B, 7, TC))
    return _Pair(jgeometry.PointTokenAttention(C, 4, TC),
                 geometry.PointTokenAttention(C, 4, TC), 11, *args)


@pytest.mark.parametrize("n_points", [7, 12])
def test_point_token_attention_matches(point_attention, n_points):
    rng = _rng(12)
    _close(*point_attention.both(_normal(rng, B, H, W, C),
                                 _normal(rng, B, n_points, TC)))


@pytest.mark.parametrize("hw", [(4, 6), (7, 3), (24, 32)])
def test_distance_map_matches(hw):
    got = geometry.distance_map(*hw)
    want = np.asarray(jax.jit(jgeometry.distance_map,
                              static_argnums=(0, 1))(*hw))
    assert got.shape == (hw[0] * hw[1],) * 2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# geometry: the discrete choices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(n, k) for n in (5, 37, 100, 101, 1000)
                                 for k in (1, 2, 3, 7, 16, 20, 50)
                                 if k <= n])
def test_linspace_index_matches_jnp(n, k):
    """The initial centres' strided indices equal JAX's float32 linspace,
    truncated."""
    want = np.asarray(jnp.linspace(0, n - 1, k).astype(jnp.int32))
    np.testing.assert_array_equal(geometry._linspace_idx(n, k), want)


def _kmeans_points(case):
    rng = _rng(13)
    if case == "uniform":
        return rng.uniform(0, 1, size=(100, 2)).astype(np.float32)
    if case == "lattice":
        # integer coordinates, many repeated: equal x in the initial sort
        # and equal distances to two centres, both exact in float32
        return rng.integers(0, 5, size=(100, 2)).astype(np.float32)
    if case == "clusters":
        c = rng.uniform(0, 1, size=(5, 2))
        return (c[rng.integers(0, 5, 37)]
                + 0.01 * rng.normal(size=(37, 2))).astype(np.float32)
    raise ValueError(case)


@pytest.mark.parametrize("case,k", [("uniform", 16), ("lattice", 16),
                                    ("lattice", 3), ("clusters", 5)])
def test_kmeans_labels_equal(case, k):
    pts = _kmeans_points(case)
    want = np.asarray(jax.jit(jgeometry._kmeans, static_argnums=1)(
        jnp.asarray(pts), k))
    got = geometry._kmeans(_t(pts), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmeans_tie_goes_to_the_lower_centre():
    """A point at equal distance from two centres joins the first."""
    pts = np.array([[0, 0], [2, 0], [1, 0]], np.float32)
    want = np.asarray(jgeometry._kmeans(jnp.asarray(pts), 2, iters=0))
    got = geometry._kmeans(_t(pts), 2, iters=0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 1, 0])


def _centers_inputs(seed, tied: bool, Q=100):
    rng = _rng(seed)
    centers = rng.uniform(0, 1, size=(B, Q, 2)).astype(np.float32)
    lines = rng.uniform(0, 1, size=(B, Q, 4)).astype(np.float32)
    lines[:, ::7, 2] = lines[:, ::7, 0]          # zero x-extent: too short
    logits = rng.normal(size=(B, Q, 2)).astype(np.float32)
    if tied:
        logits = np.round(logits, 1)             # many equal scores
        centers = np.round(centers * 4) / 4      # equal x in the sort
    return centers, lines, logits


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("h,w,top,n", [(768, 1024, 6, 50), (480, 640, 2, 30)])
def test_sample_by_centers_selects_the_same_lines(tied, h, w, top, n):
    centers, lines, logits = _centers_inputs(14, tied)
    fn = jax.jit(jgeometry.sample_by_centers,
                 static_argnames=("input_h", "input_w", "top_num",
                                  "sample_line_num"))
    want = np.asarray(fn(*map(jnp.asarray, (centers, lines, logits)),
                         input_h=h, input_w=w, top_num=top,
                         sample_line_num=n))
    got = geometry.sample_by_centers(_t(centers), _t(lines), _t(logits), h,
                                     w, top_num=top,
                                     sample_line_num=n).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# points: OffsetGeneration and the segment samplers
# ---------------------------------------------------------------------------

NRP = 8                     # 4 lines of 2 points
POOLS = (4, 2)              # the pyramid's SPP pools (default 32, 16, 8, 4)


def _offset_args(seed, hw):
    rng = _rng(seed)
    return (_normal(rng, B, *hw, C), _normal(rng, B, *hw, TC),
            _refs(rng, NRP // 2, 2, -1.0, 1.0), _normal(rng, B, *hw, C))


@pytest.fixture(scope="module")
def offset_generation():
    pair = _Pair(jpoints.OffsetGeneration(C, TC, NRP, POOLS),
                 points.OffsetGeneration(C, TC, NRP, POOLS), 15,
                 *_offset_args(15, (5, 7)))
    pair.apply = jax.jit(pair.jm.apply, static_argnames=("with_pos",))
    return pair


@pytest.mark.parametrize("with_pos", [True, False])
def test_offset_generation_matches(offset_generation, with_pos):
    """On a grid smaller than goff2's and goff3's dilations (6 and 16);
    the same location chosen by the hull areas as JAX."""
    pair = offset_generation
    args = _offset_args(16, (5, 7))
    want = np.asarray(pair.apply({"params": pair.params},
                                 *map(jnp.asarray, args),
                                 with_pos=with_pos))
    want_chosen = want[:, NRP // 2:].reshape(B, NRP)
    targs = [_t(a) for a in args[:3]] + [_t(args[3]) if with_pos else None]
    with torch.no_grad():
        coords = pair.m.proposals(*targs)
        best = pair.m.largest_hull(coords)
        got = pair.m(*targs)
    _close(got, want)
    # the JAX choice is the location the port chose, and no other
    chosen = (coords * 2.0 - 1.0).numpy()
    for b in range(B):
        near = np.abs(chosen[b] - want_chosen[b]).max(-1) < 1e-5
        assert np.flatnonzero(near).tolist() == [int(best[b])]


def test_offset_generation_degenerate_hulls_choose_the_first(
        offset_generation):
    """With the pyramid's last conv zeroed every location proposes the
    same point, every hull is degenerate (area 0), and both choose the
    first location."""
    pair = offset_generation
    params = jax.tree.map(lambda a: a, pair.params)
    params["pyramid"]["last1"]["kernel"] = np.zeros_like(
        params["pyramid"]["last1"]["kernel"])
    m = points.OffsetGeneration(C, TC, NRP, POOLS)
    m.load_state_dict(library_params_to_state_dict(params, m), strict=True)
    args = _offset_args(17, (5, 7))
    want = np.asarray(pair.apply({"params": params},
                                 *map(jnp.asarray, args)))
    with torch.no_grad():
        coords = m.proposals(*map(_t, args))
        got = m(*map(_t, args))
    assert (m.largest_hull(coords) == 0).all()
    np.testing.assert_array_equal(got[:, NRP // 2:].numpy(), 0.0)
    _close(got, want)


def test_hull_areas_host_matches():
    pts = _rng(18).uniform(size=(3, 4, 6, 2)).astype(np.float32)
    pts[0, 0] = 0.5                              # one point: degenerate
    pts[1, 1, :, 1] = pts[1, 1, :, 0]            # collinear
    got = points._hull_areas_host(pts)
    np.testing.assert_array_equal(got, jpoints._hull_areas_host(pts))
    assert got[0, 0] == 0 and got[1, 1] == 0 and got.dtype == np.float32


def test_offset_generation_launches_no_kernel(offset_generation):
    """Its pyramid is built unfused, as the JAX module builds it."""
    assert offset_generation.m.pyramid.use_pallas is False
    fused_conv.reset_counts()
    port_k1.reset_counts()
    with torch.no_grad():
        offset_generation.m(*map(_t, _offset_args(19, (5, 7))))
    assert fused_conv.conv3x3_ln_act.launches == 0
    assert port_k1.ref_attn_diffusion.launches == 0


def _segments(seed):
    rng = _rng(seed)
    lines = rng.uniform(-1, 1, size=(B, 6, 2, 2)).astype(np.float32)
    lines[:, 1, 1, 0] = lines[:, 1, 0, 0]        # vertical: equal x
    lines[:, 2, 1] = lines[:, 2, 0]              # zero length
    lines[:, 3, 1, 1] = lines[:, 3, 0, 1]        # horizontal
    lines[:, 4] = lines[:, 4, ::-1]              # right-to-left
    return lines


@pytest.mark.parametrize("n", [1, 10])
def test_sample_along_seg_matches(n):
    lines = _segments(20)
    want = np.asarray(jax.jit(jpoints.sample_along_seg,
                              static_argnums=(1, 2, 3))(
        jnp.asarray(lines), 48, 64, n))
    got = points.sample_along_seg(_t(lines), 48, 64, n)
    assert got.shape == (B, 6, 2 + n, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sample_mid_seg_matches():
    lines = _segments(21)
    want = np.asarray(jpoints.sample_mid_seg(jnp.asarray(lines)))
    np.testing.assert_array_equal(points.sample_mid_seg(_t(lines)).numpy(),
                                  want)
