"""The port's asynchronous dispatch against the JAX package's.

- Tables on the device (`ops/tables.py`): every resize index, lerp
  weight, separable matrix and shifted-window mask that the shipped
  config reaches at 768x1024 and 704x1024 (full size down to 1/32; the
  Swin stages at 1/32 to 1/4) is the numpy builder's array bit for bit,
  whatever other entries the cache holds; JAX's `resize_nearest_nhwc`,
  `resize_bilinear_nhwc` and `shifted_window_attn_mask` give the port's
  results bit for bit there; entries are keyed by dtype, outlive
  inference mode, and the cache stays bounded.
- `engine.device_prefetch` yields the loader's batches in order, with
  their host batches and names beside them.
- `engine.train_one_epoch` (prefetch and the log drain one window late)
  gives the meters of a plain loop that copies each batch in the step and
  drains each window at once, bit for bit, over two epochs of the tiny
  config; a non-finite loss stops it within two print windows.

On the CPU the tables are the numpy-backed tensors and the prefetch
copies nothing; the card runs the same code in `chip_smoke.py` phase 23.
"""

import itertools
import math

import jax
import numpy as np
import pytest
import torch

from gwdepth_tpu.ops import interpolate as jinterp
from gwdepth_tpu.ops import window as jwindow
from gwdepth_tpu_torch import engine
from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.data.batch import dummy_batch
from gwdepth_tpu_torch.models import build_glassrgbd
from gwdepth_tpu_torch.ops import interpolate as interp
from gwdepth_tpu_torch.ops import tables
from gwdepth_tpu_torch.ops import window as pwindow
from gwdepth_tpu_torch.parallel import create_train_state, make_train_step
from gwdepth_tpu_torch.utils.logging import MetricLogger

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

CANVASES = ((768, 1024), (704, 1024))      # serving and train
SCALES = (1, 2, 4, 8, 16, 32)
WS, SHIFT = 7, 3                           # GWDepthConfig().window_size
SPP_POOLS = (16, 8, 4, 2)                  # PointBasedPred's pool sizes


def _lengths(n):
    return [n // s for s in SCALES]


def _axis_lengths():
    """Every length of a grid axis at 768x1024 and 704x1024, by family."""
    return sorted({tuple(_lengths(n)) for hw in CANVASES for n in hw})


def _stage_grids():
    """(Hp, Wp) of every Swin stage, 1/32 to 1/4, padded to the window."""
    return sorted({(-(-(h // s) // WS) * WS, -(-(w // s) // WS) * WS)
                   for h, w in CANVASES for s in (32, 16, 8, 4)})


def _spp_lengths():
    """The SPP branch's padded axis lengths (1/8 and 1/4, at least the
    largest pool)."""
    return sorted({max(n // s, SPP_POOLS[0]) for hw in CANVASES
                   for n in hw for s in (8, 4)})


def _table_cases():
    """(name, cached getter, numpy builder) of every table."""
    cases = []
    for family in _axis_lengths():
        for o, i in itertools.product(family, repeat=2):
            cases.append((f"nearest {o}<-{i}",
                          lambda o=o, i=i: interp.nearest_idx(o, i, "cpu"),
                          lambda o=o, i=i: interp._nearest_idx(o, i)))
            for ac, part in itertools.product((False, True), range(3)):
                cases.append((
                    f"lerp {o}<-{i} ac={ac} [{part}]",
                    lambda o=o, i=i, ac=ac, p=part: interp.lerp_table(
                        o, i, ac, "cpu", torch.float32)[p],
                    lambda o=o, i=i, ac=ac, p=part:
                        interp._src_coords(o, i, ac)[p]))
    for n in _spp_lengths():
        for k in SPP_POOLS:
            cases.append((f"pool {n}/{k}",
                          lambda n=n, k=k: interp.pool_matrix(n, k, "cpu"),
                          lambda n=n, k=k: interp._pool_matrix(n, k)))
            cases.append((
                f"lerp matrix {n}<-{n // k}",
                lambda n=n, k=k: interp.lerp_matrix(n, n // k, True, "cpu"),
                lambda n=n, k=k: interp._lerp_matrix(n, n // k, True)))
    for hp, wp in _stage_grids():
        cases.append((f"mask {hp}x{wp}",
                      lambda hp=hp, wp=wp: pwindow.shifted_window_attn_mask(
                          hp, wp, WS, SHIFT, device="cpu"),
                      lambda hp=hp, wp=wp: pwindow._mask_np(hp, wp, WS, SHIFT,
                                                            -100.0)))
    return cases


def test_cached_tables_equal_the_numpy_builders():
    """Filled in a shuffled order, so that a key that two tables shared
    would show; then every table read back bit for bit, and read again
    as the same tensor."""
    tables.clear()
    cases = _table_cases()
    order = np.random.default_rng(0).permutation(len(cases))
    first = {cases[j][0]: cases[j][1]() for j in order}
    assert len(tables.cached_keys()) == len(cases)
    for name, get, build in cases:
        want = build()
        got = first[name]
        assert got.dtype == torch.from_numpy(want).dtype, name
        assert np.array_equal(got.numpy(), want), name
        assert get() is got, name


def _probe(src):
    """(1, H, W, 4): the row index and its parity, constant along W, then
    the column index and its parity, constant along H. A resize of it
    shows each output's source indices and weights, and every lerp on it
    rounds once, fused into one multiply-add (XLA inside `jax.jit`) or
    not (the port)."""
    h, w = src
    ys = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    xs = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    return np.stack([ys, ys % 2, xs, xs % 2], -1)[None]


def test_jax_resizes_and_masks_equal_the_ports():
    """At both canvases: the nearest resize from full size to each scale
    and up by 2 between adjacent scales, both bilinear flavours up by 2
    (the shipped path's resizes: the valid mask and the GT to each scale,
    the features and the uncertainty up a scale), and the shifted-window
    mask of every Swin stage, bit for bit. Four channels (`_probe`), so
    the tables cost, not the model; JAX's resizes in one jit per canvas.
    Also the separable matrices of the SPP branch against JAX's
    builders."""
    for h, w in CANVASES:
        hs, ws = _lengths(h), _lengths(w)
        down = [((hs[0], ws[0]), (hs[k], ws[k])) for k in range(6)]
        up = [((hs[k + 1], ws[k + 1]), (hs[k], ws[k])) for k in range(5)]
        xs = [_probe(src) for src, _ in down + up]

        def run_jax(xs):
            near = [jinterp.resize_nearest_nhwc(x, dst)
                    for x, (_, dst) in zip(xs, down + up)]
            lerp = [(jinterp.resize_bilinear_nhwc(x, dst),
                     jinterp.resize_bilinear_nhwc(x, dst, align_corners=True))
                    for x, (_, dst) in zip(xs[len(down):], up)]
            return near, lerp

        near, lerp = jax.jit(run_jax)(xs)
        for x, (src, dst), ref in zip(xs, down + up, near):
            got = interp.resize_nearest_nhwc(torch.from_numpy(x), dst)
            assert np.array_equal(got.numpy(), np.asarray(ref)), (src, dst)
        for x, (src, dst), ref in zip(xs[len(down):], up, lerp):
            t = torch.from_numpy(x)
            got = (interp.resize_bilinear_nhwc(t, dst),
                   interp.resize_bilinear_nhwc(t, dst, align_corners=True),
                   # the point sampler's (..., H, W) bilinear, same tables
                   interp.resize_bilinear(t.permute(0, 3, 1, 2), dst,
                                          align_corners=True
                                          ).permute(0, 2, 3, 1))
            for name, g, r in zip(("bilinear", "bilinear ac",
                                   "(..., H, W) bilinear ac"), got,
                                  (*ref, ref[1])):
                assert np.array_equal(g.numpy(), np.asarray(r)), \
                    (name, src, dst)
    grids = _stage_grids()
    masks = jax.jit(lambda: [jwindow.shifted_window_attn_mask(hp, wp, WS,
                                                              SHIFT)
                             for hp, wp in grids])()
    for (hp, wp), ref in zip(grids, masks):
        got = pwindow.shifted_window_attn_mask(hp, wp, WS, SHIFT,
                                               device="cpu")
        assert np.array_equal(got.numpy(), np.asarray(ref)), (hp, wp)
    for n in _spp_lengths():
        for k in SPP_POOLS:
            assert np.array_equal(interp.pool_matrix(n, k, "cpu").numpy(),
                                  jinterp._pool_matrix(n, k))
            assert np.array_equal(
                interp.lerp_matrix(n, n // k, True, "cpu").numpy(),
                jinterp._lerp_matrix(n, n // k, True))


def test_tables_are_keyed_by_dtype():
    """A bf16 call after a float32 one at the same sizes gets bf16
    weights (and the float32 call float32 ones)."""
    x = torch.randn(1, 10, 14, 3)
    interp.resize_bilinear_nhwc(x, (21, 29))
    *_, w32 = interp.lerp_table(21, 10, False, "cpu", torch.float32)
    out = interp.resize_bilinear_nhwc(x.bfloat16(), (21, 29))
    *_, w16 = interp.lerp_table(21, 10, False, "cpu", torch.bfloat16)
    assert w32.dtype == torch.float32 and w16.dtype == torch.bfloat16
    assert out.dtype == torch.bfloat16
    w = interp._src_coords(21, 10, False)[2]
    assert torch.equal(w16, torch.from_numpy(w).to(torch.bfloat16))
    assert np.array_equal(w32.numpy(), w)


def test_table_built_in_inference_mode_serves_a_backward():
    """A table first built under `torch.inference_mode()` is a normal
    tensor: `index_select` may save it for a later backward."""
    tables.clear()
    with torch.inference_mode():
        interp.resize_nearest_nhwc(torch.zeros(1, 5, 6, 2), (11, 13))
        interp.resize_bilinear_nhwc(torch.zeros(1, 5, 6, 2), (11, 13))
        pwindow.shifted_window_attn_mask(14, 14, WS, SHIFT)
    assert not any(t.is_inference() for t in
                   (interp.nearest_idx(11, 5, "cpu"),
                    *interp.lerp_table(11, 5, False, "cpu", torch.float32),
                    pwindow.shifted_window_attn_mask(14, 14, WS, SHIFT)))
    x = torch.randn(1, 5, 6, 2, requires_grad=True)
    (interp.resize_nearest_nhwc(x, (11, 13)).sum()
     + interp.resize_bilinear_nhwc(x, (11, 13)).sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_a_tracers_table_is_not_kept():
    """Under torch.export's fake tensors the table is built as a fake
    tensor for the program and not cached; an eager call after it gets
    a real one."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    tables.clear()
    with FakeTensorMode(allow_non_fake_inputs=True):
        *_, w = interp.lerp_table(9, 4, True, "cpu", torch.float32)
        assert isinstance(w, FakeTensor)
    assert tables.cached_keys() == []
    *_, w = interp.lerp_table(9, 4, True, "cpu", torch.float32)
    assert type(w) is torch.Tensor
    assert np.array_equal(w.numpy(), interp._src_coords(9, 4, True)[2])


def test_table_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(tables, "MAX_TABLES", 8)
    tables.clear()
    for n in range(2, 30):
        interp.nearest_idx(n, 3, "cpu")
    keys = tables.cached_keys()
    assert len(keys) == 8
    assert keys[-1][0] == ("nearest", 29, 3)      # the newest kept
    tables.clear()


@pytest.mark.parametrize("lookahead", [1, 3])
def test_device_prefetch_keeps_order_contents_and_names(lookahead):
    cfg = tiny_test_config()
    items = [(dummy_batch(cfg, 2, seed=i), [f"s{i}a", f"s{i}b"])
             for i in range(5)]
    got = list(engine.device_prefetch(iter(items), "cpu", lookahead))
    assert len(got) == len(items)
    for (dev_b, host_b, names), (want_b, want_names) in zip(got, items):
        assert names == want_names
        assert host_b is want_b
        for f in ("images", "valid", "depth", "seg", "lines", "line_mask"):
            assert torch.equal(getattr(dev_b, f), getattr(want_b, f))


class _Loader:
    """The `Loader` interface over fixed batches: each epoch the same."""

    def __init__(self, items):
        self.items = items
        self.pinned = []

    def __len__(self):
        return len(self.items)

    def epoch(self, epoch=0, pin_memory=False):
        self.pinned.append(pin_memory)
        return iter(self.items)


PRINT_FREQ = 2


def _plain_epoch(state, train_step, loader, epoch, generator, logger):
    """The loop without the asynchronous dispatch: the batch copied in
    the step, each print window drained at once."""
    pending = []

    def flush():
        mat = torch.stack(pending).cpu().numpy() if pending else []
        pending.clear()
        for row in mat:
            scal = dict(zip(train_step.log_keys, row.tolist()))
            if not math.isfinite(scal["loss"]):
                raise FloatingPointError(scal["loss"])
            logger.update(**scal)

    for batch, _ in logger.log_every(loader.epoch(epoch), "plain",
                                     total=len(loader), before_print=flush):
        state, vec = train_step(state, batch.to("cpu"), generator)
        pending.append(vec)
    flush()
    return state, {k: m.global_avg for k, m in logger.meters.items()}


def test_train_one_epoch_equals_the_plain_loop_bit_for_bit():
    """Two epochs of 2 steps each, a print window a step (so that every
    window but the last is drained one late), from one seed: the meters
    (every value, in order), the epoch averages and the weights."""
    cfg = tiny_test_config()
    loader = _Loader([(dummy_batch(cfg, 1, seed=10 + i), [f"s{i}"])
                      for i in range(2)])
    runs = []
    for loop in ("engine", "plain"):
        model = build_glassrgbd(cfg, 0, device="cpu")
        state = create_train_state(cfg, model, steps_per_epoch=len(loader))
        step = make_train_step(cfg)
        gen = torch.Generator().manual_seed(0)
        logger = MetricLogger(print_freq=1)
        avgs = []
        for epoch in range(2):
            if loop == "engine":
                state, avg = engine.train_one_epoch(
                    state, step, loader, epoch, gen, "cpu", logger=logger)
            else:
                state, avg = _plain_epoch(state, step, loader, epoch, gen,
                                          logger)
            avgs.append(avg)
        runs.append(({k: (list(m.deque), m.total, m.count)
                      for k, m in logger.meters.items()}, avgs,
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (m0, a0, w0), (m1, a1, w1) = runs
    assert m0 == m1 and a0 == a1
    assert m0["loss"][2] == 4 and all(math.isfinite(v) for v in m0["loss"][0])
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert loader.pinned == [False] * 4     # the CPU pins nothing


@pytest.mark.parametrize("bad_step", [0, 3, 6])
def test_non_finite_loss_stops_within_two_print_windows(bad_step):
    """A NaN loss at step k raises FloatingPointError before step k + 2 x
    the print window ends; the meters hold exactly the steps before k."""
    n = 20
    ran = []

    class Step:
        log_keys = ["loss", "loss_ce"]

        def __call__(self, state, batch, generator):
            i = len(ran)
            ran.append(i)
            loss = float("nan") if i == bad_step else float(i)
            return state, torch.tensor([loss, 2.0 * i])

    cfg = tiny_test_config()
    loader = _Loader([(dummy_batch(cfg, 1), ["x"])] * n)
    logger = MetricLogger(print_freq=PRINT_FREQ)
    with pytest.raises(FloatingPointError):
        engine.train_one_epoch(None, Step(), loader, 0, None, "cpu",
                               logger=logger)
    assert bad_step < len(ran) <= bad_step + 2 * PRINT_FREQ
    assert logger.meters["loss"].count == bad_step
    assert list(logger.meters["loss_ce"].deque) == [2.0 * i for i in
                                                    range(bad_step)][-20:]
