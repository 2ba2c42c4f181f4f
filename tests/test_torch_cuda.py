"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and `nvcc` (the CUDA kernels have no
interpret mode), is marked `cuda`, and skips elsewhere. The file imports
no JAX, so it runs on a machine without it; `tests/conftest.py` imports
JAX, so skip it there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance 1e-4 max-abs: both sides sum float32 products (the plain
version's matmuls without TF32; K2's products of operands rounded to bf16
on both sides, which are exact in float32), and the kernels only
reassociate the sums.
"""

import os
import time

import numpy as np
import pytest
import torch

from gwdepth_tpu_torch.losses import criterion as port_crit
from gwdepth_tpu_torch.ops import fused_conv as port_fc
from gwdepth_tpu_torch.ops import lap as port_lap
from gwdepth_tpu_torch.ops import ref_attn_diffusion as port_k1
from gwdepth_tpu_torch.ops import window_msa as port_wm

TOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def cupti_kept_between_profiles():
    """Kineto tears CUPTI down after every profiling session and sets it
    up again at the next; PyTorch keeps it up where CUDA graphs are in use
    (torch.profiler, TEARDOWN_CUPTI), since setting it up again after
    graph captures is unreliable. This file captures graphs before its
    profiles, and `test_k3_kernel_is_one_launch`, the third profile, once
    came back with no device events: keep CUPTI up for the module."""
    old = os.environ.get("TEARDOWN_CUPTI")
    os.environ["TEARDOWN_CUPTI"] = "0"
    yield
    if old is None:
        del os.environ["TEARDOWN_CUPTI"]
    else:
        os.environ["TEARDOWN_CUPTI"] = old


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernels have "
                    "no interpret mode")
    # full float32 on both sides: K1's backward runs F.conv2d, which
    # cuDNN would otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


def _k1_inputs(seed, shape, dev):
    B, P, R, H = shape
    rng = np.random.default_rng(seed)
    return (_t(rng.normal(size=(B, P, R, H)), dev),
            _t(rng.normal(size=(3, 3, H, H)) / np.sqrt(9 * H), dev),
            _t(0.1 * rng.normal(size=(H,)), dev))


@pytest.mark.parametrize("shape", [(1, 980, 40, 16), (2, 30, 8, 4),
                                   (1, 7, 3, 2), (1, 50, 33, 32),
                                   # the train shape; a P the grid does not
                                   # divide; P below the grid; H = 32 at
                                   # the serving P
                                   (2, 980, 40, 16), (1, 997, 12, 8),
                                   (2, 20, 40, 16), (1, 980, 40, 32)])
def test_k1_kernel_matches_plain(dev, shape):
    a, w, b = _k1_inputs(0, shape, dev)
    before = port_k1.ref_attn_diffusion.launches
    got = port_k1.ref_attn_diffusion(a, w, b)
    torch.cuda.synchronize()
    assert port_k1.ref_attn_diffusion.launches == before + 1
    torch.testing.assert_close(got, port_k1.ref_attn_diffusion_plain(a, w, b),
                               atol=TOL, rtol=0)
    # the statistics are combined in a fixed order: bit-equal on a rerun
    assert torch.equal(port_k1.ref_attn_diffusion(a, w, b), got)


def test_k1_kernel_reruns_are_bit_equal(dev):
    """The plane statistics are combined in a fixed order in every block:
    three reruns give the same bits."""
    a, w, b = _k1_inputs(20, (1, 980, 40, 16), dev)
    first = port_k1.ref_attn_diffusion(a, w, b)
    for _ in range(3):
        assert torch.equal(port_k1.ref_attn_diffusion(a, w, b), first)


def test_k1_kernel_in_cuda_graph(dev):
    """One call captured in a CUDA graph and replayed twice gives the eager
    call's bits: the grid barrier's state survives capture and replay."""
    a, w, b = _k1_inputs(21, (2, 980, 40, 16), dev)
    eager = port_k1.ref_attn_diffusion(a, w, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        port_k1.ref_attn_diffusion(a, w, b)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = port_k1.ref_attn_diffusion(a, w, b)
    for _ in range(2):
        got.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, eager)
    assert torch.equal(port_k1.ref_attn_diffusion(a, w, b), eager)


def test_k1_calls_on_two_streams_at_once(dev):
    """Calls on two streams: each stream has a grid barrier of its own, so
    every call gives the bits of an eager call on one stream. A sleep at
    the head of both streams queues the calls so that they could start
    together (on an H100 the card ran such cooperative launches one after
    another: PERF.md)."""
    shape = (1, 980, 40, 16)
    inputs = [_k1_inputs(23 + i, shape, dev) for i in range(2)]
    want = [port_k1.ref_attn_diffusion(*x) for x in inputs]
    for x, y in zip(inputs, want):
        torch.testing.assert_close(y, port_k1.ref_attn_diffusion_plain(*x),
                                   atol=TOL, rtol=0)
    streams = [torch.cuda.Stream() for _ in inputs]
    outs = [[] for _ in inputs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(50_000_000)
    for _ in range(8):
        for s, x, out in zip(streams, inputs, outs):
            with torch.cuda.stream(s):
                out.append(port_k1.ref_attn_diffusion(*x))
    torch.cuda.synchronize()
    for y, out in zip(want, outs):
        for got in out:
            assert torch.equal(got, y)


def _wait_or_fail(streams, seconds: float, what: str) -> None:
    """Wait for the work queued on `streams`, failing the test (not hanging
    it) if it has not ended after `seconds`: a grid barrier whose counter
    two launches share can wait forever."""
    events = []
    for s in streams:
        ev = torch.cuda.Event()
        ev.record(s)
        events.append(ev)
    deadline = time.monotonic() + seconds
    while not all(ev.query() for ev in events):
        if time.monotonic() > deadline:
            pytest.fail(f"{what}: not done after {seconds} s (a hang)")
        time.sleep(0.01)


def test_k1_graph_replays_beside_a_direct_call_on_the_capture_stream(dev):
    """Two K1 calls captured in two CUDA graphs on stream S1, replayed on
    S2 and S3 while S1 runs a direct call at a third input, all queued
    behind a sleep at the head of each stream so that they start together:
    every output equals `diffusion_torch`, and nothing hangs. A replay
    runs on the stream it is launched on, so a counter per stream would be
    shared by the three launches; each capture has a counter of its own.
    (On an H100 the card ran the three cooperative launches one after
    another, so this passes with a shared counter too: PERF.md.)"""
    _replays_beside_a_direct_call(dev, (1, 980, 40, 16))


def _replays_beside_a_direct_call(dev, shape):
    """The body of the replay tests: two graphs captured on S1 replayed
    on S2 and S3 beside a direct call on S1, four times."""
    inputs = [_k1_inputs(30 + i, shape, dev) for i in range(3)]
    want = [port_k1.diffusion_torch(*x) for x in inputs]
    s1, s2, s3 = (torch.cuda.Stream() for _ in range(3))
    s1.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        port_k1.ref_attn_diffusion(*inputs[2])
    torch.cuda.synchronize()
    graphs, static = [], []
    for x in inputs[:2]:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s1):
            static.append(port_k1.ref_attn_diffusion(*x))
        graphs.append(g)
    for _ in range(4):
        for y in static:
            y.zero_()
        for s in (s1, s2, s3):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                torch.cuda._sleep(50_000_000)
        with torch.cuda.stream(s2):
            graphs[0].replay()
        with torch.cuda.stream(s1):
            direct = port_k1.ref_attn_diffusion(*inputs[2])
        with torch.cuda.stream(s3):
            graphs[1].replay()
        _wait_or_fail((s1, s2, s3), 60.0, "K1 replays beside a direct call")
        for got, y in zip((*static, direct), want):
            torch.testing.assert_close(got, y, atol=TOL, rtol=0)


def test_k1_tiled_graph_replays_beside_a_direct_call(dev):
    """The device-memory schedule under the same replays: each capture's
    barrier counter is its own, as for the band schedule."""
    _replays_beside_a_direct_call(dev, (1, 13034, 30, 16))


def test_k1_kernel_is_one_launch(dev):
    """The profiler sees one CUDA kernel per call: all three steps run in
    the one cooperative launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, w, b = _k1_inputs(22, (1, 980, 40, 16), dev)
    port_k1.ref_attn_diffusion(a, w, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            port_k1.ref_attn_diffusion(a, w, b)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 2 and all("diffusion_kernel" in k
                                     for k in kernels), kernels


# the class-layer planes of the gated forward at 768x1024 (B = 1, and the
# 1/8 plane at B = 2), then planes that reach the device-memory schedule
# at every other H, with chunks and bands that do not divide the rows
K1_TILED_SHAPES = [(1, 3430, 60, 16), (1, 13034, 30, 16), (1, 50764, 80, 16),
                   (2, 13034, 30, 16), (1, 30001, 10, 2), (1, 30001, 10, 4),
                   (1, 15001, 10, 8), (2, 5001, 20, 32)]


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("shape", K1_TILED_SHAPES)
def test_k1_tiled_kernel_matches_plain(dev, shape):
    """Planes whose bands do not fit a block take the device-memory
    schedule: one launch, within TOL of the plain version, and bit-equal
    on a rerun (the statistics are combined in a fixed order)."""
    assert isinstance(port_k1.plan(*shape, _sms(dev)), port_k1.TilePlan)
    a, w, b = _k1_inputs(40, shape, dev)
    before = port_k1.ref_attn_diffusion.launches
    got = port_k1.ref_attn_diffusion(a, w, b)
    torch.cuda.synchronize()
    assert port_k1.ref_attn_diffusion.launches == before + 1
    torch.testing.assert_close(got, port_k1.ref_attn_diffusion_plain(a, w, b),
                               atol=TOL, rtol=0)
    assert torch.equal(port_k1.ref_attn_diffusion(a, w, b), got)


def test_k1_tiled_kernel_is_one_launch(dev):
    """The device-memory schedule is one CUDA kernel per call too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, w, b = _k1_inputs(41, (1, 3430, 60, 16), dev)
    port_k1.ref_attn_diffusion(a, w, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            port_k1.ref_attn_diffusion(a, w, b)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 2 and all("diffusion_tiled_kernel" in k
                                     for k in kernels), kernels


def test_k1_tiled_outputs_carry_grad_fn_only_when_inputs_require_grad(dev):
    """The device-memory schedule's forward keeps the autograd graph, and
    its gradients are autograd's through the plain version. (The bias
    gradient is zero up to rounding, since the LayerNorm removes a shift
    per head, so the planes and weights are compared.)"""
    a, w, b = _k1_inputs(42, (1, 3430, 60, 16), dev)
    assert port_k1.ref_attn_diffusion(a, w, b).grad_fn is None
    ct = torch.randn(a.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(2))
    before = port_k1.ref_attn_diffusion.launches
    y, got = _grads(port_k1.ref_attn_diffusion, (a, w, b), ct)
    assert y.grad_fn is not None
    assert port_k1.ref_attn_diffusion.launches == before + 1
    _, want = _grads(port_k1.ref_attn_diffusion_plain, (a, w, b), ct)
    _close_scaled(got[:2], want[:2])
    with torch.no_grad():
        assert port_k1.ref_attn_diffusion(a.requires_grad_(), w,
                                          b).grad_fn is None


def test_k1_kernel_raises_for_planes_no_schedule_takes(dev):
    """A row wider than the device-memory schedule's chunk raises before
    any launch, with no route to a plain version."""
    a, w, b = _k1_inputs(43, (1, 10, 2000, 16), dev)
    before = port_k1.ref_attn_diffusion.launches
    with pytest.raises(ValueError, match="R=2000"):
        port_k1.ref_attn_diffusion(a, w, b)
    assert port_k1.ref_attn_diffusion.launches == before


def test_k1_kernel_rejects_unsupported_heads(dev):
    a, w, b = _k1_inputs(1, (1, 10, 4, 3), dev)
    with pytest.raises(ValueError, match="H in"):
        port_k1.ref_attn_diffusion(a, w, b)


def _k2_inputs(seed, ci, co, dev, B=1, H=19, W=70):
    rng = np.random.default_rng(seed)
    return (_t(rng.normal(size=(B, H, W, ci)), dev),
            _t(rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci), dev),
            _t(1.0 + 0.1 * rng.normal(size=(co,)), dev),
            _t(0.1 * rng.normal(size=(co,)), dev),
            _t(rng.normal(size=(B, H, W, co)), dev))


@pytest.mark.parametrize("act", [None, "gelu", "elu"])
@pytest.mark.parametrize("ci,co", [(30, 30), (30, 60), (60, 60), (80, 80),
                                   (80, 160), (120, 120), (160, 160),
                                   (300, 120), (3, 5), (17, 256)])
def test_k2_kernel_matches_plain(dev, act, ci, co):
    """The main path's widths (W = 70 is not a multiple of the 32-pixel
    tile), with LN, with LN and a residual, and bare; batch 2."""
    x, w, g, b, r = _k2_inputs(2, ci, co, dev, B=2)
    for args in ((g, b, None), (g, b, r), (None, None, None)):
        got = port_fc.conv3x3_ln_act(x, w, *args, act)
        want = port_fc.conv3x3_ln_act_plain(x, w, *args, act)
        torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("co,ci", [(30, 30), (60, 30), (60, 60), (120, 300),
                                   (80, 80), (160, 80), (160, 160)])
def test_k2_dx_conv_matches_plain(dev, co, ci):
    """The backward's dx conv of each main-path link: Co -> Ci channels on
    the rotated, io-transposed weights, no LN (Ci = 300 in two pieces)."""
    _, w, _, _, dc = _k2_inputs(9, ci, co, dev, B=2)
    w_flip = w.flip(0, 1).transpose(2, 3)                # (3, 3, Co, Ci)
    port_fc.reset_counts()
    got = port_fc._conv_bwd(dc, w_flip)
    assert port_fc.conv3x3_ln_act.bwd_launches == -(-ci // port_fc.MAX_CO)
    torch.testing.assert_close(
        got, port_fc.conv3x3_ln_act_plain(dc, w_flip), atol=TOL, rtol=0)


def test_k2_kernel_tiles(dev):
    """The block tiles the kernel picks per plane (MT m16 tiles per warp,
    warps): these planes, ragged in both directions, take all three, and
    each matches the plain version."""
    seen = set()
    for B, H, W, co in ((2, 19, 70, 60), (2, 175, 250, 80), (2, 175, 250,
                                                             160)):
        x, w, g, b, _ = _k2_inputs(10, 32, co, dev, B=B, H=H, W=W)
        seen.add(port_fc.kernel_tile(B, H, W, co))
        torch.testing.assert_close(
            port_fc.conv3x3_ln_act(x, w, g, b, act="gelu"),
            port_fc.conv3x3_ln_act_plain(x, w, g, b, act="gelu"),
            atol=TOL, rtol=0)
    assert seen == {(1, 4), (1, 8), (2, 8)}, seen


def test_k2_kernel_odd_channels_and_offset_input(dev):
    """An x that starts 4 bytes into its storage (the kernel stages it with
    4-byte copies, though Ci = 8 would allow 16), Ci = 7 likewise, and an
    odd Co, stored without float2."""
    x, w, g, b, r = _k2_inputs(11, 8, 9, dev, B=3)
    x = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(x.shape)
    assert x.data_ptr() % 8 == 4
    torch.testing.assert_close(
        port_fc.conv3x3_ln_act(x, w, g, b, r, "elu"),
        port_fc.conv3x3_ln_act_plain(x, w, g, b, r, "elu"),
        atol=TOL, rtol=0)
    x, w, g, b, r = _k2_inputs(11, 7, 9, dev, B=3)
    torch.testing.assert_close(
        port_fc.conv3x3_ln_act(x, w, g, b, r, "gelu"),
        port_fc.conv3x3_ln_act_plain(x, w, g, b, r, "gelu"),
        atol=TOL, rtol=0)


def test_k2_kernel_refuses_float32_taps(dev):
    """The kernel multiplies bf16 taps only: fast=False raises on the card
    before any launch; no model path asks for it."""
    x, w, g, b, _ = _k2_inputs(12, 8, 8, dev, H=4, W=5)
    port_fc.reset_counts()
    with pytest.raises(ValueError, match="fast=False"):
        port_fc.conv3x3_ln_act(x, w, g, b, act="gelu", fast=False)
    assert port_fc.conv3x3_ln_act.launches == 0


def test_k2_kernel_batch_and_count(dev):
    x, w, g, b, _ = _k2_inputs(3, 8, 24, dev, B=3, H=5, W=130)
    port_fc.reset_counts()
    got = port_fc.conv3x3_ln_act(x, w, g, b, act="gelu")
    assert port_fc.conv3x3_ln_act.launches == 1
    assert sum(port_fc.conv3x3_ln_act.shape_launches.values()) == 1
    torch.testing.assert_close(
        got, port_fc.conv3x3_ln_act_plain(x, w, g, b, act="gelu"),
        atol=TOL, rtol=0)


def test_k2_kernel_rejects_wide_output(dev):
    x, w, g, b, _ = _k2_inputs(4, 4, 257, dev, H=3, W=3)
    with pytest.raises(ValueError, match="Co <="):
        port_fc.conv3x3_ln_act(x, w, g, b, act="gelu")


# ---------------------------------------------------------------------------
# gradients: each kernel's autograd.Function against autograd through its
# plain version, on the card. Tolerance 1e-4 of max(1, the call's largest
# |reference gradient|): both float32, the weight gradient sums over every
# pixel in another order, and K1's bias gradient is zero in exact
# arithmetic (its LayerNorm removes a per-head constant), so it holds
# float noise of the size of the others.
# ---------------------------------------------------------------------------

def _grads(fn, inputs, ct, **kw):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    y = fn(*leaves, **kw)
    return y, torch.autograd.grad(y, leaves, ct)


def _close_scaled(got, want):
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL * scale, rtol=0)


@pytest.mark.parametrize("act", [None, "gelu", "elu"])
@pytest.mark.parametrize("ci,co,ln,res", [(30, 60, True, False),
                                          (300, 120, True, False),
                                          (160, 160, False, False),
                                          (3, 5, True, True)])
def test_k2_function_grads_match_plain_autograd(dev, act, ci, co, ln, res):
    x, w, g, b, r = _k2_inputs(5, ci, co, dev, B=2, H=11, W=37)
    args = [x, w] + ([g, b] if ln else []) + ([r] if res else [])
    ct = torch.randn(2, 11, 37, co, device=dev,
                     generator=torch.Generator(dev).manual_seed(ci))

    def call(fn):
        def f(*t):
            t = list(t)
            xx, ww = t[0], t[1]
            gg, bb = (t[2], t[3]) if ln else (None, None)
            rr = t[-1] if res else None
            return fn(xx, ww, gg, bb, rr, act)
        return f

    port_fc.reset_counts()
    y, got = _grads(call(port_fc.conv3x3_ln_act), args, ct)
    torch.cuda.synchronize()
    assert y.grad_fn is not None
    assert port_fc.conv3x3_ln_act.launches == 1
    # the recompute, then dx in pieces of at most MAX_CO channels
    assert port_fc.conv3x3_ln_act.bwd_launches == 1 + -(-ci // port_fc.MAX_CO)
    _, want = _grads(call(port_fc.conv3x3_ln_act_plain), args, ct)
    _close_scaled(got, want)


def test_k1_function_grads_match_plain_autograd(dev):
    a, w, b = _k1_inputs(6, (2, 98, 40, 16), dev)
    ct = torch.randn(a.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(1))
    before = port_k1.ref_attn_diffusion.launches
    y, got = _grads(port_k1.ref_attn_diffusion, (a, w, b), ct)
    assert y.grad_fn is not None
    assert port_k1.ref_attn_diffusion.launches == before + 1
    _, want = _grads(port_k1.ref_attn_diffusion_plain, (a, w, b), ct)
    _close_scaled(got, want)


def test_cuda_outputs_carry_grad_fn_only_when_inputs_require_grad(dev):
    """A CUDA launch goes through ctypes on raw pointers; the autograd
    registrations of the custom ops around it keep the graph."""
    x, w, g, b, _ = _k2_inputs(7, 8, 16, dev, H=4, W=9)
    assert port_fc.conv3x3_ln_act(x, w, g, b, act="gelu").grad_fn is None
    w.requires_grad_()
    y = port_fc.conv3x3_ln_act(x, w, g, b, act="gelu")
    assert y.grad_fn is not None and y.is_cuda
    a, kw, kb = _k1_inputs(8, (1, 14, 6, 4), dev)
    kb.requires_grad_()
    assert port_k1.ref_attn_diffusion(a, kw, kb).grad_fn is not None
    with torch.no_grad():
        assert port_k1.ref_attn_diffusion(a, kw, kb).grad_fn is None


# ---------------------------------------------------------------------------
# K3 (windowed MSA) and K4 (layout fence)
# ---------------------------------------------------------------------------

def _msa_inputs(seed, shape, dev, with_mask):
    B, nW, H, N, hd = shape
    rng = np.random.default_rng(seed)
    q, k, v = (_t(rng.normal(size=shape), dev) for _ in range(3))
    bias = _t(rng.normal(size=(H, N, N)), dev)
    mask = (_t(np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0), dev)
            if with_mask else None)
    return q, k, v, bias, mask


@pytest.mark.parametrize("shape,with_mask", [
    ((1, 5, 3, 9, 1), True), ((2, 7, 2, 6, 2), False),
    ((2, 7, 2, 6, 5), True), ((3, 4, 4, 9, 32), True),
    ((1, 20, 16, 49, 32), True), ((1, 1036, 16, 49, 4), False),
    ((2, 247, 16, 49, 8), True), ((1, 3, 2, 64, 3), True),
    ((2, 5, 1, 1, 7), False),
    # the largest tiles (N = 64, hd = 32); head widths that pad to each
    # k step with a tail of 1..3 floats; one head; the 1/4 train site,
    # B > 1 with a mask (w mod nW), many windows a block
    ((2, 3, 4, 64, 32), True), ((1, 6, 2, 49, 1), True),
    ((1, 6, 2, 49, 3), False), ((1, 6, 2, 49, 12), True),
    ((1, 6, 2, 49, 20), False), ((1, 6, 2, 49, 31), True),
    ((2, 5, 1, 49, 16), True), ((2, 962, 16, 49, 4), True)])
def test_k3_kernel_matches_plain(dev, shape, with_mask):
    q, k, v, bias, mask = _msa_inputs(9, shape, dev, with_mask)
    port_wm.reset_counts()
    got = port_wm.window_msa_kernel(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert port_wm.window_msa_kernel.launches == 1
    B, nW, H, N, hd = shape
    assert got.shape == (B, nW, N, H * hd) and got.dtype == torch.float32
    want = port_wm.window_msa_plain(q, k, v, bias, mask)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def test_k3_kernel_wide_logits(dev):
    """q scaled x8, so that the logits span about +-50: the 3xTF32
    products keep the 1e-4 bound where one TF32 pass would not."""
    q, k, v, bias, mask = _msa_inputs(15, (1, 20, 16, 49, 4), dev, True)
    q = q * 8
    s = torch.einsum("bwhnd,bwhmd->bwhnm", q, k) + bias
    assert float(s.amax()) > 40 and float(s.amin()) < -40
    torch.testing.assert_close(
        port_wm.window_msa_kernel(q, k, v, bias, mask),
        port_wm.window_msa_plain(q, k, v, bias, mask), atol=TOL, rtol=0)


def test_k3_kernel_rows_all_masked(dev):
    """Rows whose every logit carries the -100 mask (the softmax is shift
    invariant, so they equal the unmasked rows) beside partly masked
    ones."""
    q, k, v, bias, mask = _msa_inputs(16, (2, 6, 4, 49, 8), dev, True)
    mask[:, ::5] = -100.0
    got = port_wm.window_msa_kernel(q, k, v, bias, mask)
    torch.testing.assert_close(
        got, port_wm.window_msa_plain(q, k, v, bias, mask), atol=TOL, rtol=0)
    plain = port_wm.window_msa_plain(q, k, v, bias, None)
    torch.testing.assert_close(got[:, :, ::5], plain[:, :, ::5], atol=TOL,
                               rtol=0)


def test_k3_kernel_reruns_and_graph_replay_are_bit_equal(dev):
    """Each output is summed in one fixed order: three reruns and a replay
    of a CUDA graph that captured a call give the same bits."""
    q, k, v, bias, mask = _msa_inputs(17, (1, 70, 16, 49, 16), dev, True)
    first = port_wm.window_msa_kernel(q, k, v, bias, mask)
    for _ in range(3):
        assert torch.equal(port_wm.window_msa_kernel(q, k, v, bias, mask),
                           first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        port_wm.window_msa_kernel(q, k, v, bias, mask)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = port_wm.window_msa_kernel(q, k, v, bias, mask)
    got.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, first)


_K3_ONE_LAUNCH = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, {tests!r})
from test_torch_cuda import _msa_inputs
from gwdepth_tpu_torch.ops import window_msa as port_wm

dev = torch.device("cuda")
calls = [_msa_inputs(18, shape, dev, m) for shape, m in (
    ((1, 20, 16, 49, 32), True), ((1, 1036, 16, 49, 4), False))]
for args in calls:
    port_wm.window_msa_kernel(*args)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for args in calls:
        port_wm.window_msa_kernel(*args)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]))
"""


def test_k3_kernel_is_one_launch(dev):
    """The profiler sees one CUDA kernel per call, at a site with one
    window a block and at one with many. Profiled in a process of its
    own: in this file's process, after the profiles and graph captures of
    the tests before it, the profiler came back with no device events at
    all (none of any kernel), though the test passed alone and after the
    K3 graph test."""
    import json
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(tests)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    run = subprocess.run([sys.executable, "-c",
                          _K3_ONE_LAUNCH.format(tests=tests)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    kernels = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(kernels) == 2 and all("window_msa_kernel" in k
                                     for k in kernels), kernels


@pytest.mark.parametrize("hd", [8, 12, 5])
def test_k3_kernel_unaligned_views(dev, hd):
    """q, k, v that start 4 bytes into their storage: no row is 16-byte
    aligned, so every element takes a 4-byte copy."""
    q, k, v, bias, mask = _msa_inputs(19, (2, 9, 4, 49, hd), dev, True)
    shifted = []
    for t in (q, k, v):
        flat = torch.cat([t.reshape(-1)[:1], t.reshape(-1)])
        shifted.append(flat[1:].view(t.shape))
    assert not any(port_wm.rows_aligned(t) for t in shifted)
    torch.testing.assert_close(
        port_wm.window_msa_kernel(*shifted, bias, mask),
        port_wm.window_msa_plain(q, k, v, bias, mask), atol=TOL, rtol=0)


def test_k3_kernel_reads_strided_views_and_scales_q(dev):
    """The model's head-split views and the fused entry's q scaling: q, k,
    v as (B, nW, H, N, hd) views of one (B*nW, N, 3C) product."""
    rng = np.random.default_rng(10)
    B, nW, N, H, hd = 2, 6, 49, 4, 8
    C = H * hd
    qkv = _t(rng.normal(size=(B * nW, N, 3 * C)), dev)
    q, k, v = port_wm._split_qkv(qkv, B, H)
    assert not q.is_contiguous()
    bias = _t(rng.normal(size=(H, N, N)), dev)
    got = torch.ops.gwdepth.window_msa(q, k, v, bias, None, hd ** -0.5)
    want = port_wm.window_msa_plain(q * hd ** -0.5, k, v, bias, None)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 2, 2, 65, 4), (1, 2, 2, 9, 33)])
def test_k3_kernel_refuses_what_it_cannot_take(dev, shape):
    q, k, v, bias, _ = _msa_inputs(11, shape, dev, False)
    B, nW, H, N, hd = shape
    C = H * hd
    x = torch.zeros(B, nW, N, C, device=dev)
    w = [torch.zeros(s, device=dev)
         for s in ((3 * C, C), (3 * C,), (C, C), (C,))]
    port_wm.reset_counts()
    with pytest.raises(ValueError, match="N <= 64"):
        port_wm.window_msa_kernel(q, k, v, bias, None)
    with pytest.raises(ValueError, match="N <= 64"):
        port_wm.fused_window_attention(x, *w, bias, None, H)
    # refused before any launch, the fence's included
    assert port_wm.window_msa_kernel.launches == 0
    assert port_wm.layout_fence.launches == 0


def test_k3_function_grads_match_plain_autograd(dev):
    q, k, v, bias, mask = _msa_inputs(12, (2, 7, 4, 49, 8), dev, True)
    ct = torch.randn(2, 7, 49, 32, device=dev,
                     generator=torch.Generator(dev).manual_seed(2))
    y, got = _grads(port_wm.window_msa_kernel, (q, k, v, bias), ct,
                    mask=mask)
    assert y.grad_fn is not None
    _, want = _grads(port_wm.window_msa_plain, (q, k, v, bias), ct,
                     mask=mask)
    _close_scaled(got, want)


@pytest.mark.parametrize("with_mask", [True, False])
def test_fused_window_attention_grads_match_plain_autograd(dev, with_mask):
    rng = np.random.default_rng(13)
    B, nW, N, C, H = 2, 70, 49, 64, 16
    x = _t(rng.normal(size=(B, nW, N, C)), dev)
    w = [_t(0.1 * rng.normal(size=s), dev)
         for s in ((3 * C, C), (3 * C,), (C, C), (C,))]
    bias = _t(rng.normal(size=(H, N, N)), dev)
    mask = (_t(np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0), dev)
            if with_mask else None)
    ct = torch.randn(B, nW, N, C, device=dev,
                     generator=torch.Generator(dev).manual_seed(3))
    port_wm.reset_counts()

    def call(fn):
        return lambda *t: fn(*t, mask, H)

    y, got = _grads(call(port_wm.fused_window_attention), (x, *w, bias), ct)
    torch.cuda.synchronize()
    assert y.grad_fn is not None
    assert port_wm.window_msa_kernel.launches == 1
    assert port_wm.layout_fence.launches == 1
    y_plain, want = _grads(call(port_wm.fused_window_attention_plain),
                           (x, *w, bias), ct)
    torch.testing.assert_close(y, y_plain, atol=TOL, rtol=0)
    _close_scaled(got, want)


def test_k3_k4_outputs_carry_grad_fn_only_when_inputs_require_grad(dev):
    q, k, v, bias, mask = _msa_inputs(14, (1, 4, 2, 9, 4), dev, True)
    assert port_wm.window_msa_kernel(q, k, v, bias, mask).grad_fn is None
    bias.requires_grad_()
    y = port_wm.window_msa_kernel(q, k, v, bias, mask)
    assert y.grad_fn is not None and y.is_cuda
    with torch.no_grad():
        assert port_wm.window_msa_kernel(q, k, v, bias, mask).grad_fn is None
    x = _t(np.ones((4, 9, 8)), dev)
    assert port_wm.layout_fence(x).grad_fn is None
    assert port_wm.layout_fence(x.requires_grad_()).grad_fn is not None
    w = [torch.zeros(s, device=dev) for s in ((24, 8), (24,), (8, 8), (8,))]
    x = _t(np.ones((1, 4, 9, 8)), dev)
    b = bias.detach()
    assert port_wm.fused_window_attention(x, *w, b, mask, 2).grad_fn is None
    w[2].requires_grad_()
    assert port_wm.fused_window_attention(x, *w, b, mask, 2).grad_fn \
        is not None


@pytest.mark.parametrize("shape,dtype", [
    ((16, 9, 5), torch.float32), ((7, 4), torch.float32),
    ((1036, 49, 64), torch.float32), ((3, 333), torch.uint8),
    ((5, 7), torch.float16)])
def test_k4_fence_is_identity_and_counts(dev, shape, dtype):
    x = torch.randn(shape, device=dev).mul(50).to(dtype)
    port_wm.reset_counts()
    got = port_wm.layout_fence(x)
    torch.cuda.synchronize()
    assert port_wm.layout_fence.launches == 1
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    # an offset view: not 16-byte aligned, so the byte loop copies it
    view = x.reshape(-1)[1:].reshape(1, -1)
    assert torch.equal(port_wm.layout_fence(view), view)
    assert port_wm.layout_fence.launches == 2
    one = torch.arange(5.0, device=dev)
    assert port_wm.layout_fence(one) is one
    assert port_wm.layout_fence.launches == 2


# byte counts around the kernel's edges: empty, below one word, one word,
# one word and a byte, around 8 KB, and around one block's trip (256
# threads x 8 words x 16 bytes)
_FENCE_BYTES = (0, 1, 15, 16, 17, 8191, 8192, 8193, 32767, 32768, 32769,
                100003)


@pytest.mark.parametrize("offset", [0, 1, 3, 16])
def test_k4_copies_every_byte(dev, offset):
    """Every byte count, from a view that starts
    `offset` bytes into its storage (1, 3: not 16-byte aligned; 16:
    aligned but not at the allocation's start), bit-exact, one launch a
    non-empty copy."""
    store = torch.randint(0, 256, (max(_FENCE_BYTES) + offset,),
                          dtype=torch.uint8, device=dev,
                          generator=torch.Generator(dev).manual_seed(offset))
    for n in _FENCE_BYTES:
        x = store[offset:offset + n].view(1, n)
        assert n == 0 or x.data_ptr() % 16 == offset % 16
        port_wm.reset_counts()
        got = torch.ops.gwdepth.layout_fence(x)
        torch.cuda.synchronize()
        assert port_wm.layout_fence.launches == (1 if n else 0)
        assert torch.equal(got, x), (offset, n)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float32])
def test_k4_fence_dtypes_and_large_input(dev, dtype):
    """1-byte, bf16 and float32 elements through the fence, at a size of
    the fused entry's largest site (about 13 MB) and an odd one."""
    gen = torch.Generator(dev).manual_seed(5)
    per_row = 256 // torch.empty((), dtype=dtype).element_size()
    for shape in ((1036 * 49, per_row), (7, 333)):
        x = torch.randn(shape, device=dev, generator=gen).mul(50).to(dtype)
        port_wm.reset_counts()
        got = port_wm.layout_fence(x)
        torch.cuda.synchronize()
        assert port_wm.layout_fence.launches == 1
        assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))


def test_k4_fence_view_with_unaligned_offset(dev):
    """A float32 view 4 bytes into its storage, and a bf16 view 2 bytes
    in: not 16-byte aligned, copied bit-exact in one launch."""
    for dtype, shift in ((torch.float32, 1), (torch.bfloat16, 1)):
        base = torch.randn(4097 * 9, device=dev).to(dtype)
        x = base[shift:shift + 4096 * 9].view(4096, 9)
        assert x.data_ptr() % 16 != 0
        port_wm.reset_counts()
        got = port_wm.layout_fence(x)
        torch.cuda.synchronize()
        assert port_wm.layout_fence.launches == 1
        assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))


def test_k4_fence_reads_strided_views_in_one_launch(dev):
    """The fused entry's x, a channel slice of wider rows, and other views
    (a transpose, rows of 12 bytes, a broadcast, a negative-free 4-dim
    slice) are copied bit-exact by one launch, without a contiguous copy
    before it."""
    gen = torch.Generator(dev).manual_seed(7)
    xw = torch.randn(2, 70, 49, 64 + 2 * 16, device=dev, generator=gen)
    big = torch.randn(6, 5, 7, 9, 11, device=dev, generator=gen)
    views = [xw[..., :64], xw[..., 64:80], xw[:, ::3, :, :64],
             xw[0].transpose(0, 1), xw[..., 1:4],
             torch.randn(33, device=dev, generator=gen).expand(7, 33),
             big[:, 1:4, ::2, 2:, 3:7]]
    for x in views:
        port_wm.reset_counts()
        got = torch.ops.gwdepth.layout_fence(x)
        torch.cuda.synchronize()
        assert port_wm.layout_fence.launches == 1
        assert got.is_contiguous() and torch.equal(got, x)
    with pytest.raises(ValueError, match="strided row dims"):
        torch.ops.gwdepth.layout_fence(big[::2, ::2, ::2, ::2, ::2])


def test_k3_k4_ops_launch_their_kernels(dev):
    """`gwdepth::window_msa` and `gwdepth::layout_fence` on CUDA tensors:
    one launch of their kernel a call, counted as the entries count them
    (the fused entry one of each), each output equal to the plain
    version's."""
    q, k, v, bias, mask = _msa_inputs(21, (2, 6, 4, 49, 8), dev, True)
    port_wm.reset_counts()
    got = torch.ops.gwdepth.window_msa(q, k, v, bias, mask, 0.5)
    torch.cuda.synchronize()
    assert (port_wm.window_msa_kernel.launches,
            port_wm.layout_fence.launches) == (1, 0)
    torch.testing.assert_close(
        got, port_wm.window_msa_plain(q * 0.5, k, v, bias, mask), atol=TOL,
        rtol=0)
    x = torch.randn(12, 49, 40, device=dev)[..., :32]
    got = torch.ops.gwdepth.layout_fence(x)
    torch.cuda.synchronize()
    assert (port_wm.window_msa_kernel.launches,
            port_wm.layout_fence.launches) == (1, 1)
    assert got.is_contiguous() and torch.equal(got, x)
    gen = torch.Generator(dev).manual_seed(22)
    w = [0.2 * torch.randn(s, device=dev, generator=gen)
         for s in ((96, 32), (96,), (32, 32), (32,))]
    xw = torch.randn(2, 6, 49, 32, device=dev, generator=gen)
    with torch.no_grad():
        got = port_wm.fused_window_attention(xw, *w, bias, mask, 4)
    torch.cuda.synchronize()
    assert (port_wm.window_msa_kernel.launches,
            port_wm.layout_fence.launches) == (2, 2)
    torch.testing.assert_close(got, port_wm.fused_window_attention_plain(
        xw, *w, bias, mask, 4), atol=TOL, rtol=0)


def test_no_op_on_a_cuda_tensor_takes_a_plain_version(dev, monkeypatch):
    """Each custom op (K1, K2, K3, K4, lap_jv) and each entry that calls
    one, on CUDA tensors, launches its kernel: every plain version raises
    here, and the launch counts move."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in ((port_k1, "ref_attn_diffusion_plain"),
                      (port_fc, "conv3x3_ln_act_plain"),
                      (port_wm, "window_msa_plain"),
                      (port_wm, "layout_fence_plain"),
                      (port_lap, "jv_plain")):
        monkeypatch.setattr(mod, name, refuse)
    for mod in (port_k1, port_fc, port_wm, port_lap):
        mod.reset_counts()
    a, w, b = _k1_inputs(23, (1, 50, 8, 16), dev)
    x, w2, g2, b2, r2 = _k2_inputs(24, 30, 60, dev)
    q, k, v, bias, mask = _msa_inputs(25, (1, 6, 4, 49, 8), dev, True)
    cost, nv = _lap_problems(26, (2, 1, 12, 9))
    gen = torch.Generator(dev).manual_seed(27)
    wf = [0.2 * torch.randn(s, device=dev, generator=gen)
          for s in ((96, 32), (96,), (32, 32), (32,))]
    with torch.no_grad():
        torch.ops.gwdepth.ref_attn_diffusion(a, w, b)
        port_k1.ref_attn_diffusion(a, w, b)
        torch.ops.gwdepth.conv3x3_ln_act(x, w2, g2, b2, r2, "gelu", True)
        port_fc.conv3x3_ln_act(x, w2, g2, b2, r2, "gelu")
        torch.ops.gwdepth.window_msa(q, k, v, bias, mask, 1.0)
        port_wm.window_msa_kernel(q, k, v, bias, mask)
        torch.ops.gwdepth.layout_fence(x)
        port_wm.layout_fence(x)
        port_wm.fused_window_attention(
            torch.randn(1, 6, 49, 32, device=dev, generator=gen), *wf,
            bias, mask, 4)
        torch.ops.gwdepth.lap_jv(cost.to(dev), nv.to(dev))
        port_lap.lap_jv(cost.to(dev), nv.to(dev))
    torch.cuda.synchronize()
    assert (port_k1.ref_attn_diffusion.launches,
            port_fc.conv3x3_ln_act.launches,
            port_wm.window_msa_kernel.launches,
            port_wm.layout_fence.launches,
            port_lap.lap_jv.launches) == (2, 2, 3, 3, 2)


# a tiny `use_pallas` model exported on the card and served through
# `export.load_exported` in a process of its own (the profiler's device
# events and CUDA API calls are reliable in a fresh process; see
# `test_k3_kernel_is_one_launch`): three calls graphed and under
# `graphs.disable()`, then one graphed and one eager call profiled
_SERVED_ARTIFACT = r"""
import json, sys
import torch
from gwdepth_tpu_torch import export, graphs
from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.models import build_glassrgbd
from gwdepth_tpu_torch.ops import fused_conv, ref_attn_diffusion
from gwdepth_tpu_torch.tools.dispatch_census import profiled

dev = torch.device("cuda")
cfg = tiny_test_config(use_pallas=True)
cfg.set_matmul_precision()
model = build_glassrgbd(cfg, 0, device="cpu").to(dev).eval()
path = sys.argv[1]
torch.export.save(export.export_forward(cfg, model, 1, "cuda"), path)
call = export.load_exported(path)
(shape, _), (vshape, _) = call.in_avals
gen = torch.Generator(dev).manual_seed(0)
xs = [torch.randn(shape, device=dev, generator=gen) for _ in range(3)]
valid = torch.ones(vshape, dtype=torch.bool, device=dev)
equal, counts = [], []
with torch.no_grad():
    for x in xs:
        for mode in ("graphed", "eager"):
            ref_attn_diffusion.reset_counts()
            fused_conv.reset_counts()
            if mode == "graphed":
                got = [t.clone() for t in call(x, valid)]
            else:
                with graphs.disable():
                    want = call(x, valid)
            counts.append([ref_attn_diffusion.ref_attn_diffusion.launches,
                           fused_conv.conv3x3_ln_act.launches])
        equal.append([bool(torch.equal(g, w)) for g, w in zip(got, want)])
    graphed = profiled(lambda: call(xs[0], valid))
    with graphs.disable():
        eager = profiled(lambda: call(xs[0], valid))
print(json.dumps({"equal": equal, "counts": counts,
                  "stats": {k: graphs.stats["exported_forward", k]
                            for k in ("captures", "replays", "eager_runs")},
                  "graphed": graphed, "eager": eager}))
"""


def test_graphed_artifact_equals_its_eager_call_without_host_launches(
        dev, tmp_path):
    """`export.load_exported` on the card replays one CUDA graph a
    signature: each call's outputs equal the same artifact's under
    `graphs.disable()` bit for bit; after the capture a call issues no
    kernel launch from the host and one graph launch, and the replay runs
    K1's and K2's kernels as often as the eager call."""
    import json
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(tests)] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    run = subprocess.run([sys.executable, "-c", _SERVED_ARTIFACT,
                          str(tmp_path / "tiny.pt2")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert all(all(e) for e in res["equal"]), res["equal"]
    graphed, eager = res["counts"][0::2], res["counts"][1::2]
    assert min(eager[0]) > 0 and all(c == eager[0] for c in eager), eager
    # the first call also runs the capture's warm-ups
    assert graphed == [[3 * n for n in eager[0]], eager[0], eager[0]], graphed
    assert res["stats"] == {"captures": 1, "replays": 4,
                            "eager_runs": 2 + 4}, res["stats"]
    g, e = res["graphed"], res["eager"]
    assert g["host_launches"] == 0 and g["graph_launches"] == 1, g
    assert e["host_launches"] > 0 and e["graph_launches"] == 0, e
    assert g["kernels_by_name"] == e["kernels_by_name"], (g, e)
    assert g["kernels_by_name"]["k1"] == eager[0][0]
    assert g["kernels_by_name"]["k2"] == eager[0][1]


def _lap_problems(seed, shape):
    """(L, B, Q, T) float32 costs, every other problem rounded to
    integers (exact ties), n_valid drawn from 0..T with T and 0 present."""
    L, B, Q, T = shape
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(L * B, Q, T)).astype(np.float32)
    cost[::2] = np.round(2 * cost[::2])
    nv = rng.integers(0, T + 1, size=L * B)
    nv[0] = T
    nv[-1] = 0 if L * B > 1 else T
    return (torch.from_numpy(cost.reshape(L, B, Q, T)),
            torch.from_numpy(nv.reshape(L, B)))


@pytest.mark.parametrize("shape", [(6, 2, 100, 96), (3, 1, 7, 5),
                                   (2, 2, 40, 40), (1, 1, 33, 33),
                                   # shared memory past 48 KB
                                   (1, 2, 3000, 8)])
def test_lap_jv_kernel_equals_plain(dev, shape):
    """Every problem of the call in one launch; the assignments equal the
    plain version's (JAX's float32 arithmetic and order, the lowest
    column on ties) exactly."""
    cost, nv = _lap_problems(0, shape)
    before = port_lap.lap_jv.launches
    got = port_lap.lap_jv(cost.to(dev), nv.to(dev))
    torch.cuda.synchronize()
    assert port_lap.lap_jv.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert torch.equal(got.cpu(), port_lap.jv_plain(cost, nv))
    assert torch.equal(port_lap.lap_jv(cost.to(dev), nv.to(dev)), got)


def test_lap_jv_kernel_stops_on_non_finite_costs(dev):
    cost = torch.full((2, 12, 9), float("nan"))
    cost[1] = float("inf")
    nv = torch.tensor([9, 9])
    got = port_lap.lap_jv(cost.to(dev), nv.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), port_lap.jv_plain(cost, nv))


def test_criterion_jv_is_one_launch_without_sync(dev):
    """The criterion at the shipped shape (6 decoder layers, bs 2, 100
    queries, 96 slots) with the JV matcher: one kernel launch, no
    device-to-host copy or sync, the CPU criterion's losses."""
    rng = np.random.default_rng(3)
    B, Q, T, D = 2, 100, 96, 6

    def layer():
        return {"pred_logits": torch.from_numpy(
                    rng.normal(size=(B, Q, 2)).astype(np.float32)),
                "pred_lines": torch.from_numpy(
                    rng.uniform(size=(B, Q, D)).astype(np.float32))}

    out = layer()
    out["aux_outputs"] = [layer() for _ in range(5)]
    lines = torch.from_numpy(rng.uniform(size=(B, T, D)).astype(np.float32))
    mask = torch.zeros((B, T), dtype=torch.bool)
    mask[0, :37] = True
    mask[1, :T] = True
    kw = dict(eos_coef=0.1, set_cost_class=1.0, set_cost_line=5.0,
              matcher_backend="jax")

    def to(o, d):
        r = {k: v.to(d) for k, v in o.items() if k != "aux_outputs"}
        r["aux_outputs"] = [to(a, d) for a in o.get("aux_outputs", [])]
        return r

    gpu = (to(out, dev), lines.to(dev), mask.to(dev))
    torch.cuda.synchronize()
    before = port_lap.lap_jv.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = port_crit.line_set_criterion(*gpu, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert port_lap.lap_jv.launches == before + 1
    want = port_crit.line_set_criterion(out, lines, mask, **kw)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-6,
                                   atol=1e-7, msg=k)


def test_device_prefetch_copies_pinned_batches_without_a_sync(dev):
    """`engine.device_prefetch` on the card: pinned batches arrive in
    order and equal, with no synchronizing call; an unpinned batch
    raises."""
    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.data.batch import FIELDS, dummy_batch
    from gwdepth_tpu_torch.engine import device_prefetch

    cfg = tiny_test_config()
    items = [(dummy_batch(cfg, 2, seed=i).pin_memory(), [f"s{i}"])
             for i in range(4)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(device_prefetch(iter(items), dev))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(got) == len(items)
    for (moved, host, names), (want, want_names) in zip(got, items):
        assert names == want_names and host is want
        for f in FIELDS:
            assert torch.equal(getattr(moved, f).cpu(), getattr(want, f)), f
    with pytest.raises(ValueError):
        next(device_prefetch(iter([(dummy_batch(cfg, 1), ["x"])]), dev))


def test_tables_reach_the_card_once(dev):
    """After a first call of each shape, the resizes and the shifted-window
    mask run under sync-debug mode "error", and equal the CPU's."""
    from gwdepth_tpu_torch.ops import interpolate as interp
    from gwdepth_tpu_torch.ops import window as pwindow

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 24, 32, 4)).astype(np.float32))

    def run(t):
        return (interp.resize_nearest_nhwc(t, (48, 64)),
                interp.resize_bilinear_nhwc(t, (48, 64), align_corners=True),
                interp.resize_bilinear_matmul_nhwc(t, (48, 64), True),
                interp.avg_pool_matmul_nhwc(t, 4),
                pwindow.shifted_window_attn_mask(28, 35, 7, 3,
                                                 device=t.device))

    xd = x.to(dev)
    run(xd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(xd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(got, run(x)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-6)


# ---- compiled entry points (graphs.py): captured once, replayed ----

@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's too), warning on an
    operation that has none; the settings before restored after."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    yield
    torch.use_deterministic_algorithms(old[0], warn_only=old[1])
    torch.backends.cudnn.deterministic = old[2]


def _tiny_model(dev, **kw):
    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.models import build_glassrgbd

    cfg = tiny_test_config(use_pallas=True, **kw)
    return cfg, build_glassrgbd(cfg, 0, device="cpu")


def test_graphed_forward_equals_the_eager_forward_bit_for_bit(dev):
    """`predict.make_forward` on the card: the first call captures, later
    calls replay; each output equals the eager forward's under
    `graphs.disable()`, and K1 and K2 are counted at each replay."""
    from gwdepth_tpu_torch import graphs
    from gwdepth_tpu_torch.data.batch import dummy_batch
    from gwdepth_tpu_torch.predict import make_forward

    cfg, model = _tiny_model(dev)
    model = model.to(dev).eval()
    fwd = make_forward(model)
    xs = [dummy_batch(cfg, 1, seed=i).to(dev) for i in range(3)]
    graphs.stats.clear()

    def counted(fn):
        port_k1.reset_counts()
        port_fc.reset_counts()
        out = {k: v.clone() for k, v in fn().items()}
        return out, (port_k1.ref_attn_diffusion.launches,
                     port_fc.conv3x3_ln_act.launches)

    with torch.no_grad():
        for i, b in enumerate(xs):
            got, n_graphed = counted(lambda: fwd(b.images, b.valid))
            with graphs.disable():
                want, n_eager = counted(lambda: fwd(b.images, b.valid))
            for k in want:
                assert torch.equal(got[k], want[k]), k
            # the first call also runs the warm-ups; a replay counts each
            # kernel the graph holds once
            runs = 1 + (graphs.WARMUPS if i == 0 else 0)
            assert n_graphed == tuple(runs * n for n in n_eager)
    assert (graphs.stats["forward", "captures"],
            graphs.stats["forward", "replays"]) == (1, 3)
    assert min(n_eager) > 0


def _train_states(cfg, model, dev):
    import copy

    from gwdepth_tpu_torch.parallel import create_train_state

    return [create_train_state(cfg, copy.deepcopy(model).to(dev),
                               steps_per_epoch=2) for _ in range(2)]


@pytest.mark.parametrize("remat", [False, True])
def test_graphed_train_steps_equal_eager_steps_bit_for_bit(dev, deterministic,
                                                           remat):
    """Three train steps (dropout 0.1 from one generator, a schedule drop
    after two; with and without `--remat`, whose checkpoints save and
    restore the RNG state) graphed and three under `graphs.disable()` from
    one state: the losses, the parameters and AdamW's moments bit for bit;
    the dropout generator advanced alike; the kept log vectors distinct
    while the returned one is the graph's static output."""
    from gwdepth_tpu_torch import graphs
    from gwdepth_tpu_torch.data.batch import dummy_batch
    from gwdepth_tpu_torch.parallel import make_train_step

    cfg, model = _tiny_model(dev, dropout=0.1, lr_drop=1, remat=remat)
    batches = [dummy_batch(cfg, 2, seed=30 + i).to(dev) for i in range(3)]
    runs = []
    graphs.stats.clear()
    for graphed, state in zip((True, False), _train_states(cfg, model, dev)):
        step = make_train_step(cfg)
        gen = torch.Generator(device=dev).manual_seed(5)
        logs, returned = [], []
        for b in batches:
            if graphed:
                state, vec = step(state, b, gen)
            else:
                with graphs.disable():
                    state, vec = step(state, b, gen)
            returned.append(vec)
            logs.append(vec.clone())
        moments = [t.clone() for p in state.trainable
                   for k, t in state.optimizer.state[p].items()
                   if k in ("exp_avg", "exp_avg_sq")]
        runs.append((logs, [p.detach().clone() for p in
                            state.model.parameters()], moments,
                     gen.get_state(), step))
        if graphed:
            assert all(v is returned[0] for v in returned)
            assert not torch.equal(logs[0], logs[1])
    (lg, pg, mg, sg, _), (le, pe, me, se, _) = runs
    assert (graphs.stats["train_step", "captures"],
            graphs.stats["train_step", "replays"]) == (1, 3)
    assert all(torch.equal(a, b) for a, b in zip(lg, le))
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))
    assert all(torch.equal(a, b) for a, b in zip(mg, me))
    assert torch.equal(sg, se)


def test_a_cpu_optimizer_state_restores_into_a_graphed_card_step(dev):
    """An optimizer state written on the CPU (`capturable=False`, step
    counts on the host), as a checkpoint of `--device cpu` or of an
    earlier version holds, restored into a card state: the groups take
    the card optimizer's `capturable`, the step counts move to the card,
    and graphed steps replay."""
    import copy

    from gwdepth_tpu_torch import graphs
    from gwdepth_tpu_torch.data.batch import dummy_batch
    from gwdepth_tpu_torch.parallel import create_train_state, make_train_step

    cfg, model = _tiny_model(dev)
    batches = [dummy_batch(cfg, 2, seed=40 + i) for i in range(3)]
    cpu = create_train_state(cfg, copy.deepcopy(model), steps_per_epoch=2)
    cpu, _ = make_train_step(cfg)(cpu, batches[0],
                                  torch.Generator().manual_seed(1))
    card = create_train_state(cfg, copy.deepcopy(model).to(dev),
                              steps_per_epoch=2)
    card.model.load_state_dict(cpu.model.state_dict())
    card.load_optimizer_state(cpu.optimizer.state_dict())
    assert all(g["capturable"] and torch.is_tensor(g["lr"])
               and g["lr"].device.type == "cuda"
               for g in card.optimizer.param_groups)
    assert all(st["step"].device.type == "cuda"
               for st in card.optimizer.state.values())
    graphs.stats.clear()
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    for b in batches[1:]:
        card, vec = step(card, b.to(dev), gen)
        assert torch.isfinite(vec).all()
    assert (graphs.stats["train_step", "captures"],
            graphs.stats["train_step", "replays"]) == (1, 2)


def test_a_table_first_built_during_a_capture_raises(dev):
    from gwdepth_tpu_torch.ops import tables

    side = torch.cuda.Stream()
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="graphs-capture-test"):
        with torch.cuda.stream(side), torch.cuda.graph(g):
            tables.device_table(("graphs-capture-test",),
                                lambda: np.zeros(4, np.float32), dev)


def test_graph_reads_its_tables_after_the_cache_evicts_them(dev,
                                                            monkeypatch):
    """The tables a graph read stay alive with it: after MAX_TABLES newer
    entries evict them from the cache, replays still give the eager
    forward's bits."""
    from gwdepth_tpu_torch import graphs
    from gwdepth_tpu_torch.data.batch import dummy_batch
    from gwdepth_tpu_torch.ops import interpolate as interp
    from gwdepth_tpu_torch.ops import tables
    from gwdepth_tpu_torch.predict import make_forward

    tables.clear()
    cfg, model = _tiny_model(dev)
    fwd = make_forward(model.to(dev).eval())
    b = dummy_batch(cfg, 1, seed=3).to(dev)
    with torch.no_grad():
        with graphs.disable():
            want = {k: v.clone() for k, v in fwd(b.images, b.valid).items()}
        fwd(b.images, b.valid)
        held = [t for e in fwd.func.entries.values()
                for t in e.capture.held]
        assert held
        monkeypatch.setattr(tables, "MAX_TABLES", 16)
        for n in range(2, 40):      # evict every entry, then reuse memory
            interp.nearest_idx(n, 5, dev)
            torch.full((4096,), float(n), device=dev)
        assert not any(any(t is c for c in tables._tables.values())
                       for t in held)
        for _ in range(2):
            got = fwd(b.images, b.valid)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    tables.clear()


def test_gloo_group_with_cuda_tensors_raises_outside_disable(dev):
    """gloo's collectives cannot be captured: a compiled call on CUDA
    tensors refuses, and runs eagerly under `graphs.disable()`."""
    import socket

    import torch.distributed as dist

    from gwdepth_tpu_torch import graphs

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        graphs.stats.clear()
        fn = graphs.compiled(lambda x: x * 2)
        x = torch.ones(3, device=dev)
        with pytest.raises(RuntimeError, match="gloo"):
            fn(x)
        with graphs.disable():
            assert torch.equal(fn(x), x * 2)
        assert graphs.stats[fn.name, "captures"] == 0
    finally:
        dist.destroy_process_group()
