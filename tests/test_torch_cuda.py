"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and `nvcc` (the CUDA kernels have no
interpret mode), is marked `cuda`, and skips elsewhere. The file imports
no JAX, so it runs on a machine without it; `tests/conftest.py` imports
JAX, so skip it there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance 1e-4 max-abs: both sides are float32 (the plain version's
matmuls without TF32), and the kernels only reassociate the sums.
"""

import numpy as np
import pytest
import torch

from gwdepth_tpu_torch.ops import fused_conv as port_fc
from gwdepth_tpu_torch.ops import ref_attn_diffusion as port_k1

TOL = 1e-4

pytestmark = pytest.mark.cuda


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
                                   (1, 7, 3, 2), (1, 50, 33, 32)])
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
@pytest.mark.parametrize("ci,co", [(30, 60), (300, 120), (160, 160), (3, 5),
                                   (17, 256)])
def test_k2_kernel_matches_plain(dev, act, ci, co):
    x, w, g, b, r = _k2_inputs(2, ci, co, dev)
    for args in ((g, b, None), (g, b, r), (None, None, None)):
        got = port_fc.conv3x3_ln_act(x, w, *args, act)
        want = port_fc.conv3x3_ln_act_plain(x, w, *args, act)
        torch.testing.assert_close(got, want, atol=TOL, rtol=0)


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

def _grads(fn, inputs, ct):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
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
    Functions around it keep the graph."""
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
