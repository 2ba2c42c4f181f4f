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
    torch.backends.cuda.matmul.allow_tf32 = False
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
