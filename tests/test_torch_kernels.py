"""The port's two kernel modules against the JAX package, on the CPU.

K1 `ops/ref_attn_diffusion.py` and K2 `ops/fused_conv.py`: on a CPU
tensor each wrapper runs its plain PyTorch version, which is held here
against the JAX formulations and the Pallas kernels in interpret mode.
The CUDA kernels themselves are held against the same plain versions on
the card (`tests/test_torch_cuda.py`, and `chip_smoke.py`).

Tolerances: float32 against float32 is reassociation (1e-5 / 2e-5). K2
with `fast=True` (bf16 taps, float32 accumulation) is held against the JAX
fused conv with `fast=True` in interpret mode: both round x and w to bf16
the same way (round to nearest even) and the product of two bf16 numbers
is exact in float32, so they differ by the order of the float32 sums
only (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.models.swin import diffusion_xla
from gwdepth_tpu.ops.fused_conv import (conv3x3_ln_act as jax_conv3x3,
                                        conv3x3_ln_act_reference,
                                        fused_conv_ln_act_frame,
                                        frame_to_nhwc, nhwc_to_frame)
from gwdepth_tpu.ops.pallas_kernels import ref_attn_diffusion_pallas

from gwdepth_tpu_torch.ops import fused_conv as port_fc
from gwdepth_tpu_torch.ops import ref_attn_diffusion as port_k1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's torch ops on one intra-op thread, and restore the
    count after it: pytest-xdist runs several test processes on the
    machine's cores beside XLA's thread pools, where torch's pool of one
    spinning thread per core slowed every process down. Yields the count
    it found."""
    found = torch.get_num_threads()
    torch.set_num_threads(1)
    yield found
    torch.set_num_threads(found)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _k1_inputs(seed, B=2, P=30, R=8, H=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, P, R, H)).astype(np.float32)
    w = (rng.normal(size=(3, 3, H, H)) / np.sqrt(9 * H)).astype(np.float32)
    b = (0.1 * rng.normal(size=(H,))).astype(np.float32)
    return a, w, b


def test_k1_plain_matches_diffusion_xla():
    a, w, b = _k1_inputs(0)
    want = np.asarray(diffusion_xla(jnp.asarray(a), jnp.asarray(w),
                                    jnp.asarray(b)))
    got = port_k1.ref_attn_diffusion_plain(_t(a), _t(w), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_k1_plain_matches_pallas_interpret():
    a, w, b = _k1_inputs(1, B=1, P=49, R=6, H=8)
    want = np.asarray(ref_attn_diffusion_pallas(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = port_k1.ref_attn_diffusion_plain(_t(a), _t(w), _t(b)).numpy()
    # the Pallas kernel's A&S erf is within 1.5e-7 of erf
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_k1_wrapper_routes_cpu_to_plain_without_counting():
    a, w, b = _k1_inputs(2)
    before = port_k1.ref_attn_diffusion.launches
    got = port_k1.ref_attn_diffusion(_t(a), _t(w), _t(b))
    want = port_k1.ref_attn_diffusion_plain(_t(a), _t(w), _t(b))
    assert torch.equal(got, want)
    assert port_k1.ref_attn_diffusion.launches == before


def test_k1_wrapper_raises_on_other_devices():
    a, w, b = (t.to("meta") for t in map(_t, _k1_inputs(3)))
    with pytest.raises(ValueError, match="no kernel"):
        port_k1.ref_attn_diffusion(a, w, b)


@pytest.mark.parametrize("shape", [(1, 980, 40, 16), (2, 980, 40, 16),
                                   (1, 997, 12, 8), (2, 20, 40, 16),
                                   (1, 7, 3, 2), (3, 50, 33, 32)])
def test_k1_band_partition(shape):
    """K1's persistent grid on a 132-SM card: the bands cover every row of
    every plane once, none crosses a plane, a plane's bands differ by at
    most a row, every block has at least one row, and the threads cover
    the widest band."""
    B, P, R, H = shape
    plan = port_k1.band_partition(B, P, R, H, sms=132)
    assert len(plan.bands) == B * plan.nbp <= 132
    rows = {}
    for b, p0, n in plan.bands:
        assert 0 <= b < B and n >= 1 and p0 + n <= P
        for p in range(p0, p0 + n):
            assert (b, p) not in rows
            rows[b, p] = True
    assert len(rows) == B * P
    sizes = [n for _, _, n in plan.bands]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) == plan.rows_max
    assert plan.threads % 32 == 0 and plan.threads <= port_k1.THREADS_MAX
    assert plan.threads // plan.ks * plan.pt >= plan.rows_max * R
    assert (plan.ks, plan.pt) in port_k1.kernel_configs(H)
    assert plan.smem == 4 * (9 * H * (H + 4) + 2 * plan.nbp * H + plan.nbp
                             + (plan.rows_max + 2) * (R + 2) * (H + plan.ks)
                             + plan.threads // 32 * H + plan.threads
                             + 4 * H)


def test_k1_kernel_configs_come_from_the_source():
    """The (KS, PT) the wrapper may pick are read from the CUDA source's one
    list of built instances: some for every H the kernel takes, none
    twice, each with KS dividing H and PT * H <= 128 sums in registers."""
    inst = port_k1._instances()
    assert len(set(inst)) == len(inst)
    assert {h for h, _, _ in inst} == set(port_k1._HEADS)
    for H in port_k1._HEADS:
        cfgs = port_k1.kernel_configs(H)
        assert cfgs and all(H % ks == 0 and pt * H <= 128
                            for ks, pt in cfgs), (H, cfgs)
    assert (4, 5) in port_k1.kernel_configs(16)


def test_k1_band_partition_main_path():
    """The serving plane: one block per SM, bands of 7 or 8 rows, 8 warps,
    4 threads on each group of 5 positions (320 a block, the widest band),
    the band with its halo 33 KB of shared memory (63 KB in all); the train
    planes: 66 blocks each, 15 rows, 2 threads on each group of 5."""
    plan = port_k1.band_partition(1, 980, 40, 16, sms=132)
    assert (plan.nbp, plan.rows_max, plan.threads, plan.ks, plan.pt) == \
        (132, 8, 256, 4, 5)
    assert plan.smem == 64336
    plan = port_k1.band_partition(2, 980, 40, 16, sms=132)
    assert (plan.nbp, plan.rows_max, plan.threads, plan.ks, plan.pt) == \
        (66, 15, 256, 2, 5)


def test_k1_band_partition_refuses_what_does_not_fit():
    """A band past 227 KB of shared memory, or wider than the block's
    threads can hold, raises before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        port_k1.band_partition(1, 10, 1020, 16, sms=132)
    with pytest.raises(ValueError, match="threads"):
        port_k1.band_partition(1, 10, 2000, 16, sms=132)
    with pytest.raises(ValueError, match="threads"):
        port_k1.band_partition(1, 10, 3000, 2, sms=132)
    # one row a block at a width that fits
    assert port_k1.band_partition(1, 10, 600, 16, sms=132).smem \
        <= port_k1.SMEM_MAX


def _k2_inputs(seed, ci, co=24, B=2, H=12, W=20):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, ci, co)) / np.sqrt(ci)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(co,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(co,))).astype(np.float32)
    r = rng.normal(size=(B, H, W, co)).astype(np.float32)
    return x, w, g, b, r


@pytest.mark.parametrize("act", [None, "gelu", "elu"])
@pytest.mark.parametrize("ci", [16, 300])
def test_k2_plain_matches_reference(act, ci):
    x, w, g, b, _ = _k2_inputs(ci, ci)
    want = np.asarray(conv3x3_ln_act_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g), jnp.asarray(b),
        act=act))
    got = port_fc.conv3x3_ln_act_plain(_t(x), _t(w), _t(g), _t(b),
                                       act=act, fast=False).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("act", [None, "gelu", "elu"])
@pytest.mark.parametrize("ci", [16, 300])
def test_k2_plain_matches_pallas_bf16_taps(act, ci):
    """The port's K2 in its default `fast=True` against the Pallas kernel
    with `fast=True`: both round x and w to bf16 (nearest even) and sum the
    exact float32 products, so only the order of the sums differs, and
    after the LayerNorm that stays below 1e-5 (a float32 plain version
    differs from the Pallas kernel by 1.1e-2 here)."""
    x, w, g, b, _ = _k2_inputs(ci + 1, ci, H=8, W=12)
    want = np.asarray(jax_conv3x3(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g), jnp.asarray(b),
        act=act, fast=True, interpret=True, k_chunk=128))
    got = port_fc.conv3x3_ln_act(_t(x), _t(w), _t(g), _t(b),
                                 act=act).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_k2_fast_rounds_operands_to_bf16():
    """`fast=True` is the float32 contraction of x and w rounded to bf16
    by round to nearest even (torch's cast and the TPU kernel's astype),
    and nothing else."""
    x, w, g, b, _ = _k2_inputs(4, 24, co=16, H=5, W=6)
    xr, wr = (t.astype(np.float32).view(np.uint32) for t in (x, w))
    # round to nearest even on the upper 16 bits, by integer arithmetic
    xr, wr = (((t + 0x7FFF + ((t >> 16) & 1)) & 0xFFFF0000).view(np.float32)
              for t in (xr, wr))
    got = port_fc.conv3x3_ln_act(_t(x), _t(w), _t(g), _t(b), act="gelu")
    want = port_fc.conv3x3_ln_act_plain(_t(xr), _t(wr), _t(g), _t(b),
                                        act="gelu", fast=False)
    assert torch.equal(got, want)


def test_k2_residual_and_no_ln():
    x, w, g, b, r = _k2_inputs(7, 32, co=32)
    want = np.asarray(conv3x3_ln_act_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g), jnp.asarray(b),
        residual=jnp.asarray(r), act="gelu"))
    got = port_fc.conv3x3_ln_act(_t(x), _t(w), _t(g), _t(b), _t(r),
                                 "gelu", fast=False).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    want = np.asarray(conv3x3_ln_act_reference(
        jnp.asarray(x), jnp.asarray(w), act="elu"))
    got = port_fc.conv3x3_ln_act(_t(x), _t(w), act="elu",
                                 fast=False).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_k2_chain_matches_frame_chain():
    """Links chained in NHWC read zero borders exactly as the JAX frame
    chain does (it zeroes its junk columns between links). Both chains
    round each link's input to bf16 (measured 4.8e-7 apart here, so one
    link's 1e-5 holds): an activation that the two float32 sum orders left
    on opposite sides of a bf16 rounding boundary would round one bf16
    step (2^-8 relative) apart and show at about 1e-3."""
    rng = np.random.default_rng(11)
    B, H, W, C = 1, 9, 13, 8
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    ws = [(rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C)).astype(np.float32)
          for _ in range(3)]
    g = np.ones((C,), np.float32)
    b = np.zeros((C,), np.float32)
    acts = ["gelu", None, "gelu"]

    xf = nhwc_to_frame(jnp.asarray(x))
    for w, act in zip(ws, acts):
        xf = fused_conv_ln_act_frame(xf, jnp.asarray(w), jnp.asarray(g),
                                     jnp.asarray(b), act, (H, W))
    want = np.asarray(frame_to_nhwc(xf, (H, W)))

    y = _t(x)
    for w, act in zip(ws, acts):
        y = port_fc.conv3x3_ln_act(y, _t(w), _t(g), _t(b), act=act)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=0)


def test_k2_weight_view_reads_the_rotated_transpose_in_place():
    """The backward's dx conv weight, w[2 - ky, 2 - kx, co, ci], is read by
    the kernel's weight tiling through `weight_view`'s offset and
    strides, without a flipped copy; also on a sliced (non-contiguous)
    piece of w, as the dx split passes it."""
    w = torch.arange(3 * 3 * 7 * 5, dtype=torch.float32).reshape(3, 3, 7, 5)
    flat = w.flatten()
    for ww in (w, w[:, :, 2:6]):
        base = ww.storage_offset()
        for flip in (False, True):
            ci, co, off, st = port_fc.weight_view(ww, flip)
            want = ww.flip(0, 1).transpose(2, 3) if flip else ww
            assert (ci, co) == tuple(want.shape[2:])
            idx = torch.tensor(np.indices(want.shape).reshape(4, -1).T)
            got = flat[base + off + (idx * torch.tensor(st)).sum(1)]
            assert torch.equal(got.reshape(want.shape), want)


def test_k2_wrapper_raises_on_other_devices():
    x, w, g, b, _ = (_t(t).to("meta") for t in _k2_inputs(5, 8, co=8))
    with pytest.raises(ValueError, match="no kernel"):
        port_fc.conv3x3_ln_act(x, w, g, b, act="gelu")
