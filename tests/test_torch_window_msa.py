"""Kernels K3 (windowed MSA) and K4 (layout fence) of the port against the
JAX package, on the CPU.

On a CPU tensor `window_msa_kernel` runs its plain version and
`fused_window_attention` runs the fence as a copy and K3's plain version;
their autograd Functions run the analytic backward (autograd through the
einsum/softmax formulation). The JAX side runs `window_msa_pallas` in
interpret mode, or the XLA `window_msa` where interpret mode is slow, and
`jax.vjp` of `_attention_xla_reference` for the gradients. Inputs come
from numpy seeds.

Tolerance 1e-5 (scaled by max(1, |reference|) where the reference is
larger): float32 against float32, reassociation only; gradients at 1e-5
of the largest reference gradient of the call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.models import swin as jswin
from gwdepth_tpu.ops.pallas_kernels import _attention_xla_reference
from gwdepth_tpu.ops.pallas_kernels import fused_window_attention as jax_fused
from gwdepth_tpu.ops.pallas_kernels import layout_fence as jax_fence
from gwdepth_tpu.ops.pallas_kernels import window_msa_pallas

from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.models import swin
from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights
from gwdepth_tpu_torch.ops import window_msa as wm

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX references this module compiles, jitted once for all its
    tests: the XLA `window_msa`, its VJP, and `_attention_xla_reference`."""

    def msa_vjp(ct, *a):
        y, vjp = jax.vjp(jswin.window_msa, *a)
        return y, vjp(ct)

    return {"window_msa": jax.jit(jswin.window_msa),
            "window_msa_vjp": jax.jit(msa_vjp),
            "attention": jax.jit(_attention_xla_reference,
                                 static_argnums=7)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0,
                               atol=tol * scale)


def _msa_inputs(B, nW, H, N, hd, with_mask, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, nW, H, N, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    mask = (np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0)
            .astype(np.float32) if with_mask else None)
    return q, k, v, bias, mask


def _jnp(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _pt(*xs):
    return [None if x is None else _t(x) for x in xs]


@pytest.mark.parametrize("B,nW,H,N,hd,with_mask", [(1, 5, 3, 9, 4, True),
                                                   (2, 7, 2, 6, 5, False)])
def test_window_msa_plain_matches_pallas_interpret(B, nW, H, N, hd,
                                                   with_mask):
    args = _msa_inputs(B, nW, H, N, hd, with_mask, B * 100 + nW)
    want = window_msa_pallas(*_jnp(*args), interpret=True)
    _close(wm.window_msa_plain(*_pt(*args)), want)
    _close(wm.window_msa_kernel(*_pt(*args)), want)


def test_window_msa_plain_matches_xla_over_130_windows(jax_ref):
    """Past the TPU kernel's 128-window lane chunk; held against the XLA
    formulation only (interpret mode is slow at this shape)."""
    args = _msa_inputs(1, 130, 4, 49, 4, True, 130)
    _close(wm.window_msa_plain(*_pt(*args)),
           jax_ref["window_msa"](*_jnp(*args)))


def test_window_msa_use_pallas_flag_and_grads_match_jax(jax_ref):
    """`swin.window_msa(use_pallas=True)` routes to K3 and equals the
    einsum/softmax path; K3's Function gives `jax.vjp`'s gradients of the
    XLA `window_msa` for q, k, v, bias and mask."""
    args = _msa_inputs(2, 3, 3, 9, 4, True, 7)
    ct = np.random.default_rng(8).standard_normal((2, 3, 9, 12))
    leaves = [t.requires_grad_() for t in _pt(*args)]
    got = swin.window_msa(*leaves, use_pallas=True)
    assert got.grad_fn is not None and got.dtype == torch.float32
    _close(got, swin.window_msa(*_pt(*args)))
    grads = torch.autograd.grad(got, leaves, _t(ct))
    want_y, want = jax_ref["window_msa_vjp"](jnp.asarray(ct, jnp.float32),
                                             *_jnp(*args))
    _close(got, want_y)
    scale = max(1.0, max(float(np.abs(np.asarray(w)).max()) for w in want))
    for name, g, w in zip(("q", "k", "v", "bias", "mask"), grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL * scale, err_msg=name)
    with torch.no_grad():
        assert swin.window_msa(*leaves, use_pallas=True).grad_fn is None


def test_fused_window_attention_matches_jax_and_vjp():
    """Forward against the JAX fused entry (K3 in interpret mode); the
    gradients of x, both weights and biases, and bias against `jax.vjp` of
    `_attention_xla_reference`. The port takes the weights in nn.Linear
    layout, the transposes of the flax kernels."""
    rng = np.random.default_rng(3)
    B, nW, N, C, H = 1, 6, 9, 32, 4
    x = rng.standard_normal((B, nW, N, C))
    wqkv = 0.2 * rng.standard_normal((C, 3 * C))
    bqkv = 0.1 * rng.standard_normal(3 * C)
    wproj = 0.2 * rng.standard_normal((C, C))
    bproj = 0.1 * rng.standard_normal(C)
    bias = rng.standard_normal((H, N, N))
    mask = np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0)
    ct = rng.standard_normal(x.shape)
    jargs = [jnp.asarray(a, jnp.float32)
             for a in (x, wqkv, bqkv, wproj, bproj, bias, mask)]
    _close(wm.fused_window_attention(*_pt(x, wqkv.T, bqkv, wproj.T, bproj,
                                          bias, mask), H),
           jax_fused(*jargs, H))
    leaves = [t.requires_grad_() for t in
              _pt(x, wqkv.T, bqkv, wproj.T, bproj, bias)]
    got = wm.fused_window_attention(*leaves, _t(mask), H)
    grads = torch.autograd.grad(got, leaves, _t(ct))

    @jax.jit
    def ref_vjp(ct, *a):
        y, vjp = jax.vjp(lambda *p: _attention_xla_reference(*p, a[-1], H),
                         *a[:-1])
        return y, vjp(ct)

    want_y, want_g = ref_vjp(jnp.asarray(ct, jnp.float32), *jargs)
    _close(got, want_y)
    want_g = [np.asarray(g) for g in want_g]
    want_g[1], want_g[3] = want_g[1].T, want_g[3].T     # flax -> nn.Linear
    scale = max(1.0, max(float(np.abs(w).max()) for w in want_g))
    for name, g, w in zip(("x", "wqkv", "bqkv", "wproj", "bproj", "bias"),
                          grads, want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL * scale,
                                   err_msg=name)


def test_fused_entry_on_loaded_window_class_attention():
    """The fused entry with a port `WindowClassAttention`'s own weights,
    loaded from the JAX module's params through `convert/from_jax.py`,
    equals both modules' projection output."""
    rng = np.random.default_rng(3)
    B, nW, N, C, H, tC = 1, 6, 9, 32, 4, 8
    x, dt, st = (rng.standard_normal((B, nW, N, c)).astype(np.float32)
                 for c in (C, tC, tC))
    mask = np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0
                    ).astype(np.float32)
    jm = jswin.WindowClassAttention(C, 3, H, tC)
    jargs = _jnp(x, dt, st, mask)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jargs)
    params = jax.tree.map(
        lambda s: 0.2 * rng.standard_normal(s.shape).astype(np.float32),
        shapes["params"])
    want = jax.jit(jm.apply)({"params": params}, *jargs)[0]
    attn = swin.WindowClassAttention(C, 3, H, tC)
    prefix = "dense_encoder.class_transformer1.blocks.0.attn."
    template = {prefix + k: v for k, v in attn.state_dict().items()}
    sd = jax_params_to_state_dict(
        {"dense_encoder": {"class_transformer1": {"block0": {
            "attn": jax.tree.map(np.asarray, params)}}}}, template)
    attn.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        _close(attn(*_pt(x, dt, st, mask))[0], want)
    xt = _t(x).requires_grad_()
    got = wm.fused_window_attention(xt, attn.qkv.weight, attn.qkv.bias,
                                    attn.proj.weight, attn.proj.bias,
                                    attn.rel_pos_bias(), _t(mask), H)
    _close(got, want)
    (got ** 2).sum().backward()
    assert torch.isfinite(xt.grad).all()
    assert torch.isfinite(attn.qkv.weight.grad).all()
    assert torch.isfinite(attn.relative_position_bias_table.grad).all()


@pytest.mark.parametrize("shape", [(16, 9, 5), (7, 4), (6,)])
def test_layout_fence_is_identity(shape):
    """Equal to the JAX fence in interpret mode; a copy, or x itself below
    two dims as there; the gradient passes through."""
    x = _t(np.random.default_rng(0).standard_normal(shape))
    got = wm.layout_fence(x)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_fence(jnp.asarray(x.numpy()),
                                          interpret=True)))
    if len(shape) < 2:
        assert got is x
        return
    assert got.data_ptr() != x.data_ptr()
    xg = x.clone().requires_grad_()
    ct = torch.ones(shape)
    (g,) = torch.autograd.grad(wm.layout_fence(xg), xg, ct)
    assert torch.equal(g, ct)


def _fence_bytes(x: torch.Tensor) -> bytes:
    """x's bytes gathered from its storage as the fence kernel reads them,
    by `fence_rows`' description."""
    row_bytes, dims = wm.fence_rows(x)
    store = bytes(x.untyped_storage())
    start = x.storage_offset() * x.element_size()
    if not dims:
        return store[start:start + x.numel() * x.element_size()]
    out = []
    for idx in np.ndindex(*[n for n, _ in dims]):
        at = start + sum(i * st for i, (_, st) in zip(idx, dims))
        out.append(store[at:at + row_bytes])
    return b"".join(out)


@pytest.mark.parametrize("make", [
    lambda t: t, lambda t: t[..., :8], lambda t: t[:, ::2, :, 3:5],
    lambda t: t[1].transpose(0, 1), lambda t: t[0, 0, :1].expand(5, 12),
    lambda t: t.reshape(-1)[1:61].view(5, 12)])
def test_fence_rows_describe_the_view(make):
    """The row description the fence kernel gets (contiguous runs of bytes
    and the strides of the rows) gathers exactly x's bytes, for the fused
    entry's channel slice and other views."""
    base = _t(np.random.default_rng(1).standard_normal((2, 6, 7, 12)))
    x = make(base)
    assert _fence_bytes(x) == x.contiguous().numpy().tobytes()
    assert len(wm.fence_rows(x)[1]) <= wm.FENCE_MAX_DIMS


# K3's sites on the main-path config: the 768x1024 bs1 forward's 1/32 ref
# layer and class layers, the class layers at bs2 704x1024 (B, nW, H, N, hd)
K3_SITES = [(1, 20, 16, 49, 32), (1, 70, 16, 49, 16), (1, 266, 16, 49, 8),
            (1, 1036, 16, 49, 4), (2, 70, 16, 49, 16), (2, 247, 16, 49, 8),
            (2, 962, 16, 49, 4)]


@pytest.mark.parametrize("per_sm", [1, 3, 8])
@pytest.mark.parametrize("site", K3_SITES + [(2, 5, 1, 9, 3), (1, 1, 2, 64, 32)])
def test_k3_launch_plan(site, per_sm):
    """K3's grid at every site: one wave at the kernel's occupancy, each
    head with the same G blocks, the windows dealt g, g + G, ... so that
    every window has one block and no block owns more than `windows`, or
    fewer than one less; two stages only where a block owns more than one
    window."""
    B, nW, H, N, hd = site
    W = B * nW
    plan = wm.launch_plan(B, nW, H, N, hd, True, 132, per_sm)
    assert plan.grid % H == 0
    G = plan.grid // H
    assert plan.grid <= max(H, 132 * per_sm)
    owned = [len(range(g, W, G)) for g in range(G)]
    assert sum(owned) == W and min(owned) >= 1
    assert max(owned) == plan.windows and min(owned) >= plan.windows - 1
    # no fewer windows a block would fit the wave
    assert plan.windows == 1 or \
        -(-W // (plan.windows - 1)) * H > 132 * per_sm
    assert plan.stages == (2 if plan.windows > 1 else 1)
    assert plan.smem == wm.smem_bytes(N, wm.head_pad(hd), True, plan.stages)
    assert plan.smem <= wm.SMEM_MAX


def test_k3_launch_plan_main_path():
    """At 132 SMs of 3 blocks: the 1/32 sites one window a block (320
    blocks, one stage), the 1/4 site 44 windows a block in 2 stages."""
    plan = wm.launch_plan(1, 20, 16, 49, 32, True, 132, 3)
    assert (plan.grid, plan.windows, plan.stages) == (320, 1, 1)
    assert plan.smem == 4 * (64 * 56 + 64 * 40 + 56 * 40 + 56 * 36
                             + 64 * 56 + 8)
    plan = wm.launch_plan(1, 1036, 16, 49, 4, False, 132, 3)
    assert (plan.grid, plan.windows, plan.stages) == (24 * 16, 44, 2)
    assert plan.smem == 4 * (64 * 56 + 2 * (64 * 8 + 56 * 8 + 56 * 12))


def _banks_free(addrs, width):
    """A warp's shared-memory read of `width` floats a lane (addresses in
    floats) is served without a bank conflict: 32 lanes of 1 float, or
    each half-warp of 2, touch 32 distinct banks."""
    group = 32 // width
    for h in range(0, 32, group):
        banks = [(a + i) % 32 for a in addrs[h:h + group]
                 for i in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("hd", [1, 4, 8, 12, 16, 20, 24, 31, 32])
@pytest.mark.parametrize("N", [1, 9, 16, 33, 49, 56, 64])
def test_k3_smem_layout_reads_free_of_bank_conflicts(N, hd):
    """The kernel's fragment reads from its carve-up: q, k and bias as
    float2 at rows g (+ 8), columns 2t of an 8-column step; v as floats at
    rows 2t and 2t + 1, columns g; every region and row 16-byte aligned,
    so the 16-byte copies land aligned."""
    lay = wm.smem_layout(N, wm.head_pad(hd), True)
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for stride in (lay["qs"], lay["bs"]):
        for step in range(8):
            assert _banks_free([g * stride + 8 * step + 2 * t
                                for g, t in lanes], 2)
    for odd in (0, 1):
        for step in range(4):
            assert _banks_free([(2 * t + odd) * lay["vs"] + 8 * step + g
                                for g, t in lanes], 1)
    for n in ("qs", "vs", "bs", "stage", "bias"):
        assert lay[n] % 4 == 0, n
    assert lay["np16"] >= N and lay["np8"] >= N
    assert lay["qs"] >= wm.head_pad(hd) and lay["vs"] >= wm.head_pad(hd)
    assert lay["bs"] >= lay["np8"]
    assert wm.smem_bytes(N, wm.head_pad(hd), True, 2) <= wm.SMEM_MAX


def test_k3_copy_path():
    """16-byte copies where every (b, w, h, n) row starts 16-byte aligned:
    contiguous q/k/v and the fused entry's views into its (W, N, 3C) qkv
    product at hd = 4 and 8; 4-byte copies at hd = 3 (rows of 12 bytes) and
    for a view 4 bytes into its storage."""
    for hd in (4, 8):
        q, k, v = wm._split_qkv(torch.zeros(6, 49, 3 * 16 * hd), 2, 16)
        assert all(wm.rows_aligned(t) for t in (q, k, v))
        assert not q.is_contiguous()
    assert wm.rows_aligned(torch.zeros(1, 2, 3, 49, 8))
    assert not wm.rows_aligned(torch.zeros(1, 2, 3, 49, 3))
    q, _, _ = wm._split_qkv(torch.zeros(6, 49, 3 * 16 * 3), 2, 16)
    assert not wm.rows_aligned(q)
    flat = torch.zeros(2 * 3 * 4 * 49 * 8 + 1)
    assert not wm.rows_aligned(flat[1:].view(2, 3, 4, 49, 8))
    assert [wm.head_pad(hd) for hd in (1, 4, 8, 9, 16, 17, 24, 31, 32)] == \
        [8, 8, 8, 16, 16, 24, 24, 32, 32]


@pytest.fixture(scope="module")
def tiny_sites():
    """One tiny-config forward of a port GlassRGBD whose dense encoder
    (every window-attention site is there) took its weights from a flax
    tree through the bridge, recording the arguments and result of each
    `swin.window_msa` call and the module, input, mask and projection
    output of each `WindowClassAttention`."""
    with pytest.MonkeyPatch.context() as mp:
        return _record_tiny_sites(mp)


def _record_tiny_sites(monkeypatch):
    cfg = tiny_test_config()
    model = init_weights(GlassRGBD(cfg), 0).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    part = {k: torch.zeros_like(v) for k, v in model.state_dict().items()
            if k.startswith("dense_encoder.")}
    res = model.load_state_dict(jax_params_to_state_dict(
        glassrgbd_torch_to_flax(sd), part), strict=False)
    assert not res.unexpected_keys and len(part) > 300
    msa, cls = [], []
    inner = swin.window_msa

    def record(q, k, v, bias, mask, use_pallas=False):
        out = inner(q, k, v, bias, mask, use_pallas)
        msa.append((q, k, v, bias, mask, out))
        return out

    monkeypatch.setattr(swin, "window_msa", record)
    for m in model.modules():
        if isinstance(m, swin.WindowClassAttention):
            m.register_forward_hook(
                lambda mod, args, out: cls.append((mod, args[0], args[3],
                                                   out[0])))
    H, W = cfg.eval_hw
    with torch.no_grad():
        model(_t(np.random.default_rng(2).normal(size=(1, H, W, 3))))
    return msa, cls


def test_slice_at_tiny_config_matches_model_and_jax(tiny_sites, jax_ref):
    """Every window-attention site of the tiny-config forward: K3 on the
    arguments of each `swin.window_msa` call, and the fused entry on the
    input and mask of each `WindowClassAttention` with its weights, equal
    the model's own results and the JAX package's XLA `window_msa` /
    `_attention_xla_reference` on the same inputs."""
    msa, cls = tiny_sites
    assert {s[0].shape[-1] for s in msa} >= {1, 2, 4}    # head widths
    assert any(s[4] is not None for s in msa)           # shifted windows
    assert len(cls) == 3

    def np_(*ts):
        return [None if t is None else t.numpy() for t in ts]

    jax_msa = jax_ref["window_msa"]
    with torch.no_grad():
        for q, k, v, bias, mask, out in msa:
            got = wm.window_msa_kernel(q, k, v, bias, mask)
            _close(got, out)
            _close(got, jax_msa(*_jnp(*np_(q, k, v, bias, mask))))
        for mod, x, mask, out in cls:
            w = [mod.qkv.weight, mod.qkv.bias, mod.proj.weight,
                 mod.proj.bias, mod.rel_pos_bias()]
            got = wm.fused_window_attention(x, *w, mask, mod.num_heads)
            _close(got, out)
            jw = np_(x, w[0].T, w[1], w[2].T, w[3], w[4], mask)
            _close(got, jax_ref["attention"](*_jnp(*jw), mod.num_heads))


class _FusedEntry(torch.nn.Module):
    def __init__(self, num_heads):
        super().__init__()
        self.num_heads = num_heads

    def forward(self, *args):
        return wm.fused_window_attention(*args, self.num_heads)


class _WindowEntries(torch.nn.Module):
    """K3's entry through `swin.window_msa(use_pallas=True)` and K4's."""

    def forward(self, q, k, v, bias, mask, x):
        return (swin.window_msa(q, k, v, bias, mask, use_pallas=True),
                wm.layout_fence(x))


def _op_nodes(program) -> list:
    return sorted(str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("gwdepth."))


def test_exported_window_entries_hold_the_ops_and_match_jax():
    """`torch.export` of the fused entry records one `gwdepth.window_msa`
    and one `gwdepth.layout_fence` node, and of the two single entries
    one node each; the exported programs equal the JAX package's
    `fused_window_attention` (K3 in interpret mode), `window_msa_pallas`
    (interpret mode) and `layout_fence` on the same seeded inputs."""
    rng = np.random.default_rng(17)
    B, nW, N, C, H = 1, 6, 9, 32, 4
    x = rng.standard_normal((B, nW, N, C)).astype(np.float32)
    wqkv = (0.2 * rng.standard_normal((C, 3 * C))).astype(np.float32)
    bqkv, bproj = (0.1 * rng.standard_normal(n).astype(np.float32)
                   for n in (3 * C, C))
    wproj = (0.2 * rng.standard_normal((C, C))).astype(np.float32)
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    mask = np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0
                    ).astype(np.float32)
    args = tuple(_pt(x, wqkv.T, bqkv, wproj.T, bproj, bias, mask))
    with torch.no_grad():
        fused = torch.export.export(_FusedEntry(H), args, strict=False)
        got = fused.module()(*args)
    assert _op_nodes(fused) == ["gwdepth.layout_fence.default",
                                "gwdepth.window_msa.default"]
    _close(got, jax_fused(*_jnp(x, wqkv, bqkv, wproj, bproj, bias, mask),
                          H))

    msa = _msa_inputs(1, 5, 3, 9, 4, True, 18)
    fence_in = rng.standard_normal((16, 9, 5)).astype(np.float32)
    ins = tuple(_pt(*msa, fence_in))
    with torch.no_grad():
        single = torch.export.export(_WindowEntries(), ins, strict=False)
        got_msa, got_fence = single.module()(*ins)
    assert _op_nodes(single) == ["gwdepth.layout_fence.default",
                                 "gwdepth.window_msa.default"]
    _close(got_msa, window_msa_pallas(*_jnp(*msa), interpret=True))
    np.testing.assert_array_equal(got_fence.numpy(),
                                  np.asarray(jax_fence(fence_in,
                                                       interpret=True)))
