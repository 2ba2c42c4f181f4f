"""The port's train slice against the JAX package, on the CPU.

Losses, matcher, eval accumulators, parameter groups, the analytic
backward passes of kernels K1 and K2, and a 3-step train trajectory, with
numpy-seeded inputs at `tiny_test_config()` sizes. On a CPU tensor each
kernel wrapper runs its plain version, and K2's `autograd.Function` runs
its analytic backward through the plain conv.

Tolerances:
  - losses, metrics, kernel gradients: float32 against float32, so
    reassociation only (1e-5 relative, or as stated at the assert);
  - train trajectory: per-step losses at 1e-4 scaled by max(1, |loss|).
    First-step gradients (two float32 backward passes through the whole
    model, summed in different orders): every element at 1e-4 of the
    model's largest gradient G; a tensor whose largest element is at least
    1e-2 G also at 1e-4 of that element; a tensor above 1e-6 G at 2e-3
    relative L2 (the dense branch's gradients are 1e-5..1e-3 of G and
    carry up to 7e-4 relative float noise; below 1e-6 G a gradient is zero
    in exact arithmetic and pure noise on both sides). Parameters after 3 AdamW
    steps: Adam divides each gradient by its own running RMS, so an
    element whose gradient is float noise around zero can take the
    opposite sign in the two packages and move by up to 2 * lr per step;
    every element is held to that bound, and all but 1e-3 of them to
    1e-2 * lr.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.data.batch import dummy_batch as jax_dummy_batch
from gwdepth_tpu.losses import criterion as jcrit
from gwdepth_tpu.models import GlassRGBD as JGlassRGBD
from gwdepth_tpu.models.swin import diffusion_xla
from gwdepth_tpu.ops.fused_conv import conv3x3_ln_act_reference
from gwdepth_tpu.parallel import train_state as jts
from gwdepth_tpu.parallel import train_step as jstep

from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.convert.from_jax import _invert_key
from gwdepth_tpu_torch.data.batch import dummy_batch
from gwdepth_tpu_torch.losses import criterion as pcrit
from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights
from gwdepth_tpu_torch.ops import fused_conv as port_fc
from gwdepth_tpu_torch.ops import ref_attn_diffusion as port_k1
from gwdepth_tpu_torch.parallel import (create_train_state, make_train_step,
                                        param_group_label)
from gwdepth_tpu_torch.parallel import train_step as pstep

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.ascontiguousarray(x, dtype))


def _line_outputs(rng, B=2, Q=12, D=6, n_aux=2):
    def one():
        return {"pred_logits": rng.normal(size=(B, Q, 2)).astype(np.float32),
                "pred_lines": rng.uniform(size=(B, Q, D)).astype(np.float32)}
    out = one()
    out["aux_outputs"] = [one() for _ in range(n_aux)]
    return out


def _targets(rng, B=2, T=8, D=6, counts=(5, 3)):
    lines = np.zeros((B, T, D), np.float32)
    mask = np.zeros((B, T), bool)
    for b, n in enumerate(counts):
        lines[b, :n] = rng.uniform(size=(n, D))
        mask[b, :n] = True
    return lines, mask


def _to_port(out):
    res = {k: _t(v) for k, v in out.items() if k != "aux_outputs"}
    res["aux_outputs"] = [{k: _t(v) for k, v in a.items()}
                          for a in out.get("aux_outputs", [])]
    return res


def _to_jax(out):
    res = {k: jnp.asarray(v) for k, v in out.items() if k != "aux_outputs"}
    res["aux_outputs"] = [{k: jnp.asarray(v) for k, v in a.items()}
                          for a in out.get("aux_outputs", [])]
    return res


KW = dict(eos_coef=0.1, set_cost_class=1.0, set_cost_line=5.0)


@pytest.mark.parametrize("focal", [False, True])
def test_line_set_criterion_matches_jax(focal):
    rng = np.random.default_rng(0)
    out = _line_outputs(rng)
    lines, mask = _targets(rng)
    want = jax.jit(functools.partial(
        jcrit.line_set_criterion, matcher_backend="scipy", focal=focal,
        **KW))(_to_jax(out), jnp.asarray(lines), jnp.asarray(mask))
    got = pcrit.line_set_criterion(_to_port(out), _t(lines),
                                   torch.from_numpy(mask), focal=focal, **KW)
    # the JAX function's own order (jit returns its dict sorted)
    assert list(got) == ["loss_ce", "loss_line", "cardinality_error",
                         "loss_ce_0", "loss_line_0", "loss_ce_1",
                         "loss_line_1"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_criterion_on_tied_costs_equals_jv_losses():
    """Identical predictions give tied costs: scipy and the JAX package's
    JV solver may pick different queries, but the losses are equal."""
    rng = np.random.default_rng(1)
    out = _line_outputs(rng, n_aux=1)
    for o in [out] + out["aux_outputs"]:
        o["pred_lines"][:, 6:] = o["pred_lines"][:, :6]
        o["pred_logits"][:, 6:] = o["pred_logits"][:, :6]
    lines, mask = _targets(rng, counts=(6, 4))
    lines[:, 1] = lines[:, 0]
    want = jax.jit(functools.partial(
        jcrit.line_set_criterion, matcher_backend="jax", **KW))(
        _to_jax(out), jnp.asarray(lines), jnp.asarray(mask))
    got = pcrit.line_set_criterion(_to_port(out), _t(lines),
                                   torch.from_numpy(mask), **KW)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_match_lines_is_one_host_solve_per_problem_and_ignores_padding():
    from gwdepth_tpu_torch.ops.lap import match_lines

    cost = torch.tensor([[[0.0, 9.0, 5.0], [9.0, 0.0, -7.0],
                          [1.0, 1.0, 1.0]]])
    got = match_lines(cost, torch.tensor([2]))
    assert got.tolist() == [[0, 1, 0]]       # slot 2 is padding -> query 0
    got = match_lines(cost, torch.tensor([3]))
    assert got.tolist() == [[0, 2, 1]]


def test_silog_and_multiscale_depth_loss_match_jax():
    rng = np.random.default_rng(2)
    gt = rng.uniform(0.1, 9.0, size=(2, 1, 16, 24)).astype(np.float32)
    valid = rng.random((2, 1, 16, 24)) > 0.2
    preds = [rng.uniform(0.2, 9.0, size=(2, 1, 16 // s, 24 // s))
             .astype(np.float32) for s in (8, 4, 2, 1)]
    w = (0.25, 0.25, 0.25, 1.0)
    jt, jper = jax.jit(lambda p, g, v: jcrit.multiscale_depth_loss(
        p, g, v, w, 0.85))([jnp.asarray(p) for p in preds], jnp.asarray(gt),
                           jnp.asarray(valid))
    pt, pper = pcrit.multiscale_depth_loss(
        [_t(p) for p in preds], _t(gt), torch.from_numpy(valid), w, 0.85)
    np.testing.assert_allclose(float(pt), float(jt), rtol=1e-5)
    for a, b in zip(pper, jper):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    np.testing.assert_allclose(
        float(pcrit.silog_loss(_t(preds[-1]), _t(gt), torch.from_numpy(valid))),
        float(jax.jit(jcrit.silog_loss)(jnp.asarray(preds[-1]),
                                        jnp.asarray(gt), jnp.asarray(valid))),
        rtol=1e-5)


@pytest.mark.parametrize("H,W", [(5, 7), (2, 6)])
def test_seg_ce_loss_layouts(H, W):
    """NHWC against the JAX package; NCHW against F.cross_entropy,
    including H == 2, where inferring the layout from the shapes would
    read NCHW as NHWC."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, H, W, 2)).astype(np.float32)
    gt = rng.integers(0, 2, size=(2, H, W))
    want_nhwc = float(jcrit.seg_ce_loss(jnp.asarray(logits), jnp.asarray(gt)))
    got_nhwc = float(pcrit.seg_ce_loss(_t(logits), torch.from_numpy(gt),
                                       "nhwc"))
    np.testing.assert_allclose(got_nhwc, want_nhwc, rtol=1e-6)
    nchw = _t(logits.transpose(0, 3, 1, 2))
    got_nchw = float(pcrit.seg_ce_loss(nchw, torch.from_numpy(gt), "nchw"))
    want_nchw = float(torch.nn.functional.cross_entropy(
        nchw, torch.from_numpy(gt)))
    np.testing.assert_allclose(got_nchw, want_nchw, rtol=1e-6)
    np.testing.assert_allclose(got_nchw, want_nhwc, rtol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        pcrit.seg_ce_loss(nchw, torch.from_numpy(gt), "guess")


def test_depth_error_sums_and_summaries_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.uniform(0.0, 12.0, size=(3, 10, 12)).astype(np.float32)
    pred[0, 0, 0] = np.nan
    pred[1, 0, 0] = np.inf
    gt = rng.uniform(0.5, 9.0, size=(3, 10, 12)).astype(np.float32)
    valid = rng.random((3, 10, 12)) > 0.3
    valid[2] = False                          # an image with no valid pixel
    want = np.asarray(jax.jit(jstep.depth_error_sums, static_argnums=(3, 4))(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid), 1e-3, 10.0))
    got = pstep.depth_error_sums(_t(pred), _t(gt), torch.from_numpy(valid),
                                 1e-3, 10.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert pstep.summarize_depth(got) == pytest.approx(
        jstep.summarize_depth(want), rel=1e-6)

    pc = rng.integers(0, 2, size=(3, 10, 12))
    sg = rng.integers(0, 2, size=(3, 10, 12))
    cw = np.asarray(jstep.seg_confusion(jnp.asarray(pc), jnp.asarray(sg),
                                        jnp.asarray(valid)))
    cg = pstep.seg_confusion(torch.from_numpy(pc), torch.from_numpy(sg),
                             torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(cg, cw)
    assert pstep.summarize_seg(cg) == jstep.summarize_seg(cw)


def _flax_paths(name, shape):
    return {"/".join(path) for path, _ in _invert_key(name, shape)}


def test_frozen_parameters_match_jax_param_group_label():
    """The port's frozen set (requires_grad=False parameters plus the
    frozen-BN buffers) maps onto exactly the JAX leaves labeled frozen;
    its backbone group onto the leaves labeled backbone."""
    cfg = tiny_test_config()
    model = GlassRGBD(cfg)
    params = glassrgbd_torch_to_flax(
        {k: v.numpy() for k, v in model.state_dict().items()})
    jlabels = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                jlabels["/".join(path + (k,))] = jts.param_group_label(
                    path + (k,))
    walk(params)
    port = {"frozen": set(), "backbone": set(), "main": set()}
    for name, p in model.named_parameters():
        port[param_group_label(name, p)] |= _flax_paths(name, tuple(p.shape))
    for name, buf in model.named_buffers():
        if name.startswith("backbone.") and torch.is_floating_point(buf):
            port["frozen"] |= _flax_paths(name, tuple(buf.shape))
    for label in ("frozen", "backbone", "main"):
        want = {k for k, v in jlabels.items() if v == label}
        assert port[label] == want, label
    assert port["frozen"] and port["backbone"] and port["main"]


# ---------------------------------------------------------------------------
# kernel backward passes
# ---------------------------------------------------------------------------

def _k2_case(seed, ci, co, B=2, H=5, W=7, with_ln=True, with_res=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    g = (1 + 0.2 * rng.normal(size=(co,))).astype(np.float32) if with_ln \
        else None
    b = (0.3 * rng.normal(size=(co,))).astype(np.float32) if with_ln \
        else None
    r = rng.normal(size=(B, H, W, co)).astype(np.float32) if with_res \
        else None
    ct = rng.normal(size=(B, H, W, co)).astype(np.float32)
    return x, w, g, b, r, ct


@pytest.mark.parametrize("act", [None, "gelu", "elu"])
@pytest.mark.parametrize("ci,co,with_ln,with_res", [
    (3, 5, True, False), (7, 4, False, False), (6, 9, True, True),
    (300, 12, True, False)])
def test_k2_backward_matches_jax_vjp(act, ci, co, with_ln, with_res):
    x, w, g, b, r, ct = _k2_case(10 + ci, ci, co, with_ln=with_ln,
                                 with_res=with_res)
    prim = [a for a in (x, w, g, b, r) if a is not None]

    def jfn(*args):
        it = iter(args)
        xx, ww = next(it), next(it)
        gg, bb = (next(it), next(it)) if with_ln else (None, None)
        rr = next(it) if with_res else None
        return conv3x3_ln_act_reference(xx, ww, gg, bb, residual=rr, act=act)

    y, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in prim])
    want = vjp(jnp.asarray(ct))
    tp = [_t(a).requires_grad_() for a in prim]
    it = iter(tp)
    tx, tw = next(it), next(it)
    tg, tb = (next(it), next(it)) if with_ln else (None, None)
    tr = next(it) if with_res else None
    got_y = port_fc.conv3x3_ln_act(tx, tw, tg, tb, tr, act, fast=False)
    assert got_y.grad_fn is not None
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(y),
                               atol=2e-5, rtol=1e-4)
    got = torch.autograd.grad(got_y, tp, _t(ct))
    for name, a, e in zip("xwgbr", got, want):
        e = np.asarray(e)
        scale = max(1.0, float(np.abs(e).max()))
        np.testing.assert_allclose(a.numpy(), e, rtol=0, atol=2e-5 * scale,
                                   err_msg=name)


def test_k2_bf16_backward_matches_jax_fused_vjp():
    """K2's Function with `fast=True` against `jax.vjp` of the JAX
    package's `fused_conv_ln_act` (the Pallas kernel in interpret mode for
    the forward, the recompute and dx; the dw einsums in XLA). Both round
    x, w, the recomputed conv's cotangent dc and the flipped weights to
    bf16 the same way, so they differ by float32 sum order only; gradients
    at 1e-5 of the call's largest."""
    from gwdepth_tpu.ops.fused_conv import fused_conv_ln_act

    act = "gelu"
    x, w, g, b, _, ct = _k2_case(30, 6, 10, B=1, H=4, W=5)
    y, vjp = jax.vjp(lambda *a: fused_conv_ln_act(*a, act),
                     *map(jnp.asarray, (x, w, g, b)))
    want = vjp(jnp.asarray(ct))
    tp = [_t(a).requires_grad_() for a in (x, w, g, b)]
    got_y = port_fc.conv3x3_ln_act(*tp, None, act)
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(y),
                               atol=1e-5, rtol=0)
    got = torch.autograd.grad(got_y, tp, _t(ct))
    scale = max(1.0, max(float(np.abs(np.asarray(e)).max()) for e in want))
    for name, a, e in zip("xwgb", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_k2_backward_of_the_wide_dx_link_uses_split_pieces():
    """Ci = 300 makes dx a 300-channel conv, past the kernel's MAX_CO; the
    backward splits it into two 150-channel pieces. On the CPU the pieces
    are not needed, so the split is checked by its arithmetic: the
    concatenated pieces equal the whole conv."""
    rng = np.random.default_rng(7)
    dc = _t(rng.normal(size=(1, 4, 6, 12)))
    w = _t(rng.normal(size=(3, 3, 12, 300)) * 0.1)
    whole = port_fc.conv3x3_ln_act_plain(dc, w)
    pieces = torch.cat([port_fc.conv3x3_ln_act_plain(dc, w[..., i:i + 150])
                        for i in (0, 150)], dim=-1)
    torch.testing.assert_close(pieces, whole, rtol=0, atol=1e-6)
    assert -(-300 // port_fc.MAX_CO) == 2


def test_k1_backward_matches_jax_vjp():
    rng = np.random.default_rng(8)
    B, P, R, H = 2, 14, 6, 4
    a = rng.normal(size=(B, P, R, H)).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 3, H, H))).astype(np.float32)
    b = (0.1 * rng.normal(size=(H,))).astype(np.float32)
    ct = rng.normal(size=(B, P, R, H)).astype(np.float32)
    y, vjp = jax.vjp(diffusion_xla, jnp.asarray(a), jnp.asarray(w),
                     jnp.asarray(b))
    want = vjp(jnp.asarray(ct))
    tp = [_t(v).requires_grad_() for v in (a, w, b)]
    got_y = port_k1.ref_attn_diffusion(*tp)
    assert got_y.grad_fn is not None
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(y),
                               atol=2e-5, rtol=1e-5)
    got = torch.autograd.grad(got_y, tp, _t(ct))
    for name, g, e in zip("awb", got, want):
        e = np.asarray(e)
        scale = max(1.0, float(np.abs(e).max()))
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=2e-5 * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# train trajectory against the JAX train step
# ---------------------------------------------------------------------------

N_STEPS = 3


def _jax_adam_mu(jstate):
    """The first moment of the JAX optimizer, as a flax-shaped tree of
    the trained leaves (the multi_transform masks out the rest)."""
    tree = {}
    for label in ("main", "backbone"):
        mu = jstate.opt_state[1].inner_states[label].inner_state[0].mu
        for path, leaf in jax.tree_util.tree_flatten_with_path(mu)[0]:
            node = tree
            keys = [k.key for k in path]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.asarray(leaf)
    return tree


@pytest.fixture(scope="module")
def trajectory():
    """N steps of the JAX `make_train_step` and of the port's, from the
    same weights on the same batches. Each optimizer's first moment after
    step k is beta1 x the one before + (1 - beta1) x the clipped gradient
    of step k, which gives every step's gradients of both without another
    compile: `jmu`/`pmu` hold the first moments after step 1, `grad_gap`
    each element's largest relative gap between the two gradients over
    the steps (`_grad_gap`)."""
    return _trajectory()


def _grad_gap(jmu, pmu, jprev, pprev, beta1: float) -> np.ndarray:
    """|port - JAX| / |JAX| of the gradient a step fed Adam, per element,
    from the first moments after the step and before it (None at step 1;
    the common factor 1 - beta1 cancels): 0 where the two are equal,
    inf where only JAX's is 0."""
    jg, pg = jmu.astype(np.float64), pmu.astype(np.float64)
    if jprev is not None:
        jg -= beta1 * jprev
        pg -= beta1 * pprev
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(pg - jg) / np.abs(jg)
    return np.where(pg == jg, 0.0, gap).astype(np.float32)


def _trajectory():
    cfg = tiny_test_config(matcher="scipy")
    jcfg = jax_tiny(matcher="scipy", use_pallas=False)
    sd = {k: v.numpy()
          for k, v in init_weights(GlassRGBD(cfg), 0).state_dict().items()}
    params = jax.tree.map(jnp.asarray, glassrgbd_torch_to_flax(sd))
    model = GlassRGBD(cfg)
    model.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params), model.state_dict()), strict=True)
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    jmodel = JGlassRGBD(jcfg)
    batches = [(jax_dummy_batch(jcfg, 2, num_lines=3 + i, seed=i),
                dummy_batch(cfg, 2, num_lines=3 + i, seed=i))
               for i in range(N_STEPS)]

    state = jts.create_train_state(jcfg, params, steps_per_epoch=2)
    step = jstep.make_train_step(jcfg, jmodel)
    pstate = create_train_state(cfg, model, steps_per_epoch=2)
    pstep_fn = make_train_step(cfg)
    beta1 = pstate.optimizer.param_groups[0]["betas"][0]
    jlosses, plosses = [], []
    prev, gap = {}, {}
    for i, (jb, pb) in enumerate(batches):
        state, vec = step(state, jb, jax.random.PRNGKey(i))
        jlosses.append(np.asarray(vec))
        pstate, vec = pstep_fn(pstate, pb, torch.Generator().manual_seed(i))
        plosses.append(vec.numpy())
        pmu_i = {n: pstate.optimizer.state[p]["exp_avg"].clone()
                 for n, p in model.named_parameters() if p.requires_grad}
        jmu_i = jax_params_to_state_dict(_jax_adam_mu(state), pmu_i)
        for n, m in pmu_i.items():
            jm, pm = jmu_i[n].numpy(), m.numpy()
            g = _grad_gap(jm, pm, *prev.get(n, (None, None)), beta1)
            gap[n] = np.maximum(gap[n], g) if n in gap else g
            prev[n] = (jm, pm)
        if i == 0:
            jmu, pmu = _jax_adam_mu(state), pmu_i
    return dict(cfg=cfg, model=model, init_sd=init_sd, jstate=state,
                jmu=jmu, pmu=pmu, grad_gap=gap, jkeys=step.log_keys,
                pkeys=pstep_fn.log_keys, jlosses=jlosses, plosses=plosses)


def test_trajectory_losses_match_jax(trajectory):
    tr = trajectory
    assert tr["pkeys"] == tr["jkeys"]
    for i, (p, j) in enumerate(zip(tr["plosses"], tr["jlosses"])):
        scale = np.maximum(1.0, np.abs(j))
        np.testing.assert_array_less(np.abs(p - j), 1e-4 * scale,
                                     err_msg=f"step {i}")


def test_first_step_gradients_match_jax(trajectory):
    tr = trajectory
    want = {n: v.numpy() / 0.1 for n, v in
            jax_params_to_state_dict(tr["jmu"], tr["pmu"]).items()}
    G = max(float(np.abs(v).max()) for v in want.values())
    for n, m in tr["pmu"].items():
        g, e = m.numpy() / 0.1, want[n]
        top = float(np.abs(e).max())
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-4 * G, err_msg=n)
        if top >= 1e-2 * G:
            np.testing.assert_allclose(g, e, rtol=0, atol=1e-4 * top,
                                       err_msg=n)
        if top >= 1e-6 * G:
            rel = np.linalg.norm(g - e) / np.linalg.norm(e)
            assert rel <= 2e-3, (n, rel)


# Adam moves an element by lr x m / (sqrt(v) + eps) from that element's
# own gradients: at step 1 by lr x their sign, whatever their size. Where
# each step's port gradient is within a relative r of JAX's, the
# bias-corrected m / sqrt(v) of the two differ by at most 2 r a step
# (Cauchy-Schwarz over the steps' weights in m and v), so after 3 steps
# the parameters by at most 4 r lr, plus float32 rounding. The elements
# whose gradients agree to GRAD_REL at every step (most of them) are held
# to 1e-2 lr with no allowance. The others include gradients near 0 that
# another summation order (torch's CPU thread count changes it) turns to
# the other sign, or that make m nearly cancel at a later step; each may
# move up to 2 lr a step the other way, and at most 0.1 % of all elements
# may lie past 1e-2 lr.
GRAD_REL = 1e-3


def test_trajectory_parameters_match_jax(trajectory):
    tr = trajectory
    cfg = tr["cfg"]
    want = jax_params_to_state_dict(
        jax.tree.map(np.asarray, tr["jstate"].params),
        tr["model"].state_dict())
    held = far = total = moved = 0
    for n, p in tr["model"].named_parameters():
        got, e = p.detach().numpy(), want[n].numpy()
        start = tr["init_sd"][n].numpy()
        if not p.requires_grad:
            np.testing.assert_array_equal(got, start, err_msg=n)
            np.testing.assert_array_equal(e, start, err_msg=n)
            continue
        lr = cfg.lr_backbone if n.startswith("backbone.") else cfg.lr
        diff = np.abs(got - e)
        assert diff.max() <= 2 * lr * N_STEPS + 1e-6, n
        agree = tr["grad_gap"][n] <= GRAD_REL
        assert diff[agree].max(initial=0.0) <= 1e-2 * lr, \
            (n, float(diff[agree].max()) / lr)
        held += int(agree.sum())
        far += int((diff > 1e-2 * lr).sum())
        total += diff.size
        moved += int((got != start).sum())
    assert held > 0.5 * total, (held, total)
    assert far <= 1e-3 * total, (far, total)
    assert moved > 0.5 * total, (moved, total)


def test_grad_accum_equals_mean_of_strided_microbatches():
    cfg = tiny_test_config(grad_accum=2)
    batch = dummy_batch(cfg, 4, seed=5)
    a = init_weights(GlassRGBD(cfg), 3)
    b = init_weights(GlassRGBD(cfg), 3)
    sa = create_train_state(cfg, a)
    sa, logs = make_train_step(cfg)(sa, batch)

    b.train()
    grads, vecs = {}, []
    for i in range(2):
        micro = batch.map(lambda t: t[i::2])
        _, lg = pstep.compute_losses(cfg, b(micro.images, micro.valid), micro)
        lg["loss"].backward()
        vecs.append(torch.stack([lg[k].detach() for k in sorted(lg)]))
        for n, p in b.named_parameters():
            if p.grad is not None:
                grads[n] = grads.get(n, 0) + p.grad / 2
        b.zero_grad(set_to_none=True)
    for n, p in b.named_parameters():
        if n in grads:
            p.grad = grads[n]
    sb = create_train_state(cfg, b)
    sb.apply_gradients()
    torch.testing.assert_close(logs, torch.stack(vecs).mean(0), rtol=1e-6,
                               atol=1e-6)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=1e-7, msg=n)
