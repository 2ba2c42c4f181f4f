"""The gated train step of the port against the JAX package's, on the CPU,
at the tiny test config: the dense encoder's gates
(`test_torch_model.ENCODER_GATES`), each with the plane-normal loss on
(`with_plane_norm_loss`, 28 queries for its top 28 triangles).

- The logged losses of one step, `loss_plane` included, against JAX's
  `compute_losses` on the same weights and batch, at every gate
  (`use_pallas` off on both sides: float32 throughout), rel 1e-4.
- At all the gates together: every first-step gradient against
  `jax.value_and_grad` of the JAX loss, at the bounds of
  `tests/test_torch_train.py::test_first_step_gradients_match_jax`; and
  with `use_pallas` (K2's bf16 taps; the JAX Pallas kernels in interpret
  mode) the losses, each to the larger of BF16_FLIP_TOL and FLIP_MARGIN
  x JAX's own spread over FLIP_DRAWS images perturbed by FLIP_NOISE
  (the FLIP rule of `tests/test_torch_model.py`).
- `remat` against no remat: the same losses, gradients to 1e-6
  relative, and every class block's K1 call made again in the backward.

Weights: the port's seeded init carried into a flax tree by the JAX
importer and perturbed, as `test_torch_model.model_run`; the class
head's bias favours class 0 and the line head's spreads the triangles'
corners, so the plane loss's score (0.6) and area (100 pixels) gates
let triangles through and `loss_plane` is not 0. Each JAX loss is compiled
once per module (`jax_losses`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.data.batch import dummy_batch as jax_dummy_batch
from gwdepth_tpu.models import GlassRGBD as JGlassRGBD
from gwdepth_tpu.parallel import train_step as jstep

from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.data.batch import dummy_batch
from gwdepth_tpu_torch.models import swin
from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights
from gwdepth_tpu_torch.parallel import (compute_losses, create_train_state,
                                        make_train_step)

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import (BF16_FLIP_TOL, ENCODER_GATES, FLIP_DRAWS,
                              FLIP_MARGIN, FLIP_NOISE, _counting, _perturb)

PLANE = dict(with_plane_norm_loss=True, num_queries=28)
TRAIN_GATES = {g: {**kw, **PLANE} for g, kw in ENCODER_GATES.items()}
LOSS_REL = 1e-4
LOSS_ABS = 1e-5
_RUNS = {}


def gated_run(gate):
    """Perturbed weights of `gate` as a flax tree, and one batch in each
    package's form (cached per gate)."""
    if gate in _RUNS:
        return _RUNS[gate]
    cfg = tiny_test_config(**TRAIN_GATES[gate])
    sd = {k: v.numpy()
          for k, v in init_weights(GlassRGBD(cfg), 0).state_dict().items()}
    params = _perturb(glassrgbd_torch_to_flax(sd), np.random.default_rng(1))
    params["class_embed"]["bias"] = np.array([2.0, -2.0], np.float32)
    params["lines_embed"]["layer2"]["bias"] = np.array(
        [-1.5, -1.5, 1.5, -1.5, 0.0, 1.5], np.float32)
    _RUNS[gate] = dict(
        cfg=cfg, params=params, batch=dummy_batch(cfg, 2, num_lines=5,
                                                   seed=3),
        jbatch=jax_dummy_batch(jax_tiny(**TRAIN_GATES[gate]), 2,
                               num_lines=5, seed=3))
    return _RUNS[gate]


def port_step(gate, use_pallas=False, remat=False, k1_calls=None):
    """The port's train-step losses (`compute_losses` of a train-mode
    forward) and the gradients of its total, by parameter name."""
    run = gated_run(gate)
    cfg = run["cfg"].replace(use_pallas=use_pallas, remat=remat)
    model = GlassRGBD(cfg)
    model.load_state_dict(jax_params_to_state_dict(run["params"],
                                                   model.state_dict()),
                          strict=True)
    b = run["batch"]
    with pytest.MonkeyPatch.context() as mp:
        if k1_calls is not None:
            mp.setattr(swin, "ref_attn_diffusion", _counting(
                swin.ref_attn_diffusion, k1_calls, "k1"))
        total, logs = compute_losses(cfg, model.train()(b.images, b.valid),
                                     b)
        total.backward()
    return ({k: float(v.detach()) for k, v in logs.items()},
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None})


@pytest.fixture(scope="module")
def jax_losses():
    """gate, use_pallas -> (jitted params, images -> JAX logs); and the
    jitted value_and_grad of the all-gates loss. Each compiles once."""
    fns = {}

    def loss_fn(gate, use_pallas):
        jcfg = jax_tiny(use_pallas=use_pallas, **TRAIN_GATES[gate])
        jm = JGlassRGBD(jcfg)
        jb = gated_run(gate)["jbatch"]

        def fn(params, images):
            out = jm.apply({"params": params}, images, jb.valid,
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
            return jstep.compute_losses(jcfg, out, jb)
        return fn

    def get(gate, use_pallas=False):
        if (gate, use_pallas) not in fns:
            fns[gate, use_pallas] = jax.jit(
                lambda p, x, f=loss_fn(gate, use_pallas): f(p, x)[1])
        return fns[gate, use_pallas]

    get.value_and_grad = jax.jit(jax.value_and_grad(
        loss_fn("all_gates", False), has_aux=True))
    return get


def _check_losses(got, want, tol=None):
    assert set(got) == set(want)
    for k, v in want.items():
        if tol is None:
            assert got[k] == pytest.approx(v, rel=LOSS_REL, abs=LOSS_ABS), k
        else:
            assert abs(got[k] - v) <= tol[k] * max(1.0, abs(v)), \
                (k, got[k], v, tol[k])


@pytest.mark.parametrize("gate", sorted(set(TRAIN_GATES) - {"all_gates"}))
def test_gated_train_step_losses_match_jax(gate, jax_losses):
    run = gated_run(gate)
    got, _ = port_step(gate)
    want = {k: float(v) for k, v in jax_losses(gate)(
        run["params"], run["jbatch"].images).items()}
    assert "loss_plane" in want
    _check_losses(got, want)


def test_all_gates_train_step_losses_and_gradients_match_jax(jax_losses):
    """The step's logged losses and every first-step gradient; then one
    port train step (clip, AdamW) logs the same losses in the JAX key
    order and updates every trained tensor to finite values."""
    run = gated_run("all_gates")
    got, grads = port_step("all_gates")
    (_, jlogs), jgrads = jax_losses.value_and_grad(run["params"],
                                                   run["jbatch"].images)
    want = {k: float(v) for k, v in jlogs.items()}
    assert want["loss_plane"] > 0
    _check_losses(got, want)

    jg = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads),
                                  {n: g.detach() for n, g in grads.items()})
    G = max(float(np.abs(v.numpy()).max()) for v in jg.values())
    for n, g in grads.items():
        g, e = g.numpy(), jg[n].numpy()
        top = float(np.abs(e).max())
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-4 * G, err_msg=n)
        if top >= 1e-2 * G:
            np.testing.assert_allclose(g, e, rtol=0, atol=1e-4 * top,
                                       err_msg=n)
        if top >= 1e-6 * G:
            rel = np.linalg.norm(g - e) / np.linalg.norm(e)
            assert rel <= 2e-3, (n, rel)

    cfg = run["cfg"]
    model = GlassRGBD(cfg)
    model.load_state_dict(jax_params_to_state_dict(run["params"],
                                                   model.state_dict()))
    step = make_train_step(cfg)
    state, vec = step(create_train_state(cfg, model), run["batch"],
                      torch.Generator().manual_seed(0))
    assert step.log_keys == list(jlogs)
    _check_losses(dict(zip(step.log_keys, vec.tolist())), want)
    assert state.step == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())


# The losses reduce each output to one number, so a rounding flip shows in
# them only where it moves a discrete choice: a sampled depth point, or a
# plane-loss triangle across its score or area gate (`loss_plane` then
# jumps by a whole triangle's variance). On these weights both packages
# sit next to such a choice: a few of the perturbed images move JAX's own
# `loss_depth_1_4` and `loss_plane` across it, the port's clean image
# lands on the other side from JAX's, and on the draws where both sides
# land together they agree within BF16_FLIP_TOL. The first three draws
# (FLIP_DRAWS) move none of JAX's losses across it.
LOSS_FLIP_DRAWS = 8


def test_all_gates_bf16_train_step_losses_match_jax(jax_losses):
    """With K2's bf16 taps on both sides (the JAX Pallas kernels in
    interpret mode), the losses under the FLIP rule, JAX's spread taken
    over LOSS_FLIP_DRAWS perturbed images; and every loss of the port
    within BF16_FLIP_TOL of JAX's on the image or on one of its perturbed
    copies (the same discrete choices on both sides)."""
    run = gated_run("all_gates")
    got, _ = port_step("all_gates", use_pallas=True)
    x = run["jbatch"].images
    fn = jax_losses("all_gates", use_pallas=True)
    want, *noisy = [
        {k: float(v) for k, v in fn(run["params"], img).items()}
        for img in [x] + [x * (1 + FLIP_NOISE * jnp.asarray(
            np.random.default_rng(10 + i).normal(size=x.shape),
            jnp.float32)) for i in range(LOSS_FLIP_DRAWS)]]
    tol = {k: max(BF16_FLIP_TOL, FLIP_MARGIN * max(
        abs(n[k] - v) for n in noisy) / max(1.0, abs(v)))
        for k, v in want.items()}
    _check_losses(got, want, tol)
    gaps = [max(abs(got[k] - w[k]) / max(1.0, abs(w[k])) for k in w)
            for w in [want] + noisy]
    assert min(gaps) <= BF16_FLIP_TOL, gaps


def test_remat_train_step_equals_no_remat():
    """`remat` recomputes each Swin block in the backward: with
    `use_pallas`, the same losses and gradients, and the 5 K1 calls of the
    forward (the two 1/32 blocks and each class block with group attention
    and reference points) made a second time."""
    runs = {}
    for remat in (False, True):
        calls = {"k1": 0}
        runs[remat] = (*port_step("all_gates", use_pallas=True, remat=remat,
                                  k1_calls=calls), calls["k1"])
    (l0, g0, n0), (l1, g1, n1) = runs[False], runs[True]
    assert l1 == l0
    assert set(g1) == set(g0)
    for n in g0:
        denom = max(float(g0[n].norm()), 1e-30)
        assert float((g1[n] - g0[n]).norm()) <= 1e-6 * denom, n
    assert (n0, n1) == (5, 10)
