"""The port's bfloat16 compute path (`cfg.dtype="bfloat16"`, `main.py
--bf16`) against the JAX package's, on the CPU, at the tiny test config.

JAX runs with XLA's `xla_allow_excess_precision` off (`NO_EXCESS`). Flax's
`Dense(dtype=bf16)` rounds its product and its sum with the bias to bf16;
with the option on, XLA's CPU fusions keep the float32 value where a
float32 add consumes the bf16 result, so every element of a DETR layer's
output then reads up to a bf16 step from the rounding that flax states
(measured 0.9 steps on all elements of a tiny encoder layer; 2e-7 with
the option off).

- The dtype of every boundary equals JAX's: the pyramid, `src`, `pos`,
  `input_proj`'s output, each encoder and decoder layer's output, `hs`,
  the heads, the dense encoder's inputs, every depth and the seg. JAX's
  come from `jax.eval_shape` of the forward with `nn.intercept_methods`,
  so no JAX compile is needed for them.
- Each bf16 module on identical operands: `detr.dense` against flax
  `Dense(dtype=bf16)` (equal on all but DENSE_MISMATCH of the elements,
  where the two products' float32 sum orders round apart; the one-rounding
  `F.linear(x, w, b)` differs on about 29 % of them, and the test checks
  that it fails), each ResNet stage's first Bottleneck (`resnet.conv_as`,
  the bf16 `FrozenBatchNorm2d`, the downsample) against JAX's (bf16 out,
  equal on all but BLOCK_MISMATCH, measured 0.22 %), an encoder and a
  decoder layer of the bf16 model against JAX's (float32 out, to
  F32_TOL).
- The whole bf16 forward on one input, no noise: every boundary before the
  sampled depth points (each pyramid level, `input_proj`'s output, each
  encoder and decoder layer, `hs`, the dense encoder's input, logits and
  lines) to BOUNDARY_STEPS bf16 steps (2^-8 relative) of its scale. The
  backbone's bf16 convolutions sum in another order on each side (oneDNN
  and XLA's CPU convolution), so a pyramid element rounds a step apart
  here and there and the stages carry it on: measured 4.6 steps at most
  (the logits), 2.5 at the 1/32 level.
- The dense branch on JAX's own pyramid and line heads (forward hooks
  replace the port's by JAX's): float32 from there on both sides, so every
  depth, the seg and every loss to F32_TOL, as
  `tests/test_torch_model.py` holds float32 (measured 3.4e-6), with the
  sampled depth points of the shipped model.
- The bf16 forward and its losses (`compute_losses` of both packages on
  one batch) end to end, with `depth_sample_layers` all off (the
  `no_point_sampling` gate) so that no sampled point flips: each output
  or loss to the larger of FLIP_MARGIN x JAX's own spread over FLIP_DRAWS
  images perturbed by FLIP_NOISE (the FLIP rule of
  `tests/test_torch_model.py`) and a floor, FLIP_MARGIN x JAX's own spread
  over FLIP_DRAWS images perturbed by BF16_STEP (one bf16 step). The
  images are cast to bf16 before the first conv, so a 1e-7 perturbation
  vanishes there and that control reads 0; the floor is the same control
  at the bf16 resolution (largest for the seg, whose JAX spread at one
  step is 0.18 of its scale). Both numbers are in each assertion's
  message.
- The port's bf16 train step is finite and within 0.1 |f32| + 0.05 of its
  float32 step on the same weights and batch, JAX's own bound
  (`tests/test_train_step.py::test_bf16_train_step_finite_and_close_to_f32`).

Weights: `test_torch_model.model_run(gate)`'s perturbed flax tree; the
batch: both packages' `dummy_batch` of one seed. JAX's forward and losses
compile once per model (`jax_shipped`, `jax_no_sampling`).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.data.batch import dummy_batch as jax_dummy_batch
from gwdepth_tpu.models import GlassRGBD as JGlassRGBD
from gwdepth_tpu.models.detr import DecoderLayer as JDecoderLayer
from gwdepth_tpu.models.detr import EncoderLayer as JEncoderLayer
from gwdepth_tpu.models.resnet import Bottleneck as JBottleneck
from gwdepth_tpu.parallel import train_step as jstep

from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.data.batch import dummy_batch
from gwdepth_tpu_torch.models.detr import dense
from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD
from gwdepth_tpu_torch.parallel import (compute_losses, create_train_state,
                                        make_train_step)

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import (_CONFIGS, FLIP_DRAWS, FLIP_MARGIN, FLIP_NOISE,
                              _scale, model_run)

BF16 = dict(dtype="bfloat16")
BF16_STEP = 2.0 ** -8
NO_EXCESS = {"xla_allow_excess_precision": False}
F32_TOL = 1e-4
BOUNDARY_STEPS = 8
DENSE_MISMATCH = 1e-3
BLOCK_MISMATCH = 1e-2
OUT_KEYS = ("pred_logits", "pred_lines", "depth16", "depth8", "depth4",
            "depth", "pred_seg")
SAMPLED = ("depth16", "depth8", "depth4", "depth", "pred_seg")


def _outputs(out) -> dict:
    return dict(zip(OUT_KEYS, (out["pred_logits"], out["pred_lines"],
                               *out["pred_depth"], out["pred_seg"])))


def _port_model(cfg, params):
    model = GlassRGBD(cfg)
    model.load_state_dict(jax_params_to_state_dict(params,
                                                   model.state_dict()),
                          strict=True)
    return model


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32))


@pytest.fixture(scope="module")
def setup():
    res = {}
    for gate in ("shipped", "no_point_sampling"):
        run = model_run(gate)
        cfg = tiny_test_config(**BF16, **_CONFIGS[gate])
        res[gate] = dict(
            params=run["params"], cfg=cfg,
            jcfg=jax_tiny(**BF16, **_CONFIGS[gate]),
            model=_port_model(cfg, run["params"]).eval(),
            batch=dummy_batch(cfg, 2, num_lines=5, seed=3),
            jbatch=jax_dummy_batch(jax_tiny(**BF16, **_CONFIGS[gate]), 2,
                                   num_lines=5, seed=3))
    return res


def _noisy(x, eps, seed):
    rng = np.random.default_rng(seed)
    return (x * (1 + eps * rng.normal(size=x.shape))).astype(np.float32)


def _interceptor(seen):
    """Records the JAX forward's boundaries into `seen`, under the names
    `_port_forward` records the port's."""
    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        name = context.module.name
        if context.method_name == "__call__":
            if name in ("backbone", "class_embed", "lines_embed"):
                seen[name] = out
            elif name == "transformer":
                seen["tr_in"], seen["tr_out"] = args, out
            elif name == "dense_encoder":
                seen["de_in"] = args
            elif name and name.startswith(("encoder_layer",
                                           "decoder_layer")):
                seen[name] = out
        return out
    return intercept


def _boundaries(seen, out, lvl, name):
    res = {f"pyramid{i}": name(f) for i, f in enumerate(seen["backbone"])}
    res["src"] = name(seen["backbone"][lvl])
    res["input_proj"] = name(seen["tr_in"][0])
    res["pos"] = name(seen["tr_in"][1])
    res["hs"] = name(seen["tr_out"][0])
    res["dense_encoder_in"] = name(seen["de_in"][0])
    res.update({f"dense_encoder_pyramid{i}": name(f)
                for i, f in enumerate(seen["de_in"][1])})
    res.update({k: name(v) for k, v in seen.items()
                if k.startswith(("encoder_layer", "decoder_layer"))})
    res.update({k: name(v) for k, v in _outputs(out).items()})
    return res


def _jax_forward(s):
    """JAX's bf16 forward of `s`'s model on its batch, jitted: (the
    boundaries as float32, the heads' and backbone's raw outputs, the
    losses)."""
    jm, jcfg, jb = JGlassRGBD(s["jcfg"]), s["jcfg"], s["jbatch"]

    def fn(params, images):
        seen = {}
        with fnn.intercept_methods(_interceptor(seen)):
            out = jm.apply({"params": params}, images, jb.valid)
        bounds = _boundaries(seen, out, jcfg.layer1_num,
                             lambda t: t.astype(jnp.float32))
        raw = {k: seen[k] for k in ("backbone", "class_embed",
                                    "lines_embed")}
        return bounds, raw, jstep.compute_losses(jcfg, out, jb)[1]

    return jax.jit(fn, compiler_options=NO_EXCESS)


def _run(fn, params, x):
    return jax.tree.map(np.asarray, fn(params, x))


@pytest.fixture(scope="module")
def jax_shipped(setup):
    s = setup["shipped"]
    return _run(_jax_forward(s), s["params"], np.asarray(s["jbatch"].images))


@pytest.fixture(scope="module")
def jax_no_sampling(setup):
    """JAX's run of the no_point_sampling model on the batch, and its
    spreads over the outputs and losses under FLIP_NOISE and BF16_STEP
    (one compile)."""
    s = setup["no_point_sampling"]
    fn = _jax_forward(s)
    x = np.asarray(s["jbatch"].images)
    want = _run(fn, s["params"], x)
    spread = {}
    for eps in (FLIP_NOISE, BF16_STEP):
        draws = [_run(fn, s["params"], _noisy(x, eps, 10 + i))
                 for i in range(FLIP_DRAWS)]
        spread[eps] = [{k: max(float(np.abs(d[part][k] - w).max())
                               for d in draws) / _scale(w)
                        for k, w in want[part].items()
                        if part == 2 or k in OUT_KEYS}
                       for part in (0, 2)]
    return want, spread


def _port_forward(model, images, valid, forced=None):
    """One port forward: (boundary -> tensor, outputs). With `forced`
    (JAX's raw backbone and head outputs), forward hooks put JAX's pyramid
    and line heads in place of the port's."""
    seen = {}

    def post(name):
        def hook(mod, args, out):
            seen[name] = out
        return hook

    def pre(name):
        def hook(mod, args):
            seen[name] = args
        return hook

    def put(value):
        def hook(mod, args, out):
            return value
        return hook

    hooks = [model.transformer.register_forward_pre_hook(pre("tr_in")),
             model.transformer.register_forward_hook(post("tr_out")),
             model.dense_encoder.register_forward_pre_hook(pre("de_in"))]
    if forced is None:
        hooks.append(model.backbone[0].register_forward_hook(
            post("backbone")))
    else:
        pyramid = tuple(_t(f).bfloat16() for f in forced["backbone"])
        hooks += [model.backbone[0].register_forward_hook(put(pyramid)),
                  model.class_embed.register_forward_hook(
                      put(_t(forced["class_embed"]))),
                  model.lines_embed.register_forward_hook(
                      put(_t(forced["lines_embed"])))]
    for i, layer in enumerate(model.transformer.encoder.layers):
        hooks.append(layer.register_forward_hook(post(f"encoder_layer{i}")))
    for i, layer in enumerate(model.transformer.decoder.layers):
        hooks.append(layer.register_forward_hook(post(f"decoder_layer{i}")))
    try:
        with torch.no_grad():
            out = model(images, valid)
    finally:
        for h in hooks:
            h.remove()
    return seen, out


def _port_run(s, forced=None):
    """The port's boundaries (float32 numpy, None when forced), outputs
    and losses on `s`'s batch."""
    b = s["batch"]
    seen, out = _port_forward(s["model"], b.images, b.valid, forced)
    with torch.no_grad():
        _, logs = compute_losses(s["cfg"], out, b)
    bounds = None if forced else _boundaries(
        seen, out, s["cfg"].layer1_num, lambda t: t.float().numpy())
    return (bounds, {k: v.numpy() for k, v in _outputs(out).items()},
            {k: float(v) for k, v in logs.items()})


@pytest.fixture(scope="module")
def port_no_sampling(setup):
    return _port_run(setup["no_point_sampling"])


def _gap(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max()) / _scale(want)


def _mismatch(got, want) -> float:
    return float(np.mean(np.asarray(got) != np.asarray(want)))


def _check_by_control(got, want, spread):
    for k, w in want.items():
        control = FLIP_MARGIN * spread[FLIP_NOISE][k]
        floor = FLIP_MARGIN * spread[BF16_STEP][k]
        gap = _gap(got[k], w)
        msg = (f"{k}: gap {gap:.3g}, floor (3x JAX's spread at one bf16 "
               f"step) {floor:.3g}, control (3x JAX's spread at "
               f"{FLIP_NOISE:g}) {control:.3g}")
        print(msg)
        assert gap <= max(floor, control), msg


def _jax_dtypes(s):
    """The boundaries' dtypes of JAX's bf16 forward, traced abstractly."""
    jm = JGlassRGBD(s["jcfg"])
    names = {}

    def record(p, x, v):
        seen = {}
        with fnn.intercept_methods(_interceptor(seen)):
            out = jm.apply({"params": p}, x, v)
        names.update(_boundaries(seen, out, jm.config.layer1_num,
                                 lambda t: t.dtype.name))
        return 0

    jb = s["jbatch"]
    jax.eval_shape(record, s["params"], jb.images, jb.valid)
    return names


def test_bf16_boundaries_have_jax_dtypes(setup):
    s = setup["shipped"]
    b = s["batch"]
    seen, out = _port_forward(s["model"], b.images, b.valid)
    got = _boundaries(seen, out, s["cfg"].layer1_num,
                      lambda t: str(t.dtype).replace("torch.", ""))
    assert got == _jax_dtypes(s)
    assert {got[k] for k in ("pyramid0", "src", "pos")} == {"bfloat16"}
    assert {got[k] for k in ("input_proj", "hs", "dense_encoder_in",
                             *OUT_KEYS)} == {"float32"}


@pytest.mark.parametrize("n,din,dout", [(12, 32, 64), (300, 256, 2048),
                                        (300, 2048, 256)])
def test_bf16_dense_matches_flax(n, din, dout):
    """`detr.dense` in bf16 against flax `Dense(dtype=bf16)`, on one
    float32 input, kernel and bias (the DETR's linear1/linear2 widths,
    tiny and shipped)."""
    rng = np.random.default_rng(din + dout)
    x = rng.normal(size=(2, n, din)).astype(np.float32)
    k = (rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32)
    b = rng.normal(size=(dout,)).astype(np.float32)
    flax_dense = jax.jit(fnn.Dense(dout, dtype=jnp.bfloat16).apply,
                         compiler_options=NO_EXCESS)
    want = np.asarray(flax_dense({"params": {"kernel": k, "bias": b}}, x)
                      .astype(jnp.float32))
    layer = torch.nn.Linear(din, dout)
    with torch.no_grad():
        layer.weight.copy_(_t(k.T))
        layer.bias.copy_(_t(b))
        got = dense(layer, _t(x), torch.bfloat16)
        one = F.linear(_t(x).bfloat16(), layer.weight.bfloat16(),
                       layer.bias.bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    msg = (f"mismatch {_mismatch(got, want):.3g}, gap {_gap(got, want):.3g} "
           f"(one rounding: mismatch {_mismatch(one.float(), want):.3g})")
    assert _mismatch(got, want) <= DENSE_MISMATCH, msg
    assert _gap(got, want) <= 2 * BF16_STEP, msg
    # the criterion tells the bias added in the product's accumulator
    assert _mismatch(one.float().numpy(), want) > 100 * DENSE_MISMATCH, msg


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_bf16_bottleneck_matches_jax(setup, stage):
    """The first Bottleneck of each ResNet stage of the bf16 model (its
    downsample and stride included) against JAX's `Bottleneck(dtype=
    bf16)`, on one bf16 input."""
    s = setup["shipped"]
    planes, cin, stride = ((64, 64, 1), (128, 256, 2), (256, 512, 2),
                           (512, 1024, 2))[stage - 1]
    rng = np.random.default_rng(stage)
    x = np.maximum(rng.normal(size=(2, 24, 32, cin)), 0).astype(
        ml_dtypes.bfloat16)
    jblock = jax.jit(JBottleneck(planes, stride, downsample=True,
                                 dtype=jnp.bfloat16).apply,
                     compiler_options=NO_EXCESS)
    params = s["params"]["backbone"][f"layer{stage}"]["block0"]
    want = np.asarray(jblock({"params": params}, x)).astype(np.float32)
    block = getattr(s["model"].backbone[0].body, f"layer{stage}")[0]
    with torch.no_grad():
        got = block(_t(x).bfloat16().permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    msg = f"mismatch {_mismatch(got, want):.3g}, gap {_gap(got, want):.3g}"
    assert _mismatch(got, want) <= BLOCK_MISMATCH, msg
    assert _gap(got, want) <= 2 * BF16_STEP, msg


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_bf16_detr_layer_matches_jax(setup, kind):
    """The bf16 model's first encoder or decoder layer against JAX's
    layer with dtype bf16, on float32 inputs and the bf16 `pos`."""
    s = setup["shipped"]
    cfg = s["cfg"]
    C, Q = cfg.hidden_dim, cfg.num_queries
    rng = np.random.default_rng(7)
    src = rng.normal(size=(2, 12, C)).astype(np.float32)
    pos = rng.normal(size=(2, 12, C)).astype(ml_dtypes.bfloat16)
    valid = np.ones((2, 12), bool)
    valid[1, 7:] = False
    tgt = rng.normal(size=(2, Q, C)).astype(np.float32)
    query_pos = rng.normal(size=(2, Q, C)).astype(np.float32)
    make = JEncoderLayer if kind == "encoder" else JDecoderLayer
    jlayer = jax.jit(make(C, cfg.nheads, cfg.dim_feedforward, 0.0,
                          jnp.bfloat16).apply, compiler_options=NO_EXCESS)
    params = {"params": s["params"]["transformer"][f"{kind}_layer0"]}
    stack = getattr(s["model"].transformer, kind)
    with torch.no_grad():
        if kind == "encoder":
            want = jlayer(params, src, pos, valid)
            got = stack.layers[0](_t(src), _t(pos).bfloat16(),
                                  torch.from_numpy(valid))
        else:
            want = jlayer(params, tgt, src, pos, query_pos, valid)
            got = stack.layers[0](_t(tgt), _t(src), _t(pos).bfloat16(),
                                  _t(query_pos), torch.from_numpy(valid))
    assert got.dtype == torch.float32
    want = np.asarray(want)
    assert _gap(got.numpy(), want) <= F32_TOL, _gap(got.numpy(), want)


def test_bf16_boundaries_match_jax(jax_no_sampling, port_no_sampling):
    """The bf16 forward on one input, no noise: each boundary before the
    sampled depth points to BOUNDARY_STEPS bf16 steps of its scale."""
    want, got = jax_no_sampling[0][0], port_no_sampling[0]
    gaps = {k: _gap(got[k], w) / BF16_STEP for k, w in want.items()
            if k not in SAMPLED}
    msg = ", ".join(f"{k} {g:.2f}" for k, g in gaps.items())
    print(f"bf16 steps: {msg}")
    assert max(gaps.values()) <= BOUNDARY_STEPS, msg


def test_bf16_dense_branch_matches_jax_on_its_pyramid(setup, jax_shipped):
    """JAX's bf16 pyramid and line heads in place of the port's: every
    depth (the sampled points' included), the seg and every loss to
    F32_TOL."""
    bounds, raw, losses = jax_shipped
    _, got, got_losses = _port_run(setup["shipped"], forced=raw)
    gaps = {k: _gap(got[k], bounds[k]) for k in OUT_KEYS}
    gaps.update({k: _gap(got_losses[k], w) for k, w in losses.items()})
    assert set(got_losses) == set(losses)
    assert max(gaps.values()) <= F32_TOL, gaps


def test_bf16_forward_matches_jax_by_control(jax_no_sampling,
                                             port_no_sampling):
    want, spread = jax_no_sampling
    _check_by_control(port_no_sampling[1],
                      {k: want[0][k] for k in OUT_KEYS},
                      {e: s[0] for e, s in spread.items()})


def test_bf16_losses_match_jax_by_control(jax_no_sampling,
                                          port_no_sampling):
    want, spread = jax_no_sampling
    assert set(port_no_sampling[2]) == set(want[2])
    _check_by_control(port_no_sampling[2], want[2],
                      {e: s[1] for e, s in spread.items()})


def test_bf16_train_step_finite_and_close_to_f32(setup):
    """One train step in each dtype from the same weights and batch: the
    bf16 loss is finite and within JAX's bound of the float32 one, and
    the bf16 step leaves float32 parameters, all finite."""
    s = setup["shipped"]
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = s["cfg"].replace(dtype=dtype)
        model = _port_model(cfg, s["params"])
        step = make_train_step(cfg)
        state, vec = step(create_train_state(cfg, model), s["batch"],
                          torch.Generator().manual_seed(1))
        logs = dict(zip(step.log_keys, vec.tolist()))
        assert np.isfinite(logs["loss"]), (dtype, logs)
        losses[dtype] = logs["loss"]
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in model.parameters())
    assert abs(losses["bfloat16"] - losses["float32"]) <= (
        0.1 * abs(losses["float32"]) + 0.05), losses
