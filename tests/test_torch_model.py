"""The port's whole GlassRGBD against the JAX package's, on the CPU, at the
tiny test config; the weight bridge against the JAX package's exporter;
the port's predict CLI.

Each test of the forward runs on the shipped model and on the gated
models that the recipes build: the depth-only model (`with_line=False`),
the line-only model (`with_dense=False`) and the learned position
embedding (`position_embedding="learned"`).

Weights: the port's seeded init, carried into a flax tree by the JAX
package's importer (the learned position tables, which that importer does
not map, taken from the port's tables) and then perturbed leaf by leaf
from a numpy seed, so neither side's init shapes the result. The port
receives them through its own `convert/from_jax.py` with `strict=True`.

The port runs once per `use_pallas` value, against the JAX model with the
same value. Tolerances, scaled by max(1, |reference|):
  - `use_pallas=False`: float32 against float32, reassociation only
    (1e-4);
  - `use_pallas=True`: both packages run their fused pyramid convs with
    bf16 taps (the JAX Pallas kernel in interpret mode), rounding the same
    float32 activations the same way, so they agree to reassociation as
    well; but an activation that the two float32 sum orders leave on
    opposite sides of a bf16 rounding boundary rounds one bf16 step
    (2^-8 relative) apart, and the later links, the point-sampling
    choices and the depth decoder carry it on; depth and seg are held at
    BF16_TAP_TOL, 1e-4 (measured 5.1e-5, at the 1/8 depth; 2.2e-6 at
    most with `use_pallas=False`). Lines and logits never reach those
    convs.
  - The gated models with `use_pallas=True` feed the point heads other
    activations, with other rounding flips, and are held at
    BF16_FLIP_TOL, 3e-4. The depth-only model's 1/8 depth reads 1.35e-4
    on 3 of its 192 elements (2e-7 without the taps). On this input the
    port's 1/8 point head run on the JAX model's own inputs to it
    already differs by 6.6e-5, with link inputs within 1.5e-5 of a bf16
    ulp of a rounding midpoint (one exactly on it), and input noise of
    1e-7 relative moves the port's own 1/8 depth between 6.5e-5 and
    1.35e-4 from the JAX result. The learned-position-embedding model's
    seg reads 1.04e-4 on 1 of its 24576 elements (2.9e-5 without the
    taps).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.convert.export_torch import glassrgbd_flax_to_torch
from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.models import GlassRGBD as JGlassRGBD

from gwdepth_tpu_torch import predict
from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.models import points, swin
from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = 1e-4
BF16_TAP_TOL = 1e-4
BF16_FLIP_TOL = 3e-4


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    a = np.asarray(tree)
    if not np.issubdtype(a.dtype, np.floating):
        return a
    noise = rng.normal(size=(2,) + a.shape).astype(a.dtype)
    return a * (1 + 0.1 * noise[0]) + 0.01 * noise[1]


# the shipped model and the gated models that the recipes build
GATES = {"shipped": {}, "depth_only": dict(with_line=False),
         "line_only": dict(with_dense=False),
         "learned_posemb": dict(position_embedding="learned")}
LINE_KEYS = ("pred_logits", "pred_lines")
DENSE_KEYS = ("pred_depth", "pred_seg")
_RUNS = {}


def model_run(gate):
    """The port forward of `gate` once per `use_pallas` value, with the
    same perturbed weights, counting the calls of the K1 and K2 wrappers
    at the names the model modules call them by (cached per gate)."""
    if gate in _RUNS:
        return _RUNS[gate]
    cfg = tiny_test_config(**GATES[gate])
    sd = {k: v.numpy()
          for k, v in init_weights(GlassRGBD(cfg), 0).state_dict().items()}
    params = glassrgbd_torch_to_flax(sd)
    if "backbone.1.row_embed.weight" in sd:
        # the JAX importer maps no learned position tables
        params["position_embedding"] = {
            "row_embed": sd["backbone.1.row_embed.weight"],
            "col_embed": sd["backbone.1.col_embed.weight"]}
    params = _perturb(params, np.random.default_rng(1))
    H, W = cfg.eval_hw
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    valid = np.ones((2, H, W), bool)
    valid[1, 40:] = False
    valid[1, :, 70:] = False
    got, calls = {}, {}
    for use_pallas in (False, True):
        model = GlassRGBD(tiny_test_config(use_pallas=use_pallas,
                                           **GATES[gate]))
        model.load_state_dict(
            jax_params_to_state_dict(params, model.state_dict()), strict=True)
        seen = {"k1": 0, "k2": 0}
        with pytest.MonkeyPatch.context() as mp:
            for mod, name, key in ((swin, "ref_attn_diffusion", "k1"),
                                   (points, "conv3x3_ln_act", "k2")):
                mp.setattr(mod, name, _counting(getattr(mod, name), seen,
                                                key))
            with torch.no_grad():
                got[use_pallas] = model.eval()(torch.from_numpy(x),
                                               torch.from_numpy(valid))
        calls[use_pallas] = seen
    _RUNS[gate] = dict(cfg=cfg, params=params, model=model, x=x,
                       valid=valid, got=got, calls=calls)
    return _RUNS[gate]


@pytest.fixture(scope="module")
def bundle():
    return model_run("shipped")


def _counting(fn, seen, key):
    def spy(*args, **kw):
        seen[key] += 1
        return fn(*args, **kw)
    return spy


def _jax_forward(run, gate, use_pallas):
    jm = JGlassRGBD(jax_tiny(use_pallas=use_pallas, **GATES[gate]))
    return jax.jit(jm.apply)({"params": run["params"]},
                             jnp.asarray(run["x"]), jnp.asarray(run["valid"]))


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_glassrgbd_matches_jax(gate, use_pallas):
    """Every output against JAX's; an output that a gate turns off is
    absent on both sides."""
    run = model_run(gate)
    got, want = run["got"][use_pallas], _jax_forward(run, gate, use_pallas)
    cfg = run["cfg"]
    assert set(got) == set(want)
    if cfg.with_line:
        for k in LINE_KEYS:
            _close(got[k], want[k], F32_TOL)
        assert len(got["aux_outputs"]) == len(want["aux_outputs"]) \
            == cfg.dec_layers - 1
        for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
            for k in LINE_KEYS:
                _close(g[k], w[k], F32_TOL)
    else:
        for k in LINE_KEYS:
            assert got[k] is None and want[k] is None
        assert "aux_outputs" not in got
    if cfg.with_dense:
        dense_tol = F32_TOL
        if use_pallas:
            dense_tol = BF16_TAP_TOL if gate == "shipped" else BF16_FLIP_TOL
        assert len(got["pred_depth"]) == len(want["pred_depth"]) == 4
        for g, w in zip(got["pred_depth"], want["pred_depth"]):
            _close(g, w, dense_tol)
        _close(got["pred_seg"], want["pred_seg"], dense_tol)
    else:
        assert not set(DENSE_KEYS) & set(got)


@pytest.mark.parametrize("gate", sorted(GATES))
def test_model_routes_kernels_by_use_pallas(gate):
    """As in the JAX package: `use_pallas=False` calls neither kernel
    wrapper; `True` calls K1 once per line-reference block and K2 for the
    12 trunk links of each point head and for its `last0` where the concat
    is at most 400 channels wide. The point heads do not depend on the
    line gate; the depth-only model's 1/32 layer is plain Swin attention
    (no K1), and the line-only model has no dense branch (neither)."""
    run = model_run(gate)
    cfg = run["cfg"]
    assert run["calls"][False] == {"k1": 0, "k2": 0}
    k2 = sum(12 + (5 * 2 * p <= points.FUSE_LAST0_MAX_CI)
             for p in cfg.interval_sample_num[:2])
    assert k2 == 26
    both = cfg.with_line and cfg.with_dense
    assert run["calls"][True] == {
        "k1": cfg.dense_trans_layers[0] if both else 0,
        "k2": k2 if cfg.with_dense else 0}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_from_jax_matches_export_torch(gate):
    """The port's bridge and the JAX package's exporter give the same
    tensors for every key. The exporter passes through only integer
    buffers, and the learned position tables, which its importer does not
    map ('unmapped'): those the bridge takes from the flax tree's
    `position_embedding`."""
    run = model_run(gate)
    template = run["model"].state_dict()
    ours = jax_params_to_state_dict(run["params"], template)
    theirs, _, passthrough = glassrgbd_flax_to_torch(
        run["params"], {k: v.numpy() for k, v in template.items()})
    assert set(ours) == set(theirs) == set(template)
    learned = {"backbone.1.row_embed.weight", "backbone.1.col_embed.weight"}
    for k, v in ours.items():
        want = run["params"]["position_embedding"][k.split(".")[2]] \
            if k in learned else theirs[k]
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    want = {(k, "unmapped") for k in learned} if gate == "learned_posemb" \
        else set()
    assert {p for p in passthrough if p[1] != "non_float"} == want
    assert all(k.endswith("relative_position_index")
               for k, r in passthrough if r == "non_float")


def test_from_jax_strict_load_and_missing_leaf(bundle):
    model = GlassRGBD(tiny_test_config())
    res = model.load_state_dict(
        jax_params_to_state_dict(bundle["params"], model.state_dict()),
        strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    want = bundle["model"].state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    params = dict(bundle["params"])
    del params["query_embed"]
    with pytest.raises(KeyError, match="query_embed"):
        jax_params_to_state_dict(params, model.state_dict())


def _write_image(path, hw, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(path)


@pytest.mark.parametrize("hw,canvas", [((300, 500), (768, 1024)),
                                       ((640, 480), (768, 1024)),
                                       ((50, 80), (64, 96))])
def test_eval_transform_matches_jax(hw, canvas):
    from gwdepth_tpu.data import transforms as jt
    from gwdepth_tpu_torch.data import transforms as pt

    rng = np.random.default_rng(hw[0])
    img = Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8))
    depth = rng.uniform(0.5, 9.0, size=hw).astype(np.float32)
    seg = rng.integers(0, 2, size=hw).astype(np.uint8)
    lines = rng.uniform(0, min(hw), size=(5, 4))
    centers = rng.uniform(0, min(hw), size=(5, 2))
    ids = np.arange(5)
    got = pt.eval_transform(pt.Sample(img, depth, seg, lines, centers, ids),
                            canvas, strict_protocol=False)
    want = jt.eval_transform(jt.Sample(img, depth, seg, lines, centers, ids),
                             canvas, strict_protocol=False)
    for f in ("image", "depth", "seg", "lines", "centers", "poly_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_predict_cli_tiny_cpu(tmp_path):
    src = tmp_path / "img.png"
    _write_image(src, (50, 80), 3)
    out = tmp_path / "out"
    predict.main(["--images", str(src), "--output_dir", str(out), "--tiny",
                  "--device", "cpu"])
    depth = np.load(out / "img_depth.npy")
    assert depth.shape == (50, 80) and np.isfinite(depth).all()
    seg = np.asarray(Image.open(out / "img_seg.png"))
    assert seg.shape == (50, 80) and set(np.unique(seg)) <= {0, 255}
    assert np.asarray(Image.open(out / "img_depth.png")).dtype == np.uint16
    rec = json.loads((out / "img_lines.json").read_text())
    assert rec["image"] == "img.png"
    assert len(rec["lines"]) == len(rec["scores"])


def test_predict_cli_torch_init(tmp_path):
    """--torch_init loads an original-code checkpoint (DDP prefix and
    legacy `bbox_embed` name included) by plain load_state_dict."""
    cfg = tiny_test_config()
    model = init_weights(GlassRGBD(cfg), 7).eval()
    sd = {("module." + k).replace("lines_embed", "bbox_embed"): v
          for k, v in model.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "ckpt.pth")
    src = tmp_path / "a.png"
    _write_image(src, (64, 96), 4)
    out = tmp_path / "out"
    predict.main(["--images", str(src), "--output_dir", str(out), "--tiny",
                  "--device", "cpu", "--torch_init",
                  str(tmp_path / "ckpt.pth")])
    canvas, valid, (h, w) = predict.preprocess(Image.open(src), cfg.eval_hw)
    with torch.no_grad():
        want = model(torch.from_numpy(canvas[None]),
                     torch.from_numpy(valid[None]))["pred_depth"][-1][0]
    want = Image.fromarray(want[:h, :w].numpy()).resize((96, 64),
                                                        Image.BILINEAR)
    # meters up to ~10: float32 reassociation between two CPU forwards
    np.testing.assert_allclose(np.load(out / "a_depth.npy"), np.asarray(want),
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("flag", [["--resume", "ckpt"], ["--mesh", "4"]])
def test_predict_cli_refuses_what_the_port_lacks(tmp_path, flag):
    with pytest.raises(SystemExit, match="port"):
        predict.main(["--images", os.fspath(tmp_path), "--output_dir",
                      os.fspath(tmp_path / "o"), "--tiny", *flag])


@pytest.mark.parametrize("device,flags,use_pallas", [
    ("cuda", [], True), ("cuda", ["--no_pallas"], False), ("cpu", [], False)])
def test_predict_routes_kernels_as_jax(device, flags, use_pallas):
    """The kernels run on the card unless --no_pallas, as the JAX CLI runs
    its Pallas kernels on a TPU unless --no_pallas; the CPU runs the plain
    formulations."""
    args = predict.build_argparser().parse_args(
        ["--images", "x", "--output_dir", "o", "--tiny", "--device", device,
         *flags])
    assert predict.config_from_args(args).use_pallas is use_pallas
