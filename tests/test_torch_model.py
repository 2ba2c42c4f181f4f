"""The port's whole GlassRGBD against the JAX package's, on the CPU, at the
tiny test config; the weight bridge against the JAX package's exporter;
the port's predict CLI.

Weights: the port's seeded init, carried into a flax tree by the JAX
package's importer and then perturbed leaf by leaf from a numpy seed, so
neither side's init shapes the result. The port receives them through its
own `convert/from_jax.py` with `strict=True`.

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


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    a = np.asarray(tree)
    if not np.issubdtype(a.dtype, np.floating):
        return a
    noise = rng.normal(size=(2,) + a.shape).astype(a.dtype)
    return a * (1 + 0.1 * noise[0]) + 0.01 * noise[1]


@pytest.fixture(scope="module")
def bundle():
    """The port forward once per `use_pallas` value, with the same
    perturbed weights, counting the calls of the K1 and K2 wrappers at
    the names the model modules call them by."""
    cfg = tiny_test_config()
    sd = {k: v.numpy()
          for k, v in init_weights(GlassRGBD(cfg), 0).state_dict().items()}
    params = _perturb(glassrgbd_torch_to_flax(sd), np.random.default_rng(1))
    H, W = cfg.eval_hw
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    valid = np.ones((2, H, W), bool)
    valid[1, 40:] = False
    valid[1, :, 70:] = False
    got, calls = {}, {}
    for use_pallas in (False, True):
        model = GlassRGBD(tiny_test_config(use_pallas=use_pallas))
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
    return dict(cfg=cfg, params=params, model=model, x=x, valid=valid,
                got=got, calls=calls)


def _counting(fn, seen, key):
    def spy(*args, **kw):
        seen[key] += 1
        return fn(*args, **kw)
    return spy


def _jax_forward(bundle, use_pallas):
    jm = JGlassRGBD(jax_tiny(use_pallas=use_pallas))
    return jax.jit(jm.apply)({"params": bundle["params"]},
                             jnp.asarray(bundle["x"]),
                             jnp.asarray(bundle["valid"]))


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("use_pallas,dense_tol", [(False, F32_TOL),
                                                  (True, BF16_TAP_TOL)])
def test_glassrgbd_matches_jax(bundle, use_pallas, dense_tol):
    got, want = bundle["got"][use_pallas], _jax_forward(bundle, use_pallas)
    for k in ("pred_logits", "pred_lines"):
        _close(got[k], want[k], F32_TOL)
    for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
        _close(g["pred_logits"], w["pred_logits"], F32_TOL)
        _close(g["pred_lines"], w["pred_lines"], F32_TOL)
    assert len(got["pred_depth"]) == len(want["pred_depth"]) == 4
    for g, w in zip(got["pred_depth"], want["pred_depth"]):
        _close(g, w, dense_tol)
    _close(got["pred_seg"], want["pred_seg"], dense_tol)


def test_model_routes_kernels_by_use_pallas(bundle):
    """As in the JAX package: `use_pallas=False` calls neither kernel
    wrapper; `True` calls K1 once per line-reference block and K2 for the
    12 trunk links of each point head and for its `last0` where the concat
    is at most 400 channels wide."""
    cfg = bundle["cfg"]
    assert bundle["calls"][False] == {"k1": 0, "k2": 0}
    k2 = sum(12 + (5 * 2 * p <= points.FUSE_LAST0_MAX_CI)
             for p in cfg.interval_sample_num[:2])
    assert bundle["calls"][True] == {"k1": cfg.dense_trans_layers[0],
                                     "k2": k2}
    assert k2 == 26


def test_from_jax_matches_export_torch(bundle):
    """The port's bridge and the JAX package's exporter give the same
    tensors for every key, and pass through only integer buffers."""
    template = bundle["model"].state_dict()
    ours = jax_params_to_state_dict(bundle["params"], template)
    theirs, _, passthrough = glassrgbd_flax_to_torch(
        bundle["params"], {k: v.numpy() for k, v in template.items()})
    assert set(ours) == set(theirs) == set(template)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    assert {reason for _, reason in passthrough} == {"non_float"}
    assert all(k.endswith("relative_position_index") for k, _ in passthrough)


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


@pytest.mark.parametrize("flag", [["--resume", "ckpt"], ["--mesh", "4"],
                                  ["--save_vis"]])
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
