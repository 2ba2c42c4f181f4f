"""The port's gated models, on the CPU, at the tiny test config: the
depth-only model (`with_line=False`), the line-only model
(`with_dense=False`) and the learned position embedding
(`position_embedding="learned"`). Their forward, kernel routes and weight
bridge against the JAX package's are cases of `tests/test_torch_model.py`;
here: the parameter groups, the learned position embedding alone, one
train-step loss and the eval loop against the JAX package's on the same
weights, `--torch_init` of each gated model's own `.pth`, and the
training CLI with the gate.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.data.batch import dummy_batch as jax_dummy_batch
from gwdepth_tpu.models import GlassRGBD as JGlassRGBD
from gwdepth_tpu.ops.posemb import LearnedPosEmb2D as JLearnedPosEmb2D
from gwdepth_tpu.parallel import train_state as jts
from gwdepth_tpu.parallel import train_step as jstep

from gwdepth_tpu_torch import main as pmain
from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.data.batch import dummy_batch
from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights
from gwdepth_tpu_torch.ops.posemb import LearnedPosEmb2D
from gwdepth_tpu_torch.parallel import (create_train_state, make_eval_step,
                                        make_train_step, param_group_label)
from gwdepth_tpu_torch.predict import load_original_checkpoint
from gwdepth_tpu_torch.tools.synthetic import generate_dataset

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)
from test_torch_model import F32_TOL, GATES, model_run
from test_torch_train import _flax_paths


def test_gated_models_build_only_their_branches():
    names = {g: {k.split(".")[0] for k in GlassRGBD(
        tiny_test_config(**kw)).state_dict()} for g, kw in GATES.items()}
    line = {"input_proj", "query_embed", "transformer", "class_embed",
            "lines_embed"}
    dense = {"dense_input_proj", "dense_encoder", "depth_decoder"}
    assert names["shipped"] == {"backbone"} | line | dense
    assert names["depth_only"] == {"backbone"} | dense
    assert names["line_only"] == {"backbone"} | line
    assert names["learned_posemb"] == {"backbone"} | line | dense
    learned = [k for k in GlassRGBD(tiny_test_config(
        position_embedding="v3")).state_dict() if k.startswith("backbone.1.")]
    assert learned == ["backbone.1.row_embed.weight",
                       "backbone.1.col_embed.weight"]


@pytest.mark.parametrize("B,H,W,F", [(1, 2, 3, 16), (2, 7, 5, 8),
                                     (1, 50, 50, 4)])
def test_learned_posemb_matches_jax(B, H, W, F):
    rng = np.random.default_rng(H * W)
    row = rng.random((50, F)).astype(np.float32)
    col = rng.random((50, F)).astype(np.float32)
    mod = LearnedPosEmb2D(F)
    mod.row_embed.weight.data = torch.from_numpy(row)
    mod.col_embed.weight.data = torch.from_numpy(col)
    with torch.no_grad():
        got = mod(B, H, W)
    want = JLearnedPosEmb2D(F).apply(
        {"params": {"row_embed": row, "col_embed": col}}, B, H, W)
    assert tuple(got.shape) == (B, H, W, 2 * F)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # init: uniform [0, 1), as the JAX module's
    w = LearnedPosEmb2D(F).row_embed.weight.detach()
    assert 0.0 <= float(w.min()) and float(w.max()) < 1.0


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gated_param_groups_match_jax(gate):
    """Frozen, backbone and main groups map onto the JAX leaves of the same
    labels; the learned position tables train at `lr`, as the JAX
    package's `position_embedding`."""
    run = model_run(gate)
    model = GlassRGBD(run["cfg"])
    jlabels = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                jlabels["/".join(path + (k,))] = jts.param_group_label(
                    path + (k,))
    walk(run["params"])
    port = {"frozen": set(), "backbone": set(), "main": set()}
    for name, p in model.named_parameters():
        port[param_group_label(name, p)] |= _flax_paths(name, tuple(p.shape))
    for name, buf in model.named_buffers():
        if name.startswith("backbone.") and torch.is_floating_point(buf):
            port["frozen"] |= _flax_paths(name, tuple(buf.shape))
    for label in ("frozen", "backbone", "main"):
        assert port[label] == {k for k, v in jlabels.items() if v == label}, \
            label


@pytest.mark.parametrize("gate", ["depth_only", "line_only"])
def test_gated_train_step_loss_matches_jax(gate):
    """One port train step's logged losses against the JAX losses of the
    same weights on the same batch (dropout 0, so train mode computes
    the eval forward), then a finite AdamW update."""
    run = model_run(gate)
    cfg = run["cfg"]
    model = GlassRGBD(cfg)
    model.load_state_dict(
        jax_params_to_state_dict(run["params"], model.state_dict()))
    step = make_train_step(cfg)
    state, vec = step(create_train_state(cfg, model), dummy_batch(cfg, 2),
                      torch.Generator().manual_seed(0))
    got = dict(zip(step.log_keys, vec.tolist()))

    jcfg = jax_tiny(**GATES[gate])
    jb = jax_dummy_batch(jcfg, 2)
    jm = JGlassRGBD(jcfg)

    @jax.jit
    def losses(params):
        out = jm.apply({"params": params}, jb.images, jb.valid)
        return jstep.compute_losses(jcfg, out, jb)[1]
    want = {k: float(v) for k, v in losses(run["params"]).items()}
    assert set(got) == set(want)
    if gate == "line_only":
        assert not any(k.startswith(("loss_depth", "loss_seg")) for k in got)
    else:
        assert not any(k.startswith(("loss_ce", "loss_line")) for k in got)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-5), k
    assert state.step == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gated_torch_init_loads_strictly(gate, tmp_path):
    """`--torch_init` of a gated model's own `.pth` loads every tensor
    (strictly); a tensor of another shape raises instead of being
    skipped."""
    run = model_run(gate)
    sd = run["model"].state_dict()
    torch.save({"model": sd}, tmp_path / "own.pth")
    model = init_weights(GlassRGBD(run["cfg"]), 9)
    assert load_original_checkpoint(model, str(tmp_path / "own.pth"),
                                    warm_start=True) == len(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bad = dict(sd)
    first = next(k for k, v in sd.items() if v.dim() == 2)
    bad[first] = torch.zeros(sd[first].shape[0] + 1, sd[first].shape[1])
    torch.save({"model": bad}, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_original_checkpoint(model, str(tmp_path / "bad.pth"),
                                 warm_start=True)


CLI_GATES = {"line_only": ["--with_line", "--with_center"],
             "depth_only": ["--with_dense"],
             "learned_posemb": ["--with_line", "--with_dense",
                                "--with_center", "--position_embedding",
                                "learned"]}


@pytest.fixture(scope="module")
def synthetic_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    generate_dataset(str(root), 2, 1, height=96, width=128, seed=2)
    return root


# narrow widths through the CLI's own flags: `--tiny` keeps the tiny
# config's gates on whatever the flags say (only values that differ from
# the parser's defaults reach it, in the JAX CLI too), so it cannot run a
# gate off
NARROW = ["--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
          "--dec_layers", "2", "--dim_feedforward", "64", "--num_queries",
          "12", "--num_ref", "4", "--max_lines", "8", "--dense_trans_dim",
          "32", "--dense_trans_heads", "4", "--class_token_dim", "8",
          "--class_init_size", "4", "--train_h", "128", "--train_w", "192",
          "--eval_h", "128", "--eval_w", "192"]


@pytest.mark.parametrize("gate", ["depth_only", "line_only"])
def test_gated_eval_matches_jax(gate, synthetic_set):
    """The eval loop of each package on the same weights and validation
    set (one image, padded to a batch of two): the same keys (a line-only
    model's stats hold nothing but its line outputs), the metrics, and
    the line outputs."""
    from gwdepth_tpu.data.dataset import GlassRGBDDataset as JDataset
    from gwdepth_tpu.data.dataset import Loader as JLoader
    from gwdepth_tpu.engine import evaluate as jevaluate

    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset, Loader
    from gwdepth_tpu_torch.engine import evaluate

    run = model_run(gate)
    root = synthetic_set
    kw = dict(GATES[gate], data_path=f"{root}/rgb",
              gt_depth_path=f"{root}/depth", gt_seg_path=f"{root}/seg",
              gt_line_path=f"{root}/lines",
              filenames_file_train=f"{root}/train.txt",
              filenames_file_eval=f"{root}/val.txt")
    cfg = tiny_test_config(**kw)
    model = GlassRGBD(cfg).eval()
    model.load_state_dict(
        jax_params_to_state_dict(run["params"], model.state_dict()))
    loader = Loader(GlassRGBDDataset(cfg, "val"), batch_size=2,
                    shuffle=False, drop_last=False, pad_to_batch=True,
                    num_workers=1)
    with torch.no_grad():
        got = evaluate(cfg, model, make_eval_step(cfg), loader, "cpu",
                       collect_lines=True)
    jcfg = jax_tiny(**kw)
    jloader = JLoader(JDataset(jcfg, "val"), batch_size=2, shuffle=False,
                      drop_last=False, pad_to_batch=True, num_workers=1)
    want = jevaluate(jcfg, run["params"],
                     jstep.make_eval_step(jcfg, JGlassRGBD(jcfg)), jloader,
                     collect_lines=True)
    assert set(got) == set(want)
    if not cfg.with_dense:
        assert set(got) == {"line_dumps"}
    for k in set(want) - {"line_dumps"}:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-3), k
    assert len(got["line_dumps"]) == len(want["line_dumps"]) \
        == (1 if cfg.with_line else 0)
    for g, w in zip(got["line_dumps"], want["line_dumps"]):
        assert g["name"] == w["name"]
        np.testing.assert_array_equal(g["extent"], np.asarray(w["extent"]))
        for k in ("pred_logits", "pred_lines"):
            w_k = np.asarray(w[k])
            np.testing.assert_allclose(
                g[k], w_k, rtol=0,
                atol=F32_TOL * max(1.0, float(np.abs(w_k).max())))


@pytest.mark.parametrize("gate", sorted(CLI_GATES))
def test_main_trains_and_evaluates_gated_model(gate, synthetic_set, tmp_path):
    """The training CLI takes each gate: one epoch of one step, eval, the
    training-input overlay; the logged keys are those of the gated
    losses."""
    root = synthetic_set
    out = tmp_path / "o"
    state = pmain.main([
        *NARROW, "--device", "cpu", "--num_workers", "1", *CLI_GATES[gate],
        "--data_path", f"{root}/rgb", "--gt_depth_path", f"{root}/depth",
        "--gt_seg_path", f"{root}/seg", "--gt_line_path", f"{root}/lines",
        "--filenames_file_train", f"{root}/train.txt",
        "--filenames_file_eval", f"{root}/val.txt",
        "--output_dir", str(out), "--epochs", "1"])
    cfg = state.model.cfg
    assert cfg.with_line == (gate != "depth_only")
    assert cfg.with_dense == (gate != "line_only")
    assert cfg.position_embedding == ("learned" if gate == "learned_posemb"
                                      else "sine")
    log = json.loads((out / "log.txt").read_text().splitlines()[0])
    train = {k[6:] for k in log if k.startswith("train_")}
    test = {k[5:] for k in log if k.startswith("test_")}
    line = {"loss_ce", "loss_ce_0", "loss_line", "loss_line_0",
            "cardinality_error"}
    dense = {"loss_depth_1", "loss_depth_1_16", "loss_depth_1_4",
             "loss_depth_1_8", "loss_seg"}
    assert train == {"loss"} | (line if cfg.with_line else set()) \
        | (dense if cfg.with_dense else set())
    assert ("silog" in test) == cfg.with_dense
    # the eval losses are summed only with the dense branch, as in JAX
    assert ("loss_ce" in test) == (cfg.with_line and cfg.with_dense)
    assert all(np.isfinite(v) for v in log.values())
    overlay = np.asarray(Image.open(out / "input_log" / "input_epoch0.png"))
    assert overlay.shape == (*cfg.train_hw, 3)
