"""The port's training CLI, `gwdepth_tpu_torch.main`, on the CPU.

Two epochs of the tiny config on four small synthetic scenes: it writes
`log.txt` and `eval_results.txt` in the JAX package's formats and a
checkpoint, `--resume` continues from the next epoch with the optimizer
state, `--eval` reads the checkpoint back, every flag the port does not
carry stops the run, and the training flags it carries since the plane
loss, reflection hints, remat and COCO-lines slice each run an epoch.
"""

import ast
import json
import re

import pytest
import torch

from gwdepth_tpu.engine import format_eval_line as jax_format_eval_line
from gwdepth_tpu.main import build_argparser as jax_build_argparser

from gwdepth_tpu_torch import main as pmain
from gwdepth_tpu_torch.engine import format_eval_line
from gwdepth_tpu_torch.tools.synthetic import generate_dataset

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

TRAIN_KEYS = ["cardinality_error", "loss", "loss_ce", "loss_ce_0",
              "loss_depth_1", "loss_depth_1_16", "loss_depth_1_4",
              "loss_depth_1_8", "loss_line", "loss_line_0", "loss_seg"]
TEST_KEYS = ["silog", "abs_rel", "log10", "rms", "sq_rel", "log_rms", "d1",
             "d2", "d3", "iou_background", "iou_glass", "mean_iou",
             "pixel_accuracy", "mean_accuracy", "loss_ce", "loss_line",
             "cardinality_error"]


def _args(root, out, *extra):
    return ["--tiny", "--device", "cpu", "--num_workers", "2",
            "--with_line", "--with_dense", "--with_center",
            "--data_path", f"{root}/rgb", "--gt_depth_path", f"{root}/depth",
            "--gt_seg_path", f"{root}/seg", "--gt_line_path", f"{root}/lines",
            "--filenames_file_train", f"{root}/train.txt",
            "--filenames_file_eval", f"{root}/val.txt",
            "--output_dir", str(out), *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    generate_dataset(str(root), 4, 2, height=96, width=128, seed=1)
    out = tmp_path_factory.mktemp("exp")
    pmain.main(_args(root, out, "--epochs", "2"))
    first_log = (out / "log.txt").read_text()
    ckpt = torch.load(out / "checkpoints" / "checkpoint.pth",
                      weights_only=False)
    pmain.main(_args(root, out, "--epochs", "3", "--resume", "auto"))
    return dict(root=root, out=out, first_log=first_log, ckpt=ckpt)


def test_main_writes_jax_format_logs(run):
    lines = [json.loads(l) for l in
             (run["out"] / "log.txt").read_text().splitlines()]
    assert [l["epoch"] for l in lines] == [0, 1, 2]
    want = ["epoch"] + [f"train_{k}" for k in TRAIN_KEYS] \
        + [f"test_{k}" for k in TEST_KEYS]
    for l in lines:
        assert list(l) == want
        assert all(isinstance(v, (int, float)) for v in l.values())
        assert all(v == v for v in l.values())           # no NaN
    evals = (run["out"] / "eval_results.txt").read_text().splitlines()
    assert len(evals) == 3
    for epoch, (line, log) in enumerate(zip(evals, lines)):
        stats = {k[5:]: v for k, v in log.items() if k.startswith("test_")}
        assert line == jax_format_eval_line(epoch, stats) \
            == format_eval_line(epoch, stats)
        m = re.fullmatch(r"oneline eval epoch(\d+) depth:(\{.*\}) "
                         r"segmentation:(\{.*\})", line)
        assert int(m.group(1)) == epoch
        assert len(ast.literal_eval(m.group(2))) == 9
        assert len(ast.literal_eval(m.group(3))) == 5


def test_main_checkpoint_and_resume(run):
    ck = run["ckpt"]
    assert ck["epoch"] == 1 and ck["step"] == 4           # 2 steps/epoch
    assert set(ck) >= {"model", "optimizer", "lr_scheduler", "args"}
    assert ck["args"]["batch_size"] == 2
    assert "backbone.0.body.layer2.0.conv1.weight" in ck["model"]
    # the resumed run trained exactly one more epoch on top
    assert (run["out"] / "log.txt").read_text().startswith(run["first_log"])
    final = torch.load(run["out"] / "checkpoints" / "checkpoint.pth",
                       weights_only=False)
    assert final["epoch"] == 2 and final["step"] == 6
    stem = "backbone.0.body.conv1.weight"
    assert torch.equal(final["model"][stem], ck["model"][stem])
    moved = "transformer.decoder.layers.0.linear1.weight"
    assert not torch.equal(final["model"][moved], ck["model"][moved])


def test_main_eval_only_reads_the_checkpoint(run):
    stats = pmain.main(_args(run["root"], run["out"], "--eval"))
    assert set(stats) == set(TEST_KEYS)
    last = (run["out"] / "eval_results.txt").read_text().splitlines()[-1]
    assert last == format_eval_line(0, stats)


def test_main_flags_and_defaults_match_jax():
    ours = {a.dest: a.default for a in pmain.build_argparser()._actions}
    theirs = {a.dest: a.default for a in jax_build_argparser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


@pytest.mark.parametrize("flag", [
    ["--mesh", "4,2"], ["--mesh", "1,2"], ["--pre_norm"]])
def test_main_refuses_what_the_port_lacks(tmp_path, flag):
    """`--pre_norm`, which the port lacks; and a two-axis mesh (tensor
    parallelism, which runs under torchrun) of more ranks than one
    process without torchrun has."""
    match = ("not supported by the PyTorch port" if flag == ["--pre_norm"]
             else "tensor parallelism spans the torchrun world, 1 rank")
    with pytest.raises(SystemExit, match=match):
        pmain.main(_args(tmp_path, tmp_path / "o", *flag))


@pytest.mark.parametrize("flag", ["with_plane_norm_loss", "with_reflection",
                                  "remat", "coco_path", "frozen_weights",
                                  "bf16"])
def test_main_runs_the_training_flags(run, tmp_path, capsys, flag):
    """Each flag that the port once refused runs one epoch (2 steps) and
    its eval: `--with_plane_norm_loss` logs a finite `loss_plane` (at 28
    queries, the loss's own `num_ref`);
    `--with_reflection` only sets the config flag; `--remat` recomputes
    every Swin layer of the dense encoder; `--coco_path` trains on a
    COCO-lines set; `--frozen_weights` starts from the first run's
    checkpoint; `--bf16` computes the backbone and DETR's dense layers in
    bfloat16 and keeps the parameters float32."""
    from test_torch_coco_lines import write_coco_set

    extra = {"with_plane_norm_loss": ["--with_plane_norm_loss",
                                      "--num_queries", "28"],
             "with_reflection": ["--with_reflection"],
             "remat": ["--remat"],
             "bf16": ["--bf16"],
             "frozen_weights": ["--frozen_weights", str(
                 run["out"] / "checkpoints" / "checkpoint.pth")]}.get(flag, [])
    argv = _args(run["root"], tmp_path / "o", "--epochs", "1", *extra)
    if flag == "coco_path":
        coco = write_coco_set(tmp_path / "coco", n=4)
        argv += ["--coco_path", str(coco / "imgs"),
                 "--coco_ann_train", str(coco / "lines_train2017.json"),
                 "--coco_ann_val", str(coco / "lines_val2017.json")]
    args = pmain.build_argparser().parse_args(argv)
    cfg = pmain.config_from_args(args)
    pmain._refuse(args, cfg)
    state = pmain.main(argv)
    assert state.step == 2
    log = json.loads((tmp_path / "o" / "log.txt").read_text())
    assert all(v == v for v in log.values())              # no NaN
    keys = [k[6:] for k in log if k.startswith("train_")]
    if flag == "with_plane_norm_loss":
        assert keys == sorted(TRAIN_KEYS + ["loss_plane"])
        assert state.model.cfg.num_queries == 28
    else:
        assert keys == TRAIN_KEYS
    assert state.model.cfg.with_reflection == (flag == "with_reflection")
    assert state.model.cfg.dtype == ("bfloat16" if flag == "bf16"
                                     else "float32")
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    remat = {layer.remat for layer in state.model.dense_encoder.modules()
             if hasattr(layer, "remat")}
    assert remat == {flag == "remat"}
    if flag == "frozen_weights":
        # every encoder, decoder and head tensor of the first run
        keep = ("encoder", "decoder", "class_embed", "lines_embed")
        n = sum(any(t in k for t in keep) for k in run["ckpt"]["model"])
        assert f": {n} tensors loaded" in capsys.readouterr().out


def test_main_carries_the_dense_encoder_gates(tmp_path):
    """`--with_dense_center`, `--with_line_depth` and
    `--class_tokenfuse_layers` reach the config as in the JAX CLI, are not
    refused, and build the gated modules."""
    from gwdepth_tpu.main import config_from_args as jax_config_from_args
    from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD

    argv = _args(tmp_path, tmp_path / "o", "--with_dense_center",
                 "--with_line_depth", "--class_tokenfuse_layers", "1,0,1")
    args = pmain.build_argparser().parse_args(argv)
    cfg = pmain.config_from_args(args)
    pmain._refuse(args, cfg)
    jcfg = jax_config_from_args(jax_build_argparser().parse_args(
        [a for a in argv if a not in ("--device", "cpu")]))
    for f in ("with_dense_center", "with_line_depth",
              "class_tokenfuse_layers", "group_attention_layers",
              "depth_sample_layers"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.ref_points_per_line == 3
    enc = GlassRGBD(cfg).dense_encoder
    assert hasattr(enc, "gpg3") and not hasattr(enc, "depth_token")
    assert [hasattr(layer.blocks[0], "token_relation") for layer in (
        enc.class_transformer1, enc.class_transformer2,
        enc.class_transformer3)] == [True, False, True]


def test_torch_init_and_weights_only_resume_load_original_names(tmp_path):
    """An original-code checkpoint (DDP prefix, legacy `bbox_embed` name,
    no optimizer) loads by name: as a warm start, and as a `--resume`
    `.pth`, which restores the weights and starts at epoch 0."""
    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights
    from gwdepth_tpu_torch.parallel import create_train_state
    from gwdepth_tpu_torch.predict import load_original_checkpoint
    from gwdepth_tpu_torch.utils.checkpoint import restore_file

    cfg = tiny_test_config()
    src = init_weights(GlassRGBD(cfg), 5)
    sd = {("module." + k).replace("lines_embed", "bbox_embed"): v
          for k, v in src.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "orig.pth")
    for load in (lambda m: load_original_checkpoint(
                     m, tmp_path / "orig.pth", warm_start=True),
                 lambda m: restore_file(create_train_state(cfg, m),
                                        tmp_path / "orig.pth")):
        model = init_weights(GlassRGBD(cfg), 6)
        assert load(model) in (0, len(sd))
        for k, v in src.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k
