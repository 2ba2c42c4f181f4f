"""The port's COCO-lines path against the JAX package's, on the CPU: the
dataset's train and eval items (`data/coco_lines.py`, bit-equal on a
COCO json of offset-form lines), `main.load_frozen_weights` against
`gwdepth_tpu.main.load_frozen_weights` on one `.pth` (the same tensors
overwritten, the same values), and the training CLI on the COCO set
with `--frozen_weights`: one step, then `--eval`.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
from gwdepth_tpu.data.coco_lines import CocoLinesDataset as JCocoLines
from gwdepth_tpu.main import load_frozen_weights as jax_load_frozen_weights

from gwdepth_tpu_torch import main as pmain
from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.convert import jax_params_to_state_dict
from gwdepth_tpu_torch.data.coco_lines import CocoLinesDataset
from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights

from test_torch_gates import NARROW
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)


def write_coco_set(root, n=3, seed=0):
    """`n` random images (the last larger than the 96x128 canvas) and
    `lines_{train,val}2017.json` with 4 offset-form lines each, one of
    them reaching past the image, under `root`."""
    os.makedirs(root / "imgs", exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i in range(n):
        name = f"{i:08d}.png"
        w, h = (160, 120) if i == n - 1 else (128, 96)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            root / "imgs" / name)
        images.append({"id": i, "file_name": name, "width": w, "height": h})
        for j in range(4):
            x, y = rng.uniform(5, 60, 2)
            dx = 90.0 if j == 3 else 30.0             # clipped at x = w
            annotations.append({"image_id": i, "category_id": 0,
                                "line": [float(x), float(y), dx, 20.0],
                                "area": 1, "iscrowd": 0})
    ann = {"images": images, "annotations": annotations}
    for split in ("train", "val"):
        with open(root / f"lines_{split}2017.json", "w") as f:
            json.dump(ann, f)
    return root


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return write_coco_set(tmp_path_factory.mktemp("coco"))


def _equal_items(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "name":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("split,idx,seed", [
    ("train", 0, 0), ("train", 1, 3), ("train", 2, 7), ("train", 2, 11),
    ("val", 0, None), ("val", 2, None)])
def test_coco_lines_item_matches_jax(coco_dir, split, idx, seed):
    kw = dict(train_hw=(96, 128), eval_hw=(96, 128))
    ann = str(coco_dir / f"lines_{split}2017.json")
    ds = CocoLinesDataset(tiny_test_config(**kw), str(coco_dir / "imgs"),
                          ann, split)
    jds = JCocoLines(jax_tiny(**kw), str(coco_dir / "imgs"), ann, split)
    assert len(ds) == len(jds) == 3
    got = ds.__getitem__(idx, seed=seed)
    _equal_items(got, jds.__getitem__(idx, seed=seed))
    assert got["depth"].max() == 0 and got["seg"].max() == 0
    lines = got["lines"][got["line_mask"]]
    assert len(lines) and lines.min() >= 0 and lines.max() <= 1
    # the center slot holds each line's midpoint
    np.testing.assert_allclose(lines[:, 4:], (lines[:, :2] + lines[:, 2:4])
                               / 2, atol=1e-6)


def _checkpoint(cfg, path):
    """A `.pth` of other weights of the model of `cfg`, written as the
    original code names them (DDP prefix, `bbox_embed`), with one encoder
    tensor of another shape."""
    sd = init_weights(GlassRGBD(cfg), 5).state_dict()
    bad = "transformer.encoder.layers.0.linear1.weight"
    sd[bad] = torch.ones(sd[bad].shape[0] + 1, sd[bad].shape[1])
    torch.save({"model": {("module." + k).replace("lines_embed",
                                                   "bbox_embed"): v
                          for k, v in sd.items()}}, path)
    return sd, bad


def test_frozen_weights_load_matches_jax(tmp_path):
    cfg = tiny_test_config()
    model = init_weights(GlassRGBD(cfg), 0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    params = glassrgbd_torch_to_flax({k: v.numpy() for k, v in
                                      start.items()})
    src, bad = _checkpoint(cfg, tmp_path / "stage1.pth")

    n = pmain.load_frozen_weights(model, str(tmp_path / "stage1.pth"))
    got = model.state_dict()
    want = jax_params_to_state_dict(
        jax_load_frozen_weights(params, str(tmp_path / "stage1.pth")),
        {k: v.clone() for k, v in start.items()})
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    loaded = {k for k in got if not torch.equal(got[k], start[k])}
    keep = ("encoder", "decoder", "class_embed", "lines_embed")
    assert loaded == {k for k in start if any(t in k for t in keep)
                      and k != bad and not torch.equal(src[k], start[k])}
    assert n >= len(loaded)
    assert not any(k.startswith(("backbone.", "input_proj",
                                 "dense_input_proj", "query_embed"))
                   for k in loaded)
    assert torch.equal(got[bad], start[bad])


def test_frozen_weights_refuses_urls_and_resume(tmp_path):
    with pytest.raises(SystemExit, match="URL"):
        pmain.main(["--tiny", "--device", "cpu", "--frozen_weights",
                    "https://example.invalid/w.pth"])
    with pytest.raises(AssertionError, match="mutually exclusive"):
        pmain.main(["--tiny", "--device", "cpu", "--frozen_weights",
                    str(tmp_path / "w.pth"), "--resume", "auto"])


def test_main_trains_and_evaluates_on_coco_lines(coco_dir, tmp_path):
    """The line-only model on the COCO set from another run's weights by
    `--frozen_weights`: one epoch of one step at bs1 over the train json's
    first image, the eval, then `--eval` from the checkpoint."""
    src_cfg = pmain.config_from_args(pmain.build_argparser().parse_args(
        NARROW + ["--with_line", "--with_center"]))
    _checkpoint(src_cfg, tmp_path / "stage1.pth")
    ann = json.loads((coco_dir / "lines_train2017.json").read_text())
    ann["images"] = ann["images"][:1]
    (tmp_path / "one.json").write_text(json.dumps(ann))
    out = tmp_path / "o"
    argv = [*NARROW, "--device", "cpu", "--num_workers", "1",
            "--with_line", "--with_center", "--batch_size", "1",
            "--coco_path", str(coco_dir / "imgs"),
            "--coco_ann_train", str(tmp_path / "one.json"),
            "--coco_ann_val", str(coco_dir / "lines_val2017.json"),
            "--output_dir", str(out), "--epochs", "1"]
    state = pmain.main(argv + ["--frozen_weights",
                               str(tmp_path / "stage1.pth")])
    assert state.step == 1 and not state.model.cfg.with_dense
    log = json.loads((out / "log.txt").read_text().splitlines()[0])
    assert {"train_loss", "train_loss_ce", "train_loss_line"} <= set(log)
    assert all(np.isfinite(v) for v in log.values())
    assert (out / "checkpoints" / "checkpoint.pth").exists()
    stats = pmain.main(argv + ["--eval", "--benchmark"])
    assert stats == {}                     # line-only: nothing, as in JAX
    dumps = sorted(os.listdir(out / "benchmark" / "benchmark_val"))
    assert dumps == [f"{i:08d}.npz" for i in range(3)]
