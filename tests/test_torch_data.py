"""The port's data pipeline against the JAX package's, on the CPU.

Synthetic scenes, joint transforms, dataset samples (train and eval),
the loader and batches: numpy-seeded inputs and the same `random.Random`
seed go through both packages, and the outputs must be equal element for
element. Both run numpy and PIL (the JAX package's native decoder is
bit-exact with PIL), so no tolerance is needed.
"""

import json
import random

import numpy as np
import pytest
from PIL import Image

from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.data import dataset as jds
from gwdepth_tpu.data import depth_only as jdo
from gwdepth_tpu.data import transforms as jt
from gwdepth_tpu.data.batch import dummy_batch as jax_dummy_batch
from gwdepth_tpu.tools import synthetic as jsyn

from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.data import dataset as pds
from gwdepth_tpu_torch.data import depth_only as pdo
from gwdepth_tpu_torch.data import transforms as pt
from gwdepth_tpu_torch.data.batch import FIELDS, dummy_batch
from gwdepth_tpu_torch.tools import synthetic as psyn

FIELDS_S = ("image", "depth", "seg", "lines", "centers", "poly_ids")


def _equal_samples(got, want):
    for f in FIELDS_S:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(g, Image.Image):
            g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_scene_matches_jax(seed):
    got = psyn.generate_scene(np.random.default_rng(seed), 72, 96)
    want = jsyn.generate_scene(np.random.default_rng(seed), 72, 96)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    psyn.generate_dataset(str(root / "port"), 4, 2, height=120, width=160,
                          seed=3)
    jsyn.generate_dataset(str(root / "jax"), 4, 2, height=120, width=160,
                          seed=3)
    return root


def test_generated_dataset_files_match_jax(dataset_root):
    port, jax_ = dataset_root / "port", dataset_root / "jax"
    for split in ("train.txt", "val.txt", "glassrgbd_images.json"):
        assert (port / split).read_text() == (jax_ / split).read_text()
    names = (port / "train.txt").read_text().split() + \
        (port / "val.txt").read_text().split()
    assert len(names) == 6
    for name in names:
        for sub in ("rgb", "depth", "seg"):
            np.testing.assert_array_equal(
                np.asarray(Image.open(port / sub / f"{name}.png")),
                np.asarray(Image.open(jax_ / sub / f"{name}.png")))
        assert json.loads((port / "lines" / f"{name}.json").read_text()) == \
            json.loads((jax_ / "lines" / f"{name}.json").read_text())


def _paths(root):
    return dict(data_path=f"{root}/rgb", gt_depth_path=f"{root}/depth",
                gt_seg_path=f"{root}/seg", gt_line_path=f"{root}/lines",
                filenames_file_train=f"{root}/train.txt",
                filenames_file_eval=f"{root}/val.txt")


@pytest.fixture(scope="module")
def datasets(dataset_root):
    paths = _paths(dataset_root / "jax")
    pcfg = tiny_test_config(**paths)
    jcfg = jax_tiny(**paths)
    return pcfg, jcfg


def _equal_items(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "name":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("idx,seed", [(0, 0), (1, 7), (2, 11), (3, 12),
                                      (0, 21), (1, 33)])
def test_train_sample_matches_jax(datasets, idx, seed):
    pcfg, jcfg = datasets
    got = pds.GlassRGBDDataset(pcfg, "train").__getitem__(idx, seed=seed)
    want = jds.GlassRGBDDataset(jcfg, "train").__getitem__(idx, seed=seed)
    _equal_items(got, want)


@pytest.mark.parametrize("idx", [0, 1])
def test_eval_sample_matches_jax(datasets, idx):
    pcfg, jcfg = datasets
    _equal_items(pds.GlassRGBDDataset(pcfg, "val")[idx],
                 jds.GlassRGBDDataset(jcfg, "val")[idx])


@pytest.fixture(scope="module")
def bts_list(dataset_root):
    """A BTS-style filenames file over the synthetic scenes: `rgb depth
    focal` per line, paths relative to the root with a leading slash."""
    root = dataset_root / "jax"
    names = (root / "train.txt").read_text().split()
    f = root / "bts_train.txt"
    f.write_text("".join(f"/rgb/{n}.png /depth/{n}.png 518.8579\n"
                         for n in names))
    return root, f


@pytest.mark.parametrize("split,idx,seed,scale", [
    ("train", 0, 4, 1000.0), ("train", 2, 9, 1000.0), ("train", 1, 5, 256.0),
    ("val", 0, None, 1000.0), ("val", 3, None, 256.0)])
def test_depth_only_sample_matches_jax(bts_list, split, idx, seed, scale):
    root, names = bts_list
    pcfg, jcfg = tiny_test_config(with_line=False), jax_tiny(with_line=False)
    got = pdo.DepthOnlyDataset(pcfg, str(root), str(names), split,
                               depth_scale=scale).__getitem__(idx, seed=seed)
    want = jdo.DepthOnlyDataset(jcfg, str(root), str(names), split,
                                depth_scale=scale).__getitem__(idx, seed=seed)
    assert not got["line_mask"].any() and not got["seg"].any()
    _equal_items(got, want)


def test_depth_only_dataset_feeds_the_loader_shares(bts_list):
    """The depth-only set through the Loader: two ranks' parts of each
    global batch side by side are one process's batch."""
    root, names = bts_list
    ds = pdo.DepthOnlyDataset(tiny_test_config(with_line=False), str(root),
                              str(names), "train")
    one = [(b, n) for b, n in pds.Loader(ds, 2, seed=1,
                                         num_workers=1).epoch(0)]
    parts = [list(pds.Loader(ds, 2, seed=1, num_workers=1, rank=r,
                             world=2).epoch(0)) for r in range(2)]
    assert len(one) == 2
    for bi, (batch, n) in enumerate(one):
        assert parts[0][bi][1] + parts[1][bi][1] == n
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.concatenate([getattr(parts[r][bi][0], f).numpy()
                                for r in range(2)]),
                getattr(batch, f).numpy(), err_msg=f)


@pytest.fixture(scope="module")
def rhint_dir(dataset_root):
    """Seeded reflection-hint jsons ([row, col] points) for every scene
    but the last validation one, which has no file; one scene's hints
    outnumber `max_rhint_points`."""
    d = dataset_root / "rhint"
    d.mkdir()
    rng = np.random.default_rng(4)
    names = (dataset_root / "jax" / "train.txt").read_text().split() + \
        (dataset_root / "jax" / "val.txt").read_text().split()
    for i, name in enumerate(names[:-1]):
        n = 60 if i == 1 else int(rng.integers(0, 9))
        pts = np.stack([rng.uniform(0, 120, n), rng.uniform(0, 160, n)], 1)
        (d / f"{name}.json").write_text(json.dumps(
            {"rhint_points": pts.round(2).tolist()}))
    return d


@pytest.mark.parametrize("split,idx,seed", [("train", 0, 3), ("train", 1, 5),
                                            ("val", 0, None),
                                            ("val", 1, None)])
def test_reflection_sample_matches_jax(dataset_root, rhint_dir, split, idx,
                                       seed):
    """`with_reflection` with a hint directory: the padded points and
    mask of each sample, the hints flipped to [x, y] and moved into the
    canvas frame; a scene without a file gets an all-False mask."""
    paths = dict(_paths(dataset_root / "jax"), with_reflection=True,
                 glassrgbd_rhint_points_path=str(rhint_dir))
    got = pds.GlassRGBDDataset(tiny_test_config(**paths), split
                               ).__getitem__(idx, seed=seed)
    want = jds.GlassRGBDDataset(jax_tiny(**paths), split
                                ).__getitem__(idx, seed=seed)
    _equal_items(got, want)
    assert got["reflection_points"].shape == (50, 2)
    if split == "train" and idx == 1:
        assert got["reflection_mask"].all()       # 60 hints, 50 slots
    if split == "val" and idx == 1:
        assert not got["reflection_mask"].any()   # no hint file
    # without the hint directory the flag alone adds nothing, as in JAX
    bare = dict(_paths(dataset_root / "jax"), with_reflection=True)
    item = pds.GlassRGBDDataset(tiny_test_config(**bare), split
                                ).__getitem__(idx, seed=seed)
    assert "reflection_points" not in item


def test_eval_loader_batches_match_jax(datasets):
    pcfg, jcfg = datasets
    pl = pds.Loader(pds.GlassRGBDDataset(pcfg, "val"), batch_size=2,
                    shuffle=False, drop_last=False, num_workers=2)
    jl = jds.Loader(jds.GlassRGBDDataset(jcfg, "val"), batch_size=2,
                    shuffle=False, drop_last=False, num_workers=2)
    got, want = list(pl.epoch(0)), list(jl.epoch(0))
    assert len(got) == len(want) == len(pl) == 1
    for (gb, gn), (wb, wn) in zip(got, want):
        assert gn == wn
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(gb, f).numpy(),
                                          np.asarray(getattr(wb, f)),
                                          err_msg=f)


def test_train_loader_order_matches_jax(datasets):
    pcfg, jcfg = datasets
    pl = pds.Loader(pds.GlassRGBDDataset(pcfg, "train"), batch_size=2,
                    seed=5, num_workers=1)
    jl = jds.Loader(jds.GlassRGBDDataset(jcfg, "train"), batch_size=2,
                    seed=5, num_workers=1)
    for epoch in (0, 1):
        assert [n for _, n in pl.epoch(epoch)] == \
            [n for _, n in jl.epoch(epoch)]


def _sample(seed, hw=(90, 130), n=6):
    rng = np.random.default_rng(seed)
    img = Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8))
    depth = rng.integers(0, 9000, size=hw).astype(np.int32)
    seg = rng.integers(0, 2, size=hw).astype(np.uint8)
    quad = np.array([[10.0, 12.0], [100.0, 8.0], [110.0, 80.0], [5.0, 70.0]])
    lines = np.concatenate([quad, np.roll(quad, -1, 0)], 1)
    lines = np.concatenate([lines, rng.uniform(0, 90, size=(n - 4, 4))])
    centers = np.tile(quad.mean(0), (n, 1))
    ids = np.array([0, 0, 0, 0] + [1] * (n - 4))
    return (pt.Sample(img, depth, seg, lines, centers, ids),
            jt.Sample(img, depth, seg, lines, centers, ids))


@pytest.mark.parametrize("box", [(5, 20, 60, 70), (0, 0, 90, 130),
                                 (30, 50, 40, 40)])
def test_crop_and_flips_match_jax(box):
    ps, js = _sample(sum(box))
    _equal_samples(pt.crop(ps, *box), jt.crop(js, *box))
    _equal_samples(pt.crop(pt.hflip(ps), *box), jt.crop(jt.hflip(js), *box))
    _equal_samples(pt.vflip(ps), jt.vflip(js))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_color_jitter_matches_jax(seed):
    ps, js = _sample(seed)
    got = pt.color_jitter(ps.image, random.Random(seed))
    want = jt.color_jitter(js.image, random.Random(seed))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_lines_from_polygons_matches_jax():
    label = {"shapes": [{"points": [[1, 2], [30, 4], [28, 40]], "poly_id": 3},
                        {"points": []},
                        {"points": [[5, 5], [9, 5], [9, 9], [5, 9]]}]}
    for g, w in zip(pds.lines_from_polygons(label),
                    jds.lines_from_polygons(label)):
        np.testing.assert_array_equal(g, w)


def test_dummy_batch_matches_jax():
    got = dummy_batch(tiny_test_config(), 3, num_lines=2, seed=4)
    want = jax_dummy_batch(jax_tiny(), 3, num_lines=2, seed=4)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    moved = got.to("cpu")
    assert moved.seg.dtype == got.seg.dtype and moved.batch_size == 3
