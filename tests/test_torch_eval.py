"""The port's eval outputs against the JAX package's, on the CPU.

- `evaluation/line_metrics.py`: every function against its JAX function
  on the same numpy-seeded arrays and npz directories. Numpy on both
  sides, the same operations in the same order: exact equality.
- `utils/visualize.py`: every function against its JAX function on the
  same arrays, identical uint8 images.
- The eval CLI end to end: the port's and the JAX package's
  `main --eval --benchmark --dump_gt_lines --save_dense --save_line` on
  one synthetic set, from one `.pth` that the JAX package's exporter
  writes from one perturbed param tree, loaded by both with
  `--torch_init`. Both run the float32 model on the CPU, so their
  outputs differ by reassociation only: the prediction npz files agree
  to F32_TOL (1e-4, scaled by max(1, |reference|)), the GT npz files
  exactly, and the sAP, F-score and APH of the two directories agree.
- `predict --no_line --save_vis` at the tiny size.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from gwdepth_tpu import evaluation as jeval_pkg
from gwdepth_tpu.evaluation import line_metrics as jlm
from gwdepth_tpu.utils import visualize as jvis

from gwdepth_tpu_torch import evaluation as peval_pkg
from gwdepth_tpu_torch.evaluation import line_metrics as plm
from gwdepth_tpu_torch.utils import visualize as pvis

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = 1e-4


def _same(a, b):
    """Equal nested results: arrays, tuples, dicts, floats."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _lines(rng, n, lo=0.0, hi=128.0):
    return rng.uniform(lo, hi, (n, 2, 2))


def _pred_gt_dirs(root, rng, n_img=3, ties=True):
    """Prediction and GT npz directories as the offline scorers read them:
    predictions near some GT lines plus noise lines, a padded duplicate
    tail, and (with `ties`) tied scores."""
    pred_dir, gt_dir = root / "pred", root / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    for i in range(n_img):
        gt = _lines(rng, 6, 10, 118)
        pred = np.concatenate([gt[:4] + rng.normal(0, 1.5, (4, 2, 2)),
                               _lines(rng, 5)])
        score = rng.uniform(0.05, 1.0, len(pred))
        if ties:
            score[[1, 4, 6]] = score[0]
        pred = np.concatenate([pred, pred[:1], pred[:1]])   # padded tail
        score = np.concatenate([score, [0.01, 0.01]])
        order = np.argsort(-score)
        np.savez(pred_dir / f"img{i}.npz", lines=pred[order],
                 score=score[order])
        np.savez(gt_dir / f"img{i}.npz", lpos=gt)
    return str(pred_dir), str(gt_dir)


def test_same_exports_as_jax():
    assert sorted(n for n in dir(peval_pkg) if not n.startswith("_")
                  and n != "line_metrics") == \
        sorted(n for n in dir(jeval_pkg) if not n.startswith("_")
               and n != "line_metrics")
    jfuncs = {n for n, v in vars(jlm).items()
              if callable(v) and getattr(v, "__module__", "") == jlm.__name__}
    pfuncs = {n for n, v in vars(plm).items()
              if callable(v) and getattr(v, "__module__", "") == plm.__name__}
    assert pfuncs == jfuncs
    assert {n for n, v in vars(pvis).items()
            if callable(v) and getattr(v, "__module__", "") == pvis.__name__} \
        == {n for n, v in vars(jvis).items()
            if callable(v) and getattr(v, "__module__", "") == jvis.__name__}


# ---------------------------------------------------------------------------
# line metrics on arrays
# ---------------------------------------------------------------------------

def _array_cases():
    rng = np.random.default_rng(0)
    tp = np.cumsum(rng.integers(0, 2, 30)) / 20.0
    fp = np.cumsum(rng.integers(0, 2, 30)) / 20.0
    gt = _lines(rng, 7)
    pred = np.concatenate([gt[:5, ::-1] + rng.normal(0, 1.0, (5, 2, 2)),
                           gt[:2] + 0.1, _lines(rng, 6)])
    dup = np.concatenate([pred[:4], pred[:1], pred[5:7]])
    dup_scores = np.linspace(1.0, 0.2, len(dup))
    logits = rng.normal(0, 2, (12, 2)).astype(np.float32)
    plines = rng.uniform(0, 1, (12, 6)).astype(np.float32)
    tied = rng.normal(0, 1, (20, 2))
    tied[5:12] = tied[4]
    return {
        "ap": ((tp, fp), {}),
        "fscore": ((tp, fp), {}),
        "ms_tp_fp": ((pred, gt, 5.0), {}),
        "ms_tp_fp_empty": ((pred[:0], gt, 5.0), {}),
        "_truncate_duplicate_tail": ((dup, dup_scores), {}),
        "_truncate_duplicate_tail_none": ((pred, np.linspace(1, 0,
                                                             len(pred))), {}),
        "_score_curve": (([(pred, np.linspace(1, 0.1, len(pred)), gt),
                           (dup, dup_scores, gt[:3]),
                           (pred[:4], np.full(4, 0.5), gt)], 10.0), {}),
        "softmax": ((tied,), {"axis": -1}),
        "postprocess_lines": ((logits, plines, (480, 640)), {}),
        "rasterize_lines": ((np.concatenate([_lines(rng, 4),
                                             _lines(rng, 2, -20, 150)]),),
                            {"size": 128}),
        "_dilate": ((rng.random((32, 32)) > 0.9, 2), {}),
        "_match_counts": ((rng.random((40, 40)) > 0.93,
                           rng.random((40, 40)) > 0.95, 1), {}),
        "_match_counts_empty": ((np.zeros((8, 8), bool),
                                 rng.random((8, 8)) > 0.5, 1), {}),
        # a point past the segment's end: the projection is not clamped
        "_pline": ((0.0, 0.0, 10.0, 0.0, 20.0, 3.0), {}),
        "_plambda": ((0.0, 0.0, 10.0, 0.0, 20.0, 3.0), {}),
    }


@pytest.mark.parametrize("case", sorted(_array_cases()))
def test_line_metric_function_matches_jax(case):
    args, kw = _array_cases()[case]
    name = case
    for suffix in ("_empty", "_none"):
        name = name.removesuffix(suffix)
    _same(getattr(plm, name)(*args, **kw), getattr(jlm, name)(*args, **kw))


def test_score_curve_orders_tied_scores_as_jax():
    """Tied scores order by numpy's default sort in both packages."""
    rng = np.random.default_rng(3)
    gt = _lines(rng, 6)
    pairs = []
    for _ in range(3):
        pred = np.concatenate([gt[:3] + 0.2, _lines(rng, 5)])
        pairs.append((pred, np.full(len(pred), 0.5), gt))
    for t in (5, 10, 15):
        _same(plm._score_curve(pairs, t), jlm._score_curve(pairs, t))


def test_line_nms_matches_jax():
    """Duplicates, overlapping collinear pieces (one cut to its uncovered
    part), a covered segment, and lines far apart."""
    rng = np.random.default_rng(4)
    base = np.array([[[0.0, 0.0], [100.0, 0.0]],
                     [[0.0, 0.0], [100.0, 0.001]],
                     [[50.0, 0.0], [150.0, 0.0]],
                     [[20.0, 0.0], [60.0, 0.0]],
                     [[0.0, 50.0], [0.0, 90.0]]])
    lines = np.concatenate([base, _lines(rng, 10) / 128.0])
    scores = np.linspace(1.0, 0.1, len(lines))
    for threshold, tol in ((0.01, 1e9), (2.0, 0.0), (0.5, 0.1)):
        _same(plm.line_nms(lines, scores, threshold, tol),
              jlm.line_nms(lines, scores, threshold, tol))


# ---------------------------------------------------------------------------
# line metrics on npz directories
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return _pred_gt_dirs(tmp_path_factory.mktemp("lm"),
                         np.random.default_rng(5))


@pytest.mark.parametrize("fn,kw", [
    ("_load_dir_pairs", {}),
    ("sap_score", {}),
    ("sap_score", {"thresholds": (2, 7)}),
    ("fscore_score", {}),
    ("pr_curve", {"threshold": 10}),
    ("aph_pr_points", {}),
    ("aph_pr_points", {"tolerance": 2, "n_thresholds": 7}),
    ("aph_pr_points", {"protocol": "match"}),
    ("aph_score", {}),
    ("aph_score", {"protocol": "match"}),
])
def test_directory_scorer_matches_jax(dirs, fn, kw):
    _same(getattr(plm, fn)(*dirs, **kw), getattr(jlm, fn)(*dirs, **kw))


def test_plot_pr_curves_matches_jax(dirs, tmp_path):
    curves = {"a": jlm.pr_curve(*dirs, threshold=5),
              "b": jlm.pr_curve(*dirs, threshold=15)}
    got = plm.plot_pr_curves(curves, str(tmp_path / "p.png"), title="t")
    want = jlm.plot_pr_curves(curves, str(tmp_path / "j.png"), title="t")
    assert got == str(tmp_path / "p.png")
    _same(np.asarray(Image.open(got)), np.asarray(Image.open(want)))


def test_dump_benchmark_npz_matches_jax(tmp_path):
    """Tied scores, center coords in pred_lines, a non-square image."""
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (30, 2)).astype(np.float32)
    logits[10:20] = logits[3]
    lines = rng.uniform(0, 1, (30, 6)).astype(np.float32)
    for pkg, sub in ((plm, "p"), (jlm, "j")):
        pkg.dump_benchmark_npz(str(tmp_path / sub), "x", logits, lines,
                               (480, 640))
    with np.load(tmp_path / "p" / "x.npz") as a, \
            np.load(tmp_path / "j" / "x.npz") as b:
        assert set(a.files) == set(b.files) == {"lines", "score"}
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            _same(a[k], b[k])


@pytest.fixture(scope="module")
def synthetic_set(tmp_path_factory):
    from gwdepth_tpu_torch.tools.synthetic import generate_dataset

    root = tmp_path_factory.mktemp("ds")
    generate_dataset(str(root), 2, 3, height=96, width=128, seed=3)
    return root


def _cfg_kwargs(root):
    return dict(data_path=f"{root}/rgb", gt_depth_path=f"{root}/depth",
                gt_seg_path=f"{root}/seg", gt_line_path=f"{root}/lines",
                filenames_file_train=f"{root}/train.txt",
                filenames_file_eval=f"{root}/val.txt",
                glassrgbd_images_json=f"{root}/glassrgbd_images.json",
                with_center=True)


def test_dump_gt_lines_matches_jax(synthetic_set, tmp_path):
    from gwdepth_tpu.config import tiny_test_config as jax_tiny
    from gwdepth_tpu.data.dataset import GlassRGBDDataset as JDataset

    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.data.dataset import GlassRGBDDataset

    kw = _cfg_kwargs(synthetic_set)
    pds = GlassRGBDDataset(tiny_test_config(**kw), "val")
    jds = JDataset(jax_tiny(**kw), "val")
    assert pds.id_to_img == jds.id_to_img and pds.id_to_img
    assert plm.dump_gt_lines(pds, str(tmp_path / "p")) == \
        jlm.dump_gt_lines(jds, str(tmp_path / "j")) == 3
    _same_npz_dirs(tmp_path / "p", tmp_path / "j")


def _same_npz_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with np.load(os.path.join(a, n)) as x, \
                np.load(os.path.join(b, n)) as y:
            assert set(x.files) == set(y.files)
            for k in x.files:
                _same(x[k], y[k])


# ---------------------------------------------------------------------------
# visualization
# ---------------------------------------------------------------------------

def _vis_inputs():
    rng = np.random.default_rng(7)
    h, w = 48, 64
    return dict(
        img=rng.normal(0, 1, (h, w, 3)).astype(np.float32),
        rgb=(rng.random((h, w, 3)) * 255).astype(np.uint8),
        depth=rng.uniform(0, 12, (h, w)).astype(np.float32),
        gt_depth=rng.uniform(0, 12, (h, w)).astype(np.float32),
        seg=rng.integers(0, 2, (h, w)),
        gt_seg=rng.integers(0, 2, (h, w)),
        lines=rng.uniform(-5, 70, (7, 4)),
        lines_norm=rng.uniform(0, 1, (5, 6)),
        centers=rng.uniform(0, 60, (7, 2)),
        scores=rng.uniform(0, 1, 7))


@pytest.mark.parametrize("case", ["inv_preprocess", "colorize_depth",
                                  "colorize_depth_max", "draw_lines",
                                  "draw_lines_centers", "show_labels",
                                  "show_labels_no_center",
                                  "show_labels_four_coords"])
def test_visualize_array_function_matches_jax(case, tmp_path):
    v = _vis_inputs()
    calls = {
        "inv_preprocess": ("inv_preprocess", (v["img"],), {}),
        "colorize_depth": ("colorize_depth", (v["depth"],), {}),
        "colorize_depth_max": ("colorize_depth", (v["depth"], 4.0), {}),
        "draw_lines": ("draw_lines", (v["rgb"], v["lines"]), {}),
        "draw_lines_centers": ("draw_lines", (v["rgb"], v["lines"]),
                               {"color": (1, 2, 3), "width": 3,
                                "centers": v["centers"]}),
        "show_labels": ("show_labels", (v["img"], v["lines_norm"]), {}),
        "show_labels_no_center": ("show_labels", (v["img"], v["lines_norm"]),
                                  {"with_center": False}),
        "show_labels_four_coords": ("show_labels",
                                    (v["img"], v["lines_norm"][:, :4]), {}),
    }
    name, args, kw = calls[case]
    got = getattr(pvis, name)(*args, **kw)
    want = getattr(jvis, name)(*args, **kw)
    assert got.dtype == want.dtype == np.uint8
    _same(got, want)


def test_visualize_writers_match_jax(tmp_path):
    v = _vis_inputs()
    for pkg, sub in ((pvis, "p"), (jvis, "j")):
        d = tmp_path / sub
        out = pkg.show_labels(v["img"], v["lines_norm"],
                              str(d / "log" / "input.png"))
        assert (np.asarray(Image.open(d / "log" / "input.png")) == out).all()
        pkg.save_dense_pred(v["depth"], v["gt_depth"], v["seg"], v["gt_seg"],
                            v["img"], str(d / "dense" / "a.png"),
                            max_depth=10.0)
        out = pkg.vis_pred_lines(v["lines"], v["scores"], v["lines"][:3],
                                 v["img"], str(d / "line" / "a.png"),
                                 score_thresh=0.4)
        assert out.shape == (48, 128, 3)
    for rel in ("log/input.png", "dense/a.png", "line/a.png"):
        _same(np.asarray(Image.open(tmp_path / "p" / rel)),
              np.asarray(Image.open(tmp_path / "j" / rel)))


def test_aph_pr_curve_matches_jax(dirs, tmp_path):
    got = pvis.aph_pr_curve(*dirs, str(tmp_path / "p"), n_thresholds=9)
    want = jvis.aph_pr_curve(*dirs, str(tmp_path / "j"), n_thresholds=9)
    assert got["aph"] == want["aph"] and got["fh"] == want["fh"]
    assert os.path.basename(got["png"]) == os.path.basename(want["png"])
    _same(np.asarray(Image.open(got["png"])),
          np.asarray(Image.open(want["png"])))
    with np.load(got["npz"]) as a, np.load(want["npz"]) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            _same(a[k], b[k])


# ---------------------------------------------------------------------------
# the eval CLI end to end
# ---------------------------------------------------------------------------

def _cli_args(root, out, *extra):
    return ["--tiny", "--with_line", "--with_dense", "--with_center",
            "--num_workers", "1", "--mesh", "1",
            "--data_path", f"{root}/rgb", "--gt_depth_path", f"{root}/depth",
            "--gt_seg_path", f"{root}/seg", "--gt_line_path", f"{root}/lines",
            "--filenames_file_train", f"{root}/train.txt",
            "--filenames_file_eval", f"{root}/val.txt",
            "--glassrgbd_images_json", f"{root}/glassrgbd_images.json",
            "--output_dir", str(out), *extra]


EVAL_FLAGS = ("--eval", "--benchmark", "--dump_gt_lines", "--save_dense",
              "--save_line")


@pytest.fixture(scope="module")
def cli_runs(synthetic_set, tmp_path_factory):
    """Both CLIs on one synthetic set from one exported `.pth`."""
    from gwdepth_tpu.convert.export_torch import glassrgbd_flax_to_torch
    from gwdepth_tpu.convert.full_model import glassrgbd_torch_to_flax
    from gwdepth_tpu.main import main as jax_main

    from gwdepth_tpu_torch import main as pmain
    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD, init_weights

    from test_torch_model import _perturb

    tmp = tmp_path_factory.mktemp("cli")
    template = {k: v.numpy() for k, v in init_weights(
        GlassRGBD(tiny_test_config()), 0).state_dict().items()}
    params = _perturb(glassrgbd_torch_to_flax(template),
                      np.random.default_rng(8))
    sd, _, passthrough = glassrgbd_flax_to_torch(params, template)
    assert {reason for _, reason in passthrough} == {"non_float"}
    pth = tmp / "exported.pth"
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}}, pth)
    pout, jout = tmp / "port", tmp / "jax"
    pstats = pmain.main(_cli_args(synthetic_set, pout, *EVAL_FLAGS,
                                  "--device", "cpu", "--torch_init",
                                  str(pth)))
    jstats = jax_main(_cli_args(synthetic_set, jout, *EVAL_FLAGS,
                                "--torch_init", str(pth)))
    return dict(pout=pout, jout=jout, pstats=pstats, jstats=jstats,
                n_tensors=len(template))


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if "checkpoints" not in d)


def test_eval_cli_writes_the_same_files_as_jax(cli_runs):
    got, want = _listing(cli_runs["pout"]), _listing(cli_runs["jout"])
    assert got == want
    for sub, ext in (("benchmark/benchmark_val", ".npz"),
                     ("lines_npz/eval", ".npz"), ("dense_pred", ".png"),
                     ("line_pred", ".png")):
        files = [f for f in got if f.startswith(sub + "/")]
        assert len(files) == 3 and all(f.endswith(ext) for f in files), sub


def test_eval_cli_gt_npz_equal_jax(cli_runs):
    _same_npz_dirs(cli_runs["pout"] / "lines_npz" / "eval",
                   cli_runs["jout"] / "lines_npz" / "eval")


def _tie_groups(score, tol):
    """Index ranges of a descending score vector whose neighbours lie
    within `tol`: inside one, the two packages may order rows apart."""
    groups, start = [], 0
    for i in range(1, len(score) + 1):
        if i == len(score) or score[i - 1] - score[i] > tol:
            groups.append((start, i))
            start = i
    return groups


def test_eval_cli_benchmark_npz_agree_with_jax(cli_runs):
    pdir = cli_runs["pout"] / "benchmark" / "benchmark_val"
    jdir = cli_runs["jout"] / "benchmark" / "benchmark_val"
    for name in sorted(os.listdir(jdir)):
        with np.load(pdir / name) as a, np.load(jdir / name) as b:
            assert set(a.files) == set(b.files) == {"lines", "score"}
            assert a["lines"].shape == b["lines"].shape
            assert a["lines"].dtype == b["lines"].dtype == np.float64
            score_tol = F32_TOL
            np.testing.assert_allclose(a["score"], b["score"], rtol=0,
                                       atol=score_tol)
            assert (np.diff(a["score"]) <= 0).all()
            line_tol = F32_TOL * max(1.0, float(np.abs(b["lines"]).max()))
            # rows in order, except within groups of scores that the
            # tolerance cannot tell apart, compared as sorted sets there
            for s, e in _tie_groups(b["score"], 2 * score_tol):
                ga = a["lines"][s:e].reshape(e - s, -1)
                gb = b["lines"][s:e].reshape(e - s, -1)
                if e - s > 1:
                    ga = ga[np.lexsort(np.round(ga, 1).T[::-1])]
                    gb = gb[np.lexsort(np.round(gb, 1).T[::-1])]
                np.testing.assert_allclose(ga, gb, rtol=0, atol=line_tol)


def test_eval_cli_line_scores_agree_with_jax(cli_runs, tmp_path):
    """sAP, F-score and APH of each package on its own directories; and
    each package's functions on the other's directories."""
    def dirs(out):
        return (str(out / "benchmark" / "benchmark_val"),
                str(out / "lines_npz" / "eval"))
    pd, jd = dirs(cli_runs["pout"]), dirs(cli_runs["jout"])
    p_sap, j_sap = plm.sap_score(*pd), jlm.sap_score(*jd)
    p_f, j_f = plm.fscore_score(*pd), jlm.fscore_score(*jd)
    p_aph, j_aph = plm.aph_score(*pd), jlm.aph_score(*jd)
    for t in (5, 10, 15):
        assert p_sap[t] == pytest.approx(j_sap[t], abs=1e-6)
        assert p_f[t] == pytest.approx(j_f[t], abs=1e-6)
    assert p_aph == pytest.approx(j_aph, abs=1e-6)
    _same(plm.sap_score(*jd), j_sap)
    _same(plm.aph_score(*jd), j_aph)
    # the GT written back as predictions scores 100
    perfect = tmp_path / "perfect"
    perfect.mkdir()
    for n in os.listdir(pd[1]):
        with np.load(os.path.join(pd[1], n)) as g:
            np.savez(perfect / n, lines=g["lpos"],
                     score=np.ones(len(g["lpos"])))
    assert plm.sap_score(str(perfect), pd[1]) == {5: 100.0, 10: 100.0,
                                                   15: 100.0}


def test_eval_cli_metrics_and_images_agree_with_jax(cli_runs):
    ps, js = cli_runs["pstats"], cli_runs["jstats"]
    assert set(ps) == set(js)
    for k in js:
        assert ps[k] == pytest.approx(js[k], rel=1e-3, abs=1e-3), k
    for sub in ("dense_pred", "line_pred"):
        for name in sorted(os.listdir(cli_runs["jout"] / sub)):
            a = np.asarray(Image.open(cli_runs["pout"] / sub / name))
            b = np.asarray(Image.open(cli_runs["jout"] / sub / name))
            assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
            if sub == "line_pred":
                # the GT half is a function of the data alone
                _same(a[:, a.shape[1] // 2:], b[:, b.shape[1] // 2:])
            else:
                h, w = a.shape[0] // 2, a.shape[1] // 3
                # image, GT depth, GT seg: functions of the data alone
                for r, c in ((0, 0), (0, 2), (1, 1)):
                    _same(a[r * h:(r + 1) * h, c * w:(c + 1) * w],
                          b[r * h:(r + 1) * h, c * w:(c + 1) * w])
                # predicted depth: colors within one level
                pa = a[:h, w:2 * w].astype(int)
                pb = b[:h, w:2 * w].astype(int)
                assert np.abs(pa - pb).max() <= 1


def test_eval_cli_torch_init_loads_every_tensor(cli_runs):
    from gwdepth_tpu_torch.config import tiny_test_config
    from gwdepth_tpu_torch.models.glassrgbd import GlassRGBD
    from gwdepth_tpu_torch.predict import load_original_checkpoint

    model = GlassRGBD(tiny_test_config())
    pth = cli_runs["pout"].parent / "exported.pth"
    assert load_original_checkpoint(model, str(pth), warm_start=True) \
        == cli_runs["n_tensors"]


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------

def test_predict_no_line_save_vis_tiny_cpu(tmp_path):
    from gwdepth_tpu_torch import predict
    from gwdepth_tpu_torch.config import tiny_test_config

    src = tmp_path / "images"
    src.mkdir()
    rng = np.random.default_rng(9)
    sizes = {"a": (50, 80), "b": (90, 60)}
    for name, hw in sizes.items():
        Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(
            src / f"{name}.png")
    out = tmp_path / "out"
    predict.main(["--images", str(src), "--output_dir", str(out), "--tiny",
                  "--device", "cpu", "--no_line", "--save_vis"])
    for name, hw in sizes.items():
        depth = np.load(out / f"{name}_depth.npy")
        assert depth.shape == hw and np.isfinite(depth).all()
        vis = np.asarray(Image.open(out / f"{name}_vis.png"))
        assert vis.shape == (*hw, 3)
        # no line branch, so nothing is drawn over the depth colormap
        _same(vis, jvis.colorize_depth(depth, tiny_test_config().max_depth))
        assert (out / f"{name}_lines.json").read_text() == (
            f'{{"image": "{name}.png", "lines": [], "centers": [], '
            '"scores": []}')
