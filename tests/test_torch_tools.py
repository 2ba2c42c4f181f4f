"""The port's offline dataset toolchain, SNE and profiling helpers against
the JAX package's, on the CPU.

- `tools/sne.py`: `sne_normals` in torch against JAX's to SNE_TOL
  max-abs, with the same fallback pixels, on depth maps with zero holes
  and with the Y <= 0 half that makes 1/Z infinite.
- The numpy tools (`depth_completion`, `reflection`, `raw_capture`,
  `pred_compare`): equal arrays, and equal files under `tmp_path`.
- `utils/profiling.py`: `trace` writes a trace file, `StepTimer` has the
  JAX version's keys, `device_memory_stats` is None off the card.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gwdepth_tpu import tools as jtools
from gwdepth_tpu.tools import depth_completion as jdc
from gwdepth_tpu.tools import pred_compare as jpc
from gwdepth_tpu.tools import raw_capture as jrc
from gwdepth_tpu.tools import reflection as jrefl
from gwdepth_tpu.tools.sne import sne_normals as jax_sne
from gwdepth_tpu.utils import profiling as jprof

from gwdepth_tpu_torch import tools
from gwdepth_tpu_torch.tools import depth_completion as dc
from gwdepth_tpu_torch.tools import pred_compare as pc
from gwdepth_tpu_torch.tools import raw_capture as rc
from gwdepth_tpu_torch.tools import reflection as refl
from gwdepth_tpu_torch.tools.sne import sne_normals
from gwdepth_tpu_torch.utils import profiling

from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)

SNE_TOL = 1e-4
INTR = dc.Intrinsics(fx=900.0, fy=900.0, ppx=640.0, ppy=360.0)


# ---------------------------------------------------------------------------
# SNE
# ---------------------------------------------------------------------------

def _fallback(n: np.ndarray) -> np.ndarray:
    """Pixels where the estimate is undefined: the (0, 0, -1) fallback."""
    return (n[0] == 0) & (n[1] == 0) & (n[2] == -1)


_jax_sne = jax.jit(jax_sne)


def _sne_depth(case: str):
    rng = np.random.default_rng(30)
    H, W = 48, 64
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    depth = 2.0 + 0.01 * xx + 0.02 * yy + 0.001 * rng.normal(size=(H, W))
    cy = H / 2
    if case in ("holes", "holes_below"):
        depth[rng.uniform(size=(H, W)) < 0.05] = 0.0    # sensor holes
        depth[30:34, 20:30] = 0.0                       # a glass pane
    if case == "holes_below":
        cy = -5.0                                       # no Y <= 0 half
    if case == "one_hole":
        cy = -5.0
        depth[0, 0] = 0.0
    if case == "constant":
        depth[:] = 3.0
    cam = np.array([[600.0, 0, W / 2], [0, 610.0, cy], [0, 0, 1]],
                   np.float32)
    return depth.astype(np.float32), cam


@pytest.mark.parametrize("case", ["smooth", "holes", "holes_below",
                                  "one_hole", "constant"])
def test_sne_normals_match_jax(case):
    """Every pixel within SNE_TOL and the same fallback pixels: with the
    upper half zeroed (Y <= 0) and sensor holes (Z = 0), where 1/Z is
    infinite and XLA's convolution multiplies the zero taps into NaN."""
    depth, cam = _sne_depth(case)
    want = np.asarray(_jax_sne(jnp.asarray(depth), jnp.asarray(cam)))
    got = sne_normals(torch.from_numpy(depth), torch.from_numpy(cam))
    assert got.shape == (3, *depth.shape) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(_fallback(got), _fallback(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=SNE_TOL)
    if case in ("holes", "smooth"):
        assert _fallback(want)[: depth.shape[0] // 2].all()   # Y <= 0 half
    if case == "holes":
        assert _fallback(want)[depth.shape[0] // 2:].any()


def test_sne_nan_pattern_of_one_hole():
    """One zero at (0, 0), no Y <= 0 half: the pixels whose 3x3 window
    holds its inf fall back."""
    depth, cam = _sne_depth("one_hole")
    got = _fallback(sne_normals(torch.from_numpy(depth), cam).numpy())
    assert got[:2, :2].all() and not got[3:, 3:].any()


# ---------------------------------------------------------------------------
# numpy tools
# ---------------------------------------------------------------------------

def test_tools_package_exports_the_same_names():
    names = [n for n in dir(jtools) if not n.startswith("_")
             and n not in ("depth_completion", "reflection", "sne",
                           "synthetic", "raw_capture", "pred_compare")]
    for n in names:
        assert hasattr(tools, n), n


def test_depth_completion_matches():
    rng = np.random.default_rng(31)
    px = rng.uniform(0, 1280, (50, 2))
    d = rng.uniform(0.5, 8.0, 50)
    jintr = jdc.Intrinsics(fx=900.0, fy=900.0, ppx=640.0, ppy=360.0)
    pts = dc.deproject(px, d, INTR)
    np.testing.assert_array_equal(pts, jdc.deproject(px, d, jintr))
    np.testing.assert_array_equal(dc.project(pts, INTR),
                                  jdc.project(pts, jintr))
    p1, p2 = pts[0], pts[1]
    np.testing.assert_array_equal(dc.interpolate_side_points(p1, p2, 6.0),
                                  jdc.interpolate_side_points(p1, p2, 6.0))

    h, w = 120, 160
    raw = rng.uniform(500, 4000, (h, w)).astype(np.float32)
    raw[rng.uniform(size=(h, w)) < 0.3] = 0.0
    verts = np.array([[20, 20], [140, 25], [130, 100], [25, 95]], float)
    depths = np.array([2000.0, 3000.0, 2800.0, 2100.0])
    np.testing.assert_array_equal(
        dc.complete_polygon_depth(raw, verts, INTR, 6.0, depths),
        jdc.complete_polygon_depth(raw, verts, jintr, 6.0, depths))
    np.testing.assert_array_equal(dc.polygon_mask(verts, h, w),
                                  jdc.polygon_mask(verts, h, w))
    raw[20, 20] = raw[25, 140] = raw[100, 130] = raw[95, 25] = 1500.0
    label = {"shapes": [{"points": verts.tolist()},
                        {"points": [[1, 1], [5, 1]]}]}
    got = dc.complete_depth(raw, label, INTR)
    np.testing.assert_array_equal(got, jdc.complete_depth(raw, label, jintr))
    gt = raw + rng.normal(0, 20, raw.shape).astype(np.float32)
    assert dc.compare_depth_preds(got, gt) == jdc.compare_depth_preds(got, gt)


def test_intrinsics_from_json_matches(tmp_path):
    p = tmp_path / "intr.json"
    p.write_text(json.dumps({"fx": 910.5, "fy": 905.25, "ppx": 641.0,
                             "ppy": 359.5, "width": 848}))
    got = dc.Intrinsics.from_json(str(p))
    want = jdc.Intrinsics.from_json(str(p))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_reflection_matches():
    rng = np.random.default_rng(32)
    img = rng.integers(0, 255, (40, 50, 3)).astype(np.uint8)
    rr = img.copy()
    rr[5:15, 5:15] = np.clip(rr[5:15, 5:15].astype(int) - 120, 0, 255)
    rr[25:35, 30:45] = np.clip(rr[25:35, 30:45].astype(int) + 90, 0, 255)
    diff = refl.reflection_difference(img, rr)
    np.testing.assert_array_equal(diff, jrefl.reflection_difference(img, rr))
    for k in (1, 5, 20):
        assert refl.sample_reflection_points(diff, k) == \
            jrefl.sample_reflection_points(diff, k)
    assert refl.sample_reflection_points(np.zeros((4, 4), np.uint8)) == \
        {"rhint_points": []}


def _tree(root) -> dict:
    """Relative path -> bytes of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(tmp_path, fn_port, fn_jax):
    """Run each package's function into a directory of its own; return
    both results and both directories' files."""
    a, b = tmp_path / "port", tmp_path / "jax"
    a.mkdir(parents=True)
    b.mkdir(parents=True)
    return fn_port(str(a)), fn_jax(str(b)), _tree(a), _tree(b)


def _capture_inputs(root):
    img = np.zeros((20, 30, 3), np.uint8)
    img[5:11, 8:16] = 200
    Image.fromarray(img).save(root / "a.png")
    depth = np.arange(20 * 30, dtype=np.uint16).reshape(20, 30)
    np.save(root / "a.npy", depth)
    label = {"shapes": [
        {"label": "crop", "shape_type": "rectangle",
         "points": [[8, 5], [15, 10]]},
        {"label": "crop", "shape_type": "rectangle",
         "points": [[0, 0], [29, 19]]},
        {"label": "glass", "shape_type": "polygon",
         "points": [[2, 2], [12, 2], [12, 9], [2, 9]]},
        {"label": "glass_door", "shape_type": "polygon",
         "points": [[14, 3], [25, 4], [20, 15]]}]}
    (root / "labels").mkdir()
    (root / "labels" / "a.json").write_text(json.dumps(label))
    (root / "labels" / "b.json").write_text(json.dumps({"shapes": []}))
    (root / "images").mkdir()
    for i in range(12):
        (root / "images" / f"im{i:03d}.png").write_bytes(b"")


def test_raw_capture_matches(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    _capture_inputs(src)
    lab = str(src / "labels" / "a.json")

    def crop(mod):
        return lambda d: mod.crop_by_labelme(
            lab, str(src / "a.png"), str(src / "a.npy"), d)
    sp, sj, fp, fj = _both(tmp_path / "crop", crop(rc), crop(jrc))
    assert [os.path.basename(p) for p in sp] == \
        [os.path.basename(p) for p in sj] and fp == fj and fp

    for fn in ("polygon2mask_dir", "label_copy"):
        def run(mod, fn=fn):
            return lambda d: getattr(mod, fn)(str(src / "labels"), d)
        np_, nj, fp, fj = _both(tmp_path / fn, run(rc), run(jrc))
        assert np_ == nj == 2 and fp == fj and len(fp) == 2

    def split(mod):
        return lambda d: mod.split_train_val(
            str(src / "images"), os.path.join(d, "train.txt"),
            os.path.join(d, "val.txt"), val_ratio=0.25, seed=3)
    np_, nj, fp, fj = _both(tmp_path / "split", split(rc), split(jrc))
    assert np_ == nj == (9, 3) and fp == fj

    np.testing.assert_array_equal(
        rc.polygon_labels_to_mask(lab, 30, 20),
        jrc.polygon_labels_to_mask(lab, 30, 20))
    depth = np.random.default_rng(33).integers(0, 12000, (12, 16))
    np.testing.assert_array_equal(rc.depth_to_vis(depth),
                                  jrc.depth_to_vis(depth))
    depth.astype("<u2").tofile(tmp_path / "d.bin")
    np.testing.assert_array_equal(
        rc.read_raw_depth(16, 12, str(tmp_path / "d.bin")),
        jrc.read_raw_depth(16, 12, str(tmp_path / "d.bin")))
    with pytest.raises(ValueError):
        rc.read_raw_depth(15, 12, str(tmp_path / "d.bin"))
    assert rc.GLASS_LABELS == jrc.GLASS_LABELS
    assert rc.LABELS_ID_MAP == jrc.LABELS_ID_MAP


def test_capture_frames_needs_the_sensor(tmp_path):
    """Gated on pyrealsense2 and a RealSense device, not on a GPU."""
    try:
        import pyrealsense2  # noqa: F401
        pytest.skip("pyrealsense2 present")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="pyrealsense2"):
        rc.capture_frames(str(tmp_path))


def _pred_sets(root):
    rng = np.random.default_rng(34)
    h, w = 30, 40
    gt_dir = root / "gt"
    dirs = {"ours": root / "ours", "other": root / "other"}
    for d in (gt_dir, *dirs.values()):
        d.mkdir()
    for i in range(3):
        gt_mm = np.round(rng.uniform(1.0, 8.0, (h, w)) * 1000)
        gt_mm[0, :5] = 0
        Image.fromarray(gt_mm.astype(np.uint16), mode="I;16").save(
            gt_dir / f"s{i}.png")
        base = gt_mm.astype(np.float32) / 1000.0
        np.save(dirs["ours"] / f"s{i}.npy",
                base + rng.normal(0, 0.05, (h, w)).astype(np.float32))
        other = base + rng.normal(0, 0.3, (h, w)).astype(np.float32)
        np.save(dirs["other"] / f"s{i}.npy", other[::2, ::2])   # resized
    return {k: str(v) for k, v in dirs.items()}, str(gt_dir)


def test_pred_compare_matches(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    dirs, gt = _pred_sets(src)
    mp, mj, fp, fj = _both(
        tmp_path / "cmp",
        lambda d: pc.compare_depth_predictions(dirs, gt, d),
        lambda d: jpc.compare_depth_predictions(dirs, gt, d))
    assert mp == mj and fp == fj
    assert len(fp) == 1 + 3 * 5           # the log, gt/ and 2 x (depth, error)

    rng = np.random.default_rng(35)
    x = rng.uniform(0, 9000, (33, 47)).astype(np.float32)
    np.testing.assert_array_equal(pc.resize_nearest(x, 20, 60),
                                  jpc.resize_nearest(x, 20, 60))
    np.testing.assert_array_equal(pc.vis_depth_jet(x / 1000.0),
                                  jpc.vis_depth_jet(x / 1000.0))
    assert pc.compute_rmse(x, x + 1) == jpc.compute_rmse(x, x + 1)

    names = ["b.png", "a.png", "c.jpg"]
    tp, tj, fp, fj = _both(
        tmp_path / "ids",
        lambda d: pc.id_to_image("", os.path.join(d, "m.json"), names),
        lambda d: jpc.id_to_image("", os.path.join(d, "m.json"), names))
    assert os.path.basename(tp) == os.path.basename(tj) and fp == fj


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_trace_file(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_step_timer_has_the_jax_keys():
    ours, theirs = profiling.StepTimer(), jprof.StepTimer()
    assert ours.summary() == theirs.summary() == {}
    for t in (ours, theirs):
        for _ in range(4):
            with t.step():
                pass
    assert set(ours.summary()) == set(theirs.summary())
    assert len(ours.times) == 4
    s = ours.summary()
    assert s["first_step_s"] == ours.times[0]
    assert s["steady_mean_s"] == pytest.approx(sum(ours.times[2:]) / 2)


def test_device_memory_stats_off_the_card():
    """None where the device reports none, as JAX's on its CPU device."""
    assert jprof.device_memory_stats() is None
    assert profiling.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() is None
