"""The port's native loader (`gwdepth_tpu_torch/native`) against PIL and
the JAX package's own copy (`gwdepth_tpu.native`), on the CPU.

Every entry must give the same bytes as the PIL/numpy path it replaces
and as the JAX package's entry on the same inputs: PNG decode (RGB8,
RGBA, gray16 raw, gray8, palette), the fused color jitter over fuzzed op
orders, the bilinear resize over fuzzed sizes, and normalize-and-pad.
Dataset samples through the port's native path must equal the JAX
package's, train and eval. No tolerance: all of it is integer or
float32 op for op.
"""

import random

import numpy as np
import pytest
from PIL import Image, ImageEnhance

from gwdepth_tpu import native as jnative
from gwdepth_tpu.config import tiny_test_config as jax_tiny
from gwdepth_tpu.data import dataset as jds
from gwdepth_tpu.tools import synthetic as jsyn

from gwdepth_tpu_torch import native
from gwdepth_tpu_torch.config import tiny_test_config
from gwdepth_tpu_torch.data import dataset as pds
from gwdepth_tpu_torch.data import transforms as T

from test_torch_data import _equal_items, _equal_samples, _paths
from test_torch_kernels import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def built(monkeypatch):
    """Both libraries built here (g++ and libpng present), and neither
    path disabled unless a test says so."""
    monkeypatch.delenv("GWDEPTH_NO_NATIVE", raising=False)
    st = native.available()
    assert st and st.decode, st
    assert jnative.available()
    return st


def _rand_rgb(rng, h=97, w=131):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


def _three_ways(path, rgb):
    """The port's decode, the JAX package's and PIL's, of one file."""
    pil = Image.open(path)
    pil = np.asarray(pil.convert("RGB") if rgb else pil)
    return (native.decode_png(str(path), rgb=rgb),
            jnative.decode_png(str(path), rgb=rgb), pil)


def _png(tmp_path, kind, rng):
    p = tmp_path / f"{kind}.png"
    if kind == "rgb8":
        Image.fromarray(_rand_rgb(rng)).save(p)
    elif kind == "rgba":
        Image.fromarray(rng.integers(0, 256, (40, 50, 4), np.uint8),
                        "RGBA").save(p)
    elif kind == "gray16":
        Image.fromarray(rng.integers(0, 65535, (60, 70)).astype(
            np.uint16)).save(p)
    elif kind == "gray8":
        Image.fromarray(rng.integers(0, 256, (30, 40), np.uint8)).save(p)
    else:
        im = Image.fromarray(rng.integers(0, 5, (30, 40), np.uint8), "P")
        im.putpalette(list(rng.integers(0, 256, 768)))
        im.save(p)
    return p


@pytest.mark.parametrize("kind", ["rgb8", "rgba", "gray16", "gray8",
                                  "palette"])
@pytest.mark.parametrize("rgb", [True, False])
def test_decode_equals_pil_and_jax(tmp_path, kind, rgb):
    path = _png(tmp_path, kind, np.random.default_rng(len(kind)))
    got, jax_, pil = _three_ways(path, rgb)
    if kind == "gray16" and rgb:
        # PIL's convert("RGB") clips 16-bit gray at 255; libpng's strip
        # keeps the high byte (as the JAX package's decoder returns), so
        # the port's decoder declines and the dataset opens it with PIL
        assert got is None and (jax_ != pil).any()
        np.testing.assert_array_equal(np.asarray(pds._open_rgb(str(path))),
                                      pil)
        return
    assert got.dtype == pil.dtype and got.shape == pil.shape
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, jax_)


def test_decode_missing_or_foreign_file_returns_none(tmp_path):
    assert native.decode_png(str(tmp_path / "nope.png")) is None
    jpg = tmp_path / "a.jpg"
    Image.fromarray(_rand_rgb(np.random.default_rng(0))).save(jpg)
    assert native.decode_png(str(jpg)) is None
    # the dataset opens a non-PNG file with PIL
    np.testing.assert_array_equal(np.asarray(pds._open_rgb(str(jpg))),
                                  np.asarray(Image.open(jpg).convert("RGB")))


def _pil_jitter(img, ops, factors):
    im = Image.fromarray(img)
    for op, f in zip(ops, factors):
        if op == 0:
            im = ImageEnhance.Brightness(im).enhance(f)
        elif op == 1:
            im = ImageEnhance.Contrast(im).enhance(f)
        elif op == 2:
            im = ImageEnhance.Color(im).enhance(f)
        else:
            im = T.adjust_hue(im, 0.0, shift=int(f))
    return np.asarray(im)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_jitter_equals_pil_and_jax_over_random_orders(seed):
    rng = np.random.default_rng(seed)
    pr = random.Random(seed)
    for _ in range(3):
        img = _rand_rgb(rng, *(int(v) for v in rng.integers(5, 70, 2)))
        ops = [0, 1, 2, 3]
        pr.shuffle(ops)
        ops = ops[:pr.randint(1, 4)]
        factors = [int(pr.uniform(-0.4, 0.4) * 255) if op == 3
                   else pr.uniform(0.05, 1.95) for op in ops]
        got = native.color_jitter(img, ops, factors)
        np.testing.assert_array_equal(got, _pil_jitter(img, ops, factors))
        np.testing.assert_array_equal(
            got, jnative.color_jitter(img, ops, factors))


@pytest.mark.parametrize("seed", [0, 1])
def test_resize_equals_pil_and_jax_over_random_sizes(seed):
    rng = np.random.default_rng(seed)
    for _ in range(15):
        h, w = (int(v) for v in rng.integers(4, 90, 2))
        oh, ow = (int(v) for v in rng.integers(3, 120, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = native.resize_bilinear_rgb8(img, oh, ow)
        np.testing.assert_array_equal(got, np.asarray(
            Image.fromarray(img).resize((ow, oh), Image.BILINEAR)),
            err_msg=f"{(h, w)}->{(oh, ow)}")
        np.testing.assert_array_equal(
            got, jnative.resize_bilinear_rgb8(img, oh, ow))


def test_normalize_pad_equals_numpy_and_jax():
    img = _rand_rgb(np.random.default_rng(6), 50, 60)
    got = native.normalize_pad(img, (64, 80), T.MEAN, T.STD)
    ref = np.zeros((64, 80, 3), np.float32)
    ref[:50, :60] = (np.asarray(img, np.float32) / 255.0 - T.MEAN) / T.STD
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, jnative.normalize_pad(img, (64, 80), T.MEAN, T.STD))
    with pytest.raises(ValueError, match="exceeds canvas"):
        native.normalize_pad(img, (40, 80), T.MEAN, T.STD)
    with pytest.raises(ValueError, match="uint8"):
        native.resize_bilinear_rgb8(img.astype(np.float32), 4, 4)


def test_no_native_env_selects_pil(monkeypatch):
    """GWDEPTH_NO_NATIVE=1: every entry answers None, `available()` says
    why, and the transforms give the same bytes through PIL."""
    rng = np.random.default_rng(13)
    img = Image.fromarray(_rand_rgb(rng, 48, 64))
    dep = rng.uniform(0, 10, (48, 64)).astype(np.float32)
    seg = rng.integers(0, 2, (48, 64)).astype(np.uint8)

    def run():
        s = T.Sample(img, dep.copy(), seg.copy(),
                     np.asarray([[1.0, 2, 30, 40]]), np.asarray([[15.0, 20]]),
                     np.asarray([0]))
        s = T.resize(s, (100, 72))
        s.image = T.color_jitter(s.image, random.Random(42))
        return T.normalize(s)

    a = run()
    monkeypatch.setenv("GWDEPTH_NO_NATIVE", "1")
    st = native.available()
    assert not st and "GWDEPTH_NO_NATIVE" in st.reason
    assert "PIL" in st.describe()
    assert native.lib() is None
    assert native.color_jitter(np.asarray(img), [0], [1.2]) is None
    b = run()
    _equal_samples(a, b)


def test_status_describes_the_decoder(built):
    assert built.reason.endswith(".so")
    assert built.describe().startswith("native PNG decode")
    assert not native.Status(True, False, "built without libpng: x").decode
    assert native.Status(True, False, "x").describe().startswith(
        "PIL PNG decode, native")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_scenes")
    jsyn.generate_dataset(str(root), 3, 2, height=120, width=160, seed=5)
    paths = _paths(root)
    return tiny_test_config(**paths), jax_tiny(**paths)


@pytest.mark.parametrize("split,idx,seed", [("train", 0, 3), ("train", 1, 4),
                                            ("train", 2, 8), ("val", 0, None),
                                            ("val", 1, None)])
def test_native_dataset_samples_equal_jax(scenes, monkeypatch, split, idx,
                                          seed):
    """The port's sample through the native path against the JAX
    package's through PIL, and the other way round."""
    pcfg, jcfg = scenes
    port = pds.GlassRGBDDataset(pcfg, split)
    jax_ = jds.GlassRGBDDataset(jcfg, split)
    got = port.__getitem__(idx, seed=seed)
    raw = port.load_raw(idx)[0]
    monkeypatch.setenv("GWDEPTH_NO_NATIVE", "1")
    _equal_items(got, jax_.__getitem__(idx, seed=seed))
    _equal_samples(raw, jax_.load_raw(idx)[0])
    pil = port.__getitem__(idx, seed=seed)
    monkeypatch.delenv("GWDEPTH_NO_NATIVE")
    _equal_items(pil, jax_.__getitem__(idx, seed=seed))
