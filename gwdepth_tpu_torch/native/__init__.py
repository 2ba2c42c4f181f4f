"""ctypes binding of the native loader (`loader.cpp`).

Four C entries, each bit-exact with the PIL or numpy path it replaces
(tests/test_torch_native_loader.py): `decode_png` (PNG decode, as PIL's
`Image.open(...).convert("RGB")` or `np.asarray(Image.open(...))`),
`color_jitter` (the train transform's brightness, contrast, saturation
and hue), `resize_bilinear_rgb8` (PIL's BILINEAR resize) and
`normalize_pad` (`(u8/255 - mean)/std` onto a zero canvas). The data
pipeline calls each where the JAX package calls its own copy; each
returns None when it cannot run, and the caller takes the PIL path.

The library is built with the host g++ at first use into `build/native/`
at the repo root; the file name carries a hash of the source and the
flags, so an edited source is rebuilt. Where libpng is missing the
library is built without the decode entry (`-DGW_NO_PNG`) and PIL
decodes; where it cannot be built at all, PIL does everything. Neither is
silent: `available()` carries the reason, and `main.py` logs it.

Set GWDEPTH_NO_NATIVE=1 to force the PIL paths.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
PNG_FLAGS = ["-lpng", "-lz"]
NO_PNG_FLAGS = ["-DGW_NO_PNG"]


@dataclasses.dataclass(frozen=True)
class Status:
    """What the native path can do here. `ok`: the library is loaded
    (jitter, resize, normalize); `decode`: with its PNG decoder; `reason`:
    the library's path, or why a part is missing. True when ok."""
    ok: bool
    decode: bool
    reason: str

    def __bool__(self) -> bool:
        return self.ok

    def describe(self) -> str:
        """One line: which decoder and which transforms the data pipeline
        runs, and why."""
        if not self.ok:
            return f"PIL decode and transforms ({self.reason})"
        dec = "native" if self.decode else "PIL"
        return (f"{dec} PNG decode, native jitter/resize/normalize "
                f"({self.reason})")


_lock = threading.Lock()
_state: Optional[Tuple[Optional[ctypes.CDLL], Status]] = None
# per-thread decode scratch (1280x1024 RGBA16), grown on demand
_scratch = threading.local()


def _target(flags: Sequence[str]) -> Path:
    h = hashlib.sha256(SRC.read_bytes()
                       + " ".join([*GXX_FLAGS, *flags]).encode())
    return BUILD_DIR / f"libgwloader-{h.hexdigest()[:16]}.so"


def _compile(flags: Sequence[str]) -> Tuple[Optional[Path], str]:
    """(the built library, "") or (None, the compiler's complaint)."""
    out = _target(flags)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC),
                               *flags], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"g++ did not run: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        err = [ln for ln in proc.stderr.splitlines() if "error" in ln]
        return None, (err or proc.stderr.splitlines() or ["?"])[0].strip()
    os.replace(tmp, out)
    return out, ""


def _bind(so: ctypes.CDLL, decode: bool) -> None:
    P = ctypes.c_char_p
    I = ctypes.c_int
    IP = ctypes.POINTER(ctypes.c_int)
    FP = ctypes.POINTER(ctypes.c_float)
    if decode:
        so.gw_png_decode.restype = I
        so.gw_png_decode.argtypes = [P, I, P, ctypes.c_long, IP, IP, IP, IP]
    so.gw_color_jitter.restype = I
    so.gw_color_jitter.argtypes = [P, I, I, I, IP, FP]
    so.gw_resize_bilinear_rgb8.restype = I
    so.gw_resize_bilinear_rgb8.argtypes = [P, I, I, P, I, I]
    so.gw_normalize_pad.restype = I
    so.gw_normalize_pad.argtypes = [P, I, I, FP, I, I, FP, FP]


def _load() -> Tuple[Optional[ctypes.CDLL], Status]:
    path, why = _compile(PNG_FLAGS)
    decode = path is not None
    if path is None:
        path, err = _compile(NO_PNG_FLAGS)
        if path is None:
            return None, Status(False, False, f"g++ failed: {err}")
        why = f"built without libpng: {why}"
    try:
        so = ctypes.CDLL(str(path))
        _bind(so, decode)
    except OSError as e:
        return None, Status(False, False, f"{path} did not load: {e}")
    return so, Status(True, decode, why or str(path))


def _get() -> Tuple[Optional[ctypes.CDLL], Status]:
    global _state
    if os.environ.get("GWDEPTH_NO_NATIVE"):
        return None, Status(False, False, "GWDEPTH_NO_NATIVE is set")
    if _state is None:
        with _lock:
            if _state is None:
                _state = _load()
    return _state


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it is unavailable or disabled."""
    return _get()[0]


def available() -> Status:
    """The native path's `Status` (true when the library is loaded)."""
    return _get()[1]


def _rgb8(img: np.ndarray, what: str) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{what} takes uint8 (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    return np.ascontiguousarray(img)


def decode_png(path: str, rgb: bool = True) -> Optional[np.ndarray]:
    """Decode a PNG. rgb=True mirrors PIL `.convert("RGB")` (uint8 HWC);
    rgb=False mirrors `np.asarray(Image.open(path))` for gray8 / gray16 /
    palette-index / multi-channel files. None on any failure, and where
    the library or its decoder is missing."""
    so, st = _get()
    if so is None or not st.decode:
        return None
    buf = getattr(_scratch, "buf", None)
    if buf is None:
        buf = _scratch.buf = ctypes.create_string_buffer(1280 * 1024 * 8)
    h, w, ch, isz = (ctypes.c_int() for _ in range(4))
    for _ in range(2):
        rc = so.gw_png_decode(path.encode(), int(rgb), buf, len(buf),
                              ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(ch), ctypes.byref(isz))
        if rc == 1:  # scratch too small: grow and retry once
            buf = _scratch.buf = ctypes.create_string_buffer(
                h.value * w.value * ch.value * isz.value)
            continue
        break
    if rc != 0:
        return None
    dtype = np.uint16 if isz.value == 2 else np.uint8
    arr = np.frombuffer(buf, dtype=dtype,
                        count=h.value * w.value * ch.value).copy()
    shape = ((h.value, w.value) if ch.value == 1
             else (h.value, w.value, ch.value))
    return arr.reshape(shape)


def color_jitter(img: np.ndarray, ops: Sequence[int],
                 factors: Sequence[float]) -> Optional[np.ndarray]:
    """Fused brightness/contrast/saturation/hue on uint8 HWC RGB. ops: a
    sequence of {0, 1, 2, 3} in application order; factors aligned with
    ops (hue entries carry the integer uint8 shift). A new array, or None
    when the library is unavailable."""
    so = lib()
    if so is None:
        return None
    if len(ops) != len(factors):
        raise ValueError(f"{len(ops)} ops, {len(factors)} factors")
    out = _rgb8(img, "color_jitter").copy()
    ops_c = (ctypes.c_int * len(ops))(*ops)
    fac_c = (ctypes.c_float * len(factors))(*[float(f) for f in factors])
    rc = so.gw_color_jitter(
        out.ctypes.data_as(ctypes.c_char_p), out.shape[0], out.shape[1],
        len(ops), ops_c, fac_c)
    return out if rc == 0 else None


def resize_bilinear_rgb8(img: np.ndarray, oh: int, ow: int
                         ) -> Optional[np.ndarray]:
    """PIL `Image.resize((ow, oh), BILINEAR)` on uint8 HWC RGB, bit-exact
    (Pillow's Resample.c). None when the library is unavailable or the
    call fails."""
    so = lib()
    if so is None:
        return None
    img = _rgb8(img, "resize_bilinear_rgb8")
    out = np.empty((oh, ow, 3), np.uint8)
    rc = so.gw_resize_bilinear_rgb8(
        img.ctypes.data_as(ctypes.c_char_p), img.shape[0], img.shape[1],
        out.ctypes.data_as(ctypes.c_char_p), oh, ow)
    return out if rc == 0 else None


def normalize_pad(img: np.ndarray, canvas_hw: Tuple[int, int],
                  mean: np.ndarray, std: np.ndarray) -> Optional[np.ndarray]:
    """(img/255 - mean)/std onto a zero-padded (ch, cw, 3) float32 canvas.
    None when the library is unavailable."""
    so = lib()
    if so is None:
        return None
    img = _rgb8(img, "normalize_pad")
    ch, cw = canvas_hw
    if img.shape[0] > ch or img.shape[1] > cw:
        raise ValueError(f"image {img.shape[:2]} exceeds canvas {canvas_hw}")
    out = np.empty((ch, cw, 3), np.float32)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    FP = ctypes.POINTER(ctypes.c_float)
    rc = so.gw_normalize_pad(
        img.ctypes.data_as(ctypes.c_char_p), img.shape[0], img.shape[1],
        out.ctypes.data_as(FP), ch, cw, m.ctypes.data_as(FP),
        s.ctypes.data_as(FP))
    return out if rc == 0 else None
