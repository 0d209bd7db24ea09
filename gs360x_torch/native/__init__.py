"""ctypes bindings for the C++ host library (``native/gs360x_native.cpp``
at the root of the checkout; host code, not a device kernel).

The shared library is built with ``g++`` at first use, not at import, into
``build/gs360x_torch/`` (listed in ``.gitignore``) under a name that
carries a hash of the source, so an edit rebuilds and an unchanged checkout
reuses the build. Every consumer degrades to the numpy implementation when
``HAS_NATIVE`` is False (no toolchain, build failure, unusual platform);
``HAS_NATIVE`` is resolved on first access.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "gs360x_native.cpp"
_BUILD_DIR = _ROOT / "build" / "gs360x_torch"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class AviInfo(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int32), ("height", ctypes.c_int32),
                ("fps_num", ctypes.c_int32), ("fps_den", ctypes.c_int32),
                ("n_frames", ctypes.c_int64)]


def _lib_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libgs360x_native_{digest}.so"


def _build(lib_path: pathlib.Path) -> bool:
    if shutil.which("g++") is None:
        return False
    # built beside its final name and moved into place, so that two
    # processes building at once never load a half-written file
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib_path)
        return True
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def _open() -> Optional[ctypes.CDLL]:
    if not _SRC.exists():
        return None
    lib_path = _lib_path()
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.gs_deinterleave_u8.argtypes = [u8p, u8p, i64, i64, i64]
    lib.gs_interleave_u8.argtypes = [u8p, u8p, i64, i64, i64]
    lib.gs_planar_f32_to_u8_hwc.argtypes = [f32p, u8p, i64, i64, i64]
    lib.gs_planar_f32_to_u8_hwc_mt.argtypes = [f32p, u8p, i64, i64, i64,
                                               ctypes.c_int]
    lib.gs_f32_to_u8.argtypes = [f32p, u8p, i64]
    lib.gs_yuv444_to_rgb.argtypes = [u8p, u8p, i64, i64]
    lib.gs_yuv420_to_rgb.argtypes = [u8p, u8p, i64, i64]
    lib.gs_avi_scan.argtypes = [u8p, i64, ctypes.POINTER(i64),
                                ctypes.POINTER(i64), i64,
                                ctypes.POINTER(AviInfo)]
    lib.gs_avi_scan.restype = i64
    return lib


def _native() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if need be, or None; tried once."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _lib = _open()
            _tried = True
        return _lib


def __getattr__(name: str):
    if name == "HAS_NATIVE":
        return _native() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def planar_f32_to_u8_hwc(chw: np.ndarray, threads: int = 2) -> np.ndarray:
    """float [0,1] (C, H, W) → uint8 (H, W, C), fused convert+interleave
    (the async-writer encode transform)."""
    chw = np.ascontiguousarray(chw, np.float32)
    c, h, w = chw.shape
    lib = _native()
    if lib is None:
        return np.clip(np.moveaxis(chw, 0, -1) * 255.0 + 0.5,
                       0, 255).astype(np.uint8)
    out = np.empty((h, w, c), np.uint8)
    lib.gs_planar_f32_to_u8_hwc_mt(_f32p(chw), _u8p(out), h, w, c,
                                   int(threads))
    return out


def interleave_u8(chw: np.ndarray) -> np.ndarray:
    chw = np.ascontiguousarray(chw, np.uint8)
    c, h, w = chw.shape
    lib = _native()
    if lib is None:
        return np.ascontiguousarray(np.moveaxis(chw, 0, -1))
    out = np.empty((h, w, c), np.uint8)
    lib.gs_interleave_u8(_u8p(chw), _u8p(out), h, w, c)
    return out


def deinterleave_u8(hwc: np.ndarray) -> np.ndarray:
    hwc = np.ascontiguousarray(hwc, np.uint8)
    h, w, c = hwc.shape
    lib = _native()
    if lib is None:
        return np.ascontiguousarray(np.moveaxis(hwc, -1, 0))
    out = np.empty((c, h, w), np.uint8)
    lib.gs_deinterleave_u8(_u8p(hwc), _u8p(out), h, w, c)
    return out


def yuv444_to_rgb(yuv_planar: np.ndarray) -> np.ndarray:
    """(3, H, W) limited-range BT.601 → (H, W, 3) RGB."""
    yuv_planar = np.ascontiguousarray(yuv_planar, np.uint8)
    _, h, w = yuv_planar.shape
    lib = _native()
    if lib is None:
        from gs360x_torch.io.video import yuv601_to_rgb

        return yuv601_to_rgb(np.moveaxis(yuv_planar, 0, -1))
    out = np.empty((h, w, 3), np.uint8)
    lib.gs_yuv444_to_rgb(_u8p(yuv_planar), _u8p(out), h, w)
    return out


def yuv420_to_rgb(yuv_planar_bytes: np.ndarray, h: int, w: int) -> np.ndarray:
    """Flat (H*W*3//2,) planar 4:2:0 bytes → (H, W, 3) RGB."""
    buf = np.ascontiguousarray(yuv_planar_bytes, np.uint8)
    lib = _native()
    if lib is None:
        from gs360x_torch.io.video import yuv601_to_rgb

        ysz, csz = h * w, h * w // 4
        y = buf[:ysz].reshape(h, w)
        u = np.repeat(np.repeat(buf[ysz:ysz + csz].reshape(h // 2, w // 2),
                                2, 0), 2, 1)
        v = np.repeat(np.repeat(buf[ysz + csz:].reshape(h // 2, w // 2),
                                2, 0), 2, 1)
        return yuv601_to_rgb(np.stack([y, u, v], -1))
    out = np.empty((h, w, 3), np.uint8)
    lib.gs_yuv420_to_rgb(_u8p(buf), _u8p(out), h, w)
    return out


def avi_scan(data: bytes) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Scan AVI bytes for MJPEG frame chunks. Returns (offsets, sizes,
    info dict). Raises ValueError for non-AVI input."""
    arr = np.frombuffer(data, np.uint8)
    max_frames = max(16, len(data) // 1024)
    offsets = np.zeros(max_frames, np.int64)
    sizes = np.zeros(max_frames, np.int64)
    lib = _native()
    if lib is None:
        raise RuntimeError("native library unavailable")
    info = AviInfo()
    n = lib.gs_avi_scan(_u8p(arr), len(data),
                        offsets.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int64)),
                        sizes.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int64)),
                        max_frames, ctypes.byref(info))
    if n < 0:
        raise ValueError("not an AVI file")
    return offsets[:n].copy(), sizes[:n].copy(), {
        "width": info.width, "height": info.height,
        "fps": info.fps_num / max(info.fps_den, 1),
        "n_frames": int(info.n_frames)}
