"""Build and load the hand-written CUDA kernels (``gs360x_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface for Hopper (``sm_90a``), at first use, into
``build/gs360x_torch/`` at the root of the checkout (listed in
``.gitignore``). The library's name carries a hash of the sources and the
flags, so an edit rebuilds and an unchanged checkout reuses the build.
It is loaded with :mod:`ctypes`; the wrappers pass every pointer and the
stream as ``c_void_p``. Sources come only from the repository.

Nothing here runs at import time: the CPU tests import every module, and
this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "gs360x_torch"

# no --use_fast_math: approximate atan2f/asinf move u by > 0.01 px at 8K
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0   # wall time of the last build (0 when reused)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = pathlib.Path(cand) / "bin" / "nvcc"
            if path.is_file():
                return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.gs360x_planarize.argtypes = [vp, i32, vp, i32, i64, i64, f32, vp]
    lib.gs360x_planarize.restype = i32
    lib.gs360x_warp_equirect.argtypes = [vp, i32, i32, i32, vp, i32, vp,
                                         i32, i32, i32, f32, vp]
    lib.gs360x_warp_equirect.restype = i32
    lib.gs360x_cuda_error_string.argtypes = [i32]
    lib.gs360x_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if this checkout has
    no build of the current sources."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = BUILD_DIR / f"libgs360x_torch_{_digest()}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in _sources() if s.suffix == ".cu"]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        text = load().gs360x_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
