"""Build and load the hand-written CUDA kernels (``gs360x_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, at first use, into
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
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Tuple

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "gs360x_torch"

# no --use_fast_math: approximate atan2f/asinf move u by > 0.01 px at 8K
# -Xptxas -v: registers, shared memory and spills of each kernel, kept in
# ``build_log``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
library_path: Optional[pathlib.Path] = None   # the library loaded
build_seconds: float = 0.0   # wall time of the last build (0 when reused)
build_log: str = ""          # the compilers' output of the last build


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _cuda_tool(name: str) -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = pathlib.Path(cand) / "bin" / name
            if path.is_file():
                return str(path)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (set CUDA_HOME or put {name} "
                           "on PATH): the CUDA kernels cannot be built")
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
    lib.gs360x_planarize_variant.argtypes = [vp, i32, vp, i32, i64, i64, f32,
                                             i32, vp]
    lib.gs360x_planarize_variant.restype = i32
    lib.gs360x_planarize_auto_variant.argtypes = [vp, vp, i32, i64, i64]
    lib.gs360x_planarize_auto_variant.restype = i32
    lib.gs360x_warp_equirect.argtypes = [vp, i32, i32, i64, i64, i32, i32,
                                         vp, i32, vp, i32, i32, i32, i32,
                                         i32, f32, vp]
    lib.gs360x_warp_equirect.restype = i32
    lib.gs360x_remap.argtypes = [vp, i32, i32, i32, i32, vp, vp, vp, i32,
                                 vp, i32, i32, i32, i32, f32, f32, vp]
    lib.gs360x_remap.restype = i32
    lib.gs360x_micro_op.argtypes = [i32, vp, vp, vp, vp, vp, vp, i32, i32,
                                    i32, vp]
    lib.gs360x_micro_op.restype = i32
    lib.gs360x_pack_rgb.argtypes = [vp, vp, i64]
    lib.gs360x_pack_rgb.restype = None
    lib.gs360x_cuda_error_string.argtypes = [i32]
    lib.gs360x_cuda_error_string.restype = ctypes.c_char_p


def _compile(lib_path: pathlib.Path) -> str:
    """Compile every source in parallel, then link; returns the log."""
    work = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.objs")
    work.mkdir(parents=True, exist_ok=True)
    try:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = work / f"{src.stem}.o"
            cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-c", "-o", str(obj),
                   str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for cmd, _obj, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = work / lib_path.name
        cmd = [_cuda_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
               "-shared", "-o", str(tmp), *[str(o) for _c, o, _p in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
        return "\n".join(log)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if this checkout has
    no build of the current sources."""
    global _lib, build_seconds, build_log, library_path
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = BUILD_DIR / f"libgs360x_torch_{_digest()}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            build_log = _compile(lib_path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
        _lib, library_path = lib, lib_path
        return lib


def ptxas_report() -> list:
    """What ptxas said of every kernel of the last build, from
    ``build_log``: ``(mangled name, registers, spill_bytes, text)`` with
    ``text`` the "Used N registers" line joined to the stack and spill
    line. Empty when this process reused an earlier build."""
    report, name, frame = [], "", ""
    for line in build_log.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
        elif "bytes stack frame" in line:
            frame = line
        elif line.startswith("ptxas info") and "Used" in line \
                and "registers" in line:
            used = line.split(":", 1)[-1].strip()
            nums = [int(t) for t in frame.replace(",", " ").split()
                    if t.isdigit()]
            report.append((name, int(used.split()[1]), sum(nums[1:3]),
                           f"{used}; {frame}"))
    return report


def sass_counts(opcodes: Tuple[str, ...]) -> Dict[str, Dict[str, int]]:
    """How many instructions of each of ``opcodes`` each kernel of the
    loaded library holds, ``{mangled name: {opcode: count}}``, read from
    ``cuobjdump -sass`` (kernels and opcodes with none are left out)."""
    load()
    proc = subprocess.run([_cuda_tool("cuobjdump"), "-sass",
                           str(library_path)], capture_output=True,
                          text=True, check=True)
    wanted = re.compile(r"\b(%s)[.\s]" % "|".join(opcodes))
    counts: Dict[str, Dict[str, int]] = {}
    name = ""
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
        elif name:
            found = wanted.search(line)
            if found:
                held = counts.setdefault(name, {})
                held[found.group(1)] = held.get(found.group(1), 0) + 1
    return counts


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        text = load().gs360x_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
