"""Primitive-cost microbenchmark kernels — the counterpart of the Pallas
``bench`` call and the 14 kernel bodies of the root ``micro_ops.py``.

``gs360x_torch/csrc/micro_ops.cu`` holds one hand-written kernel per
primitive (multiply, gathers along either axis of a tile, ``where``,
concat, two f32 products, dynamic roll, a counted loop, a predicated
read-modify-write, a dynamic row slice and the bicubic chunk-body
composite). Each applies its primitive ``reps`` times, every application
depending on the last, in each of ``grid`` blocks that all do the same work
on the same block of data, so that ``time / (grid · reps)`` prices one
application.

:data:`OPS` lists the primitives under the labels ``micro_ops.py`` prints;
:func:`make_inputs` builds that script's seeded inputs (``default_rng(0)``,
drawn in its order); :func:`micro_op` runs one primitive. A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain torch version
(``OPS[key].plain``), which is also what the tests and ``chip_smoke.py``
hold the kernels against. ``LAUNCHES`` and ``PLAIN_CALLS`` count each, as
in :mod:`gs360x_torch.kernels.warp_cuda`.

Indices are int32 and must lie inside the tile (the kernels mask them to
it, the plain versions raise on an index outside it).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gs360x_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"micro_ops": 0}
PLAIN_CALLS: Dict[str, int] = {"micro_ops": 0}

GRID = 2048      # blocks of the benchmark grid
OP_REPS = 64     # nominal applications per block


def reset_counters() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for key in counts:
            counts[key] = 0


# ---- plain versions ---------------------------------------------------------


def _plain_mul(a, reps):
    x = a
    for _ in range(reps):
        x = x * 1.0001
    return x


def _plain_gather_lane(a, idx, reps):
    x, i = a, idx.long()
    for _ in range(reps):
        x = torch.take_along_dim(x, i, 1) + 0.5
    return x


def _plain_gather_sub(a, idx, reps):
    i = idx.long()
    acc = torch.zeros_like(a)
    for _ in range(reps):
        acc = acc + torch.take_along_dim(a, i, 0)
    return acc


def _plain_where(a, idx, reps):
    x = a
    for r in range(reps):
        x = torch.where(idx == r, x, x * 1.0001)
    return x


def _plain_concat(a, reps):
    acc = torch.zeros((64, 128), dtype=a.dtype, device=a.device)
    for _ in range(reps):
        acc = acc + torch.cat([a] * 8, 0)
    return acc


def _plain_matmul(a, b, reps):
    x = a
    for _ in range(reps):
        x = x @ b
    return x


def _plain_dyn_roll(a, idx, reps):
    shift = int(idx[0, 0])
    acc = torch.zeros_like(a)
    for _ in range(reps):
        acc = acc + torch.roll(a, shift, 1)
    return acc


def _plain_loop(a, reps):
    acc = a
    for _ in range(reps):
        acc = acc + 1.0
    return acc


def _plain_when_rmw(a, reps):
    out = a.clone()
    for _ in range(reps):
        out += 1.0
    return out


def _plain_dyn_slice(a, idx, reps):
    first = int(idx[0, 0])
    acc = torch.zeros((8, 128), dtype=a.dtype, device=a.device)
    for r in range(reps):
        start = ((first + r) % 8) * 8
        acc = acc + a[start:start + 8]
    return acc


def _plain_chunk(win, relb, wfb, ry, wv, reps):
    relb, ry = relb.long(), ry.long()
    acc = torch.zeros((8, 128), dtype=win.dtype, device=win.device)
    for _ in range(reps):
        for ch in range(3):
            rep8 = torch.cat([win[ch]] * 8, 0)
            ih = None
            for k in range(4):
                term = torch.take_along_dim(rep8, relb[k], 1) * wfb[k]
                ih = term if ih is None else ih + term
            adds = []
            for r in range(8):
                ih_r = ih[r * 8:(r + 1) * 8]
                add = None
                for m in range(4):
                    gv = torch.take_along_dim(ih_r, ry[m, r], 0)[0:1]
                    term = gv * wv[m, r][0:1]
                    add = term if add is None else add + term
                adds.append(add)
            acc = acc + torch.cat(adds, 0)
    return acc


# ---- the table of primitives ------------------------------------------------


@dataclass(frozen=True)
class MicroOp:
    """One primitive. ``inputs`` name entries of :func:`make_inputs`;
    ``shapes`` are their shapes (int32 where ``ints`` says so, else f32).
    The benchmark loops ``OP_REPS // loops_div`` times and reports
    ``per_loop`` applications a loop, on ``grid`` blocks (None: ``GRID``),
    as ``micro_ops.py`` does."""

    key: str
    label: str
    code: int
    inputs: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    ints: Tuple[bool, ...]
    out_shape: Tuple[int, int]
    plain: Callable[..., torch.Tensor]
    loops_div: int = 1
    per_loop: int = 1
    grid: Optional[int] = None
    flops_per_loop: int = 0    # f32 operations of one loop of one block


_T8, _T64, _T128 = (8, 128), (64, 128), (128, 128)
_TAPS, _ROWS = (4, 64, 128), (4, 8, 8, 128)

OPS: Dict[str, MicroOp] = {op.key: op for op in (
    MicroOp("mul8", "mul (8,128)", 0, ("a8",), (_T8,), (False,), _T8,
            _plain_mul, flops_per_loop=1024),
    MicroOp("mul64", "mul (64,128)", 1, ("a64",), (_T64,), (False,), _T64,
            _plain_mul, flops_per_loop=8192),
    MicroOp("gather_lane8", "lane-gather axis1 (8,128)", 2, ("a8", "idx8"),
            (_T8, _T8), (False, True), _T8, _plain_gather_lane,
            flops_per_loop=1024),
    MicroOp("gather_lane64", "lane-gather axis1 (64,128)", 3,
            ("a64", "idx64"), (_T64, _T64), (False, True), _T64,
            _plain_gather_lane, flops_per_loop=8192),
    MicroOp("gather_sub8", "sublane-gather axis0 (8,128)<-8", 4,
            ("a8", "ridx8"), (_T8, _T8), (False, True), _T8,
            _plain_gather_sub, flops_per_loop=1024),
    MicroOp("where", "where (8,128)", 5, ("a8", "ridx8"), (_T8, _T8),
            (False, True), _T8, _plain_where, flops_per_loop=1024),
    MicroOp("concat", "concat 8x(8,128)->(64,128) [/8 reps]", 6, ("a8",),
            (_T8,), (False,), _T64, _plain_concat, loops_div=8, per_loop=8,
            flops_per_loop=8192),
    MicroOp("matmul64", "matmul (64,128)@(128,128) f32-default", 7,
            ("a64", "a128"), (_T64, _T128), (False, False), _T64,
            _plain_matmul, flops_per_loop=2 * 64 * 128 * 128),
    MicroOp("matmul8", "matmul (8,128)@(128,128) f32-default", 8,
            ("a8", "a128"), (_T8, _T128), (False, False), _T8,
            _plain_matmul, flops_per_loop=2 * 8 * 128 * 128),
    MicroOp("dyn_roll", "dynamic lane-roll (8,128)", 9, ("a8", "ridx8"),
            (_T8, _T8), (False, True), _T8, _plain_dyn_roll,
            flops_per_loop=1024),
    MicroOp("loop", "fori_loop iteration (trivial body)", 10, ("a8",),
            (_T8,), (False,), _T8, _plain_loop, flops_per_loop=1024),
    MicroOp("when_rmw", "pl.when + vmem rmw (8,128)", 11, ("a8",), (_T8,),
            (False,), _T8, _plain_when_rmw, flops_per_loop=1024),
    MicroOp("dyn_slice", "dynamic-slice rows (8,128)<-(64,128)", 12,
            ("a64", "ridx8"), (_T64, _T8), (False, True), _T8,
            _plain_dyn_slice, flops_per_loop=1024),
    MicroOp("chunk", "chunk_body composite (3ch)", 13,
            ("win", "relb", "wfb", "ry", "wv"),
            ((3, 8, 128), _TAPS, _TAPS, _ROWS, _ROWS),
            (False, True, False, True, False), _T8, _plain_chunk,
            loops_div=16, grid=256,
            # per channel: 4 mul + 3 add on (64,128), 4 mul + 4 add on (8,128)
            flops_per_loop=3 * (7 * 8192 + 8 * 1024)),
)}


def make_inputs(device: Optional[torch.device] = None
                ) -> Dict[str, torch.Tensor]:
    """The seeded inputs of ``micro_ops.py`` (``default_rng(0)``, drawn in
    that script's order), f32 values and int32 indices, on ``device``."""
    rng = np.random.default_rng(0)
    arrays = {
        "a8": rng.random((8, 128), np.float32),
        "a64": rng.random((64, 128), np.float32),
        "a128": rng.random((128, 128), np.float32),
        "idx8": rng.integers(0, 128, (8, 128)),
        "idx64": rng.integers(0, 128, (64, 128)),
        "ridx8": rng.integers(0, 8, (8, 128)),
        "ridx64": rng.integers(0, 64, (8, 128)),   # drawn, used by no kernel
        "win": rng.random((3, 8, 128), np.float32),
        "relb": rng.integers(0, 128, (4, 64, 128)),
        "wfb": rng.random((4, 64, 128), np.float32),
        "ry": rng.integers(0, 8, (4, 8, 8, 128)),
        "wv": rng.random((4, 8, 8, 128), np.float32),
    }
    device = device or torch.device("cpu")
    return {name: torch.from_numpy(
        arr if arr.dtype == np.float32 else arr.astype(np.int32)).to(device)
        for name, arr in arrays.items()}


def micro_op(key: str, tensors: Sequence[torch.Tensor], reps: int,
             grid: int = 1) -> torch.Tensor:
    """Apply primitive ``key`` ``reps`` times to ``tensors`` (its inputs in
    the order of ``OPS[key].inputs``) and return the result block.

    CUDA tensors: one launch of the primitive's kernel over ``grid`` blocks
    that all compute and store that same block. CPU tensors: the plain
    version (``grid`` does not enter the result)."""
    op = OPS[key]
    tensors = list(tensors)
    if len(tensors) != len(op.inputs):
        raise ValueError(f"micro_op {key}: expected {len(op.inputs)} inputs "
                         f"({', '.join(op.inputs)}), got {len(tensors)}")
    if reps < 0 or grid < 1:
        raise ValueError(f"micro_op {key}: reps {reps} must be >= 0 and "
                         f"grid {grid} >= 1")
    device = tensors[0].device
    for name, t, shape, is_int in zip(op.inputs, tensors, op.shapes, op.ints):
        want = torch.int32 if is_int else torch.float32
        if tuple(t.shape) != shape or t.dtype != want or t.device != device:
            raise ValueError(
                f"micro_op {key}: input {name} must be {shape} {want} on "
                f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if device.type == "cpu":
        PLAIN_CALLS["micro_ops"] += 1
        return op.plain(*tensors, reps)
    if device.type != "cuda":
        raise ValueError(f"micro_op {key}: expected CUDA or CPU tensors, "
                         f"got {device}")
    tensors = [t.contiguous() for t in tensors]
    out = torch.empty(op.out_shape, dtype=torch.float32, device=device)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    ptrs += [ctypes.c_void_p(None)] * (5 - len(ptrs))
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.gs360x_micro_op(
            op.code, *ptrs, ctypes.c_void_p(out.data_ptr()), int(reps),
            int(grid), 0,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _build.check(err, f"micro_op {key}")
    LAUNCHES["micro_ops"] += 1
    return out


# How a kernel is held to its plain version on the same device. Gathers,
# where, concat, roll and slice only move or select values, and their
# accumulations add in one order: bitwise. mul, the counted loop, the
# predicated update and the composite: 1e-6 relative (a plain version may
# contract a multiply-add). The products: 1e-5 relative a step against the
# f32 product, whose sum runs in another order; they are compared at no
# more than ``MATMUL_CHECK_LOOPS`` steps, since 64 steps of uniform [0, 1)
# rows overflow f32.
BITWISE = frozenset({"gather_lane8", "gather_lane64", "gather_sub8", "where",
                     "concat", "dyn_roll", "dyn_slice"})
MATMUL_CHECK_LOOPS = 8


def rel_tolerance(key: str, loops: int) -> float:
    """Relative tolerance (of the plain result's largest magnitude) at
    which kernel ``key`` is held to its plain version after ``loops``
    applications; 0.0 means bitwise."""
    if key in BITWISE:
        return 0.0
    if key in ("matmul64", "matmul8"):
        return 1e-5 * max(1, loops)
    return 1e-6


def bench_loops(op: MicroOp, op_reps: int = OP_REPS) -> int:
    """Loop count of ``op`` at a nominal ``op_reps`` applications."""
    return op_reps // op.loops_div
