"""Primitive-cost microbenchmark kernels — the counterpart of the Pallas
``bench`` call and the 14 kernel bodies of the root ``micro_ops.py``.

``gs360x_torch/csrc/micro_ops.cu`` holds one hand-written kernel per
primitive (multiply, gathers along either axis of a tile, ``where``,
concat, two f32 products on the tensor cores in three TF32 passes,
dynamic roll, a counted loop, a predicated read-modify-write, a dynamic
row slice and the bicubic chunk-body composite). Each applies its
primitive ``reps`` times, every application depending on the last, in each
of ``grid`` blocks that all do the same work on the same block of data, so
that ``time / (grid · reps)`` prices one application.

:data:`OPS` lists the primitives under the labels ``micro_ops.py`` prints;
:func:`make_inputs` builds that script's seeded inputs (``default_rng(0)``,
drawn in its order); :func:`micro_op` runs one primitive. A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain torch version
(``OPS[key].plain``), which is also what the tests and ``chip_smoke.py``
hold the kernels against. ``OP_LAUNCHES`` counts the launches of each
primitive; ``LAUNCHES`` (their sum) and ``PLAIN_CALLS`` count as in
:mod:`gs360x_torch.kernels.warp_cuda`. :func:`bound_ms` is the least time
the card could take for a launch; :func:`smem_wavefronts` counts the
shared-memory wavefronts of a gather's warp-loads, and
:func:`block_loop_wavefronts` and :func:`wavefront_floor_ms` apply it to
the two axis-1 gathers and the composite (``WAVEFRONT_MODELS``).
``BITWISE``, ``rel_tolerance`` and ``CHECK_LOOPS`` say how and where a
kernel is held to its plain version on the card; ``SASS_CHECKS`` (read by
:func:`sass_checks`) what its ``cuobjdump -sass`` must hold.

Indices are int32 and must lie inside the tile (the kernels mask them to
it, the plain versions raise on an index outside it).
"""

from __future__ import annotations

import ctypes
import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from gs360x_torch.kernels import _build

PLAIN_CALLS: Dict[str, int] = {"micro_ops": 0}

GRID = 2048      # blocks of the benchmark grid
OP_REPS = 64     # nominal applications per block

# Published H100 SXM rates (dense): f32 outside the tensor cores, TF32 on
# them, and shared memory: 128 B a clock an SM x 132 SMs x 1.98 GHz, the
# clock the 67 TFLOP/s is quoted at. The 67 counts an FMA as two flops: the
# four schedulers of an SM issue one warp-instruction a clock each, whatever
# the pipe, so a lone f32 multiply or add issues at half that, 33.5 T a
# second (FP32_ISSUE_T), as does an FMA counted as one instruction.
FP32_TFLOPS = 67.0
FP32_ISSUE_T = FP32_TFLOPS / 2
TF32_TFLOPS = 495.0
SMEM_TBS = 33.5
SMEM_CLOCK_GHZ = 1.98   # that clock
SMEM_BANKS = 32         # 4-byte banks; a wavefront serves each bank once
TF32_PASSES = 3  # hi.lo + lo.hi + hi.hi: the products' f32 accuracy


def reset_counters() -> None:
    for counts in (PLAIN_CALLS, OP_LAUNCHES):
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
    as ``micro_ops.py`` does.

    What one loop of one block must do, for its bound:

    - ``issue_per_loop``: the f32 instructions it must issue, for each
      element at each application a lone multiply or add 1, a compare and
      a predicated multiply 2, an FMA 1 (a product's M·N·K FMAs, which the
      kernel runs on the tensor cores: that count gives the FMA bound
      only);
    - ``smem_bytes_per_loop``: 4 bytes for each store of a value that
      crosses threads and 4 for each of its reads; a value that only the
      thread that stored it reads back counts nothing, nor does what the
      kernel's own layout puts in shared memory (``concat``'s body reads
      its ref once, before its loop, and replicates a value: 0). Two
      exceptions, each a memory access of the Pallas body that registers
      cannot stand for: a row offset chosen at run time cannot index
      registers, so a dynamic slice's reads count; and a body that writes
      a ref every application (``when_rmw``'s ``o_ref[...] += 1.0``)
      counts that read and that write, whichever thread reads them back,
      since that round trip is the work it measures (in registers it
      would be ``loop``'s adds under a branch);
    - ``tc_flops_per_loop``: a product's tensor-core operations,
      ``TF32_PASSES`` · 2·M·N·K."""

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
    issue_per_loop: int = 0
    smem_bytes_per_loop: int = 0
    tc_flops_per_loop: int = 0


_T8, _T64, _T128 = (8, 128), (64, 128), (128, 128)
_TAPS, _ROWS = (4, 64, 128), (4, 8, 8, 128)

OPS: Dict[str, MicroOp] = {op.key: op for op in (
    MicroOp("mul8", "mul (8,128)", 0, ("a8",), (_T8,), (False,), _T8,
            _plain_mul, issue_per_loop=1024),
    MicroOp("mul64", "mul (64,128)", 1, ("a64",), (_T64,), (False,), _T64,
            _plain_mul, issue_per_loop=8192),
    # the new tile is stored every application for other lanes to read
    MicroOp("gather_lane8", "lane-gather axis1 (8,128)", 2, ("a8", "idx8"),
            (_T8, _T8), (False, True), _T8, _plain_gather_lane,
            issue_per_loop=1024, smem_bytes_per_loop=8 * 1024),
    MicroOp("gather_lane64", "lane-gather axis1 (64,128)", 3,
            ("a64", "idx64"), (_T64, _T64), (False, True), _T64,
            _plain_gather_lane, issue_per_loop=8192,
            smem_bytes_per_loop=8 * 8192),
    MicroOp("gather_sub8", "sublane-gather axis0 (8,128)<-8", 4,
            ("a8", "ridx8"), (_T8, _T8), (False, True), _T8,
            _plain_gather_sub, issue_per_loop=1024,
            smem_bytes_per_loop=4 * 1024),
    # compare idx == r, then a multiply predicated on it
    MicroOp("where", "where (8,128)", 5, ("a8", "ridx8"), (_T8, _T8),
            (False, True), _T8, _plain_where, issue_per_loop=2 * 1024),
    # accumulator element e adds x[e mod 1024]: a thread can hold the x of
    # its own elements, so nothing crosses threads
    MicroOp("concat", "concat 8x(8,128)->(64,128) [/8 reps]", 6, ("a8",),
            (_T8,), (False,), _T64, _plain_concat, loops_div=8, per_loop=8,
            issue_per_loop=8192),
    MicroOp("matmul64", "matmul (64,128)@(128,128) f32-default", 7,
            ("a64", "a128"), (_T64, _T128), (False, False), _T64,
            _plain_matmul, issue_per_loop=64 * 128 * 128,
            tc_flops_per_loop=TF32_PASSES * 2 * 64 * 128 * 128),
    MicroOp("matmul8", "matmul (8,128)@(128,128) f32-default", 8,
            ("a8", "a128"), (_T8, _T128), (False, False), _T8,
            _plain_matmul, issue_per_loop=8 * 128 * 128,
            tc_flops_per_loop=TF32_PASSES * 2 * 8 * 128 * 128),
    MicroOp("dyn_roll", "dynamic lane-roll (8,128)", 9, ("a8", "ridx8"),
            (_T8, _T8), (False, True), _T8, _plain_dyn_roll,
            issue_per_loop=1024, smem_bytes_per_loop=4 * 1024),
    MicroOp("loop", "fori_loop iteration (trivial body)", 10, ("a8",),
            (_T8,), (False,), _T8, _plain_loop, issue_per_loop=1024),
    # the body's own read-modify-write of its output ref, an element read
    # and written every application (the docstring's second exception)
    MicroOp("when_rmw", "pl.when + vmem rmw (8,128)", 11, ("a8",), (_T8,),
            (False,), _T8, _plain_when_rmw, issue_per_loop=1024,
            smem_bytes_per_loop=8 * 1024),
    MicroOp("dyn_slice", "dynamic-slice rows (8,128)<-(64,128)", 12,
            ("a64", "ridx8"), (_T64, _T8), (False, True), _T8,
            _plain_dyn_slice, issue_per_loop=1024,
            smem_bytes_per_loop=4 * 1024),
    MicroOp("chunk", "chunk_body composite (3ch)", 13,
            ("win", "relb", "wfb", "ry", "wv"),
            ((3, 8, 128), _TAPS, _TAPS, _ROWS, _ROWS),
            (False, True, False, True, False), _T8, _plain_chunk,
            loops_div=16, grid=256,
            # per channel: 4 mul + 3 add on (64,128), 4 mul + 4 add on
            # (8,128), each rounded on its own; in shared memory: 4 taps of
            # (64,128) along axis 1 from the replicated window, the ih
            # store, 4 taps of the kept row (8,128) along axis 0
            issue_per_loop=3 * (7 * 8192 + 8 * 1024),
            smem_bytes_per_loop=3 * 4 * (4 * 8192 + 8192 + 4 * 1024)),
)}


OP_LAUNCHES: Dict[str, int] = {key: 0 for key in OPS}


class _LaunchTotal(Mapping):
    """``{"micro_ops": the sum of OP_LAUNCHES}``, read-only."""

    def __getitem__(self, key: str) -> int:
        if key != "micro_ops":
            raise KeyError(key)
        return sum(OP_LAUNCHES.values())

    def __iter__(self) -> Iterator[str]:
        return iter(("micro_ops",))

    def __len__(self) -> int:
        return 1


LAUNCHES = _LaunchTotal()


def bound_ms(op: MicroOp, loops: int, grid: Optional[int] = None
             ) -> Tuple[float, str, Dict[str, float]]:
    """The least time in ms the card could take for one launch of ``op`` at
    ``loops`` loops on ``grid`` blocks (None: the op's own grid), what
    bounds it, and each resource's time: ``"f32"`` (f32 instructions at
    ``FP32_ISSUE_T``), ``"shared memory"`` (``SMEM_TBS``), ``"tensor
    cores"`` (``TF32_TFLOPS``) and ``"device memory"`` (inputs read once
    and the block written once at 3.35 TB/s). A product's operations run
    on the tensor cores, so its ``"f32"`` time, its bound on the FMA
    units, does not enter its bound."""
    n = (grid or op.grid or GRID) * loops
    elements = sum(math.prod(shape) for shape in op.shapes) \
        + math.prod(op.out_shape)
    times = {
        "f32": n * op.issue_per_loop / (FP32_ISSUE_T * 1e9),
        "shared memory": n * op.smem_bytes_per_loop / (SMEM_TBS * 1e9),
        "tensor cores": n * op.tc_flops_per_loop / (TF32_TFLOPS * 1e9),
        "device memory": 4 * elements / (3.35 * 1e9),
    }
    used = [k for k in times if not (k == "f32" and op.tc_flops_per_loop)]
    by = max(used, key=times.get)
    return times[by], by, times


def smem_wavefronts(words) -> int:
    """Shared-memory wavefronts of warp-loads of 4-byte words. ``words``
    holds word addresses, 32 a warp-load (the last axis, or consecutive
    runs of 32). Lanes that read one word share it; distinct words in one
    bank take a wavefront each, so a warp-load takes as many as its
    fullest bank holds distinct words (1 when conflict-free)."""
    w = np.sort(np.asarray(words, np.int64).reshape(-1, 32), axis=1)
    distinct = np.ones(w.shape, bool)
    distinct[:, 1:] = w[:, 1:] != w[:, :-1]
    per_bank = np.zeros((w.shape[0], SMEM_BANKS), np.int64)
    loads = np.broadcast_to(np.arange(w.shape[0])[:, None], w.shape)
    np.add.at(per_bank, (loads, w % SMEM_BANKS), distinct)
    return int(per_bank.max(axis=1).sum())


def block_loop_wavefronts(key: str, inputs: Mapping[str, torch.Tensor]
                          ) -> Dict[str, int]:
    """The shared-memory wavefronts one loop of one block of ``key``'s
    kernel (one of ``WAVEFRONT_MODELS``) takes on ``inputs``, by access,
    and ``"bound"``: those the bound counts (``smem_bytes_per_loop`` at 128
    bytes a wavefront). A warp-load of each kernel is 32 consecutive
    elements of one row.

    ``gather_lane8`` and ``gather_lane64``: the row gathers of the tile by
    ``idx8`` or ``idx64`` and the store of the new tile. ``chunk`` (3
    channels): the horizontal gathers of each channel's window row by
    ``relb``, the ih store, and the vertical gathers of the kept rows by
    ``ry``."""
    rows = np.arange(64)[:, None]
    if key in ("gather_lane8", "gather_lane64"):
        name, height = ("idx8", 8) if key == "gather_lane8" else ("idx64", 64)
        idx = inputs[name].cpu().numpy() & 127
        got = {"gather": smem_wavefronts(rows[:height] * 128 + idx),
               "store": height * 128 // 32}
    elif key == "chunk":
        relb = inputs["relb"].cpu().numpy() & 127
        ry = inputs["ry"].cpu().numpy()[:, :, 0] & 7     # (4, 8, 128)
        groups = np.arange(8)[:, None]
        cols = np.arange(128)[None, :]
        # ih row r reads window row r % 8 (the window replicated to 64 rows)
        got = {"gather": 3 * smem_wavefronts((rows % 8) * 128 + relb),
               "store": 3 * 64 * 128 // 32,
               "vertical": 3 * smem_wavefronts(
                   (groups * 8 + ry) * 128 + cols)}
    else:
        raise ValueError(f"block_loop_wavefronts: no model for {key}")
    got["bound"] = OPS[key].smem_bytes_per_loop // 128
    return got


WAVEFRONT_MODELS = ("gather_lane8", "gather_lane64", "chunk")


def wavefront_floor_ms(key: str, inputs: Mapping[str, torch.Tensor],
                       loops: int, sms: int, grid: Optional[int] = None
                       ) -> float:
    """The least time in ms ``key``'s kernel could take when every
    wavefront of :func:`block_loop_wavefronts` (but not ``"bound"``) costs
    a clock of ``sms`` multiprocessors at ``SMEM_CLOCK_GHZ``."""
    counts = block_loop_wavefronts(key, inputs)
    per_loop = sum(n for name, n in counts.items() if name != "bound")
    blocks = grid or OPS[key].grid or GRID
    return per_loop * blocks * loops / sms / (SMEM_CLOCK_GHZ * 1e6)


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
    OP_LAUNCHES[key] += 1
    return out


# How a kernel is held to its plain version on the same device. Gathers,
# where, concat, roll, the counted loop and slice only move or select
# values, and their accumulations add in one order: bitwise. mul: bitwise
# too, since a lone ``__fmul_rn`` and torch's f32 multiply by 1.0001 round
# once each. The predicated update and the composite: 1e-6 relative (a
# plain version may contract a multiply-add). The products: 1e-5 relative
# a step against the f32 product (three TF32 passes keep ~21 bits of each
# operand and sum in another order); they are compared at no more than 8
# steps, since 64 steps of uniform [0, 1) rows overflow f32.
PRODUCTS = ("matmul64", "matmul8")
BITWISE = frozenset({"mul8", "mul64", "gather_lane8", "gather_lane64",
                     "gather_sub8", "where", "concat", "dyn_roll", "loop",
                     "dyn_slice"})
# what ``cuobjdump -sass`` must show of a kernel: for each check, the
# opcodes counted together and how many the kernel must hold (None: at
# least one; 0: none). The products run on the tensor cores. The adds of
# concat, loop and gather_lane8 and the multiplies of mul8 and where sit
# in a loop that is not unrolled: one for each element a thread holds, so
# a chain that nvcc merged with another or dropped shows as fewer. where
# multiplies under the compare's predicate: a select (FSEL) would mean a
# multiply of every element each application, kept or not. gather_lane8's
# warps meet only over their own rows: a block barrier (BAR) would mean the
# block-synchronised layout
SassCheck = Tuple[Tuple[str, ...], Optional[int]]
SASS_CHECKS: Dict[str, Tuple[SassCheck, ...]] = {
    "matmul64": ((("HGMMA", "HMMA"), None),),
    "matmul8": ((("HGMMA", "HMMA"), None),),
    "concat": ((("FADD", "FADD32I"), 64),),
    "loop": ((("FADD", "FADD32I"), 32),),
    "mul8": ((("FMUL", "FMUL32I"), 32),),
    "where": ((("FMUL", "FMUL32I"), 32), (("FSEL",), 0)),
    "gather_lane8": ((("FADD", "FADD32I"), 32), (("BAR",), 0)),
}
SASS_OPCODES = tuple(dict.fromkeys(
    op for checks in SASS_CHECKS.values() for ops, _ in checks for op in ops))
# the kernel a key's checks read, where it is not ``<key>_kernel``
SASS_KERNELS = {"matmul64": "tc_matmul64_kernel",
                "matmul8": "tc_matmul8_kernel"}


def sass_checks(counts: Mapping[str, Mapping[str, int]]
                ) -> List[Tuple[str, Tuple[str, ...], int, Optional[int],
                                bool]]:
    """Each check of ``SASS_CHECKS`` against ``counts``
    (``_build.sass_counts(SASS_OPCODES)``: ``{mangled kernel name:
    {opcode: count}}``): ``(key, opcodes, count, want, ok)``, the count
    summed over the opcodes in the key's kernel, found by its
    length-prefixed mangled identifier (``11mul8_kernel``, which
    ``17tc_matmul8_kernel`` does not hold)."""
    rows = []
    for key, checks in SASS_CHECKS.items():
        kernel = SASS_KERNELS.get(key, f"{key}_kernel")
        mangled = f"{len(kernel)}{kernel}"
        for ops, want in checks:
            n = sum(held.get(op, 0) for name, held in counts.items()
                    if mangled in name for op in ops)
            rows.append((key, ops, n, want,
                         n > 0 if want is None else n == want))
    return rows


# the loops at which the redesigned kernels are held to their plain
# versions on the card (the others at their nominal loops); the deepest is
# also the depth of the check across grids and launches
CHECK_LOOPS = {"matmul64": (1, 8), "matmul8": (1, 8),
               "gather_lane64": (1, 8, 64), "chunk": (1, 4, 8),
               "concat": (1, 8, 64), "loop": (1, 8, 64),
               "mul8": (1, 8, 64), "where": (1, 8, 64),
               "gather_lane8": (1, 8, 64)}


def rel_tolerance(key: str, loops: int) -> float:
    """Relative tolerance (of the plain result's largest magnitude) at
    which kernel ``key`` is held to its plain version after ``loops``
    applications; 0.0 means bitwise."""
    if key in BITWISE:
        return 0.0
    if key in PRODUCTS:
        return 1e-5 * max(1, loops)
    return 1e-6


def bench_loops(op: MicroOp, op_reps: int = OP_REPS) -> int:
    """Loop count of ``op`` at a nominal ``op_reps`` applications."""
    return op_reps // op.loops_div
