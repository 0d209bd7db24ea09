"""The port's ``micro_ops`` primitives (plain torch versions; CPU tensors
through :func:`gs360x_torch.kernels.micro_ops_cuda.micro_op`) against the
Pallas kernel bodies of the root ``micro_ops.py`` they stand for.

``micro_ops.py`` defines its bodies inside ``main()``: ``micro_ops.bench``
is replaced by a recorder, ``main()`` runs once, and each recorded body
goes through ``pl.pallas_call(..., grid=(1,), interpret=True)`` on the
recorded inputs. ``OP_REPS`` is 8 here: at 64 the two products overflow
f32. The CUDA kernels are held to the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: gathers, ``where``, concat, roll, slice and the counted loop
only move, select or add in one order, so they are bitwise; ``mul``, the
composite and the predicated update at 1e-6 relative (XLA may fuse a
multiply-add, folds the update's eight ``+= 1`` into one add and mul's
chain of multiplies by 1.0001 into one multiply by its power); the
products at 1e-5 relative a step against the f32 product (the CPU
interpreter computes them in f32).

Numpy emulations of the kernels' layouts (the products' fragments, the
(64,128) gather's warp-owned rows, the composite's tables in registers,
concat's chains a warpgroup, and a chain a warp for the counted loop, mul
(8,128) and where) are held bitwise to the plain versions.

The kernels compute the products on the tensor cores in three TF32 passes
(``csrc/micro_ops.cu``). A plain emulation of that arithmetic, kept here
(TF32 rounding to nearest with ties away from zero, as ``cvt.rna.tf32.f32``,
then ``x_lo @ b_hi + x_hi @ b_lo + x_hi @ b_hi`` with f32 sums), is held to
the Pallas bodies at the same gate, and one TF32 pass is shown to miss it.
The register fragments the kernels hand from one step to the next are
emulated too: with the permuted K of the stored ``b^T`` (64 rows) and the
transposed product over four chains a block (8 rows) they give the plain
product.
"""

import ast
import inspect
import pathlib
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gs360x_torch.kernels import micro_ops_cuda as mo
from gs360x_torch.runtime import profiling
from gs360x_torch.runtime.profiling import device_ms
from gs360x_torch.tools import micro_ops as mo_tool

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPS = 8
BITWISE = {"gather_lane8", "gather_lane64", "gather_sub8", "where", "concat",
           "dyn_roll", "loop", "dyn_slice"}
RTOL = {"mul8": 1e-6, "mul64": 1e-6, "chunk": 1e-6, "when_rmw": 1e-6,
        "matmul64": REPS * 1e-5, "matmul8": REPS * 1e-5}


@pytest.fixture(scope="module")
def recorded():
    """{label: (body, out_shape, inputs)} of micro_ops.main() at OP_REPS 8;
    the bodies read ``OP_REPS`` when they are traced, so it stays 8 until
    the module's tests are done."""
    sys.path.insert(0, str(ROOT))
    try:
        import micro_ops
    finally:
        sys.path.remove(str(ROOT))
    calls = {}

    def recorder(name, kernel, out_shape, *inputs, reps=None, grid=None):
        calls[name] = (kernel, out_shape, inputs)
        return 0.0

    saved = micro_ops.bench, micro_ops.OP_REPS
    micro_ops.bench, micro_ops.OP_REPS = recorder, REPS
    try:
        micro_ops.main()
        yield calls
    finally:
        micro_ops.bench, micro_ops.OP_REPS = saved


def run_pallas(body, out_shape, inputs):
    call = pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        grid=(1,), interpret=True)
    return np.asarray(call(*inputs))


def pallas_at(body, out_shape, arrays, op_reps):
    """The recorded Pallas body run at ``OP_REPS = op_reps``."""
    scope = body.__globals__
    saved = scope["OP_REPS"]
    scope["OP_REPS"] = op_reps
    try:
        return run_pallas(body, out_shape, arrays)
    finally:
        scope["OP_REPS"] = saved


def test_inputs_are_the_scripts(recorded):
    """make_inputs draws micro_ops.py's arrays in its order."""
    inputs = mo.make_inputs()
    for op in mo.OPS.values():
        _body, out_shape, arrays = recorded[op.label]
        assert tuple(out_shape) == op.out_shape
        assert len(arrays) == len(op.inputs)
        for name, arr in zip(op.inputs, arrays):
            np.testing.assert_array_equal(inputs[name].numpy(),
                                          np.asarray(arr), err_msg=name)


@pytest.mark.parametrize("key", list(mo.OPS))
def test_plain_version_matches_pallas_body(recorded, key):
    op = mo.OPS[key]
    body, out_shape, arrays = recorded[op.label]
    ref = run_pallas(body, out_shape, arrays)
    tensors = [torch.from_numpy(np.array(a)) for a in arrays]
    loops = mo.bench_loops(op, REPS)
    mo.reset_counters()
    got = mo.micro_op(key, tensors, loops, grid=4).numpy()
    assert mo.PLAIN_CALLS["micro_ops"] == 1 and mo.LAUNCHES["micro_ops"] == 0
    assert not any(mo.OP_LAUNCHES.values())
    assert got.shape == ref.shape == op.out_shape
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    if key in BITWISE:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL[key],
                                   atol=RTOL[key] * float(np.abs(ref).max()))


def tf32_rna(v):
    """f32 -> TF32 as ``cvt.rna.tf32.f32``: the low 13 bits rounded off to
    nearest, ties away from zero (sign and magnitude: the carry rounds the
    magnitude up)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_product(x, b, passes):
    """x @ b as the kernels compute it: one pass ``x_hi @ b_hi``, or three,
    ``x_lo @ b_hi + x_hi @ b_lo + x_hi @ b_hi`` accumulated in f32 in that
    order. TF32 products are exact in f32; only the sums round."""
    xh, bh = tf32_rna(x), tf32_rna(b)
    if passes == 1:
        return xh @ bh
    xl, bl = tf32_rna(x - xh), tf32_rna(b - bh)
    return (xl @ bh + xh @ bl) + xh @ bh


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                # a TF32 ulp at 1
    half = np.float32(2.0 ** -11)
    got = tf32_rna(np.array([one + half, -(one + half), one + half * 0.5,
                             one + ulp + half], np.float32))
    np.testing.assert_array_equal(
        got, np.array([one + ulp, -(one + ulp), one, one + 2 * ulp],
                      np.float32))


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("key", ["matmul64", "matmul8"])
def test_tf32_passes_against_pallas_body(recorded, key, passes):
    """Three TF32 passes hold the products' gate (1e-5 of max|f32| a step)
    against the Pallas body at every step up to REPS; one pass misses it,
    which is why the kernels take three."""
    op = mo.OPS[key]
    body, out_shape, arrays = recorded[op.label]
    x, b = (np.array(arr, np.float32) for arr in arrays)
    worst = 0.0
    for step in range(1, REPS + 1):
        x = tf32_product(x, b, passes)
        ref = run_pallas(body, out_shape, arrays) if step == REPS else \
            np.asarray(arrays[0], np.float64) @ np.linalg.matrix_power(
                np.asarray(b, np.float64), step)
        rel = float(np.abs(x - ref).max()) / float(np.abs(ref).max())
        worst = max(worst, rel / (1e-5 * step))
    if passes == 3:
        assert worst <= 1.0
    else:
        assert worst > 1.0


STORED_K = [(q >> 1) + 4 * (q & 1) for q in range(8)]   # micro_ops.cu


def _fragments(rows):
    """(warp, lane) -> the thread's rows and column pairs, as the kernels
    name them: g = lane // 4, t = lane % 4, rows 16w + g and 16w + g + 8."""
    for warp in range(rows // 16):
        for lane in range(32):
            yield warp * 16 + lane // 4, lane % 4


def _bt_fragments(b):
    """The A operand of the 8-row product, b^T, as its threads load it:
    thread (m, t) holds b[8j + t][m], b[8j + t][m + 8], b[8j + t + 4][m],
    b[8j + t + 4][m + 8] in registers a0..a3 of k-step j, which wgmma reads
    as A rows m, m + 8 at k positions t, t + 4."""
    frags = []
    for j in range(16):
        a_j = np.zeros((128, 8))
        for half in range(2):
            for m, t in _fragments(64):
                m += 64 * half
                a_j[m, t] = b[8 * j + t, m]
                a_j[m + 8, t] = b[8 * j + t, m + 8]
                a_j[m, t + 4] = b[8 * j + t + 4, m]
                a_j[m + 8, t + 4] = b[8 * j + t + 4, m + 8]
        frags.append(a_j)
    return frags


CHAINS8 = 4   # chains of a block of the 8-row product (micro_ops.cu)


@pytest.mark.parametrize("key", ["matmul64", "matmul8"])
def test_fragment_layout_gives_the_plain_product(key):
    """The kernels' register fragments, emulated in f64 on make_inputs'
    arrays. 64 rows: the accumulator fragment of a step, read as the next
    step's A fragment against b^T stored with K permuted inside each group
    of 8, is x @ b. 8 rows: four chains through the kernel's indexing for
    two steps, with a stand-in split (hi = v, lo = eps * v, exact in f64):
    b^T's A fragments against the 64-row B operand (each chain's x_hi, then
    each chain's x_lo) and the 32 x_hi rows, read back from the
    accumulator chunks, summed as (hi.lo + lo.hi) + hi.hi, written back as
    the next B operand and stored as each chain's result, give
    x_c @ b @ b (1 + 2 eps)^2 for every chain c."""
    inputs = mo.make_inputs()
    b = inputs["a128"].double().numpy()
    if key == "matmul64":
        x = inputs["a64"].double().numpy()
        y = np.zeros((64, 128))
        for j in range(16):
            a_j = np.zeros((64, 8))             # A of k-step j: (row, pos)
            for r0, t in _fragments(64):
                d = [x[r0 + 8 * (h >> 1), 8 * j + 2 * t + (h & 1)]
                     for h in range(4)]
                # registers a0..a3: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
                a_j[r0, t], a_j[r0 + 8, t] = d[0], d[2]
                a_j[r0, t + 4], a_j[r0 + 8, t + 4] = d[1], d[3]
            b_j = np.zeros((8, 128))            # stored b^T, transposed back
            for q in range(8):
                b_j[STORED_K[q]] = b[8 * j + q]
            y += a_j @ b_j
        np.testing.assert_allclose(y, x @ b, rtol=1e-12)
        return
    eps = 2.0 ** -12
    x = inputs["a8"].double().numpy()
    xs = [np.roll(x, c, axis=1) * (1 + c) for c in range(CHAINS8)]
    operand = np.zeros((16 * CHAINS8, 128))      # rows n, K = 128
    for c, xc in enumerate(xs):
        operand[8 * c:8 * c + 8] = xc
        operand[8 * (CHAINS8 + c):8 * (CHAINS8 + c) + 8] = eps * xc
    a_hi, a_lo = _bt_fragments(b), _bt_fragments(eps * b)
    out = [np.zeros((8, 128)) for _ in xs]
    for _step in range(2):
        hh = sum(a_hi[j] @ operand[:, 8 * j:8 * j + 8].T for j in range(16))
        lh = sum(a_lo[j] @ operand[:8 * CHAINS8, 8 * j:8 * j + 8].T
                 for j in range(16))
        nxt = np.zeros_like(operand)
        for half in range(2):
            for m, t in _fragments(64):
                m += 64 * half
                for i in range(4 * CHAINS8):
                    # register 4 * chunk + h: row m + 8 (h >> 1), column
                    # 8 * chunk + 2t + (h & 1) of the accumulator
                    row = m + 8 * ((i >> 1) & 1)
                    col = 8 * (i >> 2) + 2 * t + (i & 1)
                    d = (hh[row, 8 * CHAINS8 + col] + lh[row, col]) \
                        + hh[row, col]
                    nxt[col, row] = d
                    nxt[8 * CHAINS8 + col, row] = eps * d
                    out[i >> 2][2 * t + (i & 1), row] = d
        operand = nxt
    for xc, yc in zip(xs, out):
        np.testing.assert_allclose(yc, xc @ b @ b * (1 + 2 * eps) ** 2,
                                   rtol=1e-12)


# ---- the redesigned (64,128) gather and composite, emulated -----------------

GATHER64_THREADS = 256   # micro_ops.cu: a block of the (64,128) gather
CHUNK_THREADS = 512      # kChunkThreads: a block of the composite


def gather_lane64_layout(threads=GATHER64_THREADS):
    """(thread, i) -> the element thread holds as its i-th: warp w owns rows
    rows_per_warp * w ..., lane l their columns l, l + 32, l + 64, l + 96."""
    rows_per_warp = 64 // (threads // 32)
    warp = np.arange(threads)[:, None] // 32
    lane = np.arange(threads)[:, None] % 32
    i = np.arange(rows_per_warp * 4)[None, :]
    return (warp * rows_per_warp + i // 4) * 128 + (i % 4) * 32 + lane


def emulate_gather_lane64(a, idx, reps):
    """The kernel's loop: each thread's gather sources (in its own row) held
    in registers, two buffers, every application reading one and writing
    the other."""
    elems = gather_lane64_layout()
    src = (elems & ~127) + (idx.reshape(-1)[elems] & 127)
    xs = np.zeros((2, 64 * 128), np.float32)
    xs[0][elems] = a.reshape(-1)[elems]
    for r in range(reps):
        xs[(r & 1) ^ 1][elems] = xs[r & 1][src] + np.float32(0.5)
    return xs[reps & 1].reshape(64, 128)


def chunk_layout(threads=CHUNK_THREADS):
    """Thread t's ih elements t + threads * j and acc elements likewise."""
    t = np.arange(threads)[:, None]
    return (t + threads * np.arange(64 * 128 // threads)[None, :],
            t + threads * np.arange(8 * 128 // threads)[None, :])


def emulate_chunk(win, relb, wfb, ry, wv, loops):
    """The composite as the kernel computes it: the tap tables packed into
    the registers of the thread that owns each element once (four 7-bit
    relb indices a word, one a byte; four 3-bit ry rows of the kept row a
    word; the weights beside them), unpacked in every channel-loop; ih in
    two buffers, one a channel-loop; products rounded on their own, taps
    summed in order."""
    ih_e, acc_e = chunk_layout()
    hidx = np.zeros(ih_e.shape, np.uint32)
    for k in range(4):
        hidx |= (relb[k].reshape(-1)[ih_e] & 127).astype(np.uint32) << 8 * k
    hw = [wfb[k].reshape(-1)[ih_e] for k in range(4)]
    group, col = acc_e // 128, acc_e % 128
    vidx = np.zeros(acc_e.shape, np.uint32)
    for m in range(4):
        vidx |= (ry[m, group, 0, col] & 7).astype(np.uint32) << 8 * m
    vw = [wv[m, group, 0, col] for m in range(4)]
    row = (ih_e // 128 % 8) * 128          # ih row r reads window row r % 8
    ihs = np.zeros((2, 64 * 128), np.float32)
    acc = np.zeros(acc_e.shape, np.float32)
    buf = 0
    for _ in range(loops):
        for ch in range(3):
            window = win[ch].reshape(-1)
            ih = None
            for k in range(4):
                term = window[row + (hidx >> 8 * k & 0xFF)] * hw[k]
                ih = term if ih is None else ih + term
            ihs[buf][ih_e] = ih
            add = None
            for m in range(4):
                kept = (group * 8 + (vidx >> 8 * m & 0xFF)) * 128 + col
                term = ihs[buf][kept] * vw[m]
                add = term if add is None else add + term
            acc = acc + add
            buf ^= 1
    out = np.zeros(8 * 128, np.float32)
    out[acc_e] = acc
    return out.reshape(8, 128)


def test_layouts_cover_each_element_once():
    """Every element has one owner; a (64,128) gather's sources stay in
    rows of the warp that reads them (so a __syncwarp orders the loop);
    each warp-load of either kernel is 32 consecutive elements of a row,
    the grouping ``block_loop_wavefronts`` counts."""
    idx = mo.make_inputs()["idx64"].numpy()
    elems = gather_lane64_layout()
    np.testing.assert_array_equal(np.sort(elems.ravel()), np.arange(8192))
    src = (elems & ~127) + (idx.reshape(-1)[elems] & 127)
    warp = np.arange(GATHER64_THREADS)[:, None] // 32
    assert (src // 128 // 8 == warp).all()
    ih_e, acc_e = chunk_layout()
    np.testing.assert_array_equal(np.sort(ih_e.ravel()), np.arange(8192))
    np.testing.assert_array_equal(np.sort(acc_e.ravel()), np.arange(1024))
    for layout in (elems, ih_e, acc_e):
        loads = layout.reshape(-1, 32, layout.shape[1]).transpose(0, 2, 1)
        assert (np.diff(loads, axis=2) == 1).all()
        assert (loads[..., 0] % 32 == 0).all()


def test_gather_lane64_emulation(recorded):
    """The warp-owned, double-buffered (64,128) gather at REPS
    applications: bitwise the plain version and the Pallas body."""
    op = mo.OPS["gather_lane64"]
    body, out_shape, arrays = recorded[op.label]
    a, idx = (np.array(arr) for arr in arrays)
    got = emulate_gather_lane64(a, idx, REPS)
    plain = mo.micro_op("gather_lane64", [torch.from_numpy(a),
                                          torch.from_numpy(idx)], REPS)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, run_pallas(body, out_shape, arrays))
    np.testing.assert_array_equal(emulate_gather_lane64(a, idx, 0), a)


@pytest.mark.parametrize("loops", [1, 8])
def test_chunk_emulation(recorded, loops):
    """The composite with its tables held on chip, at 1 and 8 loops:
    bitwise the plain version, and within 1e-6 of the Pallas body (at
    ``OP_REPS = 16 * loops``: the body runs OP_REPS // 16 loops, none at
    the module's REPS)."""
    op = mo.OPS["chunk"]
    body, out_shape, arrays = recorded[op.label]
    arrs = [np.array(arr) for arr in arrays]
    got = emulate_chunk(*arrs, loops)
    plain = mo.micro_op("chunk", [torch.from_numpy(x) for x in arrs], loops)
    np.testing.assert_array_equal(got, plain.numpy())
    ref = pallas_at(body, out_shape, arrays, 16 * loops)
    assert np.isfinite(ref).all() and float(np.abs(ref).max()) > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))


# ---- concat and the warp-a-chain kernels (loop, mul8, where), emulated -------

WARPGROUP = 128          # micro_ops.cu: a concat chain's threads
CONCAT_TURNS = 4         # kConcatTurns: chains a warpgroup runs in turn
CONCAT_CHAINS = 2 * CONCAT_TURNS   # kConcatChains: chains a CUDA block
CHAINS = 8               # kChains: a chain a warp, 8 warps a block
SCALE = np.float32(1.0001)


def concat_layout():
    """Thread t of a warpgroup: its accumulator elements t + 128 j (j <
    64) and the x element each adds, t + 128 (j mod 8)."""
    t = np.arange(WARPGROUP)[:, None]
    j = np.arange(64 * 128 // WARPGROUP)[None, :]
    return t + WARPGROUP * j, t + WARPGROUP * (j % 8)


def loop_layout():
    """Lane l of a warp (the counted loop, mul8, where): its elements
    l + 32 j (j < 32)."""
    return np.arange(32)[:, None] + 32 * np.arange(8 * 128 // 32)[None, :]


def warp_chains(grid):
    """(block, warp, chain) of the warp-a-chain kernels: block b's warp w
    runs chain 8b + w; a warp past the grid leaves before its loop."""
    for block in range(-(-grid // CHAINS)):
        for warp in range(CHAINS):
            if block * CHAINS + warp < grid:
                yield block, warp, block * CHAINS + warp


def concat_chains(grid):
    """(block, warpgroup, turn, chain) in the order the kernel runs them:
    block b's warpgroup w takes chains 8b + w + 2 k in turn k and leaves
    at the first past the grid."""
    for block in range(-(-grid // CONCAT_CHAINS)):
        for wg in range(2):
            for turn in range(CONCAT_TURNS):
                chain = block * CONCAT_CHAINS + wg + 2 * turn
                if chain >= grid:
                    break
                yield block, wg, turn, chain


def emulate_concat(a, loops, grid):
    """Every chain of the grid as the kernel runs it: x of a thread's own
    elements loaded once, each accumulator from 0, one add an element a
    loop in the plain order; the result stored by each block's first chain
    (warpgroup 0, turn 0), which must agree with every other chain."""
    elems, src = concat_layout()
    x = a.reshape(-1)[src]
    out, stored, finals = np.full(64 * 128, np.nan, np.float32), 0, []
    for _block, wg, turn, _chain in concat_chains(grid):
        acc = np.zeros(elems.shape, np.float32)
        for _ in range(loops):
            acc = acc + x
        finals.append(acc)
        if wg == 0 and turn == 0:
            out[elems] = acc
            stored += 1
    assert stored == -(-grid // CONCAT_CHAINS)
    assert all(np.array_equal(f, finals[0]) for f in finals)
    return out.reshape(64, 128)


def emulate_warp_chains(key, arrays, loops, grid):
    """Every chain (warp) of the grid as the ``loop``, ``mul8``, ``where``
    or ``gather_lane8`` kernel runs it: its lanes' 32 elements each loaded
    (where and the gather: their 32 indices too), then an application a
    loop: an add of 1, a multiply by 1.0001 rounded once, that multiply
    under the predicate ``index != r``, the index compared as it is at
    every application, or the gather: the warp's tile in two buffers of
    its own, each lane's 32 values read from one at their sources in their
    own rows (the index masked to the row) plus 0.5 and stored to the
    other; the result stored by each block's warp 0, which must agree with
    every other chain."""
    elems = loop_layout()
    out, stored, finals = np.full(8 * 128, np.nan, np.float32), 0, []
    for _block, warp, _chain in warp_chains(grid):
        x = arrays[0].reshape(-1)[elems]
        if key in ("where", "gather_lane8"):
            i = arrays[1].reshape(-1)[elems]
        if key == "gather_lane8":
            src = (elems & ~127) + (i & 127)
            bufs = np.full((2, 8 * 128), np.nan, np.float32)
            bufs[0][elems] = x
        for r in range(loops):
            if key == "loop":
                x = x + np.float32(1.0)
            elif key == "mul8":
                x = x * SCALE
            elif key == "gather_lane8":
                x = bufs[r & 1][src] + np.float32(0.5)
                bufs[(r & 1) ^ 1][elems] = x
            else:
                np.multiply(x, SCALE, out=x, where=i != r)
        finals.append(x)
        if warp == 0:
            out[elems] = x
            stored += 1
    assert stored == -(-grid // CHAINS)
    assert all(np.array_equal(f, finals[0]) for f in finals)
    return out.reshape(8, 128)


@pytest.mark.parametrize("grid", [1, 11, 2048])
def test_concat_and_loop_layouts(grid):
    """Each accumulator element has one owner a chain and each of its adds
    reads the x of its own thread (concat's sources are its own elements
    mod 1024); every chain of the grid runs once, in a block of its own
    share; a warp-load or -store is 32 consecutive elements. The counted
    loop, mul8 and where share one layout: a lane's 32 elements, a chain a
    warp, every chain once, one store a block (by warp 0, which every block
    has)."""
    elems, src = concat_layout()
    np.testing.assert_array_equal(np.sort(elems.ravel()), np.arange(8192))
    np.testing.assert_array_equal(src, elems % 1024)
    assert len(np.unique(src, axis=None)) == 1024
    chains = [c for _b, _w, _t, c in concat_chains(grid)]
    assert sorted(chains) == list(range(grid))
    blocks = {b for b, _w, _t, _c in concat_chains(grid)}
    assert len(blocks) == -(-grid // CONCAT_CHAINS)
    lanes = loop_layout()
    np.testing.assert_array_equal(np.sort(lanes.ravel()), np.arange(1024))
    for layout in (elems, lanes):
        loads = layout.reshape(-1, 32, layout.shape[1]).transpose(0, 2, 1)
        assert (np.diff(loads, axis=2) == 1).all()
        assert (loads[..., 0] % 32 == 0).all()
    warps = list(warp_chains(grid))
    assert [c for _b, _w, c in warps] == list(range(grid))
    stores = [b for b, w, _c in warps if w == 0]
    assert stores == list(range(-(-grid // CHAINS)))
    assert {b for b, _w, _c in warps} == set(stores)


@pytest.mark.parametrize("loops", [0, 1, REPS, 64])
@pytest.mark.parametrize("key", ["concat", "loop", "mul8", "where",
                                 "gather_lane8"])
def test_concat_and_loop_emulation(recorded, key, loops):
    """The redesigned concat, counted loop, (8,128) mul, where and (8,128)
    gather at 0, 1, REPS and 64 loops over a ragged grid of 11 chains:
    bitwise the plain
    version, and the Pallas body (run at ``OP_REPS`` = the loops'
    applications) bitwise too, but for mul8: XLA folds the body's chain of
    multiplies by the constant into one multiply by 1.0001**n (rounded
    once), so there each of the chain's n roundings and the fold's own
    (each ≤ 2**-24 of the value) part the two, ≤ (n + 1) * 2**-24."""
    op = mo.OPS[key]
    body, out_shape, arrays = recorded[op.label]
    arrs = [np.array(arr) for arr in arrays]
    got = emulate_concat(arrs[0], loops, 11) if key == "concat" else \
        emulate_warp_chains(key, arrs, loops, 11)
    plain = mo.micro_op(key, [torch.from_numpy(x) for x in arrs], loops)
    np.testing.assert_array_equal(got, plain.numpy())
    ref = pallas_at(body, out_shape, arrays, op.loops_div * loops)
    if key == "mul8":
        np.testing.assert_allclose(got, ref, rtol=(loops + 1) * 2.0 ** -24,
                                   atol=0)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("span", ["past_8", "negative"])
def test_where_reads_the_index_every_application(recorded, span):
    """``where`` compares each element's index with the application's
    count at every application, as it is: indices from 8 to 70 (some hit
    within 64 applications, some never) or from -40 to 7 (the negative ones
    never hit) give the plain version's result and the Pallas body's,
    bitwise, and not what indices masked to [0, 8) would give."""
    body, out_shape, arrays = recorded[mo.OPS["where"].label]
    rng = np.random.default_rng(12)
    lo, hi = (8, 71) if span == "past_8" else (-40, 8)
    a = np.array(arrays[0])
    idx = rng.integers(lo, hi, (8, 128)).astype(np.int32)
    got = emulate_warp_chains("where", [a, idx], 64, 11)
    plain = mo.micro_op("where", [torch.from_numpy(a),
                                  torch.from_numpy(idx)], 64)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(
        got, pallas_at(body, out_shape, [arrays[0], idx], 64))
    masked = emulate_warp_chains("where", [a, idx & 7], 64, 11)
    assert not np.array_equal(got, masked)


def test_sass_counts_reads_cuobjdump(monkeypatch):
    """``_build.sass_counts`` counts an opcode with or without modifiers
    by kernel, and no opcode that merely starts with the same letters."""
    from gs360x_torch.kernels import _build
    sass = "\n".join([
        "  Function : _ZN12_GLOBAL__N_113concat_kernelEPKfPfii",
        "  /*0100*/   FADD R4, R4, R12 ;   /* 0x0000000c04047221 */",
        "  /*0110*/   FADD.FTZ R5, R5, R13 ;",
        "  /*0120*/   FADD32I R6, R6, 0.5 ;",
        "  /*0130*/   DFADD R8, R8, R10 ;",
        "  /*0140*/   FFMA R7, R7, R7, R7 ;",
        "  Function : _ZN12_GLOBAL__N_118tc_matmul64_kernelEPKfS1_Pfii",
        "  /*0200*/   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR4], R24 ;",
        "  /*0210*/   FADD R1, R1, 1 ;",
    ])
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(_build, "_cuda_tool", lambda name: name)
    monkeypatch.setattr(_build.subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": sass})())
    concat = "_ZN12_GLOBAL__N_113concat_kernelEPKfPfii"
    matmul = "_ZN12_GLOBAL__N_118tc_matmul64_kernelEPKfS1_Pfii"
    assert _build.sass_counts(("FADD", "FADD32I")) == {
        concat: {"FADD": 2, "FADD32I": 1}, matmul: {"FADD": 1}}
    assert _build.sass_counts(("HGMMA", "HMMA")) == {matmul: {"HGMMA": 1}}
    assert _build.sass_counts(("HGMMA", "FADD32I", "FADD")) == {
        concat: {"FADD": 2, "FADD32I": 1},
        matmul: {"HGMMA": 1, "FADD": 1}}


@pytest.mark.parametrize("fault,wrong", [
    (None, []),
    (("where", "FSEL", 1), [("where", ("FSEL",), 1, 0)]),     # a select
    (("loop", "FADD", 31), [("loop", ("FADD", "FADD32I"), 31, 32)]),  # merged
    (("mul8", "FMUL", 33), [("mul8", ("FMUL", "FMUL32I"), 33, 32)]),
    (("matmul8", "HGMMA", 0), [("matmul8", ("HGMMA", "HMMA"), 0, None)]),
    (("gather_lane8", "BAR", 2), [("gather_lane8", ("BAR",), 2, 0)]),
    (("gather_lane8", "FADD", 64), [("gather_lane8", ("FADD", "FADD32I"),
                                     64, 32)]),                # unrolled
])
def test_sass_checks_flag_a_merged_chain_or_a_select(fault, wrong):
    """``sass_checks`` on the counts the right build holds passes every
    check; a chain merged or dropped (one FADD or FMUL too few or many), a
    select in where, a block barrier in the (8,128) gather, or a product
    off the tensor cores fails its check alone. A kernel is found by its
    own mangled name (mul8's count leaves out ``tc_matmul8_kernel``'s and
    ``mul_kernel<64>``'s, gather_lane8's ``gather_lane64_kernel``'s); a
    key's count sums its opcodes."""
    counts = {
        "_ZN12_GLOBAL__N_118tc_matmul64_kernelEPKfS1_Pfii": {"HGMMA": 48},
        "_ZN12_GLOBAL__N_117tc_matmul8_kernelEPKfS1_Pfii": {"HGMMA": 32,
                                                            "FMUL": 8},
        "_ZN12_GLOBAL__N_113concat_kernelEPKfPfii": {"FADD": 64},
        "_ZN12_GLOBAL__N_111loop_kernelEPKfPfii": {"FADD": 32},
        "_ZN12_GLOBAL__N_111mul8_kernelEPKfPfii": {"FMUL": 30, "FMUL32I": 2},
        "_ZN12_GLOBAL__N_112where_kernelEPKfPKiPfii": {"FMUL": 32},
        "_ZN12_GLOBAL__N_110mul_kernelILi64EEvPKfPfi": {"FMUL": 32},
        "_ZN12_GLOBAL__N_119gather_lane8_kernelEPKfPKiPfii": {"FADD": 32},
        "_ZN12_GLOBAL__N_120gather_lane64_kernelEPKfPKiPfi": {"FADD": 32,
                                                             "BAR": 0},
        "_ZN12_GLOBAL__N_117gather_sub_kernelEPKfPKiPfi": {"FADD": 8,
                                                          "BAR": 1},
    }
    if fault:
        key, op, n = fault
        name = next(k for k in counts if f"{len(key) + 7}{key}_kernel" in k
                    or f"tc_{key}_kernel" in k)
        counts[name] = {**counts[name], op: n} if op in ("FSEL", "BAR") \
            else {op: n}
    rows = mo.sass_checks(counts)
    assert [(k, ops) for k, ops, _n, _w, _ok in rows] == [
        (k, ops) for k, checks in mo.SASS_CHECKS.items() for ops, _ in checks]
    assert [row[:4] for row in rows if not row[4]] == wrong


def brute_force_wavefronts(words):
    """One warp-load at a time: the distinct words each bank holds."""
    total = 0
    for load in np.asarray(words).reshape(-1, 32).tolist():
        banks = {}
        for word in load:
            banks.setdefault(word % 32, set()).add(word)
        total += max(len(held) for held in banks.values())
    return total


@pytest.mark.parametrize("name,want", [("idx8", 90), ("idx64", 710),
                                       ("relb", 2831)])
def test_smem_wavefronts_of_the_seeded_gathers(name, want):
    """The (8,128) and (64,128) gathers' row reads by ``idx8`` and
    ``idx64`` a block-loop, and one channel's horizontal taps of the
    composite by ``relb`` (ih row r reads window row r % 8): the helper
    against a count made one warp-load at a time."""
    idx = mo.make_inputs()[name].numpy() & 127
    rows = np.arange(idx.shape[-2])[:, None]
    words = (rows % 8) * 128 + idx if name == "relb" else rows * 128 + idx
    assert mo.smem_wavefronts(words) == brute_force_wavefronts(words) == want


def test_smem_wavefronts_edge_cases():
    lanes = np.arange(32)
    assert mo.smem_wavefronts(lanes) == 1                  # one a bank
    assert mo.smem_wavefronts(np.full(32, 7)) == 1         # a broadcast
    assert mo.smem_wavefronts(lanes * 32) == 32            # all in bank 0
    assert mo.smem_wavefronts(lanes % 4 * 32) == 4         # 4 words, bank 0
    assert mo.smem_wavefronts(np.stack([lanes, lanes * 32])) == 33


def test_block_loop_wavefronts_and_floors():
    """The seeded inputs' counts behind the three kernels' floors, and the
    floors at grid 2048 (composite 256), reps 64, on 132 SMs. The bound
    counts a store and a read of each gathered element (the new tile is
    stored for other lanes every application; the composite's ih too)."""
    inputs = mo.make_inputs()
    assert mo.block_loop_wavefronts("gather_lane8", inputs) == {
        "gather": 90, "store": 32, "bound": 64}
    assert mo.block_loop_wavefronts("gather_lane64", inputs) == {
        "gather": 710, "store": 256, "bound": 512}
    assert mo.block_loop_wavefronts("chunk", inputs) == {
        "gather": 3 * 2831, "store": 3 * 256, "vertical": 3 * 128,
        "bound": 3 * (1024 + 256 + 128)}
    floors = {key: mo.wavefront_floor_ms(key, inputs,
                                         mo.bench_loops(mo.OPS[key]), 132)
              for key in mo.WAVEFRONT_MODELS}
    assert floors["gather_lane8"] == pytest.approx(0.061183, rel=1e-4)
    assert floors["gather_lane64"] == pytest.approx(0.48445, rel=1e-4)
    assert floors["chunk"] == pytest.approx(0.0378, rel=1e-3)
    bound = mo.bound_ms(mo.OPS["chunk"], 4)[0]
    assert bound / floors["chunk"] == pytest.approx(0.437, rel=1e-2)
    for key in ("mul8", "concat", "loop"):
        with pytest.raises(ValueError):
            mo.block_loop_wavefronts(key, inputs)


def test_device_ms_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        device_ms(lambda: None)


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph`` that counts its replays."""

    replays = 0

    def __init__(self, keep_graph):
        assert keep_graph

    def raw_cuda_graph(self):
        return 0

    def instantiate(self):
        pass

    def replay(self):
        _Graph.replays += 1


class _Event:
    """A stand-in for ``torch.cuda.Event`` whose spans are given in turn."""

    spans = iter(())

    def __init__(self, enable_timing):
        assert enable_timing

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, _stop):
        return next(_Event.spans)


@pytest.mark.parametrize("nodes, kernels", [
    (10, 1), (20, 2),    # one or two kernels a call
    (0, None),           # nothing captured: raises
    (15, None),          # not the same kernels in every call: raises
])
def test_device_ms_times_a_graph_replay(monkeypatch, nodes, kernels):
    """``device_ms`` takes a call's kernels from the captured graph's kernel
    nodes and its time from the median of the timed replays over the calls,
    each timed replay behind an untimed one."""
    import contextlib
    stream = type("Stream", (), {"wait_stream": lambda self, other: None})()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda _s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda _g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(profiling, "kernel_nodes", lambda _raw: nodes)
    spans = [5.0, 1.0, 3.0, 2.0, 4.0][:profiling.DEVICE_BATCHES]
    _Event.spans, _Graph.replays = iter(spans), 0
    calls = []
    if kernels is None:
        with pytest.raises(RuntimeError, match="kernels in"):
            profiling.device_ms(lambda: calls.append(1))
        return
    ms, got = profiling.device_ms(lambda: calls.append(1))
    assert got == kernels
    assert ms == pytest.approx(sorted(spans)[len(spans) // 2]
                               / profiling.DEVICE_REPS)
    assert len(calls) == profiling.DEVICE_WARMUP + profiling.DEVICE_REPS
    assert _Graph.replays == 2 * profiling.DEVICE_BATCHES


# f32 instructions and shared-memory bytes an output element a loop: a
# lone add or multiply 1, where's compare + predicated multiply 2, a
# product's K FMAs; 8 bytes where a value crossing threads is stored and
# read every application (the gathers along axis 1) or where the body reads
# and writes its own ref every application (when_rmw), 4 where it is only
# read (axis-0 gather, roll, slice), none where no value crosses threads
# (concat: a thread's accumulators add the x it holds)
PER_ELEMENT = {"mul8": (1, 0), "mul64": (1, 0), "gather_lane8": (1, 8),
               "gather_lane64": (1, 8), "gather_sub8": (1, 4),
               "where": (2, 0), "concat": (1, 0), "matmul64": (128, 0),
               "matmul8": (128, 0), "dyn_roll": (1, 4), "loop": (1, 0),
               "when_rmw": (1, 8), "dyn_slice": (1, 4)}
# the least time in ms at grid 2048 (composite 256), reps 64, and what
# bounds it
BOUNDS = {"mul8": (0.0040063, "f32"), "mul64": (0.032050, "f32"),
          "gather_lane8": (0.032050, "shared memory"),
          "gather_lane64": (0.25640, "shared memory"),
          "gather_sub8": (0.016025, "shared memory"),
          "where": (0.0080125, "f32"), "concat": (0.0040063, "f32"),
          "matmul64": (1.6659, "tensor cores"),
          "matmul8": (0.20824, "tensor cores"),
          "dyn_roll": (0.016025, "shared memory"),
          "loop": (0.0040063, "f32"),
          "when_rmw": (0.032050, "shared memory"),
          "dyn_slice": (0.016025, "shared memory"),
          "chunk": (0.016528, "shared memory")}


@pytest.mark.parametrize("key", list(mo.OPS))
def test_every_primitive_has_a_bound(key):
    """Each primitive's least time at grid 2048, reps 64, by the quotient
    that bounds it: the products by three TF32 passes on the tensor cores
    (their f32 time, the FMA bound, does not enter), the rest by f32
    instructions at 33.5 T a second or by shared memory, whichever is
    larger; each pinned."""
    op = mo.OPS[key]
    loops = mo.bench_loops(op)
    ms, by, times = mo.bound_ms(op, loops)
    assert (ms, by) == (pytest.approx(BOUNDS[key][0], rel=1e-4),
                        BOUNDS[key][1])
    assert ms == times[by]
    applications = (op.grid or mo.GRID) * loops
    assert times["f32"] == pytest.approx(applications * op.issue_per_loop
                                         / 33.5e9)
    if key in PER_ELEMENT:
        elements = op.out_shape[0] * op.out_shape[1]
        assert (op.issue_per_loop, op.smem_bytes_per_loop) == tuple(
            n * elements for n in PER_ELEMENT[key])
    if key in mo.PRODUCTS:
        assert by == "tensor cores"
        assert ms == pytest.approx(applications * 3 * 2 * op.issue_per_loop
                                   / 495e9)
        assert times["f32"] > ms
    elif op.smem_bytes_per_loop:
        assert by == "shared memory"
        assert ms == pytest.approx(applications * op.smem_bytes_per_loop
                                   / 33.5e9)
    else:
        assert by == "f32"
    assert ms == max(t for k, t in times.items()
                     if not (k == "f32" and key in mo.PRODUCTS))


def ref_accesses_in_loop(body):
    """(the refs a Pallas body reads, the refs it writes) inside its loop:
    subscripts of an argument named ``*_ref`` or of a local bound to one,
    under a ``for`` (a nested ``pl.when`` body included)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(body)))
    refs = {a.arg for a in tree.body[0].args.args if a.arg.endswith("_ref")}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) \
                and node.value.id in refs:
            refs |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    loads, stores = set(), set()
    for loop in (n for n in ast.walk(tree) if isinstance(n, ast.For)):
        for node in ast.walk(loop):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in refs:
                (loads if isinstance(node.ctx, ast.Load)
                 else stores).add(node.value.id)
        for node in ast.walk(loop):
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Subscript):
                loads.add(node.target.value.id)
    return loads, stores


@pytest.mark.parametrize("key", list(mo.OPS))
def test_shared_memory_exceptions_are_the_bodys_own_accesses(recorded, key):
    """``MicroOp``'s shared-memory exceptions stand on the Pallas body:
    only ``when_rmw``'s body writes a ref every application, and it counts
    that read and that write (8 bytes an element); only ``dyn_slice``'s and
    the composite's read one there; ``concat``'s touches none inside its
    loop, so its replication of the x a thread holds counts nothing."""
    op = mo.OPS[key]
    loads, stores = ref_accesses_in_loop(recorded[op.label][0])
    elements = op.out_shape[0] * op.out_shape[1]
    assert bool(stores) == (key == "when_rmw")
    assert bool(loads) == (key in ("when_rmw", "dyn_slice", "chunk"))
    if key == "when_rmw":
        assert loads == stores == {"o_ref"}
        assert op.smem_bytes_per_loop == 8 * elements
    if key == "dyn_slice":
        assert op.smem_bytes_per_loop == 4 * elements
    if key == "concat":
        assert op.smem_bytes_per_loop == 0


def test_product_bounds_at_the_benchmark_size():
    """grid 2048, reps 64: matmul64 1.67 ms on the tensor cores (4.10 on
    the FMA units), matmul8 0.208 (0.513)."""
    got = {}
    for key in mo.PRODUCTS:
        ms, _by, times = mo.bound_ms(mo.OPS[key], mo.OP_REPS)
        got[key] = (ms, times["f32"])
    assert got["matmul64"] == pytest.approx((1.666, 4.103), rel=1e-3)
    assert got["matmul8"] == pytest.approx((0.2082, 0.5128), rel=1e-3)


def test_launch_total_is_the_sum_of_each_primitive():
    """``LAUNCHES["micro_ops"]`` is the sum of ``OP_LAUNCHES``, read-only,
    and merges into a plain dict as the other wrappers' counts do."""
    mo.reset_counters()
    assert dict(mo.LAUNCHES) == {"micro_ops": 0}
    mo.OP_LAUNCHES["matmul8"] += 2
    mo.OP_LAUNCHES["chunk"] += 1
    try:
        assert {**mo.LAUNCHES} == {"micro_ops": 3}
        assert mo.LAUNCHES == {"micro_ops": 3}
        with pytest.raises(TypeError):
            mo.LAUNCHES["micro_ops"] = 0
    finally:
        mo.reset_counters()
    assert mo.LAUNCHES["micro_ops"] == 0


def test_every_body_has_a_counterpart(recorded):
    assert sorted(recorded) == sorted(op.label for op in mo.OPS.values())
    assert len(mo.OPS) == 14
    assert sorted(op.code for op in mo.OPS.values()) == list(range(14))


@pytest.mark.parametrize("key,bad", [
    ("mul8", lambda t: [t[0][:4]]),                       # shape
    ("gather_lane8", lambda t: [t[0], t[1].long()]),      # index dtype
    ("matmul8", lambda t: [t[0]]),                        # input count
    ("where", lambda t: [t[0].double(), t[1]]),           # value dtype
])
def test_micro_op_rejects_bad_inputs(key, bad):
    inputs = mo.make_inputs()
    tensors = [inputs[name] for name in mo.OPS[key].inputs]
    with pytest.raises(ValueError):
        mo.micro_op(key, bad(tensors), 2)


def test_micro_op_rejects_bad_counts():
    inputs = mo.make_inputs()
    with pytest.raises(ValueError):
        mo.micro_op("mul8", [inputs["a8"]], -1)
    with pytest.raises(ValueError):
        mo.micro_op("mul8", [inputs["a8"]], 2, grid=0)
    with pytest.raises(KeyError):
        mo.micro_op("no-such-op", [inputs["a8"]], 2)


def test_tool_prints_the_scripts_lines_on_the_cpu(capsys):
    """On the CPU: one ``name … ns/op`` line a primitive under the
    script's labels, marked as a host-clock rehearsal."""
    mo_tool.run(torch.device("cpu"), op_reps=16)
    lines = capsys.readouterr().out.splitlines()
    ops = list(mo.OPS.values())
    bench_lines = [ln for ln in lines if ln.rstrip().endswith("host clock]")]
    assert len(bench_lines) == len(ops)
    for op, line in zip(ops, bench_lines):
        assert line.startswith(f"{op.label:44s} ")
        assert " ns/op" in line
    assert any(ln.startswith("  -> per chunk-body:") for ln in lines)


def test_tool_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        mo_tool.main(["--device", "cuda"])
