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
multiply-add, and folds the update's eight ``+= 1`` into one add); the
products at 1e-5 relative a step against the f32 product (the CPU
interpreter computes them in f32).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gs360x_torch.kernels import micro_ops_cuda as mo
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
    assert got.shape == ref.shape == op.out_shape
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    if key in BITWISE:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL[key],
                                   atol=RTOL[key] * float(np.abs(ref).max()))


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
