"""Microbenchmark of primitive costs on the GPU — the port of the root
``micro_ops.py``.

    python -m gs360x_torch.tools.micro_ops [--device cuda]

Each primitive of :data:`gs360x_torch.kernels.micro_ops_cuda.OPS` runs
``OP_REPS`` dependent applications in each of ``GRID`` blocks; the line
printed is ``micro_ops.py``'s, ``name … ns/op``, with ns/op = device time /
(grid · reps). The device time is taken with CUDA events around launches
issued back to back (a host clock around one call would time the host).

Blocks run in parallel on every multiprocessor of the card, so that figure
is the cost of one application amortised over the whole card, with the
launch, the wrapper's host time (tens of µs a call, more than the cheap
primitives' whole launch) and the loads of a block in it. A second figure
removes all three: the same kernel at deeper loop counts, four times
deeper each step until a launch takes 1 ms, and the difference in time
between the last two depths over the difference in applications
(``marginal``), also given times the card's multiprocessor count
(``SM-ns``: the time one multiprocessor spends on one application when all
are busy).

``--device cpu`` runs the plain torch versions once each under a host
clock and says so on every line: a rehearsal of the control flow, not a
measurement of a device.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import torch

from gs360x_torch.device import DEVICE_CHOICES, resolve_device
from gs360x_torch.kernels import micro_ops_cuda as mo
from gs360x_torch.runtime.profiling import cuda_ms

DEPTH_STEP = 4          # each deeper run's loop count, times the last's
DEEP_ENOUGH_MS = 1.0    # a launch this long times the device, not the host
MAX_DEPTH = 4096        # times the nominal loop count
TIMING_REPS = 5         # launches between a pair of events (5 such batches)


def bench(op: mo.MicroOp, inputs: Dict[str, torch.Tensor], *,
          op_reps: int = mo.OP_REPS, grid: int = mo.GRID) -> dict:
    """Time one primitive on the device its inputs lie on. Returns ``ms``
    (one launch at the nominal loop count), ``ns_per_op``, and on a CUDA
    device ``marginal_ns`` (see the module docstring)."""
    tensors = [inputs[name] for name in op.inputs]
    grid = op.grid or grid
    loops = mo.bench_loops(op, op_reps)
    applications = grid * loops * op.per_loop
    if tensors[0].device.type != "cuda":
        t0 = time.perf_counter()
        mo.micro_op(op.key, tensors, loops, grid)
        ms = (time.perf_counter() - t0) * 1e3
        # the plain version computes one block, whatever the grid
        return {"ms": ms, "ns_per_op": ms * 1e6 / (loops * op.per_loop),
                "marginal_ns": None, "marginal_depth": None}
    ms = cuda_ms(lambda: mo.micro_op(op.key, tensors, loops, grid),
                 reps=TIMING_REPS)
    depth, shallow_ms = 1, ms
    while True:
        depth *= DEPTH_STEP
        deep_ms = cuda_ms(lambda: mo.micro_op(op.key, tensors, depth * loops,
                                              grid), reps=TIMING_REPS)
        if deep_ms >= DEEP_ENOUGH_MS or depth >= MAX_DEPTH:
            break
        shallow_ms = deep_ms
    marginal = (deep_ms - shallow_ms) * 1e6 / (
        (depth - depth // DEPTH_STEP) * applications)
    return {"ms": ms, "ns_per_op": ms * 1e6 / applications,
            "marginal_ns": marginal, "marginal_depth": depth}


def run(device: torch.device, *, op_reps: int = mo.OP_REPS,
        grid: int = mo.GRID, out=None) -> List[dict]:
    """Benchmark every primitive and print one line each to ``out``."""
    out = out or sys.stdout
    inputs = mo.make_inputs(device)
    on_card = device.type == "cuda"
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if on_card else 0)
    rows = []
    for op in mo.OPS.values():
        res = bench(op, inputs, op_reps=op_reps, grid=grid)
        line = f"{op.label:44s} {res['ns_per_op']:8.2f} ns/op"
        if on_card:
            line += (f"   marginal {res['marginal_ns']:9.4f} ns/op "
                     f"({res['marginal_ns'] * sms:9.2f} SM-ns, depth x"
                     f"{res['marginal_depth']})")
        else:
            line += "   [plain version on the CPU, host clock]"
        print(line, file=out, flush=True)
        if op.key == "chunk":
            print(f"  -> per chunk-body: {res['ns_per_op']:.0f} ns",
                  file=out, flush=True)
        rows.append({"key": op.key, "label": op.label, **res})
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Cost of the warp kernels' primitives on the GPU "
                    "(ns per application).")
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "present; cpu runs the plain torch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"# {torch.cuda.get_device_name(device)}, grid {mo.GRID}, "
              f"reps {mo.OP_REPS}")
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
