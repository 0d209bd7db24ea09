"""Drives perspcut's image mode: ``gs360x_torch.runtime.executor.run_plan``
over a plan that perspcut's own parser and ``build_view_plan`` build from
the configuration's flags.

Set-up: the distinct frames, a folder of linked names, the kernel
library, and a warm-up ``run_plan`` over a few other names of the same
frames, through the same shapes. The window is the timed ``run_plan``
call: it starts at the call and ends when the call returns, by which time
the writer pool has drained. The plan lists ``frames_per_s_sizing ×
--seconds`` frames, so the window lasts about ``--seconds`` at the rate
the traffic file was sized at; a faster program finishes the same frames
sooner. The fixed plan, not ``run_plan``'s ``stop_event``, ends the
window, so that every run does the same work. ``views_per_s`` is
``ExecutionReport.ok`` over the window.
"""

from __future__ import annotations

import math
import os
import pathlib
import time

import torch

from portbench import harness, scenes, work
from portbench.reference import compare, equirect

# the warp launch's return value is the views as the cell produces them
PRODUCES = ("gs360x_torch.kernels.warp_cuda", "warp_equirect_to_views_cuda")


def _workers(jobs: str) -> int:
    """perspcut's ``-j``: ``auto`` is one encode worker a core."""
    if str(jobs).lower() == "auto":
        return max(1, os.cpu_count() or 1)
    return max(1, int(jobs))


def reference(cfg: dict, distinct, keys, dtype: torch.dtype,
              device: torch.device, traffic: dict = None,
              work_dir: pathlib.Path = None) -> dict:
    """The reference's u8 view of each (distinct frame, view) of ``keys``,
    computed in ``dtype``: ``{(frame, view id): (size, size, 3) u8}``
    (``traffic`` and ``work_dir`` hold nothing it needs: no LUT)."""
    frames, refs = {}, {}
    for d, view in keys:
        if d not in frames:
            frames[d] = torch.from_numpy(
                compare.read_u8(distinct[d]).copy()).to(device)
        if (d, view["id"]) not in refs:
            refs[(d, view["id"])] = equirect.cut_view(frames[d], view,
                                                      cfg["views"], dtype)
    return refs


def inputs(cfg: dict, traffic: dict, seed: int,
           work_dir: pathlib.Path) -> list:
    """The traffic's distinct 8K frames, as JPEG files under
    ``work_dir / "inputs"``."""
    frame = cfg["frame"]
    return scenes.make_inputs(seed, (frame["height"], frame["width"]),
                              traffic, work_dir / "inputs")


def run(cell: harness.Cell, bench: harness.Bench) -> harness.Outcome:
    from gs360x_torch.io import image as imagelib
    from gs360x_torch.kernels import _build
    from gs360x_torch.rig.presets import build_view_plan
    from gs360x_torch.runtime import executor
    from gs360x_torch.tools import perspcut

    cfg, traffic, wd = cell.config, cell.traffic, cell.work
    t = time.perf_counter()
    distinct = inputs(cfg, traffic, cell.seed, wd)
    bench.notes["inputs_s"] = round(time.perf_counter() - t, 6)
    bench.notes["input_bytes"] = [p.stat().st_size for p in distinct]
    n_warm = int(traffic["warmup_frames"])
    n_listed = max(1, math.ceil(cell.seconds
                                * traffic["frames_per_s_sizing"]))
    warm = scenes.link_names(distinct, [f"w{k:06d}.jpg"
                                        for k in range(n_warm)], wd / "warm")
    names = [f"f{k:06d}" for k in range(n_listed)]
    files = scenes.link_names(distinct, [f"{n}.jpg" for n in names],
                              wd / "frames")

    args = perspcut.create_arg_parser().parse_args(
        ["-i", str(wd / "frames"), *cfg["args"]])
    plan_cfg = perspcut.config_from_args(args)
    plan = build_view_plan(plan_cfg, files, wd / "out")
    warm_plan = build_view_plan(plan_cfg, warm, wd / "warm_out")
    run_args = dict(device=cell.device, backend=args.backend,
                    overwrite=not args.no_overwrite,
                    writer_workers=_workers(args.jobs), quiet=True)

    if cell.device.type == "cuda":
        t = time.perf_counter()
        _build.load()
        bench.notes["library_s"] = round(time.perf_counter() - t, 6)
        bench.notes["library_build_s"] = round(_build.build_seconds, 6)
    t = time.perf_counter()
    executor.run_plan(warm_plan, **run_args)
    bench.notes["warmup_s"] = round(time.perf_counter() - t, 6)
    if cell.traced:
        bench.notes["warp_bound"] = work.warp_launch(cfg, cell.device)

    # host spans: the readers count frames by ``decode`` and ``dispatch``,
    # and the breakdown's idle gaps are named by all four
    bench.wrap(imagelib, "read_image", "decode")
    bench.wrap(executor, "_warp_frame_views", "dispatch")
    bench.wrap(executor._ViewFetcher, "__call__", "fetch")
    bench.wrap(imagelib, "write_image", "encode")
    bench.window_start()
    try:
        report = executor.run_plan(plan, **run_args)
    finally:
        bench.window_end()

    layout = cfg["views"]["layout"]
    expected = [(k, v) for k in range(n_listed) for v in layout]
    bench.notes["views"] = report.ok

    def check(dtype: torch.dtype) -> dict:
        paths = [wd / "out" / f"{names[k]}_{v['id']}.jpg"
                 for k, v in expected]
        present = [p.is_file() and p.stat().st_size > 0 for p in paths]
        picks = harness.sample(cell.seed, len(paths), traffic["check_sample"])
        keys = [(expected[i][0] % len(distinct), expected[i][1])
                for i in picks]
        refs = reference(cfg, distinct, keys, dtype, cell.device)
        pairs = [(compare.read_u8(paths[i]), refs[(d, v["id"])])
                 for i, (d, v) in zip(picks, keys) if present[i]]
        return compare.numbers(pairs, present.count(False))

    return harness.Outcome(
        e2e={"views_per_s": report.ok / bench.window_s},
        attempted=len(expected), failed=len(expected) - report.ok,
        check=check, counts={"views": report.ok},
        stage_seconds=dict(report.stage_seconds),
        work={"warp": bench.notes.get("warp_bound", {})})
