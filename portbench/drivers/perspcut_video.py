"""Drives perspcut's video mode: ``gs360x_torch.runtime.executor.run_plan``
over a plan that perspcut's own parser and ``build_view_plan`` build from
the configuration's flags and an MJPEG-AVI clip, as ``perspcut.main`` does
for a file input (``input_is_video``, and ``video_bit_depth`` from
``probe_video``).

Set-up: the distinct frames as JPEG files, two clips of them muxed by the
benchmark (:mod:`portbench.avi`, the files' very bytes, cycled): a warm-up
clip of ``warmup_frames`` (on one card one batch of 4 and a 1-frame tail,
so fill, drain and the tail run before the window) and the timed clip of
``frames_per_s_sizing × --seconds`` frames, the plan, the kernel library,
and a warm-up ``run_plan`` over the warm-up clip. The window is the timed
``run_plan`` call, from the call to its return (the writer pool drained):
both of its opens of the clip, ``_run_video``'s probe and the frame
iterator's, fall inside it. ``views_per_s`` is ``ExecutionReport.ok``
over the window. The clip, not a stop, ends the window, so every run does
the same work.
"""

from __future__ import annotations

import math
import os
import pathlib
import time

import numpy as np
import torch
from PIL import Image

from portbench import avi, harness, scenes, video_work
from portbench.reference import compare, video

# the colour move's return value is the views as the cell produces them,
# before the plain quantize (which the CPU's plain warp calls too)
PRODUCES = ("gs360x_torch.core.color", "video_color_move_planar")


def _workers(jobs: str) -> int:
    """perspcut's ``-j``: ``auto`` is one encode worker a core."""
    if str(jobs).lower() == "auto":
        return max(1, os.cpu_count() or 1)
    return max(1, int(jobs))


def clip_frames(traffic: dict, seconds: float) -> int:
    """The timed clip's frames: the work the traffic was sized at."""
    return max(1, math.ceil(seconds * traffic["frames_per_s_sizing"]))


def reference(cfg: dict, distinct, keys, dtype: torch.dtype,
              device: torch.device, traffic: dict = None,
              work_dir: pathlib.Path = None) -> dict:
    """The reference's u8 view of each (distinct frame, view) of ``keys``,
    computed in ``dtype``: ``{(frame, view id): (size, size, 3) u8}``,
    from the JPEG files the clip holds, decoded by Pillow."""
    if cfg.get("keep_rec709") or cfg.get("bit_depth", 8) != 8:
        raise ValueError("the reference moves to sRGB and writes 8 bits")
    frames, refs = {}, {}
    for d, view in keys:
        if d not in frames:
            frames[d] = torch.from_numpy(
                compare.read_u8(distinct[d]).copy()).to(device)
        if (d, view["id"]) not in refs:
            refs[(d, view["id"])] = video.cut_move_view(
                frames[d], view, cfg["views"], dtype)
    return refs


def _write_frame(path: pathlib.Path, img: np.ndarray, jpeg: dict) -> None:
    Image.fromarray(img).save(path, format="JPEG",
                              quality=int(jpeg["quality"]),
                              subsampling=int(jpeg["subsampling"]))


def inputs(cfg: dict, traffic: dict, seed: int, work_dir: pathlib.Path,
           seconds: float = None) -> list:
    """The traffic's distinct 8K frames, as JPEG files under ``work_dir /
    "inputs"`` (the scenes' statistics, the clip's per-frame JPEG
    settings); with ``seconds``, also the clips muxed from them, cycled:
    ``warm.avi`` (``warmup_frames``) and ``clip.avi``
    (:func:`clip_frames`). Returns the JPEG files in order."""
    frame = cfg["frame"]
    out = work_dir / "inputs"
    out.mkdir(parents=True, exist_ok=True)
    n = int(traffic["distinct"])
    paths = [out / f"d{i}.jpg" for i in range(n)]
    for i, path in enumerate(paths):
        _write_frame(path, scenes.scene(seed, i, frame["height"],
                                        frame["width"], traffic["scene"]),
                     traffic["frame_jpeg"])
    if seconds is not None:
        fps = float(traffic["clip_fps"])
        for name, count in (("warm.avi", int(traffic["warmup_frames"])),
                            ("clip.avi", clip_frames(traffic, seconds))):
            avi.write_clip(out / name, paths, [k % n for k in range(count)],
                           fps)
    return paths


def _wrap_frames(bench: harness.Bench, owner, kind: str) -> None:
    """In a traced run, a ``kind`` host span around each frame the
    reader's ``frames`` generator hands out while the window is open."""
    if not bench.traced:
        return
    inner = owner.frames
    record = bench.record

    def frames(self, *args, **kwargs):
        it = inner(self, *args, **kwargs)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                record(kind, t, time.perf_counter())
            yield item
    bench.patch(owner, "frames", frames)


def run(cell: harness.Cell, bench: harness.Bench) -> harness.Outcome:
    from gs360x_torch.io import image as imagelib
    from gs360x_torch.io import video as videolib
    from gs360x_torch.kernels import _build
    from gs360x_torch.rig.presets import build_view_plan
    from gs360x_torch.runtime import executor
    from gs360x_torch.tools import perspcut

    cfg, traffic, wd = cell.config, cell.traffic, cell.work
    t = time.perf_counter()
    distinct = inputs(cfg, traffic, cell.seed, wd, cell.seconds)
    bench.notes["inputs_s"] = round(time.perf_counter() - t, 6)
    clip, warm = wd / "inputs" / "clip.avi", wd / "inputs" / "warm.avi"
    bench.notes["input_bytes"] = [p.stat().st_size for p in distinct]
    bench.notes["clip_bytes"] = clip.stat().st_size
    n_frames = clip_frames(traffic, cell.seconds)

    def plan_of(path: pathlib.Path, out: pathlib.Path):
        args = perspcut.create_arg_parser().parse_args(
            ["-i", str(path), *cfg["args"]])
        args.input_is_video = True          # as perspcut.main does
        args.video_bit_depth = videolib.probe_video(path).bit_depth
        return args, build_view_plan(perspcut.config_from_args(args),
                                     [path], out)

    args, plan = plan_of(clip, wd / "out")
    _args, warm_plan = plan_of(warm, wd / "warm_out")
    if bool(plan.keep_rec709) != bool(cfg["keep_rec709"]) \
            or plan.bit_depth != cfg["bit_depth"]:
        raise RuntimeError(f"the plan's colour move ({plan.keep_rec709}, "
                           f"{plan.bit_depth} bits) is not the "
                           "configuration's")
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
        bench.notes["mesh_warp_bound"] = video_work.mesh_warp_launch(
            cfg, executor.CARD_FRAMES_PER_LAUNCH, cell.device)

    # host spans: the breakdown's idle gaps are named by all four
    _wrap_frames(bench, videolib.MJPEGAVIReader, "decode")
    bench.wrap(executor, "_warp_frames_batch", "dispatch")
    bench.wrap(executor._ViewFetcher, "__call__", "fetch")
    bench.wrap(imagelib, "write_image", "encode")
    bench.window_start()
    try:
        report = executor.run_plan(plan, **run_args)
    finally:
        bench.window_end()

    layout = cfg["views"]["layout"]
    expected = [(k, v) for k in range(n_frames) for v in layout]
    bench.notes["views"] = report.ok

    def check(dtype: torch.dtype) -> dict:
        paths = [wd / "out" / f"{clip.stem}_{k:07d}_{v['id']}.jpg"
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
        work={"mesh_warp": bench.notes.get("mesh_warp_bound", {})})
