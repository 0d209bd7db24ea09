"""RenderPlan executor (port of :mod:`gs360x.runtime.executor`).

Both modes decode ahead of the loop on the port's one decode-ahead stage
(:class:`gs360x_torch.runtime.prefetch.Prefetcher`). Image mode decodes
each frame once, on a pool of threads that hands the frames out in order,
uploads it to the device once as Pillow's own RGBX texels
(:func:`upload_rows`), warps all views of a view group in one launch,
quantizes in the warp kernel's own store, fetches once per (group, frame)
and streams the encodes through the async writer pool. Video mode decodes
an MJPEG-AVI clip's frames on the same pool (a Y4M or ffmpeg stream on one
thread, in its read order) and batches frames over a data mesh
(:mod:`gs360x_torch.runtime.mesh`): on a CUDA device 4 frames a batch
over every visible card (at least one a card), on the CPU 1; one upload a
batch, one warp launch a (group, batch, device) for every frame
× view, the colour move and the quantize on the device, one fetch a
(group, batch, device). Progress (≥5 %% steps), cooperative stop via an
Event and the overwrite guard behave as in the JAX executor.

The device is explicit: :func:`run_plan` takes a :class:`torch.device`
and passes it down; video mode on a CUDA device takes every visible card,
whichever card ``device`` names, as the JAX executor takes every chip. ``backend`` keeps the JAX spelling: ``auto`` and
``pallas`` send every view group through the CUDA kernel wrapper
(:mod:`gs360x_torch.kernels.warp_cuda`), which launches the kernels on a
CUDA device and runs their plain versions on a CPU device; ``xla`` runs
the plain torch twin on either. Every view group of every preset (yaw
ring, tilted, rolled, pole and fisheye views) launches the kernels on a
CUDA device: ``--backend xla`` is the only way to the plain twin there.
"""

from __future__ import annotations

import functools
import math
import os
import pathlib
import sys
import threading
import time
import warnings
from dataclasses import dataclass, field
from operator import add
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gs360x_torch.io import image as imagelib
from gs360x_torch.io import video as videolib
from gs360x_torch.runtime.prefetch import Prefetcher, decode_overlap
from gs360x_torch.runtime.profiling import (StageTimers, WindowCounter,
                                            maybe_trace, span)
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.kernels.warp import view_rotation
from gs360x_torch.rig.spec import RenderPlan
from gs360x_torch.runtime import mesh as meshlib

PROGRESS_INTERVAL = 5
# video mode on the card: frames a batch over the mesh, the JAX executor's
# per_launch on an accelerator (on one card, frames a launch). On a
# 200-frame 8K clip its wall matched 1 frame a launch within the spread of
# runs in turns (video_batch_ab.py; PERF.md, the batched video path)
CARD_FRAMES_PER_LAUNCH = 4

# video mode's batches: (start on time.perf_counter, frames warped)
_WARPED = WindowCounter(frames=add)


def video_frames_warped(start: Optional[float] = None,
                        end: Optional[float] = None) -> int:
    """The frames video mode's batches warped in this process (the mesh's
    pad not counted); given ``start`` and ``end`` (``time.perf_counter``),
    only those of the newest 65536 batches that started in [start, end)."""
    return _WARPED.read(start, end)["frames"]


# both modes' warps: (start on time.perf_counter, view-frames, those off the
# horizon, those holding a pole), one event a warped frame or batch
_VIEWS = WindowCounter(views=add, off_horizon=add, pole=add)


def view_counts(start: Optional[float] = None,
                end: Optional[float] = None) -> dict:
    """``{"views", "off_horizon", "pole"}``: the view-frames (views ×
    frames, the mesh's pad not counted) that both modes' warps carried in
    this process, those pitched or rolled off the horizon, and those whose
    frustum holds a pole (:func:`holds_pole`); given ``start`` and
    ``end`` (``time.perf_counter``), only those of the newest 65536 warped
    frames or batches that started in [start, end)."""
    return _VIEWS.read(start, end)


@functools.lru_cache(maxsize=1024)
def holds_pole(view) -> bool:
    """Whether ``view``'s frustum holds the zenith or the nadir, (0, ∓1, 0)
    in the warp frame (y down): turned into the camera's frame by the
    transpose of the view's rotation, a pole lies ahead and within both
    half-FOV tangents of a perspective view, or within half the FOV of a
    fisheye view's axis. Host arithmetic, once a view."""
    r = view_rotation(*(torch.tensor(a, dtype=torch.float64) for a in (
        view.yaw_deg, view.pitch_deg, view.roll_deg))).numpy()
    half_h = math.radians(view.hfov_deg) / 2
    half_v = math.radians(view.vfov_deg) / 2
    for x, y, z in (r[1], -r[1]):        # Rᵀ (0, ±1, 0)
        if view.projection == "perspective":
            if z > 0 and abs(x) <= z * math.tan(half_h) \
                    and abs(y) <= z * math.tan(half_v):
                return True
        elif math.acos(min(1.0, max(-1.0, z))) <= half_h:
            return True
    return False


def _view_classes(views) -> Tuple[int, int]:
    """(views off the horizon, views holding a pole) of ``views``."""
    return (sum(v.pitch_deg != 0 or v.roll_deg != 0 for v in views),
            sum(holds_pole(v) for v in views))


@dataclass
class ExecutionReport:
    ok: int = 0
    failed: int = 0
    skipped: int = 0
    total: int = 0
    seconds: float = 0.0
    errors: List[str] = field(default_factory=list)
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def stopped(self) -> bool:
        return self.ok + self.failed + self.skipped < self.total


class ProgressPrinter:
    """Throttled single-line progress, same cadence as 360PerspCut's."""

    def __init__(self, label: str = "Progress", stream=None):
        self.label = label
        self._stream = stream  # None -> current sys.stdout at write time
        self._last = -1

    @property
    def stream(self):
        return self._stream if self._stream is not None else sys.stdout

    def update(self, completed: int, total: int) -> None:
        if total <= 0:
            return
        pct = int(completed * 100 / total)
        if self._last < 0 or pct >= 100 or (pct - self._last) >= PROGRESS_INTERVAL:
            self.stream.write(f"{self.label}... {pct:3d}% ({completed}/{total})\r")
            self.stream.flush()
            self._last = pct

    def finish(self) -> None:
        if self._last >= 0:
            self.stream.write("\n")
            self.stream.flush()


def _decode_width() -> int:
    """The decode threads of image mode and of video mode on an MJPEG-AVI
    clip: one a core, at most 8. They share the cores with the encoders,
    one a core at ``-j auto``: on the 8 cores of an H100's host, where
    decode is ~40% of an 8K frame's CPU time, 6 or 8 threads ran ~15-20%
    more frames a second than 4 (PERF.md)."""
    return min(8, os.cpu_count() or 1)


def _quantize_dtype(bit_depth: int) -> torch.dtype:
    return torch.uint16 if bit_depth > 8 else torch.uint8


def _quantize_device(arr: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """Round float [0,1] to uint8/uint16 on the device (device→host
    transfers shrink 4x, 2x for 16-bit), half to even like ``jnp.rint``:
    four passes over ``arr``. Where nothing stands between a warp or remap
    kernel and the quantize, the kernel's ``out_dtype`` store gives the
    same bits without them."""
    return warp_cuda.quantize_plain(arr, _quantize_dtype(bit_depth))


def upload_rows(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    """A decoded (H, W, 3) host frame on ``device`` as (H, W·3) rows in its
    own dtype, a texel decode (:func:`imagelib.is_texel_decode`) as its
    (H, W, 4) RGBX texels: one host→device copy of the frame's bytes."""
    h, w = frame.shape[:2]
    if not imagelib.is_texel_decode(frame):
        frame = np.ascontiguousarray(frame).reshape(h, w * 3)
    with warnings.catch_warnings():
        # decoders hand out read-only arrays; nothing here writes to them
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(frame).to(device)


def _view_groups(views) -> Dict[tuple, List[int]]:
    """Views that share one warp launch: same projection, size and FOV.
    Maps ``(projection, w, h, hfov, vfov)`` to view indices."""
    groups: Dict[tuple, List[int]] = {}
    for i, view in enumerate(views):
        key = (view.projection, view.width, view.height,
               round(view.hfov_deg, 6), round(view.vfov_deg, 6))
        groups.setdefault(key, []).append(i)
    return groups


def _group_angles(views, idxs):
    return tuple(np.array([getattr(views[i], name) for i in idxs], np.float64)
                 for name in ("yaw_deg", "pitch_deg", "roll_deg"))


def _warp_frame_views(frame: np.ndarray, views, *, interp: str,
                      backend: str, device: torch.device,
                      quantize_bits: Optional[int] = None):
    """Warp one decoded frame through all plan views.

    Returns [(parent, view_idx), ...] in view order, where ``parent`` is
    the group's batched planar (V, 3, h, w) device result shared across
    its views (fetched once by :class:`_ViewFetcher`; the channel
    interleave happens in the encode threads). The frame goes to the
    device once (:func:`upload_rows`), as (H, W·3) rows in its own dtype
    or, decoded with ``read_image(..., texels=True)``, as the RGBX texels
    the kernel reads. The kernel's own store quantizes (the plain twin's
    views, ``--backend xla``, go through :func:`_quantize_device`). Video
    mode takes :func:`_warp_frames_batch`. The views count in
    :func:`view_counts`.
    """
    t0 = time.perf_counter()
    results: List = [None] * len(views)
    rows = upload_rows(frame, device)

    warp = (warp_cuda.warp_equirect_to_views_plain if backend == "xla"
            else warp_cuda.warp_equirect_to_views_cuda)
    # the plain twin (--backend xla) has no quantizing store
    fused = quantize_bits is not None and backend != "xla"
    store = dict(out_dtype=_quantize_dtype(quantize_bits)) if fused else {}
    for (projection, vw, vh, hfov, vfov), idxs in _view_groups(views).items():
        yaws, pitches, rolls = _group_angles(views, idxs)
        out = warp(rows, yaws, pitches, rolls, width=vw, height=vh,
                   hfov_deg=hfov, vfov_deg=vfov, projection=projection,
                   interp=interp, planar=True, **store)
        if quantize_bits is not None and not fused:
            out = _quantize_device(out, quantize_bits)
        for j, i in enumerate(idxs):
            results[i] = (out, j)
    off_horizon, pole = _view_classes(views)
    _VIEWS.add(t0, views=len(views), off_horizon=off_horizon, pole=pole)
    return results


class _ViewFetcher:
    """Lazy bulk fetch for per-view warp outputs: each distinct parent is
    copied to the host exactly once, on first use — one transfer per
    (group, frame) instead of one per view, while overwrite-skipped
    entries stay free."""

    def __init__(self, timers):
        self._timers = timers
        self._cache: Dict[int, np.ndarray] = {}

    def __call__(self, parent, view_idx):
        buf = self._cache.get(id(parent))
        if buf is None:
            with self._timers.stage("fetch"):
                buf = parent.cpu().numpy()
            self._cache[id(parent)] = buf
        return buf if view_idx is None else buf[view_idx]


def run_plan(plan: RenderPlan, *,
             device: torch.device,
             backend: str = "auto",
             overwrite: bool = True,
             writer_workers: int = 8,
             stop_event: Optional[threading.Event] = None,
             progress: Optional[Callable[[int, int], None]] = None,
             quiet: bool = False,
             stats: bool = False) -> ExecutionReport:
    """Execute a RenderPlan (image-dir or video mode) on ``device``."""
    t0, t_run = time.time(), time.perf_counter()
    stop_event = stop_event or threading.Event()
    report = ExecutionReport(total=plan.total if not plan.video_mode else 0)
    out_dir = plan.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    printer = None if quiet else ProgressPrinter()

    def tick(done: int, total: int) -> None:
        if progress:
            progress(done, total)
        if printer:
            printer.update(done, total)

    jpeg_quality = 95 if plan.jpeg_quality_95 else None
    interp = plan.interpolation

    timers = StageTimers()
    with maybe_trace("run_plan"), \
            imagelib.AsyncImageWriter(workers=writer_workers,
                                      timers=timers) as writer:
        run = _run_video if plan.video_mode else _run_images
        run(plan, writer, report, stop_event, tick, backend, device, interp,
            jpeg_quality, overwrite, timers)
    if printer:
        printer.finish()
    report.seconds = time.time() - t0
    report.stage_seconds = dict(timers.totals)
    if stats and not quiet:
        texels = imagelib.texel_decode_counts()
        pool = decode_overlap()
        views = view_counts(t_run, time.perf_counter())
        mode = (f" | decodes overlapped {pool['overlapped']} of "
                f"{pool['decodes']}, width {pool['width']}")
        if plan.video_mode:
            counts = videolib.open_counts()
            mode = (f" | video opens {counts['opens']}, "
                    f"{counts['bytes']} bytes" + mode)
        print(f"[STATS] {timers.report()} | wall {report.seconds:.2f}s | "
              f"texel decodes {texels['served']} of {texels['requested']} | "
              f"views {views['views']} (off-horizon {views['off_horizon']}, "
              f"pole {views['pole']})" + mode)
    return report


def _run_images(plan, writer, report, stop_event, tick, backend, device,
                interp, jpeg_quality, overwrite, timers) -> None:
    by_source: Dict[pathlib.Path, List] = {}
    for job in plan.jobs:
        by_source.setdefault(job.source, []).append(job)

    done = 0
    work = []  # (source, jobs-to-run) after the overwrite guard
    for source, jobs in by_source.items():
        todo = []
        for job in jobs:
            out_path = plan.out_dir / job.output_name
            if not overwrite and out_path.exists():
                report.skipped += 1
                done += 1
            else:
                todo.append(job)
        if todo:
            work.append((source, todo))
    tick(done, report.total)

    def decode(item):
        source, jobs = item
        try:
            with timers.stage("decode"):
                img = imagelib.read_image(source, texels=True)
        except Exception as exc:
            return source, jobs, None, exc
        return source, jobs, img, None

    inflight = None  # (jobs, outs) warped on device, not yet fetched

    def drain(entry):
        nonlocal done
        jobs, outs = entry
        fetch = _ViewFetcher(timers)
        for job, (out, j) in zip(jobs, outs):
            img = fetch(out, j)
            writer.submit(plan.out_dir / job.output_name, img,
                          jpeg_quality=jpeg_quality, planar=True)
            report.ok += 1
            done += 1
            tick(done, report.total)

    # software pipeline: decode N+1.. (a pool of threads, in order) ||
    # warp N+1 (device queue) || fetch+encode N (here + writer pool)
    for source, jobs, src, exc in Prefetcher(work, stop_event,
                                             timers=timers, decode=decode,
                                             width=_decode_width()):
        if stop_event.is_set():
            return
        if exc is not None:
            report.failed += len(jobs)
            report.errors.append(f"{source.name}: {exc}")
            done += len(jobs)
            tick(done, report.total)
            continue
        with timers.stage("warp_dispatch"):
            outs = _warp_frame_views(
                src, [j.view for j in jobs], interp=interp, backend=backend,
                device=device,
                quantize_bits=16 if plan.bit_depth > 8 else 8)
        if inflight is not None:
            drain(inflight)
        inflight = (jobs, outs)
    if inflight is not None and not stop_event.is_set():
        drain(inflight)


def _warp_frames_batch(frames, views, *, interp, keep_rec709,
                       quantize_bits, mesh, backend="auto"):
    """Warp a batch of decoded (H, W, 3) frames through all plan views over
    ``mesh``: the stacked batch (padded to a multiple of the mesh size by
    :func:`meshlib.pad_to_mesh`) goes to the devices once, then each view
    group is one :func:`meshlib.warp_frames_sharded_cuda` call (``auto``,
    ``pallas``: one source pass and one warp launch a device, planar
    outputs) or one :func:`meshlib.warp_frames_sharded` call (``xla``: the
    plain twin, channel-last outputs), colour move and quantize on the
    device. Returns, for each frame, ``[(block, (frame in block, view in
    group), planar), ...]`` in view order: each (group, device) block is
    shared by its frames and views, so :class:`_ViewFetcher` copies it to
    the host once, and the mesh's pad is sliced off before any copy. The
    stack and the pad are a ``batch_stack`` span, the copies to the
    devices a ``batch_upload`` span, the frames count in
    :func:`video_frames_warped` and their views in :func:`view_counts`."""
    t0 = time.perf_counter()
    results: List[List] = [[None] * len(views) for _ in frames]
    with span("batch_stack"):
        # one frame goes up as it is: np.stack would copy it first
        stacked = np.stack(frames) if len(frames) > 1 else frames[0][None]
        padded = meshlib.pad_to_mesh(mesh, stacked)
    with span("batch_upload"):
        batch = meshlib.shard_frames(mesh, padded)
    warp = (meshlib.warp_frames_sharded if backend == "xla"
            else meshlib.warp_frames_sharded_cuda)
    for (projection, vw, vh, hfov, vfov), idxs in _view_groups(views).items():
        blocks = warp(mesh, batch, *_group_angles(views, idxs), width=vw,
                      height=vh, hfov_deg=hfov, vfov_deg=vfov,
                      interp=interp, projection=projection,
                      keep_rec709=keep_rec709, quantize_bits=quantize_bits)
        f = 0
        for block in meshlib.drop_tail(blocks, len(frames)):
            for local in range(len(block)):
                for j, i in enumerate(idxs):
                    results[f][i] = (block, (local, j), backend != "xla")
                f += 1
    n = len(frames)
    off_horizon, pole = _view_classes(views)
    _WARPED.add(t0, frames=n)
    _VIEWS.add(t0, views=n * len(views), off_horizon=n * off_horizon,
               pole=n * pole)
    return results


def _run_video_sharded(plan, writer, report, stop_event, tick, interp,
                       jpeg_quality, overwrite, timers, n_batch, mesh,
                       backend="auto") -> None:
    """Batched video path: frames batch ``n_batch`` at a time (a multiple
    of the mesh size), split over ``mesh``, and every frame × view of a
    view group goes through one launch a device. Batch k+1 is dispatched
    before batch k is fetched; every upload, launch and fetch stays on
    PyTorch's current stream, and each batch has its own outputs. Output
    names keep the source's frame index. An MJPEG-AVI clip's frames decode
    on :func:`_decode_width` threads, each source frame once however many
    ticks take it; a Y4M or ffmpeg stream on one thread."""
    source = plan.jobs[0].source
    views = plan.unique_views()
    name_patterns = [plan.jobs[i].output_name for i in range(len(views))]
    qbits = 16 if plan.bit_depth > 8 else 8
    groups, decode = videolib.source_frames(source, fps=plan.fps,
                                            start=plan.start_time,
                                            end=plan.end_time)
    selected = plan.selected_frames
    if selected is not None:
        # CSV frame selection, the original numbering kept: a source frame
        # none of whose ticks is selected is dropped before its decode
        groups = ((item, kept) for item, ticks in groups
                  if (kept := [tick for tick in ticks if tick[0] in selected]))
    done = 0
    total_est = report.total
    pending = None  # (idxs, results) on the devices, not yet fetched

    def drain(entry):
        nonlocal done
        idxs, results = entry
        fetch = _ViewFetcher(timers)
        for idx, outs in zip(idxs, results):
            for pattern, (out, j, planar) in zip(name_patterns, outs):
                name = pattern.replace("%07d", f"{idx:07d}")
                out_path = plan.out_dir / name
                if not overwrite and out_path.exists():
                    report.skipped += 1
                else:
                    writer.submit(out_path, fetch(out, j),
                                  jpeg_quality=jpeg_quality, planar=planar)
                    report.ok += 1
                done += 1
                if total_est:
                    tick(done, total_est)

    batch_idx: List = []
    batch_rgb: List = []

    def flush():
        nonlocal pending, batch_idx, batch_rgb
        if not batch_rgb:
            return
        with timers.stage("warp_dispatch"):
            results = _warp_frames_batch(
                batch_rgb, views, interp=interp,
                keep_rec709=plan.keep_rec709,
                quantize_bits=qbits, mesh=mesh, backend=backend)
        if pending is not None:
            drain(pending)
        pending = (batch_idx, results)
        batch_idx, batch_rgb = [], []

    if decode is None:
        # a stream read in order decodes in each next(): one thread
        stage = Prefetcher(timers.wrap_iter("decode", groups), stop_event,
                           depth=n_batch + 2, timers=timers)
    else:
        def decoded(group):
            item, ticks = group
            with timers.stage("decode"):
                return decode(item), ticks

        # MJPEG-AVI: each frame's JPEG on image mode's pool, in order
        stage = Prefetcher(groups, stop_event, depth=n_batch + 2,
                           timers=timers, decode=decoded,
                           width=_decode_width())
    # width + n_batch + 2 source frames taken and not yet passed
    for rgb, ticks in stage:
        if stop_event.is_set():
            return
        rgb = np.ascontiguousarray(rgb)
        for idx, _t in ticks:
            batch_idx.append(idx)
            batch_rgb.append(rgb)
            if len(batch_rgb) == n_batch:
                flush()
    flush()
    if pending is not None and not stop_event.is_set():
        drain(pending)
    report.total = done


def _run_video(plan, writer, report, stop_event, tick, backend, device,
               interp, jpeg_quality, overwrite, timers) -> None:
    """Video mode: every backend takes the batched path. On a CUDA device
    the mesh is every visible card, whichever card ``device`` names (as
    the JAX executor takes every chip; ``CUDA_VISIBLE_DEVICES`` narrows
    it), and a batch holds :data:`CARD_FRAMES_PER_LAUNCH` frames spread
    over the mesh, at least one a card (``n_dev · ceil(4 / n_dev)``, the
    JAX executor's rule); on the CPU, a 1-device mesh of ``device`` and
    one frame a batch."""
    info = videolib.probe_video(plan.jobs[0].source)
    est_frames = None
    if info.n_frames and info.fps and plan.fps:
        span = info.n_frames / info.fps
        if plan.start_time or plan.end_time:
            t0 = plan.start_time or 0.0
            t1 = min(plan.end_time, span) if plan.end_time else span
            span = max(0.0, t1 - t0)
        est_frames = int(span * plan.fps) + 1
    report.total = (est_frames or 0) * len(plan.unique_views())

    if device.type == "cuda":
        mesh, per_launch = meshlib.data_mesh(), CARD_FRAMES_PER_LAUNCH
    else:
        mesh, per_launch = meshlib.data_mesh([device]), 1
    n_dev = mesh.size
    n_batch = n_dev * max(1, -(-per_launch // n_dev))
    _run_video_sharded(plan, writer, report, stop_event, tick, interp,
                       jpeg_quality, overwrite, timers, n_batch, mesh,
                       backend=backend)
