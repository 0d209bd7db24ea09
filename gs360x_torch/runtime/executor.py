"""RenderPlan executor (port of :mod:`gs360x.runtime.executor`).

Decodes each frame once, uploads it to the device once as u8 (H, W·3)
rows, warps all views of a view group in one launch, quantizes on the
device, fetches once per (group, frame) and streams the encodes through
the async writer pool. Progress (≥5 %% steps), cooperative stop via an
Event and the overwrite guard behave as in the JAX executor.

The device is explicit: :func:`run_plan` takes a :class:`torch.device`
and passes it down. ``backend`` keeps the JAX spelling: ``auto`` and
``pallas`` send every view group through the CUDA kernel wrapper
(:mod:`gs360x_torch.kernels.warp_cuda`), which launches the kernels on a
CUDA device and runs their plain versions on a CPU device; ``xla`` runs
the plain torch twin on either. On a CUDA device a plan with a view
group outside the kernel gate raises ``NotImplementedError`` before any
frame is read: it never quietly runs the plain twin on the card.
"""

from __future__ import annotations

import pathlib
import queue as queuelib
import sys
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gs360x.io import image as imagelib
from gs360x.io import video as videolib
from gs360x.runtime.profiling import StageTimers
from gs360x_torch.core import color as colorlib
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.rig.spec import RenderPlan

PROGRESS_INTERVAL = 5


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


class _Prefetcher:
    """Background decode thread: overlaps host decode/IO of item N+1 with
    device work on item N."""

    _DONE = object()

    def __init__(self, iterator, stop_event, depth: int = 2):
        self._q: "queuelib.Queue" = queuelib.Queue(maxsize=depth)
        self._stop = stop_event
        self._thread = threading.Thread(
            target=self._pump, args=(iterator,), daemon=True)
        self._thread.start()

    def _pump(self, iterator):
        try:
            for item in iterator:
                while True:
                    if self._stop.is_set():
                        return
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queuelib.Full:
                        continue
            self._q.put(self._DONE)
        except Exception as exc:  # surfaced on the consumer side
            self._q.put(exc)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, Exception):
                raise item
            yield item


def _quantize_device(arr: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """Round float [0,1] to uint8/uint16 on the device (device→host
    transfers shrink 4x, 2x for 16-bit). ``torch.round`` rounds half to
    even, like ``jnp.rint``."""
    scale = 65535.0 if bit_depth > 8 else 255.0
    dt = torch.uint16 if bit_depth > 8 else torch.uint8
    return torch.round(torch.clamp(arr, 0.0, 1.0) * scale).to(dt)


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


def _check_kernel_gate(views, backend: str, device: torch.device) -> None:
    """On a CUDA device with the kernel backend, raise before any work if
    a view group lies outside the kernel gate."""
    if device.type != "cuda" or backend == "xla":
        return
    for (projection, *_), idxs in _view_groups(views).items():
        _yaws, pitches, rolls = _group_angles(views, idxs)
        warp_cuda.require_kernel_gate(projection, pitches, rolls)


def _warp_frame_views(frame: np.ndarray, views, *, interp: str,
                      backend: str, device: torch.device,
                      keep_rec709: Optional[bool] = None,
                      quantize_bits: Optional[int] = None):
    """Warp one decoded frame through all plan views.

    Returns [(parent, view_idx), ...] in view order, where ``parent`` is
    the group's batched planar (V, 3, h, w) device result shared across
    its views (fetched once by :class:`_ViewFetcher`; the channel
    interleave happens in the encode threads). The frame goes to the
    device once, as (H, W·3) rows in its own dtype. When ``keep_rec709``
    is not None the video colour move runs on the device, on the warped
    outputs.
    """
    results: List = [None] * len(views)
    h, w = frame.shape[:2]
    with warnings.catch_warnings():
        # decoders hand out read-only arrays; nothing here writes to them
        warnings.filterwarnings("ignore", message=".*not writable.*")
        rows = torch.from_numpy(
            np.ascontiguousarray(frame).reshape(h, w * 3)).to(device)

    warp = (warp_cuda.warp_equirect_to_views_plain if backend == "xla"
            else warp_cuda.warp_equirect_to_views_cuda)
    for (projection, vw, vh, hfov, vfov), idxs in _view_groups(views).items():
        yaws, pitches, rolls = _group_angles(views, idxs)
        out = warp(rows, yaws, pitches, rolls, width=vw, height=vh,
                   hfov_deg=hfov, vfov_deg=vfov, projection=projection,
                   interp=interp, planar=True)
        if keep_rec709 is not None:
            out = colorlib.video_color_move_planar(out,
                                                   keep_rec709=keep_rec709)
        if quantize_bits is not None:
            out = _quantize_device(out, quantize_bits)
        for j, i in enumerate(idxs):
            results[i] = (out, j)
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
    _check_kernel_gate(plan.unique_views(), backend, device)
    t0 = time.time()
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
    with imagelib.AsyncImageWriter(workers=writer_workers) as writer:
        run = _run_video if plan.video_mode else _run_images
        run(plan, writer, report, stop_event, tick, backend, device, interp,
            jpeg_quality, overwrite, timers)
    if printer:
        printer.finish()
    report.seconds = time.time() - t0
    report.stage_seconds = dict(timers.totals)
    if stats and not quiet:
        print(f"[STATS] {timers.report()} | wall {report.seconds:.2f}s")
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

    def decode(items):
        for source, jobs in items:
            try:
                with timers.stage("decode"):
                    img = imagelib.read_image(source)
            except Exception as exc:
                yield source, jobs, None, exc
                continue
            yield source, jobs, img, None

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

    # software pipeline: decode N+1 (thread) || warp N+1 (device queue)
    # || fetch+encode N (here + writer pool)
    for source, jobs, src, exc in _Prefetcher(decode(work), stop_event):
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


def _run_video(plan, writer, report, stop_event, tick, backend, device,
               interp, jpeg_quality, overwrite, timers) -> None:
    """Single-device per-frame video loop: decode N+1 || warp N+1 || fetch
    and encode N. Output names keep the source's frame index."""
    source = plan.jobs[0].source
    views = plan.unique_views()
    name_patterns = [plan.jobs[i].output_name for i in range(len(views))]
    info = videolib.probe_video(source)
    est_frames = None
    if info.n_frames and info.fps and plan.fps:
        span = info.n_frames / info.fps
        if plan.start_time or plan.end_time:
            t0 = plan.start_time or 0.0
            t1 = min(plan.end_time, span) if plan.end_time else span
            span = max(0.0, t1 - t0)
        est_frames = int(span * plan.fps) + 1
    total_est = (est_frames or 0) * len(views)
    report.total = total_est
    qbits = 16 if plan.bit_depth > 8 else 8

    frame_iter = videolib.iter_frames(source, fps=plan.fps, start=plan.start_time,
                                      end=plan.end_time)
    done = 0
    pending = None  # (idx, outs) warped on device, not yet fetched

    def drain(entry):
        nonlocal done
        idx, outs = entry
        fetch = _ViewFetcher(timers)
        for pattern, (out, j) in zip(name_patterns, outs):
            name = pattern.replace("%07d", f"{idx:07d}")
            out_path = plan.out_dir / name
            if not overwrite and out_path.exists():
                report.skipped += 1
            else:
                img = fetch(out, j)
                writer.submit(out_path, img, jpeg_quality=jpeg_quality,
                              planar=True)
                report.ok += 1
            done += 1
            if total_est:
                tick(done, total_est)

    for idx, _t, rgb in _Prefetcher(
            timers.wrap_iter("decode", frame_iter), stop_event):
        if stop_event.is_set():
            return
        if plan.selected_frames is not None \
                and idx not in plan.selected_frames:
            continue  # CSV frame selection: original numbering preserved
        # video colour chain (Rec709 -> SMPTE170M [+ sRGB trc]) on the
        # warped outputs, on the device
        with timers.stage("warp_dispatch"):
            outs = _warp_frame_views(rgb, views, interp=interp,
                                     backend=backend, device=device,
                                     keep_rec709=plan.keep_rec709,
                                     quantize_bits=qbits)
        if pending is not None:
            drain(pending)
        pending = (idx, outs)
    if pending is not None and not stop_event.is_set():
        drain(pending)
    report.total = done
