"""Per-stage timers for the streaming pipelines (the port's copy of
:class:`StageTimers`): accumulated per-stage wall clock (decode / warp /
fetch / encode) surfaced on the execution report, and every stage's
interval in one process-wide ring (:func:`spans`; :func:`span` puts an
interval there without timers); :class:`WindowCounter`, the counts of one
kind of event with the newest events' starts, read whole or by window;
:func:`maybe_trace`, a
``torch.profiler`` trace of a block when ``GS360X_TRACE_DIR`` is set, with
the ring's spans of the block on the trace's clock, and
:func:`read_trace`, its kernels and the device's busy time in it;
:func:`cuda_ms`, the device time of a call taken with CUDA events; and
:func:`device_ms`, the device time of a call without the host's, from a
CUDA graph's replay.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import pathlib
import threading
import time
from collections import defaultdict, deque
import statistics
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch


# every stage's span, from every StageTimers of the process: (name, the
# thread's native id, start, end, the thread's CPU seconds inside), start
# and end on time.perf_counter. A traced window holds ~2,000 spans. A
# WindowCounter holds as many events.
SPAN_RING = 65536
_SPANS: deque = deque(maxlen=SPAN_RING)


def spans(since: Optional[float] = None) -> List[tuple]:
    """The ring's spans, oldest first, that end after ``since`` (every one
    it holds when None)."""
    held = _SPANS.copy()  # one call: atomic against the appends
    if since is None:
        return list(held)
    return [s for s in held if s[3] > since]


class WindowCounter:
    """The counts of one kind of event in this process: their totals, and
    the newest ``SPAN_RING`` events, each with its start on
    ``time.perf_counter``, under one lock. ``combine`` names each count and
    how two of its values make one (``operator.add`` sums, ``max`` keeps
    the largest); counts start at 0."""

    def __init__(self, **combine: Callable[[int, int], int]) -> None:
        self._names = tuple(combine)
        self._combine = tuple(combine.values())
        self._zero = (0,) * len(combine)
        self._lock = threading.Lock()
        self._totals = self._zero
        self._events: deque = deque(maxlen=SPAN_RING)

    def _fold(self, acc: tuple, row: tuple) -> tuple:
        return tuple(f(a, v) for f, a, v in zip(self._combine, acc, row))

    def add(self, start: float, **values: int) -> None:
        """One event that started at ``start``, with its value of every
        count."""
        row = tuple(values[name] for name in self._names)
        with self._lock:
            self._totals = self._fold(self._totals, row)
            self._events.append((start, row))

    def read(self, start: Optional[float] = None,
             end: Optional[float] = None) -> dict:
        """The totals by name; given ``start`` and ``end``, the counts of
        the held events that started in [start, end)."""
        with self._lock:
            rows = ([self._totals] if start is None else
                    [row for t, row in self._events if start <= t < end])
        return dict(zip(self._names,
                        functools.reduce(self._fold, rows, self._zero)))


@contextmanager
def span(name: str):
    """One interval of the block in the ring (:func:`spans`), as a
    :class:`StageTimers` stage records it, for code that keeps no timers
    (a video reader's open, a batch's stack and upload, the colour
    move)."""
    t0 = time.perf_counter()
    cpu0 = time.thread_time()
    try:
        yield
    finally:
        _SPANS.append((name, threading.get_native_id(), t0,
                       time.perf_counter(), time.thread_time() - cpu0))


class StageTimers:
    """Thread-safe accumulated wall-clock per named pipeline stage.

    Stages run concurrently (decode in the prefetch thread, fetch/encode
    in the main thread), so per-stage sums can exceed the total wall
    clock — that overlap is the point of the pipeline. Each stage's span
    also goes to the process's ring (:func:`spans`).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        cpu0 = time.thread_time()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            _SPANS.append((name, threading.get_native_id(), t0, t1,
                           time.thread_time() - cpu0))
            with self._lock:
                self.totals[name] += t1 - t0
                self.counts[name] += 1

    def wrap_iter(self, name: str, iterator) -> Iterator:
        """Time each ``next()`` of an iterator (e.g. the decode source
        driven from the prefetch thread)."""
        it = iter(iterator)
        while True:
            with self.stage(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def report(self) -> str:
        with self._lock:
            parts = [f"{k} {self.totals[k]:.2f}s/{self.counts[k]}"
                     for k in sorted(self.totals)]
        return " | ".join(parts) if parts else "no stages recorded"


SPAN_CAT = "gs360x_span"


@contextmanager
def maybe_trace(label: str = "gs360x"):
    """A ``torch.profiler`` trace of the block, active only when
    ``GS360X_TRACE_DIR`` is set (so production runs pay nothing): host ops
    and, with a card, every kernel and copy on it, whichever thread
    launched them, under a ``label`` annotation that spans the block. On
    exit the TensorBoard trace (``*.pt.trace.json``) is written under
    ``<GS360X_TRACE_DIR>/<label>/``, the directory the JAX package's
    ``jax.profiler`` trace goes to, and the ring's spans that ended in the
    block are added to it (:func:`_merge_spans`): the decode, loop and
    writer threads' stages on one timeline with the kernels and copies."""
    trace_dir = os.environ.get("GS360X_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)

    out_dir = pathlib.Path(trace_dir, label)
    export = tensorboard_trace_handler(str(out_dir))
    written: List[pathlib.Path] = []

    def on_trace_ready(prof) -> None:
        before = set(out_dir.glob("*.pt.trace.json"))
        export(prof)
        written.extend(sorted(set(out_dir.glob("*.pt.trace.json")) - before))

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=on_trace_ready):
        # read just before the annotation opens: its timestamp is taken as
        # the call starts, and a profile's first annotation then takes ~1
        # ms more before it returns
        anchor = time.perf_counter()
        with record_function(label):
            yield
    for path in written:
        _merge_spans(path, label, anchor, spans(since=anchor))


def _merge_spans(path, label: str, anchor: float, held: List[tuple]) -> None:
    """Add ``held`` spans (:func:`spans`' tuples) to the Chrome trace at
    ``path`` as ``"ph": "X"`` events of category ``gs360x_span``, each on
    its thread's row (``tid``, the native id the profiler's host events
    carry), with ``args.cpu_ms``. A span starting ``t0`` lands at the
    ``label`` annotation's ``ts`` + (``t0`` − ``anchor``) µs, ``anchor``
    being ``time.perf_counter()`` just before the annotation opened."""
    path = pathlib.Path(path)
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == label]
    if len(ann) != 1:
        raise ValueError(f"_merge_spans: {len(ann)} {label!r} annotations")
    origin, pid = float(ann[0]["ts"]), ann[0].get("pid", os.getpid())
    events.extend({"ph": "X", "cat": SPAN_CAT, "name": name, "pid": pid,
                   "tid": tid, "ts": origin + (t0 - anchor) * 1e6,
                   "dur": (t1 - t0) * 1e6, "args": {"cpu_ms": cpu * 1e3}}
                  for name, tid, t0, t1, cpu in held)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(trace))
    os.replace(tmp, path)


def read_trace(trace_dir, label: str = "run_plan") -> dict:
    """What the one trace :func:`maybe_trace` wrote under
    ``<trace_dir>/<label>/`` shows: ``kernels``, the kernel events on the
    device (name, start and duration in µs), ``window_us``, the span of the
    ``label`` annotation, and ``busy_us``, the time in it during which at
    least one kernel ran (the union of the kernels' intervals)."""
    files = list(pathlib.Path(trace_dir, label).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise ValueError(f"read_trace: {len(files)} traces under "
                         f"{pathlib.Path(trace_dir, label)}, expected 1")
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == label]
    if len(spans) != 1:
        raise ValueError(f"read_trace: {len(spans)} {label!r} annotations")
    start, window = spans[0]["ts"], spans[0]["dur"]
    end = start + window
    kernels = [(e["name"], e["ts"], e["dur"]) for e in events
               if e.get("cat") == "kernel"]
    busy, reach = 0.0, start
    for _, ts, dur in sorted(kernels, key=lambda k: k[1]):
        lo, hi = max(ts, reach), min(ts + dur, end)
        if hi > lo:
            busy += hi - lo
        reach = max(reach, min(ts + dur, end))
    return {"kernels": kernels, "window_us": window, "busy_us": busy}


def cuda_ms(fn: Callable[[], object], reps: int = 10, batches: int = 5,
            warmup: int = 2) -> float:
    """Device time of one ``fn`` in ms: CUDA events around ``reps`` runs
    issued back to back, so the host's work for the next launch overlaps
    the device's run (a host clock around one call would time the host);
    the median over ``batches`` such means."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


# device_ms: calls captured in one graph, warm-up calls before the
# capture, and timed replays (the median is kept)
DEVICE_REPS, DEVICE_WARMUP, DEVICE_BATCHES = 10, 2, 5
_CU_GRAPH_NODE_TYPE_KERNEL = 0


def kernel_nodes(raw_graph: int) -> int:
    """Kernel nodes of a captured ``cudaGraph_t`` (the driver's
    ``cuGraphGetNodes`` and ``cuGraphNodeGetType``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(raw_graph)
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(graph, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def device_ms(fn: Callable[[], object]) -> Tuple[float, int]:
    """Device time of one ``fn`` in ms without the host's time, and the
    kernels a call launches. ``DEVICE_REPS`` calls of ``fn`` are captured in
    one CUDA graph; its kernel nodes give the kernels a call launches, and
    CUDA events around one replay, issued behind another replay so that the
    device is busy when it reaches the first event, give the device time of
    the calls back to back, with no host time between them; the median over
    ``DEVICE_BATCHES`` replays, divided by the calls. Where a call's host
    work (a wrapper's tens of µs) is longer than its kernel, :func:`cuda_ms`
    times the host; this does not. Every launch runs and is timed whole.
    Raises when there is no CUDA device, when ``fn`` does what a capture
    forbids, or when its kernels are not the same in every call."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms: no CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(DEVICE_WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(DEVICE_REPS):
            fn()
    kernels = kernel_nodes(graph.raw_cuda_graph())
    if not kernels or kernels % DEVICE_REPS:
        raise RuntimeError(f"device_ms: {kernels} kernels in "
                           f"{DEVICE_REPS} calls")
    graph.instantiate()
    times = []
    for _ in range(DEVICE_BATCHES):
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / DEVICE_REPS)
    return statistics.median(times), kernels // DEVICE_REPS


__all__ = ["StageTimers", "spans", "maybe_trace", "read_trace", "cuda_ms",
           "device_ms"]
