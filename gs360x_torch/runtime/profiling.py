"""Per-stage timers for the streaming pipelines (the port's copy of
:class:`StageTimers`): accumulated per-stage wall clock (decode / warp /
fetch / encode) surfaced on the execution report; and :func:`cuda_ms`, the
device time of a call taken with CUDA events.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
import statistics
from contextlib import contextmanager
from typing import Callable, Dict, Iterator

import torch


class StageTimers:
    """Thread-safe accumulated wall-clock per named pipeline stage.

    Stages run concurrently (decode in the prefetch thread, fetch/encode
    in the main thread), so per-stage sums can exceed the total wall
    clock — that overlap is the point of the pipeline.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
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


__all__ = ["StageTimers", "cuda_ms"]
