"""Memory-adaptive concurrency throttle.

Rebuild of the reference FrameSelector's ``AdaptiveLimiter`` + memory
monitor (``gs360_FrameSelector.py:65-193``): a worker pool's effective
concurrency shrinks by one step whenever system memory crosses the high
water mark (80%%) and grows back below the low water mark (70%%), checked
once a second. Memory usage reads ``psutil`` when present and falls back
to ``/proc/meminfo``; unavailable → the limiter stays at its base target.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

MEMORY_HIGH_WATER = 0.80
MEMORY_LOW_WATER = 0.70
MEMORY_CHECK_INTERVAL = 1.0


def memory_usage_ratio() -> Optional[float]:
    """System memory usage in [0, 1], or None when undeterminable."""
    try:
        import psutil  # type: ignore

        mem = psutil.virtual_memory()
        if mem.total > 0:
            return float(mem.percent) / 100.0
    except Exception:
        pass
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                info[key] = float(rest.strip().split()[0])
        total = info.get("MemTotal", 0.0)
        avail = info.get("MemAvailable")
        if total > 0 and avail is not None:
            return 1.0 - avail / total
    except Exception:
        pass
    return None


class AdaptiveLimiter:
    """Concurrency gate with a dynamically adjustable target."""

    def __init__(self, target: int):
        self._cond = threading.Condition()
        self.base_target = max(1, int(target))
        self._target = self.base_target
        self._running = 0

    @property
    def target(self) -> int:
        return self._target

    def set_target(self, n: int) -> None:
        with self._cond:
            self._target = max(1, min(int(n), self.base_target))
            self._cond.notify_all()

    def __enter__(self):
        with self._cond:
            while self._running >= self._target:
                self._cond.wait(0.5)
            self._running += 1
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._running -= 1
            self._cond.notify_all()
        return False


class MemoryMonitor:
    """Daemon thread nudging a limiter's target by ±1 around the water
    marks (start() is a no-op when memory usage can't be read)."""

    def __init__(self, limiter: AdaptiveLimiter, *,
                 high: float = MEMORY_HIGH_WATER,
                 low: float = MEMORY_LOW_WATER,
                 interval: float = MEMORY_CHECK_INTERVAL):
        self.limiter = limiter
        self.high = high
        self.low = low
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MemoryMonitor":
        if memory_usage_ratio() is not None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            usage = memory_usage_ratio()
            if usage is None:
                continue
            if usage >= self.high:
                self.limiter.set_target(self.limiter.target - 1)
            elif usage <= self.low:
                self.limiter.set_target(self.limiter.target + 1)

    def stop(self) -> None:
        self._stop.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


__all__ = ["AdaptiveLimiter", "MemoryMonitor", "memory_usage_ratio",
           "MEMORY_HIGH_WATER", "MEMORY_LOW_WATER"]
