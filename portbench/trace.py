"""Reading the traced window: a ``torch.profiler`` Chrome trace of the
window, the harness's own host spans, and what the per-layer readers and
the result line's ``device`` and ``breakdown`` take from them.

The window is the span of the ``portbench.window`` annotation the harness
opens when the window starts. Device operations are the trace's kernels,
copies and fills; the device is busy where at least one runs: the union of
their intervals inside the window, swept in start order
(``runtime/profiling.read_trace``'s arithmetic, which counts kernels
only: a copy engine moving a frame is the device at work too).
"""

from __future__ import annotations

import json
import pathlib
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from portbench.work import family

WINDOW_LABEL = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
          ) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, idle gaps) of [start, end) intervals clipped to
    [lo, hi): the sweep of ``read_trace``, with the gaps it steps over."""
    busy, reach, gaps = 0.0, lo, []
    for start, end in sorted(intervals):
        a, b = max(start, reach), min(end, hi)
        if a > reach and reach < hi:
            gaps.append((reach, min(a, hi)))
        if b > a:
            busy += b - a
        reach = max(reach, min(end, hi))
    if reach < hi:
        gaps.append((reach, hi))
    return busy, gaps


class Trace:
    """The device operations of one traced window, in µs of the trace's
    clock."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == WINDOW_LABEL]
        if len(spans) != 1:
            raise ValueError(f"{len(spans)} {WINDOW_LABEL!r} annotations "
                             "in the trace, expected 1")
        self.start = float(spans[0]["ts"])
        self.window_us = float(spans[0]["dur"])
        self.end = self.start + self.window_us
        self.ops = [(e["cat"], e["name"], float(e["ts"]), float(e["dur"]))
                    for e in events if e.get("cat") in DEVICE_CATS
                    and float(e["ts"]) < self.end
                    and float(e["ts"]) + float(e["dur"]) > self.start]
        self.busy_us, self.gaps = union(
            [(ts, ts + dur) for _c, _n, ts, dur in self.ops],
            self.start, self.end)

    @classmethod
    def load(cls, path: pathlib.Path) -> "Trace":
        return cls(json.loads(pathlib.Path(path).read_text())["traceEvents"])

    def kernels(self) -> List[Tuple[str, float]]:
        """(name, µs) of each kernel in the window."""
        return [(n, d) for c, n, _t, d in self.ops if c == "kernel"]

    def top_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations with the most time, by name: [name,
        seconds]."""
        total: Dict[str, float] = defaultdict(float)
        for _c, name, _t, dur in self.ops:
            total[name] += dur
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], us / 1e6] for name, us in ranked]

    def labelled_gaps(self, spans: Sequence[Tuple[str, float, float]],
                      anchor: float, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps, each named by the host spans
        (kind, start, end in seconds of the host clock) that cover at
        least half of it, joined by ``+`` (``host`` where none does):
        [name, seconds]. ``anchor`` is the host time at which the window
        annotation opened."""
        def host_us(t):
            return self.start + (t - anchor) * 1e6
        out = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]:
            by_kind: Dict[str, list] = defaultdict(list)
            for kind, s, e in spans:
                by_kind[kind].append((host_us(s), host_us(e)))
            kinds = sorted(k for k, iv in by_kind.items()
                           if union(iv, a, b)[0] >= 0.5 * (b - a))
            out.append(["+".join(kinds) or "host", (b - a) / 1e6])
        return out

    def idle_pct(self) -> float:
        """100 × (1 − busy ÷ window)."""
        return 100.0 * (1.0 - self.busy_us / self.window_us)

    def family_us(self, fam: str) -> List[float]:
        """The durations (µs) of the window's kernels of one launch
        family (``work.family``)."""
        return [d for n, d in self.kernels() if family(n) == fam]
