"""Output-folder progress monitor (reference ``gs360_GUI.py:19196-19267``).

During a video export the tool process reports frame progress on its own
cadence; the reference additionally polls the OUTPUT FOLDER and reports
file-count progress so the user sees work landing on disk even when the
tool's stdout stalls (e.g. long encoder queues). Headless core —
the Tk tab supplies the ``report`` callback.
"""

from __future__ import annotations

import fnmatch
import pathlib
import threading
from typing import Callable, Optional, Sequence

PROGRESS_INTERVAL = 5


def count_matches(out_dir: pathlib.Path, patterns: Sequence[str]) -> int:
    """Count files in ``out_dir`` matching any of the glob patterns."""
    try:
        names = [p.name for p in out_dir.iterdir() if p.is_file()]
    except OSError:
        return 0
    return sum(1 for n in names
               if any(fnmatch.fnmatch(n, pat) for pat in patterns))


def patterns_for_outputs(output_names: Sequence[str]) -> list:
    """Job output names -> glob patterns (%07d frame slots become *)."""
    pats = set()
    for name in output_names:
        pats.add(name.replace("%07d", "*") if "%07d" in name else name)
    return sorted(pats)


class OutputMonitor:
    """Polls an output folder and reports (pct, done, total) on growth.

    Progress is stepped at PROGRESS_INTERVAL percent like the tools' own
    progress lines; the baseline count is taken at start so resumed runs
    don't over-report.
    """

    def __init__(self, out_dir, patterns: Sequence[str], total_units: int,
                 report: Callable[[int, int, int], None],
                 interval_sec: float = 10.0):
        self.out_dir = pathlib.Path(out_dir)
        self.patterns = list(patterns)
        self.total_units = int(total_units)
        self.report = report
        self.interval_sec = interval_sec
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_pct = -1
        self._last_seen = -1

    # headless-testable single step
    def poll_once(self, initial_count: int) -> bool:
        """One poll; returns True when the monitor should keep running."""
        current = count_matches(self.out_dir, self.patterns)
        done = max(0, current - initial_count)
        if self.total_units > 0:
            done = min(self.total_units, done)
            pct = int(done * 100 / self.total_units)
            if done != self._last_seen:
                if (pct == 100 or self._last_pct < 0
                        or (pct - self._last_pct) >= PROGRESS_INTERVAL):
                    self._last_pct = pct
                    self.report(pct, done, self.total_units)
            self._last_seen = done
            return done < self.total_units
        # unknown total: report raw growth, run until stopped
        if done != self._last_seen:
            self.report(-1, done, 0)
        self._last_seen = done
        return True

    def _loop(self, initial_count: int) -> None:
        while not self._stop.is_set():
            if not self.poll_once(initial_count):
                break
            self._stop.wait(self.interval_sec)
        self._stop.set()

    def start(self) -> bool:
        if not self.out_dir.exists() or not self.patterns:
            return False
        initial = count_matches(self.out_dir, self.patterns)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(initial,), daemon=True,
            name="output-monitor")
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
