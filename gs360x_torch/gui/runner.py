"""Subprocess manager for the GUI: single-flight keyed runs with streamed
logs, stop buttons, and a sequential command queue (reference
``gs360_GUI.py:8949-9173``)."""

from __future__ import annotations

import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional, Sequence


class ProcessRunner:
    """Runs one subprocess per key; streams stdout lines to a callback."""

    def __init__(self):
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def is_running(self, key: str) -> bool:
        with self._lock:
            proc = self._procs.get(key)
        return proc is not None and proc.poll() is None

    def run(self, key: str, argv: Sequence[str],
            on_line: Callable[[str], None],
            on_done: Optional[Callable[[int], None]] = None) -> bool:
        """Start argv under ``key``. Returns False if one is already
        running for that key."""
        if self.is_running(key):
            on_line(f"[WARN] {key} is already running\n")
            return False
        proc = subprocess.Popen(list(argv), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                bufsize=1)
        with self._lock:
            self._procs[key] = proc

        def pump():
            assert proc.stdout is not None
            for line in proc.stdout:
                on_line(line)
            rc = proc.wait()
            on_line(f"[exit {rc}]\n")
            if on_done:
                on_done(rc)

        threading.Thread(target=pump, daemon=True).start()
        return True

    def run_queue(self, key: str, argvs: Sequence[Sequence[str]],
                  on_line: Callable[[str], None],
                  on_done: Optional[Callable[[int], None]] = None) -> bool:
        """Run commands sequentially under one key (the dual-fisheye
        Y-then-X extraction pattern, reference ``:9035-9068``)."""
        if self.is_running(key):
            on_line(f"[WARN] {key} is already running\n")
            return False
        argvs = [list(a) for a in argvs]

        def next_cmd(i: int) -> None:
            if i >= len(argvs):
                if on_done:
                    on_done(0)
                return

            def step_done(rc: int) -> None:
                if rc != 0:
                    on_line(f"[ERR] queued step {i + 1} failed (rc={rc}); "
                            "aborting queue\n")
                    if on_done:
                        on_done(rc)
                    return
                next_cmd(i + 1)

            on_line(f"[queue {i + 1}/{len(argvs)}] "
                    + " ".join(argvs[i]) + "\n")
            self.run(key, argvs[i], on_line, step_done)

        next_cmd(0)
        return True

    def stop(self, key: str) -> bool:
        with self._lock:
            proc = self._procs.get(key)
        if proc is None or proc.poll() is not None:
            return False
        proc.terminate()
        return True

    def stop_all(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()


def tool_argv(module: str, args: Sequence[str]) -> List[str]:
    """argv to launch a gs360x_torch tool as a subprocess of this
    interpreter."""
    return [sys.executable, "-m", f"gs360x_torch.tools.{module}", *args]
