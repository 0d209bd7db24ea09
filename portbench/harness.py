"""The harness: a cell's files found by name, the window, the host spans and
the trace of a traced run, the check, and the result line.

Everything that belongs to one cell lives in files of its own, found by the
names in ``BENCHMARK.json``:

- ``workloads/<cell>.json``: the traffic (distinct inputs, linked names,
  warm-up, scene statistics, the LUT) and the check's sample and limits;
- ``configs/<config>.json``: the deployment (shapes, the tool's flags, the
  tables the reference works from) and ``entry``, the tool it drives;
- ``drivers/<entry>.py``: the code that drives that tool's entry point;
- ``metrics/<metric>.py``: one per-layer metric's reader;
- ``tests/tiny/<config>.py``: the configuration and its traffic at the
  size the CPU tests run.

A driver has four names. ``inputs(config, traffic, seed, work)`` writes a
run's distinct inputs (and whatever else the traffic asks to be made, such
as a LUT) under ``work`` and returns their paths; a run and the control
both make them through it. ``run(cell, bench)`` makes the inputs, warms
up, calls ``bench.window_start()`` and ``bench.window_end()`` around the
timed call, and returns an :class:`Outcome`. ``reference(config, distinct,
keys, dtype, device, traffic, work)`` is the plain reference's view of each
key. ``PRODUCES`` is (module, function) of the program's function whose
return value is the answer as the cell produces it, where the CPU tests
plant a fault. A reader's ``read(readings)`` returns the metric's value,
or None where it finds nothing to read.

An end-to-end metric whose ``source`` is ``device_trace`` has a reader
too, ``metrics/<metric>.py``: a cell that reports one has its window
profiled in every run, traced or not, and the reader takes the metric
from that trace.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import io
import json
import pathlib
import re
import shutil
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from portbench import scenes
from portbench.reference import compare
from portbench.trace import WINDOW_LABEL, Trace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
WORK_ROOT = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "gs360x")


def load_json(path: pathlib.Path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def load_module(path: pathlib.Path):
    """A driver, reader or tiny file, by file (names may hold dots)."""
    name = "portbench_" + re.sub(r"\W", "_", "/".join(path.parts[-2:]))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    work: pathlib.Path
    device: torch.device


@dataclass
class Outcome:
    """What a driver hands back: the end-to-end rate of the window, the
    units attempted and failed in it, the program's own timers and counts,
    the work of each kernel family (traced runs), and the check."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    check: Callable[[torch.dtype], dict]
    counts: Dict[str, float] = field(default_factory=dict)
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    stage_counts: Dict[str, int] = field(default_factory=dict)
    work: Dict[str, dict] = field(default_factory=dict)


class Spec:
    """``BENCHMARK.json`` and the files its names lead to, under
    ``data_dir``: the checkout's ``portbench/``, or a tree the CPU tests
    make of the same files."""

    def __init__(self, data: dict, data_dir: pathlib.Path = HERE):
        self.data, self.data_dir = data, data_dir
        self.cells = {w["name"]: w for w in data["workloads"]}

    @classmethod
    def load(cls) -> "Spec":
        return cls(load_json(ROOT / "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        return load_json(self.data_dir / "workloads" / f"{name}.json")

    def config(self, cell: str) -> dict:
        return load_json(self.data_dir / "configs"
                         / f"{self.cells[cell]['config']}.json")

    def driver(self, config: dict):
        return load_module(self.data_dir / "drivers"
                           / f"{config['entry']}.py")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        return load_module(self.data_dir / "metrics" / f"{metric}.py")


class LineWatch(io.TextIOBase):
    """A text sink that keeps what the program prints in a log and calls
    ``on_line`` with each complete line."""

    def __init__(self, log, on_line: Callable[[str], None]):
        self._log, self._on_line, self._buf = log, on_line, ""

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        self._log.write(s)
        self._buf += s
        *lines, self._buf = re.split(r"[\r\n]", self._buf)
        for line in lines:
            self._on_line(line)
        return len(s)

    def flush(self) -> None:
        self._log.flush()


class Bench:
    """The window and what a traced run records in it.

    Host spans are (kind, start, end) on ``time.perf_counter``, recorded by
    wrappers the driver installs with :meth:`wrap` (traced runs only) while
    the window is open. A profiled run's window (every traced run, and
    every run of a cell with an end-to-end metric from the device trace)
    is also one ``torch.profiler`` session, opened when the window starts,
    around a ``portbench.window`` annotation whose start is ``anchor`` on
    the host clock."""

    def __init__(self, device: torch.device, traced: bool,
                 work: pathlib.Path, profiled: Optional[bool] = None):
        self.device, self.traced, self.work = device, traced, work
        self.profiled = traced if profiled is None else profiled
        self.start: Optional[float] = None
        self.end: Optional[float] = None
        self.spans: List[tuple] = []
        self.notes: Dict[str, object] = {}
        self.trace: Optional[Trace] = None
        self.anchor = 0.0
        self._patches: List[tuple] = []
        self._prof = self._ann = None
        self._cpu0 = 0.0

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm_profiler(self) -> None:
        """One empty profiler session: a process's first costs seconds
        (CUPTI's and Kineto's set-up), which belong to set-up."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            pass

    def patch(self, owner, attr: str, new) -> None:
        self._patches.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def restore(self) -> None:
        while self._patches:
            owner, attr, old = self._patches.pop()
            setattr(owner, attr, old)

    def is_open(self) -> bool:
        return self.start is not None and self.end is None

    def record(self, kind: str, start: float, end: float) -> None:
        if self.is_open():
            self.spans.append((kind, start, end))

    def wrap(self, owner, attr: str, kind: str) -> None:
        """In a traced run, record a ``kind`` span around every call of
        ``owner.attr`` (whichever thread makes it) while the window is
        open."""
        if not self.traced:
            return
        inner = getattr(owner, attr)
        record = self.record

        def spanned(*args, **kwargs):
            t = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                record(kind, t, time.perf_counter())
        self.patch(owner, attr, spanned)

    def window_start(self) -> None:
        if self.start is not None:
            return
        if self.profiled:
            from torch.profiler import profile, record_function
            self._prof = profile(activities=self._activities())
            self._prof.__enter__()
            self._ann = record_function(WINDOW_LABEL)
            self.anchor = time.perf_counter()
            self._ann.__enter__()
        self._cpu0 = time.process_time()
        self.start = time.perf_counter()

    def window_end(self) -> None:
        self.end = time.perf_counter()
        # this process's CPU seconds in the window, all threads: the
        # per-run cost of the same work, which sets the rates' spread
        self.notes["process_cpu_s"] = round(time.process_time() - self._cpu0,
                                            3)
        if self.profiled and self._prof is not None:
            self._ann.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            path = self.work / "window.pt.trace.json"
            self._prof.export_chrome_trace(str(path))
            self._prof = self._ann = None
            self.trace = Trace.load(path)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def span_totals(self) -> Dict[str, tuple]:
        """kind → (seconds summed, spans) over the window."""
        out: Dict[str, list] = {}
        for kind, s, e in self.spans:
            tot = out.setdefault(kind, [0.0, 0])
            tot[0] += e - s
            tot[1] += 1
        return {k: tuple(v) for k, v in out.items()}


@dataclass
class Readings:
    """What a per-layer reader reads."""

    outcome: Outcome
    bench: Bench
    spans: Dict[str, tuple]
    trace: Optional[Trace]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``gs360x_torch`` is not ``gs360x``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def info(msg: str) -> None:
    print(f"[portbench] {msg}", flush=True)


def sample(seed: int, n: int, k: int) -> list:
    """The indices of the outputs a run's check compares: ``k`` of ``n``
    drawn from the seed, and the last written."""
    picks = set()
    if n:
        rng = scenes.rng_for(seed, 1 << 21)
        picks = set(rng.choice(n, min(int(k), n), replace=False).tolist())
        picks.add(n - 1)
    return sorted(picks)


def bytes_under(path: pathlib.Path) -> int:
    """Bytes of the regular files under ``path`` (links not followed)."""
    return sum(p.lstat().st_size for p in path.rglob("*")
               if p.is_file() and not p.is_symlink())


def run_cell(spec: Spec, name: str, *, seed: int, seconds: float,
             traced: bool, device: torch.device, t0: float,
             work_root: pathlib.Path = WORK_ROOT) -> dict:
    """One run of one cell; the result line's object. Raises on a fault
    of the harness or a program that does not run to its end."""
    config = spec.config(name)
    traffic = spec.workload(name)
    work = work_root / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cell = Cell(name, config, traffic, seed, seconds, traced, work, device)
    end_to_end = spec.end_to_end(name)
    profiled = traced or any(m["source"] == "device_trace"
                             for m in end_to_end)
    bench = Bench(device, traced, work, profiled)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    if profiled:
        bench.warm_profiler()
    driver = spec.driver(config)
    try:
        outcome = driver.run(cell, bench)
    finally:
        bench.restore()
    if bench.start is None or bench.end is None:
        raise RuntimeError(f"{name}: the driver opened no window")
    setup_s = bench.start - t0
    dev = device_info(device)
    info(f"window {bench.window_s:.6f} s | setup {setup_s:.6f} s | "
         + " | ".join(f"{k} {v}" for k, v in bench.notes.items()))
    inputs = bytes_under(work / "inputs")
    info(f"bytes written {bytes_under(work)}: inputs {inputs}, outputs "
         f"and the rest {bytes_under(work) - inputs} ({work})")

    metrics: Dict[str, dict] = {}
    result: Dict[str, object] = {}
    if traced:
        readings = Readings(outcome, bench, bench.span_totals(), bench.trace)
        for metric in spec.per_layer(name):
            value = spec.reader(metric["name"]).read(readings)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
        if bench.trace is not None:
            dev["busy_s"] = bench.trace.busy_us / 1e6
            dev["window_s"] = bench.trace.window_us / 1e6
            result["breakdown"] = {
                "device_ops": bench.trace.top_ops(),
                "idle_gaps": bench.trace.labelled_gaps(bench.spans,
                                                       bench.anchor)}
    else:
        values = dict(outcome.e2e, setup_s=setup_s)
        readings = Readings(outcome, bench, {}, bench.trace)
        for metric in end_to_end:
            value = values.get(metric["name"])
            if metric["source"] == "device_trace":
                value = spec.reader(metric["name"]).read(readings)
            if value is None:
                # a trace of the CPU holds no kernel to read
                if device.type == "cuda":
                    raise RuntimeError(f"{name}: no {metric['name']} read")
                continue
            metrics[metric["name"]] = {"value": value,
                                       "unit": metric["unit"]}

    # the reference runs once the peak is read and the program's state is
    # freed: a process's peak never falls again
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    found = outcome.check(torch.float64)
    limits = traffic["limits"]
    correct = (compare.verdict(found, limits) and outcome.failed == 0
               and outcome.attempted > 0)
    info(f"check {time.perf_counter() - t:.3f} s")
    shutil.rmtree(work, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: {bad}")
    check = {k: [found[k], limits[k]] for k in limits}
    check["failed"] = [outcome.failed, 0]
    for k, (value, limit) in check.items():
        print(f"check {k} {value} limit {limit}", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(outcome.attempted),
           "failed": int(outcome.failed), "metrics": metrics, "device": dev}
    out.update(result)
    out["check"] = check
    return out


@contextlib.contextmanager
def program_output(log_path: pathlib.Path, on_line=lambda line: None):
    """The program's standard output into ``log_path`` (so the result line
    stays the last of the benchmark's own), each line also handed to
    ``on_line``."""
    with open(log_path, "a") as log:
        watch = LineWatch(log, on_line)
        with contextlib.redirect_stdout(watch):
            yield watch
