"""The port's spans (:func:`gs360x_torch.runtime.profiling.spans`): every
``StageTimers`` stage in one bounded process-wide ring, each from the
thread that does the work — the prefetch thread's ``decode``, the feeding
loop's ``decode_wait``, ``warp_dispatch``, ``fetch`` and ``writer_block``,
the writer threads' ``encode`` in a CPU ``run_plan``; ``decode_wait``,
``upload``, ``remap+fetch``, ``writer_block``, ``encode`` and ``map_build``
in a CPU ``dualfisheye.main`` — with ``[STATS]`` still parsed by the
regex ``portbench`` reads it with; the window counter beside the ring;
the writer and the prefetcher without timers as before; the trace
``maybe_trace`` writes holding the spans on the profiler's own clock; the
prefetcher's stop while the loop waits on a decode; and the benchmark's
readers of the spans on synthetic readings."""

import json
import math
import pathlib
import re
import threading
import time

import numpy as np
import pytest
import torch

from gs360x.io import image as jim
from gs360x_torch.io import image as tim
from gs360x_torch.rig.presets import build_view_plan
from gs360x_torch.runtime import executor
from gs360x_torch.runtime import profiling as tprof
from gs360x_torch.runtime.prefetch import Prefetcher
from gs360x_torch.tools import dualfisheye as tdf
from gs360x_torch.tools import perspcut
from test_dualfisheye import CALIB_XML

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# how portbench reads the [STATS] line (its dualfisheye entry point)
STATS = re.compile(r"([\w+]+) ([0-9.]+)s/(\d+)")
LOOP_PERSPCUT = {"decode_wait", "warp_dispatch", "fetch", "writer_block"}
LOOP_DUALFISHEYE = {"decode_wait", "upload", "remap+fetch", "writer_block"}


def _pano(w=256, h=128):
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    img = np.stack([0.5 + 0.5 * np.sin(lon), 0.5 + 0.5 * np.sin(lat),
                    0.5 + 0.5 * np.cos(2 * lon)], -1)
    return (img * 255).astype(np.uint8)


@pytest.fixture
def pano_dir(tmp_path):
    d = tmp_path / "panos"
    d.mkdir()
    for k in range(3):
        tim.write_image(d / f"pano_{k:04d}.png", np.roll(_pano(), 9 * k, 1))
    return d


@pytest.fixture
def pair_dir(tmp_path):
    (tmp_path / "calib.xml").write_text(CALIB_XML)
    d = tmp_path / "pairs"
    d.mkdir()
    for k in range(2):
        for lens in "XY":
            tim.write_image(d / f"s{k:04d}_{lens}.png",
                            np.roll(_pano(512, 512), 37 * k, 1))
    return d


def _perspcut(pano_dir, out, *extra):
    return perspcut.main(["-i", str(pano_dir), "-o", str(out), "--size",
                          "48", "--ext", "png", "--count", "4", "--device",
                          "cpu", *extra])


def _dualfisheye(pair_dir, out, *extra):
    return tdf.main(["-i", str(pair_dir), "-o", str(out), "--camera-xml",
                     str(pair_dir.parent / "calib.xml"),
                     "--perspective-size", "32", "--workers", "1",
                     "--device", "cpu", *extra])


def _by_name(held):
    out = {}
    for name, tid, t0, t1, cpu in held:
        out.setdefault(name, []).append((tid, t0, t1, cpu))
    return out


def _stats(text):
    line = [ln for ln in text.splitlines() if ln.startswith("[STATS]")][-1]
    return {name: (float(s), int(n)) for name, s, n in STATS.findall(line)}


# --- the ring -------------------------------------------------------------

def test_run_plan_spans_come_from_their_threads(pano_dir, tmp_path, capsys):
    since = time.perf_counter()
    assert _perspcut(pano_dir, tmp_path / "out", "--stats") == 0
    spans = _by_name(tprof.spans(since))
    main = threading.get_native_id()
    assert set(spans) == LOOP_PERSPCUT | {"decode", "encode"}
    for name in LOOP_PERSPCUT:
        assert {tid for tid, *_ in spans[name]} == {main}, name
    # the decode pool's threads, one a decode at most
    decoders = {tid for tid, *_ in spans["decode"]}
    writers = {tid for tid, *_ in spans["encode"]}
    assert 1 <= len(decoders) <= executor._decode_width()
    assert main not in decoders
    assert writers and not writers & (decoders | {main})
    # 3 frames of 4 views; the loop's last wait is the one that ends it
    counts = {name: len(v) for name, v in spans.items()}
    assert counts == {"decode": 3, "decode_wait": 4, "warp_dispatch": 3,
                      "fetch": 3, "writer_block": 12, "encode": 12}
    for name, held in spans.items():
        for _tid, t0, t1, cpu in held:
            assert since <= t0 <= t1 and 0.0 <= cpu <= t1 - t0 + 0.02
    # the [STATS] line still parses, with the new stages in it
    stats = _stats(capsys.readouterr().out)
    assert {k: n for k, (_s, n) in stats.items()} == counts


def test_dualfisheye_spans_come_from_their_threads(pair_dir, tmp_path,
                                                   capsys):
    since = time.perf_counter()
    assert _dualfisheye(pair_dir, tmp_path / "out", "--stats") == 0
    out = capsys.readouterr().out
    spans = _by_name(tprof.spans(since))
    main = threading.get_native_id()
    assert set(spans) == LOOP_DUALFISHEYE | {"decode", "encode",
                                              "map_build"}
    for name in LOOP_DUALFISHEYE | {"map_build"}:
        assert {tid for tid, *_ in spans[name]} == {main}, name
    decoders = {tid for tid, *_ in spans["decode"]}
    writers = {tid for tid, *_ in spans["encode"]}
    assert len(decoders) == 1 and main not in decoders
    assert writers and not writers & (decoders | {main})
    # 2 pairs; the loop's last wait is the one that ends it
    counts = {name: len(v) for name, v in spans.items()}
    assert counts == {"map_build": 1, "decode": 2, "decode_wait": 3,
                      "upload": 2, "remap+fetch": 4, "writer_block": 20,
                      "encode": 20}
    # the lines portbench reads as before, the new stages in [STATS]
    lines = out.splitlines()
    assert "[1/2] s0000" in lines and "[2/2] s0001" in lines
    assert lines[-1] == "[OK] processed=2 failed=0"
    stats = _stats(out)
    assert {k: n for k, (_s, n) in stats.items()} == counts
    t0, t1 = spans["map_build"][0][1:3]
    assert stats["map_build"][0] == pytest.approx(t1 - t0, abs=0.006)


def test_ring_stays_bounded():
    timers = tprof.StageTimers()
    since = time.perf_counter()
    for _ in range(tprof.SPAN_RING + 10):
        with timers.stage("bounded"):
            pass
    held = tprof.spans()
    assert len(held) == tprof.SPAN_RING
    assert all(s[0] == "bounded" for s in held)
    assert timers.counts == {"bounded": tprof.SPAN_RING + 10}
    last = held[-1]
    assert tprof.spans(last[3]) == [] and tprof.spans(since) == held
    assert tprof.spans(held[-2][3]) == [last]


def test_window_counter_totals_window_and_bound():
    """The totals of every event, the counts of the held events that
    started in [start, end) (a sum and a max), and a ring of the newest
    ``SPAN_RING`` events; the totals keep the events the ring dropped."""
    from operator import add
    counter = tprof.WindowCounter(n=add, size=add, widest=max)
    assert counter.read() == {"n": 0, "size": 0, "widest": 0}
    assert counter.read(0.0, 1.0) == {"n": 0, "size": 0, "widest": 0}
    for k in range(tprof.SPAN_RING + 10):
        counter.add(float(k), n=1, size=k, widest=k % 7)
    total = tprof.SPAN_RING + 10
    assert counter.read() == {"n": total, "size": total * (total - 1) // 2,
                              "widest": 6}
    # the ring holds the newest SPAN_RING: events 10.. onwards
    assert counter.read(0.0, 10.0) == {"n": 0, "size": 0, "widest": 0}
    assert counter.read(0.0, 11.0) == {"n": 1, "size": 10, "widest": 3}
    # [start, end): the event at ``end`` is not in the window
    assert counter.read(20.0, 23.0) == {"n": 3, "size": 63, "widest": 6}
    assert counter.read(20.0, 20.0) == {"n": 0, "size": 0, "widest": 0}
    assert counter.read(total - 1.0, total + 5.0) == {
        "n": 1, "size": total - 1, "widest": (total - 1) % 7}
    # bools count as 0 and 1, and the counts come back as ints
    flags = tprof.WindowCounter(hits=add)
    flags.add(1.0, hits=True)
    flags.add(2.0, hits=False)
    assert [type(v) for v in (flags.read()["hits"],
                              flags.read(0.0, 3.0)["hits"])] == [int, int]
    assert flags.read() == flags.read(0.0, 3.0) == {"hits": 1}


# --- the writer and the prefetcher without timers ---------------------------

@pytest.mark.parametrize("timed", [False, True])
def test_writer_without_timers_records_nothing(tmp_path, timed):
    imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(12)]
    timers = tprof.StageTimers() if timed else None
    since = time.perf_counter()
    (tmp_path / "torch").mkdir()
    (tmp_path / "jax").mkdir()
    with tim.AsyncImageWriter(workers=4, max_pending=4,
                              timers=timers) as writer:
        for i, img in enumerate(imgs):
            writer.submit(tmp_path / "torch" / f"f{i}.png", img)
    with jim.AsyncImageWriter(workers=4, max_pending=4) as writer:
        for i, img in enumerate(imgs):
            writer.submit(tmp_path / "jax" / f"f{i}.png", img)
    for i in range(12):
        assert (tmp_path / "torch" / f"f{i}.png").read_bytes() == \
            (tmp_path / "jax" / f"f{i}.png").read_bytes()
    got = {name: len(v) for name, v in _by_name(tprof.spans(since)).items()}
    assert got == ({"writer_block": 12, "encode": 12} if timed else {})


@pytest.mark.parametrize("timed", [False, True])
def test_prefetcher_without_timers_records_nothing(timed):
    timers = tprof.StageTimers() if timed else None
    since = time.perf_counter()
    items = list(Prefetcher(iter(range(7)), threading.Event(),
                            timers=timers))
    assert items == list(range(7))
    got = {name: len(v) for name, v in _by_name(tprof.spans(since)).items()}
    assert got == ({"decode_wait": 8} if timed else {})


# --- the stop while the loop waits on a decode ------------------------------

def _slow_source(n, seconds):
    for k in range(n):
        time.sleep(seconds)
        yield k


def test_prefetcher_stops_while_the_loop_waits():
    stop = threading.Event()
    pre = Prefetcher(_slow_source(20, 0.4), stop)
    got = []

    def consume():
        got.extend(pre)
    worker = threading.Thread(target=consume, daemon=True)
    threading.Timer(1.0, stop.set).start()
    t = time.perf_counter()
    worker.start()
    worker.join(timeout=3.0)
    assert not worker.is_alive(), "the prefetcher did not stop"
    assert time.perf_counter() - t < 3.0 and 1 <= len(got) < 20
    (thread,) = pre._threads
    thread.join(timeout=3.0)
    assert not thread.is_alive()   # the decode thread ended on the stop too


def test_run_plan_stops_while_the_loop_waits(pano_dir, tmp_path,
                                             monkeypatch):
    inner = tim.read_image

    def slow_read(path, **kw):
        time.sleep(0.4)
        return inner(path, **kw)
    monkeypatch.setattr(tim, "read_image", slow_read)
    names = [pano_dir / f"pano_{k % 3:04d}.png" for k in range(20)]
    links = tmp_path / "frames"
    links.mkdir()
    files = []
    for k, src in enumerate(names):
        files.append(links / f"f{k:04d}.png")
        files[-1].symlink_to(src)
    args = perspcut.create_arg_parser().parse_args(
        ["-i", str(links), "--size", "48", "--ext", "png", "--count", "4"])
    plan = build_view_plan(perspcut.config_from_args(args), files,
                           tmp_path / "out")
    stop = threading.Event()
    reports = []

    def run():
        reports.append(executor.run_plan(plan, device=torch.device("cpu"),
                                         stop_event=stop, quiet=True))
    worker = threading.Thread(target=run, daemon=True)
    threading.Timer(1.0, stop.set).start()
    worker.start()
    worker.join(timeout=3.0)
    assert not worker.is_alive(), "run_plan did not return after the stop"
    (report,) = reports
    assert report.stopped and report.failed == 0 and report.ok < 80


# --- the trace on the profiler's clock --------------------------------------

def _trace(directory, label):
    (path,) = (directory / label).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (ann,) = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == label]
    spans = [e for e in events if e.get("cat") == tprof.SPAN_CAT]
    assert spans and all(
        ann["ts"] <= e["ts"] and e["ts"] + e["dur"] <= ann["ts"] + ann["dur"]
        and e["ph"] == "X" and e["args"]["cpu_ms"] >= 0 for e in spans)
    main = threading.get_native_id()
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("tid") == main and e["name"].startswith("aten::")
           and ann["ts"] <= e["ts"] <= ann["ts"] + ann["dur"]]
    return spans, ops


def _within(op, span, slack_us=500.0):
    return span["ts"] - slack_us <= op["ts"] and \
        op["ts"] + op["dur"] <= span["ts"] + span["dur"] + slack_us


def _on_the_clock(spans, ops, upload, work):
    """Every op the loop ran lies inside one of its ``work`` spans, and
    each ``upload`` span holds its own ops, to within 0.5 ms."""
    main = threading.get_native_id()
    loop = [e for e in spans if e["tid"] == main]
    busy = [e for e in loop if e["name"] in work]
    assert ops and all(any(_within(op, s) for s in busy) for op in ops)
    uploads = [e for e in loop if e["name"] == upload]
    assert uploads and all(
        any(op["name"] == "aten::to" and _within(op, s) for op in ops)
        for s in uploads)


def test_trace_holds_run_plans_spans_on_its_clock(pano_dir, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("GS360X_TRACE_DIR", str(tmp_path / "trace"))
    assert _perspcut(pano_dir, tmp_path / "out") == 0
    spans, ops = _trace(tmp_path / "trace", "run_plan")
    assert {e["name"] for e in spans} == LOOP_PERSPCUT | {"decode", "encode"}
    _on_the_clock(spans, ops, "warp_dispatch", {"warp_dispatch", "fetch"})


def test_trace_holds_dualfisheyes_spans_on_its_clock(pair_dir, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("GS360X_TRACE_DIR", str(tmp_path / "trace"))
    assert _dualfisheye(pair_dir, tmp_path / "out") == 0
    assert [p.name for p in (tmp_path / "trace").iterdir()] == \
        ["dualfisheye"]
    spans, ops = _trace(tmp_path / "trace", "dualfisheye")
    # the map build runs before the traced pair loop
    assert {e["name"] for e in spans} == LOOP_DUALFISHEYE | {"decode",
                                                             "encode"}
    _on_the_clock(spans, ops, "upload", {"upload", "remap+fetch"})


# --- the benchmark's readers -------------------------------------------------

def _readings(stage_seconds):
    """A window of 1 s from host time 100 (the annotation's anchor) on a
    trace whose annotation opens at 1000 µs, with one device operation at
    200-300 ms of it: 900 ms idle."""
    from portbench import harness
    from portbench.trace import WINDOW_LABEL, Trace

    bench = harness.Bench(torch.device("cpu"), True, ROOT)
    bench.start, bench.end, bench.anchor = 100.0, 101.0, 100.0
    trace = Trace([
        {"ph": "X", "cat": "user_annotation", "name": WINDOW_LABEL,
         "ts": 1000.0, "dur": 1e6},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 201000.0,
         "dur": 100000.0}])
    outcome = harness.Outcome(e2e={}, attempted=1, failed=0,
                              check=lambda dtype: {},
                              stage_seconds=stage_seconds)
    return harness.Readings(outcome, bench, {}, trace)


# (name, thread, start, end, CPU s): a frame (or pair) before the window,
# two in it
SYNTHETIC = [
    ("warp_dispatch", 1, 99.6, 99.62, 0.02),
    ("upload", 1, 99.6, 99.62, 0.02),
    ("decode_wait", 1, 99.5, 100.05, 0.0),
    ("encode", 3, 99.7, 99.8, 0.1),
    ("decode", 2, 99.4, 99.9, 0.5),
    ("decode_wait", 1, 100.0, 100.1, 0.0),
    ("decode", 2, 100.0, 100.5, 0.4),
    ("warp_dispatch", 1, 100.1, 100.12, 0.02),
    ("upload", 1, 100.1, 100.12, 0.02),
    ("writer_block", 1, 100.13, 100.132, 0.0),
    ("encode", 3, 100.14, 100.22, 0.08),
    ("decode_wait", 1, 100.25, 100.35, 0.0),
    ("decode", 2, 100.5, 101.0, 0.3),
    ("warp_dispatch", 1, 100.35, 100.37, 0.02),
    ("upload", 1, 100.35, 100.37, 0.02),
    ("writer_block", 1, 100.38, 100.384, 0.0),
    ("encode", 4, 100.39, 100.48, 0.09),
    ("encode", 3, 100.4, 100.5, 0.1),
    ("decode_wait", 1, 101.0, 101.2, 0.0),
]
READERS = {
    "decode_wait_ms_per_frame": 100.0,
    "writer_block_ms_per_frame": 3.0,
    "writer_encode_ms_per_view": 90.0,
    # idle inside 100.0-100.1 (100 ms) and 100.3-100.35 (50 ms) of 900
    "idle_decode_wait_pct.perspcut": 100.0 * 150.0 / 900.0,
    "decode_cpu_pct.perspcut": 70.0,
    "decode_wait_ms_per_pair": 100.0,
    "writer_block_ms_per_pair": 3.0,
    "writer_encode_ms_per_pair": 135.0,
    "idle_decode_wait_pct.dualfisheye": 100.0 * 150.0 / 900.0,
    "decode_cpu_pct.dualfisheye": 70.0,
    "map_build_span_s": 6.5,
}


def _reader(name):
    from portbench import harness
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_span_readers_are_benchmark_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(READERS) <= {m["name"] for m in spec["per_layer"]}


@pytest.mark.parametrize("name", list(READERS))
def test_span_reader(name, monkeypatch):
    monkeypatch.setattr(tprof, "spans", lambda since=None: list(SYNTHETIC))
    got = _reader(name).read(_readings({"map_build": 6.5}))
    assert got == pytest.approx(READERS[name], rel=1e-9)


@pytest.mark.parametrize("name", list(READERS))
def test_span_reader_without_spans(name, monkeypatch):
    """Nothing recorded, or a program without the ring: None."""
    reader = _reader(name)
    monkeypatch.setattr(tprof, "spans", lambda since=None: [])
    assert reader.read(_readings({})) is None
    monkeypatch.delattr(tprof, "spans")
    assert reader.read(_readings({})) is None
