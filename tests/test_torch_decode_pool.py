"""The port's one decode-ahead stage (``runtime/prefetch.Prefetcher``)
and image mode's pool on it: results in submission order when decodes
finish out of order, a failed item as that item's failure with the items
after it still coming, the stop while the loop waits ending the loop and
every thread, at most ``width`` decodes at once and ``width + depth``
items held, the ``decode_overlap`` counter and its window, the
benchmark's reader of it, a width-1 stage over an iterator whose
``next()`` decodes (video mode, Video2Frames); ``run_plan``'s image mode
on a pool of three against one, byte for byte, with ``read_image``
wrapped on the module as the benchmark wraps it; and dualfisheye's pair
loop on one decode thread and on two, byte for byte, a corrupt lens file
that pair's own failure."""

import json
import math
import os
import pathlib
import random
import sys
import threading
import time
from operator import add
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gs360x_torch.io import image as tim
from gs360x_torch.rig.presets import build_view_plan
from gs360x_torch.runtime import executor, prefetch
from gs360x_torch.runtime import profiling as tprof
from gs360x_torch.runtime.prefetch import Prefetcher
from gs360x_torch.tools import perspcut

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
READER = "decode_overlap_pct.perspcut"


def _drain(pre, hold_s=0.0):
    got = []
    for item in pre:
        got.append(item)
        time.sleep(hold_s)
    return got


def _join_all(pre, timeout=3.0):
    for t in pre._threads:
        t.join(timeout=timeout)
    return [t for t in pre._threads if t.is_alive()]


# --- order, failures, bounds ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_results_come_in_submission_order(seed):
    rng = random.Random(seed)
    delays = [rng.uniform(0.0, 0.02) for _ in range(24)]

    def decode(k):
        time.sleep(delays[k])
        return k * 10
    pre = Prefetcher(list(range(24)), threading.Event(),
                     decode=decode, width=4)
    assert _drain(pre) == [k * 10 for k in range(24)]
    assert _join_all(pre) == []


def test_a_failed_item_stays_that_items_failure():
    """As ``_run_images``' decode does, the failure comes back as the
    item's result and the items after it still come; a ``decode`` that
    raises reaches the consumer at that item, after every item before
    it."""
    def returned(k):
        time.sleep(0.01 * (k % 3))
        if k == 3:
            return k, ValueError("bad frame 3")
        return k, None
    pre = Prefetcher(list(range(8)), threading.Event(),
                     decode=returned, width=3)
    got = _drain(pre)
    assert [k for k, _ in got] == list(range(8))
    assert [str(e) for _, e in got if e is not None] == ["bad frame 3"]

    def raised(k):
        if k == 3:
            raise ValueError("bad frame 3")
        return k
    got = []
    pre = Prefetcher(list(range(8)), threading.Event(),
                     decode=raised, width=3)
    with pytest.raises(ValueError, match="bad frame 3"):
        for item in pre:
            got.append(item)
    assert got == [0, 1, 2]
    assert _join_all(pre) == []    # the pool ends once the consumer has


@pytest.mark.parametrize("width,depth", [(1, 2), (3, 2), (4, 1)])
def test_no_more_than_width_decodes_and_width_plus_depth_held(width, depth):
    lock = threading.Lock()
    state = {"running": 0, "most_running": 0, "started": 0, "passed": 0,
             "most_held": 0}

    def decode(k):
        with lock:
            state["running"] += 1
            state["started"] += 1
            state["most_running"] = max(state["most_running"],
                                        state["running"])
            state["most_held"] = max(state["most_held"],
                                     state["started"] - state["passed"])
        time.sleep(0.01 + 0.01 * (k % 3))
        with lock:
            state["running"] -= 1
        return k
    pre = Prefetcher(list(range(30)), threading.Event(),
                     depth=depth, decode=decode, width=width)
    got = []
    for item in pre:
        got.append(item)
        time.sleep(0.03)   # a slow loop: the pool fills up
        with lock:
            state["passed"] += 1
    assert got == list(range(30))
    assert state["most_running"] <= width
    assert state["most_held"] <= width + depth
    # the slow loop lets every slot fill
    assert state["most_held"] == width + depth
    assert _join_all(pre) == []


def test_more_threads_than_cores_lose_nothing():
    """Twice as many pool threads as cores, switching every microsecond:
    every item once, in order, and every decode counted."""
    width = 2 * (os.cpu_count() or 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        pre = Prefetcher(list(range(3000)), threading.Event(),
                         depth=3, decode=lambda k: k + 1,
                         width=width)
        got = _drain(pre)
        t1 = time.perf_counter()
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(1, 3001))
    counts = executor.decode_overlap(t0, t1)
    assert counts["decodes"] == 3000 and counts["width"] == width
    assert _join_all(pre) == []


# --- the stop ----------------------------------------------------------------

def test_pool_stops_while_the_loop_waits():
    stop = threading.Event()

    def slow(k):
        time.sleep(0.4)
        return k
    pre = Prefetcher(list(range(40)), stop, decode=slow, width=3)
    got = []

    def consume():
        got.extend(pre)
    worker = threading.Thread(target=consume, daemon=True)
    threading.Timer(1.0, stop.set).start()
    t = time.perf_counter()
    worker.start()
    worker.join(timeout=3.0)
    assert not worker.is_alive(), "the loop did not stop"
    assert time.perf_counter() - t < 3.0 and 1 <= len(got) < 40
    assert got == list(range(len(got)))
    # each pool thread finishes the read it is in, then ends
    assert len(pre._threads) == 3
    assert _join_all(pre) == []


# --- the counter -------------------------------------------------------------

def test_decode_overlap_counts_the_window():
    before = executor.decode_overlap()
    barrier = threading.Barrier(3)

    def together(k):
        if k < 3:
            barrier.wait(timeout=5.0)   # the first three run at once
        time.sleep(0.005)
        return k
    t0 = time.perf_counter()
    earlier = executor.decode_overlap(t0 - 100.0, t0)
    assert _drain(Prefetcher(
        list(range(9)), threading.Event(), decode=together,
        width=3)) == list(range(9))
    t1 = time.perf_counter()
    got = executor.decode_overlap(t0, t1)
    assert got["decodes"] == 9 and got["width"] == 3
    # the first of the three never overlaps, the two others do
    assert 2 <= got["overlapped"] <= 8
    assert executor.decode_overlap(t1, t1 + 100.0) == {
        "decodes": 0, "overlapped": 0, "width": 0}
    assert executor.decode_overlap(t0 - 100.0, t0) == earlier

    # one thread never overlaps itself
    t2 = time.perf_counter()
    _drain(Prefetcher(list(range(5)), threading.Event(),
                      decode=lambda k: k, width=1))
    assert executor.decode_overlap(t2, time.perf_counter()) == {
        "decodes": 5, "overlapped": 0, "width": 1}

    after = executor.decode_overlap()
    assert after["decodes"] - before["decodes"] == 14
    assert after["overlapped"] - before["overlapped"] == got["overlapped"]
    assert after["width"] >= 3


def _reader():
    from portbench import harness
    return harness.load_module(harness.HERE / "metrics" / f"{READER}.py")


def test_the_overlap_reader_reads_the_window(monkeypatch):
    """100 × overlapped ÷ decodes of those that started in [bench.start,
    bench.end); None with none there, or without the counter."""
    r = SimpleNamespace(bench=SimpleNamespace(start=100.0, end=101.0))
    reader = _reader()

    def counter(*decodes):
        fed = tprof.WindowCounter(decodes=add, overlapped=add, width=max)
        for t, overlapped in decodes:
            fed.add(t, decodes=1, overlapped=overlapped, width=4)
        monkeypatch.setattr(prefetch, "_DECODES", fed)
    counter((99.5, True), (100.0, False), (100.2, True), (100.6, True),
            (100.9, False), (101.0, True))
    assert reader.read(r) == pytest.approx(50.0, rel=1e-12)
    counter((99.5, True), (101.0, True))
    assert reader.read(r) is None
    monkeypatch.delattr(executor, "decode_overlap")
    assert reader.read(r) is None


def test_the_overlap_reader_is_the_image_cells_metric():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in spec["per_layer"] if m["name"] == READER]
    (texel,) = [m for m in spec["per_layer"]
                if m["name"] == "texel_decode_pct.perspcut"]
    assert entry == dict(texel, name=READER)


# --- a width-1 stage over an iterator ----------------------------------------

def _frames(n, fail_at=None):
    for k in range(n):
        if k == fail_at:
            raise ValueError(f"bad frame {k}")
        yield k


def test_iterator_form_as_before():
    """Width 1 over an iterator: one thread runs it, its items come as it
    yields them, an exception it raises reaches the consumer after the
    items before it, and each wait is one ``decode_wait``."""
    timers = tprof.StageTimers()
    since = time.perf_counter()
    pre = Prefetcher(_frames(6), threading.Event(), timers=timers)
    assert len(pre._threads) == 1
    assert list(pre) == list(range(6))
    assert timers.counts == {"decode_wait": 7}
    assert [s[0] for s in tprof.spans(since)] == ["decode_wait"] * 7

    got = []
    pre = Prefetcher(_frames(6, fail_at=4), threading.Event())
    with pytest.raises(ValueError, match="bad frame 4"):
        for item in pre:
            got.append(item)
    assert got == [0, 1, 2, 3]
    assert _join_all(pre) == []


def test_iterator_form_ends_once_the_consumer_stops_early():
    pre = Prefetcher(_frames(1000), threading.Event())
    for item in pre:
        if item == 2:
            break
    assert _join_all(pre) == []


@pytest.mark.parametrize("depth", [1, 3, 6])
def test_iterator_form_takes_depth_plus_one_ahead(depth):
    """Width 1 over an iterator takes ``depth + 1`` items ahead of a slow
    loop, the one it holds included: what the old queue form of depth − 1
    held (its queue, the item its pump held, the loop's)."""
    lock = threading.Lock()
    state = {"taken": 0, "passed": 0, "most": 0}

    def source():
        for k in range(12):
            with lock:
                state["taken"] += 1
                state["most"] = max(state["most"],
                                    state["taken"] - state["passed"])
            yield k
    pre = Prefetcher(source(), threading.Event(), depth=depth)
    for _ in pre:
        time.sleep(0.02)
        with lock:
            state["passed"] += 1
    assert state["most"] == depth + 1
    assert _join_all(pre) == []


# --- run_plan's image mode on the pool ---------------------------------------

def _pano(shift, w=256, h=128):
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    img = np.stack([0.5 + 0.5 * np.sin(lon + shift),
                    0.5 + 0.5 * np.sin(lat),
                    0.5 + 0.5 * np.cos(2 * lon)], -1)
    return (img * 255).astype(np.uint8)


FRAMES = 7


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for k in range(FRAMES):
        tim.write_image(d / f"f{k:04d}.jpg", _pano(0.3 * k))
    return d


def _plan(frame_dir, out):
    args = perspcut.create_arg_parser().parse_args(
        ["-i", str(frame_dir), "--size", "48", "--ext", "png", "--count",
         "4"])
    files = sorted(frame_dir.glob("*.jpg"))
    return build_view_plan(perspcut.config_from_args(args), files, out)


def _run(frame_dir, out, width, monkeypatch):
    """``run_plan`` with ``width`` decode threads and ``read_image``
    wrapped on the module, as the benchmark wraps it: the wrapper's calls,
    their threads, the run's ``decode`` spans and its overlap counter."""
    monkeypatch.setattr(executor, "_decode_width", lambda: width)
    inner = tim.read_image
    calls, lock = [], threading.Lock()

    def wrapped(*args, **kwargs):
        with lock:
            calls.append(threading.get_native_id())
        time.sleep(0.05)   # long enough for the pool's decodes to meet
        return inner(*args, **kwargs)
    monkeypatch.setattr(tim, "read_image", wrapped)
    t0 = time.perf_counter()
    report = executor.run_plan(_plan(frame_dir, out),
                               device=torch.device("cpu"), quiet=True)
    t1 = time.perf_counter()
    monkeypatch.undo()
    decodes = [s for s in tprof.spans(t0) if s[0] == "decode"]
    return report, calls, decodes, executor.decode_overlap(t0, t1)


def test_run_plan_on_a_pool_writes_what_one_thread_writes(frame_dir, tmp_path,
                                                          monkeypatch):
    views = FRAMES * 4
    one, calls1, spans1, pool1 = _run(frame_dir, tmp_path / "one", 1,
                                      monkeypatch)
    three, calls3, spans3, pool3 = _run(frame_dir, tmp_path / "three", 3,
                                        monkeypatch)
    for report in (one, three):
        assert (report.ok, report.failed) == (views, 0)
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert len(names) == views
    assert names == sorted(p.name for p in (tmp_path / "three").iterdir())
    for name in names:
        assert (tmp_path / "one" / name).read_bytes() == \
            (tmp_path / "three" / name).read_bytes(), name
    # the wrapper on the module sees every decode, from the pool's threads
    assert len(calls1) == len(calls3) == FRAMES
    assert len(set(calls1)) == 1
    assert 1 < len(set(calls3)) <= 3
    main = threading.get_native_id()
    assert main not in set(calls1) | set(calls3)
    # one ``decode`` stage a frame, on the threads that decoded
    assert len(spans1) == len(spans3) == FRAMES
    assert {s[1] for s in spans3} == set(calls3)
    assert three.stage_seconds["decode"] > 0.0
    assert pool1 == {"decodes": FRAMES, "overlapped": 0, "width": 1}
    assert pool3["decodes"] == FRAMES and pool3["width"] == 3
    assert pool3["overlapped"] >= 1


def test_run_plan_keeps_a_bad_frame_its_own_failure(frame_dir, tmp_path,
                                                    monkeypatch):
    d = tmp_path / "frames"
    d.mkdir()
    for p in sorted(frame_dir.glob("*.jpg")):
        (d / p.name).write_bytes(p.read_bytes())
    (d / "f0002.jpg").write_bytes(b"not a jpeg")
    monkeypatch.setattr(executor, "_decode_width", lambda: 3)
    report = executor.run_plan(_plan(d, tmp_path / "out"),
                               device=torch.device("cpu"), quiet=True)
    assert (report.ok, report.failed) == ((FRAMES - 1) * 4, 4)
    assert len(report.errors) == 1 and report.errors[0].startswith(
        "f0002.jpg:")
    written = {p.name.split("_")[0] for p in (tmp_path / "out").iterdir()}
    assert written == {f"f{k:04d}" for k in range(FRAMES) if k != 2}


def test_run_plan_prints_the_overlap_on_stats(frame_dir, tmp_path, capsys):
    assert perspcut.main(["-i", str(frame_dir), "-o", str(tmp_path / "o"),
                          "--size", "48", "--ext", "png", "--count", "4",
                          "--device", "cpu", "--stats"]) == 0
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("[STATS]")]
    totals = executor.decode_overlap()
    assert line.endswith(
        f"| decodes overlapped {totals['overlapped']} of "
        f"{totals['decodes']}, width {totals['width']}")


# --- dualfisheye's pair loop on the stage ------------------------------------

PAIRS = 4


@pytest.fixture(scope="module")
def lens_dir(tmp_path_factory):
    from test_dualfisheye import CALIB_XML
    d = tmp_path_factory.mktemp("lenses")
    (d / "calib.xml").write_text(CALIB_XML)
    (d / "pairs").mkdir()
    for k in range(PAIRS):
        for lens in "XY":
            tim.write_image(d / "pairs" / f"s{k:04d}_{lens}.jpg",
                            np.roll(_pano(0.3 * k, 512, 512), 37 * k, 1))
    return d


@pytest.mark.parametrize("corrupt", [None, 1])
def test_dualfisheye_on_a_pool_writes_what_one_thread_writes(
        lens_dir, tmp_path, capsys, corrupt):
    """``--workers 1`` and ``--workers 2`` write the same bytes and print
    the same lines, the pairs in order; a corrupt lens file fails its own
    pair, named on its ``[WARN]`` and progress lines, and every other pair
    is written."""
    from gs360x_torch.tools import dualfisheye as tdf
    src = tmp_path / "pairs"
    src.mkdir()
    for p in sorted((lens_dir / "pairs").iterdir()):
        (src / p.name).write_bytes(p.read_bytes())
    if corrupt is not None:
        (src / f"s{corrupt:04d}_Y.jpg").write_bytes(b"not a jpeg")
    runs = {}
    for workers in (1, 2):
        code = tdf.main(["-i", str(src), "-o", str(tmp_path / f"w{workers}"),
                         "--camera-xml", str(lens_dir / "calib.xml"),
                         "--perspective-size", "32", "--workers",
                         str(workers), "--device", "cpu"])
        cap = capsys.readouterr()
        runs[workers] = (code, cap.out, cap.err)
    assert runs[1] == runs[2]
    code, out, err = runs[1]
    bases = [f"s{k:04d}" for k in range(PAIRS)]
    progress = [ln for ln in out.splitlines() if ln.endswith(tuple(bases))
                and ln.startswith("[")]
    assert progress == [f"[{k + 1}/{PAIRS}] {b}" for k, b in enumerate(bases)]
    failed = [] if corrupt is None else [bases[corrupt]]
    assert code == (2 if failed else 0)
    assert out.splitlines()[-1] == \
        f"[OK] processed={PAIRS - len(failed)} failed={len(failed)}"
    assert [ln.split(" failed:")[0] for ln in err.splitlines()
            if ln.startswith("[WARN]")] == [f"[WARN] pair {b}" for b in failed]
    views = sorted(p.relative_to(tmp_path / "w1")
                   for p in (tmp_path / "w1").rglob("*") if p.is_file())
    assert views == sorted(p.relative_to(tmp_path / "w2")
                           for p in (tmp_path / "w2").rglob("*")
                           if p.is_file())
    assert {v.name.split("_")[0] for v in views} == set(bases) - set(failed)
    for v in views:
        assert (tmp_path / "w1" / v).read_bytes() == \
            (tmp_path / "w2" / v).read_bytes(), v
