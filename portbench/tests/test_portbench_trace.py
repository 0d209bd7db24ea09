"""The traced window's arithmetic (``read_trace``'s union of device
intervals, frozen) on a hand-built trace, and the profile an end-to-end
metric from the device trace asks of every run."""

import copy
import json
import shutil

import pytest

from portbench import harness, trace
from portbench.tests import cpu


def _events():
    ann = {"cat": "user_annotation", "name": trace.WINDOW_LABEL,
           "ts": 1000.0, "dur": 100.0}
    ops = [("kernel", "warp_equirect_kernel<x>", 990.0, 20.0),   # clipped
           ("kernel", "texelize_regs(x)", 1005.0, 10.0),         # overlaps
           ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1040.0, 10.0),
           ("kernel", "remap_kernel<y>", 1060.0, 5.0),
           ("kernel", "vectorized_elementwise_kernel<z>", 1062.0, 2.0),
           ("kernel", "after", 1100.0, 5.0)]                    # outside
    return [ann] + [{"cat": c, "name": n, "ts": t, "dur": d}
                    for c, n, t, d in ops] + [
        {"cat": "cpu_op", "name": "aten::add", "ts": 1001.0, "dur": 50.0}]


def test_union_and_gaps():
    busy, gaps = trace.union([(0, 2), (1, 3), (5, 6), (9, 20)], 0, 10)
    assert busy == 5 and gaps == [(3, 5), (6, 9)]
    busy, gaps = trace.union([], 0, 4)
    assert busy == 0 and gaps == [(0, 4)]


def test_window(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    t = trace.Trace.load(path)
    assert t.window_us == 100.0
    # 1000-1015 (the clipped warp and the texel pass), 1040-1050, 1060-1065
    assert t.busy_us == 30.0
    assert t.idle_pct() == pytest.approx(70.0)
    assert t.gaps == [(1015.0, 1040.0), (1050.0, 1060.0), (1065.0, 1100.0)]
    assert t.family_us("warp") == [20.0]
    assert t.family_us("other") == [2.0]
    assert [n for n, _ in t.top_ops()][:2] == ["warp_equirect_kernel<x>",
                                              "texelize_regs(x)"]


def test_labelled_gaps():
    t = trace.Trace(_events())
    anchor = 50.0   # host seconds at the annotation's start (ts 1000 µs)
    spans = [("decode", 50.0 + 10e-6, 50.0 + 45e-6),
             ("encode", 50.0 + 60e-6, 50.0 + 70e-6),
             ("encode", 50.0 + 62e-6, 50.0 + 90e-6)]
    gaps = t.labelled_gaps(spans, anchor)
    assert [g[0] for g in gaps] == ["encode", "decode", "host"]
    assert gaps[0][1] == pytest.approx(35e-6)


def test_one_window_annotation():
    with pytest.raises(ValueError):
        trace.Trace(_events()[1:])


def test_kernel_ms_per_pair():
    """Every kernel of the window (the clipped one whole), none of its
    copies, over the pairs remapped: one remap launch is half a pair."""
    reader = harness.load_module(harness.HERE / "metrics"
                                 / "kernel_ms_per_pair.py")
    r = harness.Readings(None, None, {}, trace.Trace(_events()))
    assert reader.read(r) == pytest.approx((20 + 10 + 5 + 2) / 0.5 / 1e3)
    assert reader.read(harness.Readings(None, None, {}, None)) is None


def test_device_trace_end_to_end_profiles_every_run(tmp_path):
    """An end-to-end metric from the device trace is read by its reader
    from a profile of the window in an untraced run too; the CPU's trace,
    with no kernel, leaves a kernel metric out."""
    src = tmp_path / "src"
    for sub in ("configs", "workloads", "drivers", "metrics"):
        shutil.copytree(harness.HERE / sub, src / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (src / "metrics" / "window_probe_us.py").write_text(
        "def read(r):\n    return r.trace.window_us\n")
    data = copy.deepcopy(harness.Spec.load().data)
    cell = next(w["name"] for w in data["workloads"]
                if w["config"] == "perspcut-8k-default")
    data["end_to_end"].insert(0, {
        "name": "window_probe_us", "unit": "us", "better": "lower",
        "bound": 0.01, "source": "device_trace", "workloads": [cell]})
    spec = harness.Spec(data, cpu.tiny_spec_dir(data, tmp_path / "spec",
                                                src))
    out = cpu.run_tiny(spec, cell, tmp_path / "work")
    assert out["correct"] is True, out["check"]
    assert out["metrics"]["window_probe_us"]["value"] > 0
    assert "busy_s" not in out["device"] and "breakdown" not in out
