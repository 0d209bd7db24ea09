"""The port's trace hook (:func:`gs360x_torch.runtime.profiling.maybe_trace`)
against the JAX package's: with ``GS360X_TRACE_DIR`` unset (or empty) it
enters no ``torch.profiler`` and writes nothing; with it set, the port's
``perspcut --device cpu`` writes a JSON trace under
``<GS360X_TRACE_DIR>/run_plan/`` whose ``run_plan`` annotation spans the
warps, the directory the JAX executor's ``jax.profiler`` trace goes to."""

import json
import math

import numpy as np
import pytest
import torch

from gs360x.io import image as im
from gs360x.runtime import profiling as jprof
from gs360x.tools import perspcut as jax_perspcut
from gs360x_torch.runtime import profiling as tprof
from gs360x_torch.tools import perspcut as torch_perspcut

torch.set_num_threads(1)


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
    im.write_image(d / "pano_0001.png", _pano())
    return d


def _perspcut(module, pano_dir, out, *extra):
    return module.main(["-i", str(pano_dir), "-o", str(out), "--size", "64",
                        "--ext", "png", "--count", "4", *extra])


def test_maybe_trace_is_exported_like_the_jax_hook():
    assert "maybe_trace" in tprof.__all__ and "maybe_trace" in jprof.__all__
    assert jprof.maybe_trace.__wrapped__.__defaults__ == \
        tprof.maybe_trace.__wrapped__.__defaults__ == ("gs360x",)


@pytest.mark.parametrize("value", [None, ""])
def test_unset_trace_dir_enters_no_profiler(pano_dir, tmp_path, monkeypatch,
                                            value):
    if value is None:
        monkeypatch.delenv("GS360X_TRACE_DIR", raising=False)
    else:
        monkeypatch.setenv("GS360X_TRACE_DIR", value)

    def refuse(*args, **kw):
        raise AssertionError("torch.profiler entered")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    with tprof.maybe_trace("run_plan"):
        pass
    assert _perspcut(torch_perspcut, pano_dir, tmp_path / "out",
                     "--device", "cpu") == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out", "panos"]
    assert len(list((tmp_path / "out").iterdir())) == 4


def test_trace_dir_traces_run_plan_like_the_jax_executor(pano_dir, tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("GS360X_TRACE_DIR", str(tmp_path / "torch_trace"))
    assert _perspcut(torch_perspcut, pano_dir, tmp_path / "out",
                     "--device", "cpu") == 0
    assert [p.name for p in (tmp_path / "torch_trace").iterdir()] == \
        ["run_plan"]
    files = list((tmp_path / "torch_trace" / "run_plan").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    window = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == "run_plan"]
    assert len(window) == 1
    start, end = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and all(start <= e["ts"] <= end for e in ops)
    # no card: the window is read, and no kernel ran in it
    summary = tprof.read_trace(tmp_path / "torch_trace")
    assert summary == {"kernels": [], "window_us": window[0]["dur"],
                       "busy_us": 0.0}

    monkeypatch.setenv("GS360X_TRACE_DIR", str(tmp_path / "jax_trace"))
    assert _perspcut(jax_perspcut, pano_dir, tmp_path / "jax_out") == 0
    assert [p.name for p in (tmp_path / "jax_trace").iterdir()] == \
        ["run_plan"]
    assert list((tmp_path / "jax_trace" / "run_plan").rglob("*.xplane.pb"))


def _trace_file(directory, events):
    directory.mkdir(parents=True)
    (directory / "host_1.2.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))


def test_read_trace_counts_the_union_of_kernel_intervals(tmp_path):
    """Overlapping kernels count once, and only inside the window."""
    def kernel(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur}
    events = [{"ph": "X", "cat": "user_annotation", "name": "run_plan",
               "ts": 100.0, "dur": 100.0},
              kernel("a", 90.0, 20.0),      # 100-110 inside
              kernel("b", 105.0, 10.0),     # 110-115 new
              kernel("c", 130.0, 5.0),      # 5
              kernel("d", 132.0, 1.0),      # inside c
              kernel("e", 195.0, 50.0),     # 195-200
              kernel("f", 250.0, 5.0),      # after the window
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 120.0,
               "dur": 50.0}]
    _trace_file(tmp_path / "run_plan", events)
    got = tprof.read_trace(tmp_path)
    assert [k[0] for k in got["kernels"]] == list("abcdef")
    assert got["window_us"] == 100.0
    assert got["busy_us"] == 10.0 + 5.0 + 5.0 + 5.0
    _trace_file(tmp_path / "two" / "run_plan", events[1:])
    with pytest.raises(ValueError, match="0 'run_plan' annotations"):
        tprof.read_trace(tmp_path / "two")
    with pytest.raises(ValueError, match="0 traces under"):
        tprof.read_trace(tmp_path / "none")
