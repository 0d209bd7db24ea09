"""BENCHMARK.json against the benchmark's contract, and every cell resolved
by name to its traffic, configuration, driver and per-layer readers."""

import json
import re

import pytest

from portbench import harness
from portbench.tests import cpu

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names(name):
    assert NAME.match(name), name


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in \
            metric["layer"]
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_setup_s_everywhere():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    """A cell's traffic, configuration, driver and readers by name; it
    reports setup_s, another end-to-end metric and a per-layer metric,
    and each reader it lists has a ``read``."""
    cpu.check_cell_resolves(harness.Spec.load(), cell)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_tiny_file(config):
    """Every configuration brings its CPU test size."""
    cpu.check_tiny_file(cpu.TINY, config)


@pytest.mark.parametrize("entry", sorted({
    json.loads((ROOT / c["file"]).read_text())["entry"]
    for c in SPEC["configs"]}))
def test_driver(entry):
    """Every driver a configuration names has ``run``, ``inputs``,
    ``reference`` and a ``PRODUCES`` that imports and resolves."""
    cpu.check_driver(harness.Spec.load().driver({"entry": entry}))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    path = ROOT / config["file"]
    assert path.is_file() and path.parent == ROOT / "portbench" / "configs"
    assert path.stem == config["name"]
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert 1 <= len(config["source"]) <= 200
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


def test_layers_named_alike():
    """Metrics of one module share one ``layer``, letter for letter."""
    by_module = {}
    for m in SPEC["per_layer"]:
        module = re.search(r"\(([^)]*)\)|(csrc/\S+)|^(device)$", m["layer"])
        by_module.setdefault(module.group(0) if module else m["layer"],
                             set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


def test_paths_hold_only_the_benchmark():
    files = [p.relative_to(ROOT).as_posix()
             for p in (ROOT / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    for f in files:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", f), f
    assert "portbench/run.py" in files


def test_per_layer_readers_exist():
    """A reader for every per-layer metric and every end-to-end metric
    taken from the device trace, and no other."""
    readers = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in SPEC["per_layer"]} | {
        m["name"] for m in SPEC["end_to_end"]
        if m["source"] == "device_trace"}
