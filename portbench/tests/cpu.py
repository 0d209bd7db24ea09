"""What the benchmark's CPU tests share: a spec tree at the size the CPU
runs in a second, one run of a cell on the CPU, the faults planted under
it, and the checks that a cell resolves by name.

Each takes the spec tree (a :class:`harness.Spec`, or its directory) and
the directory of tiny files as arguments, so that a test can build a tree
of its own with a configuration and a cell the checkout does not have.
A configuration's tiny file, ``tiny/<config>.py``, has ``config(cfg)``
and ``traffic(t)``: each takes the checkout's dict and returns it shrunk.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import shutil
import time

import torch

from portbench import harness

TINY = harness.HERE / "tests" / "tiny"
SEED = 2 ** 34 + 21


def tiny_module(tiny_dir: pathlib.Path, config: str):
    """The tiny file of configuration ``config``; a configuration without
    one fails with the file to add."""
    path = pathlib.Path(tiny_dir) / f"{config}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {config!r} has no CPU test size: add {path} "
            "with config(cfg) and traffic(t), each returning its argument "
            "shrunk")
    return harness.load_module(path)


def tiny_spec_dir(data: dict, base: pathlib.Path,
                  spec_dir: pathlib.Path = harness.HERE,
                  tiny_dir: pathlib.Path = TINY) -> pathlib.Path:
    """A spec tree under ``base`` for ``data`` (a ``BENCHMARK.json``): the
    drivers and readers of ``spec_dir`` as they are, and every
    configuration and traffic file ``data`` names shrunk by its
    configuration's tiny file in ``tiny_dir``."""
    for sub in ("drivers", "metrics"):
        shutil.copytree(spec_dir / sub, base / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "workloads"):
        (base / sub).mkdir()
    tiny = {c["name"]: tiny_module(tiny_dir, c["name"])
            for c in data["configs"]}
    for name, module in tiny.items():
        cfg = harness.load_json(spec_dir / "configs" / f"{name}.json")
        (base / "configs" / f"{name}.json").write_text(
            json.dumps(module.config(cfg)))
    for w in data["workloads"]:
        t = harness.load_json(spec_dir / "workloads" / f"{w['name']}.json")
        (base / "workloads" / f"{w['name']}.json").write_text(
            json.dumps(tiny[w["config"]].traffic(t)))
    return base


def run_tiny(spec: harness.Spec, cell: str, work_root: pathlib.Path,
             traced: bool = False, seed: int = SEED) -> dict:
    """One run of ``cell`` on the CPU, past the harness's look for a
    card: the result line's object."""
    return harness.run_cell(spec, cell, seed=seed, seconds=1.0,
                            traced=traced, device=torch.device("cpu"),
                            t0=time.perf_counter(), work_root=work_root)


def leave_half_out(monkeypatch) -> None:
    """Every other file the program writes is left out."""
    from gs360x_torch.io import image as imagelib
    inner, calls = imagelib.write_image, []

    def every_other(*args, **kwargs):
        calls.append(1)
        if len(calls) % 2:
            inner(*args, **kwargs)
    monkeypatch.setattr(imagelib, "write_image", every_other)


def mirror_where_produced(spec: harness.Spec, cell: str,
                          monkeypatch) -> None:
    """Every answer mirrored where the cell produces it: the return value
    of the function the cell's driver names in ``PRODUCES``."""
    module, name = spec.driver(spec.config(cell)).PRODUCES
    owner = importlib.import_module(module)
    inner = getattr(owner, name)
    monkeypatch.setattr(owner, name,
                        lambda *a, **k: inner(*a, **k).flip(-1))


def check_tiny_file(tiny_dir: pathlib.Path, config: str) -> None:
    module = tiny_module(tiny_dir, config)
    assert callable(getattr(module, "config", None)), config
    assert callable(getattr(module, "traffic", None)), config


def check_driver(driver) -> None:
    """A driver has ``run``, ``inputs`` and ``reference``, and its
    ``PRODUCES`` names a function of the program that imports."""
    for name in ("run", "inputs", "reference"):
        assert callable(getattr(driver, name, None)), name
    module, name = driver.PRODUCES
    assert callable(getattr(importlib.import_module(module), name))


def check_cell_resolves(spec: harness.Spec, cell: str) -> None:
    """A cell's traffic, configuration, driver and readers by name; it
    reports setup_s, another end-to-end metric and a per-layer metric,
    and each reader it lists has a ``read``."""
    entry = spec.cells[cell]
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200
    traffic = spec.workload(cell)
    assert traffic["traffic"] == entry["traffic"]
    config = spec.config(cell)
    assert config["name"] == entry["config"]
    check_driver(spec.driver(config))
    e2e = {m["name"] for m in spec.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for metric in spec.end_to_end(cell):
        if metric["source"] == "device_trace":
            assert callable(spec.reader(metric["name"]).read)
    layers = spec.per_layer(cell)
    assert layers
    for metric in layers:
        assert callable(spec.reader(metric["name"]).read)
        assert metric["moves"] in e2e
    assert set(traffic["limits"]) == {"missing", "mae_lsb", "far_pct"}
