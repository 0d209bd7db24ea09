"""A configuration and a cell that the checkout does not have, added to a
spec tree of the test's own as new files alone (what a later configuration
brings): the configuration's file, its traffic file, its tiny file and a
per-layer reader, and entries appended to ``BENCHMARK.json``. The cell
resolves, a sound run comes out correct, half the outputs left out, the
answer mirrored where the driver says it is produced, and the control each
come out not correct; nothing under the checkout's ``portbench/`` is
written."""

import copy
import json
import shutil

import pytest
import torch

from portbench import control, harness
from portbench.tests import cpu

CONFIG = "seam-probe-8k"
CELL = "seam-probe.8k.frames"
METRIC = "seam_views_in_window"
SEED = 2 ** 36 + 7

# a size of its own, so the test sees that this file, and no other, sized
# the cell
TINY_FILE = '''
def config(cfg):
    cfg["frame"].update(width=192, height=96)
    cfg["views"]["size"] = 40
    cfg["args"] = ["--preset", "default", "--size", "40", "--ext", "jpg",
                   "-j", "2"]
    return cfg


def traffic(t):
    t.update(distinct=2, check_sample=6, warmup_frames=1,
             frames_per_s_sizing=3.0)
    return t
'''

READER = '''
def read(r):
    return r.outcome.counts.get("views") or None
'''


def _checkout():
    """(size, mtime) of every file under the checkout's ``portbench/``,
    bytecode caches aside."""
    return {p: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in harness.HERE.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _spec_with_new_cell(tmp_path) -> harness.Spec:
    src, tiny = tmp_path / "src", tmp_path / "tiny"
    for sub in ("configs", "workloads", "drivers", "metrics"):
        shutil.copytree(harness.HERE / sub, src / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(cpu.TINY, tiny,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_json(src / "configs/perspcut-8k-default.json")
    cfg["name"] = CONFIG
    (src / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    shutil.copy(src / "workloads/perspcut.8k-default.jpg-frames.json",
                src / "workloads" / f"{CELL}.json")
    (src / "metrics" / f"{METRIC}.py").write_text(READER)
    (tiny / f"{CONFIG}.py").write_text(TINY_FILE)

    data = copy.deepcopy(harness.Spec.load().data)
    data["configs"].append(dict(
        next(c for c in data["configs"]
             if c["name"] == "perspcut-8k-default"),
        name=CONFIG, file=f"portbench/configs/{CONFIG}.json"))
    data["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "jpg-frames", "chips": 1,
        "why": "a configuration and a cell added by new files alone"})
    data["per_layer"].append({
        "name": METRIC, "unit": "views", "better": "higher",
        "source": "program_counter", "layer": "seam probe",
        "moves": "views_per_s", "workloads": [CELL]})
    for metric in data["end_to_end"]:
        if metric["name"] == "views_per_s":
            metric["workloads"].append(CELL)
    return harness.Spec(data, cpu.tiny_spec_dir(data, tmp_path / "spec",
                                                src, tiny))


@pytest.mark.parametrize("check", ["resolves", "sound", "sound_traced",
                                   "half_left_out", "mirrored", "control"])
def test_a_new_cell_by_new_files_alone(check, tmp_path, monkeypatch):
    before = _checkout()
    spec = _spec_with_new_cell(tmp_path)
    assert spec.config(CELL)["views"]["size"] == 40
    work = tmp_path / "work"
    if check == "resolves":
        cpu.check_cell_resolves(spec, CELL)
        cpu.check_tiny_file(tmp_path / "tiny", CONFIG)
    elif check in ("sound", "sound_traced"):
        out = cpu.run_tiny(spec, CELL, work, check == "sound_traced", SEED)
        assert out["correct"] is True, out["check"]
        assert out["attempted"] > 0 and out["failed"] == 0
        if check == "sound_traced":
            assert out["metrics"][METRIC]["value"] > 0
        else:
            assert set(out["metrics"]) == {"views_per_s", "setup_s"}
    elif check == "half_left_out":
        cpu.leave_half_out(monkeypatch)
        out = cpu.run_tiny(spec, CELL, work, seed=SEED)
        assert out["correct"] is False
        assert out["check"]["missing"][0] > 0
    elif check == "mirrored":
        cpu.mirror_where_produced(spec, CELL, monkeypatch)
        out = cpu.run_tiny(spec, CELL, work, seed=SEED)
        assert out["correct"] is False
        assert out["check"]["mae_lsb"][0] > out["check"]["mae_lsb"][1]
    else:
        out = control.readings(spec, CELL, SEED, torch.device("cpu"),
                               tmp_path / "control")
        assert out["correct"] is False
        assert out["check"]["mae_lsb"][0] > out["check"]["mae_lsb"][1]
    assert _checkout() == before


def test_a_config_without_a_tiny_file_names_the_file(tmp_path):
    data = copy.deepcopy(harness.Spec.load().data)
    data["configs"].append({"name": CONFIG})
    with pytest.raises(FileNotFoundError, match=f"{CONFIG}.py"):
        cpu.tiny_spec_dir(data, tmp_path / "spec")
