"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath, it comes out not correct. The faults a cell can have: half of
the outputs left out, and an answer altered where it is produced (a cell
has no training step, and one chip no exchange between chips). The
harness refuses a run in which JAX was loaded."""

import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests import cpu

CELLS = [w["name"] for w in harness.Spec.load().data["workloads"]]
SEED = cpu.SEED


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, traced, tiny_spec, tmp_path):
    out = cpu.run_tiny(tiny_spec, cell, tmp_path / "work", traced)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in (tiny_spec.per_layer(cell) if traced
                                 else tiny_spec.end_to_end(cell))}
    assert set(out["metrics"]) <= names
    if not traced:
        # the CPU's trace has no kernel: a device-trace metric is left out
        assert set(out["metrics"]) == {
            m["name"] for m in tiny_spec.end_to_end(cell)
            if m["source"] != "device_trace"}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "check"
    assert not (tmp_path / "work" / cell).exists()


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_outputs_left_out(cell, tiny_spec, tmp_path, monkeypatch):
    cpu.leave_half_out(monkeypatch)
    out = cpu.run_tiny(tiny_spec, cell, tmp_path / "work")
    assert out["correct"] is False
    assert out["check"]["missing"][0] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, tiny_spec, tmp_path,
                                       monkeypatch):
    """Every view mirrored as the function the cell's driver names in
    ``PRODUCES`` returns it."""
    cpu.mirror_where_produced(tiny_spec, cell, monkeypatch)
    out = cpu.run_tiny(tiny_spec, cell, tmp_path / "work")
    assert out["correct"] is False
    assert out["check"]["mae_lsb"][0] > out["check"]["mae_lsb"][1]


def test_jax_loaded_refuses_the_run(tiny_spec, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(RuntimeError, match="JAX"):
        cpu.run_tiny(tiny_spec, CELLS[0], tmp_path / "work")


def test_no_card_no_result(capsys, monkeypatch):
    """run.py exits non-zero and prints no result where there is no
    card."""
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_cell_on_the_card(tmp_path):
    """One short run of the first cell on the card: correct, with the
    card's name and a peak beside the metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell(harness.Spec.load(), CELLS[0], seed=SEED,
                           seconds=3.0, traced=False,
                           device=torch.device("cuda", 0),
                           t0=time.perf_counter(),
                           work_root=tmp_path / "work")
    assert out["correct"] is True, out["check"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
