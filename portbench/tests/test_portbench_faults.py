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

CELLS = [w["name"] for w in harness.Spec.load().data["workloads"]]
SEED = 2 ** 34 + 21


def _run(spec, cell, tmp_path, traced=False):
    return harness.run_cell(spec, cell, seed=SEED, seconds=1.0,
                            traced=traced, device=torch.device("cpu"),
                            t0=time.perf_counter(),
                            work_root=tmp_path / "work")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, traced, tiny_spec, tmp_path):
    out = _run(tiny_spec, cell, tmp_path, traced)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in (tiny_spec.per_layer(cell) if traced
                                 else tiny_spec.end_to_end(cell))}
    assert set(out["metrics"]) <= names
    if not traced:
        assert set(out["metrics"]) == names
        assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "check"
    assert not (tmp_path / "work" / cell).exists()


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_outputs_left_out(cell, tiny_spec, tmp_path, monkeypatch):
    from gs360x_torch.io import image as imagelib
    inner, calls = imagelib.write_image, []

    def every_other(*args, **kwargs):
        calls.append(1)
        if len(calls) % 2:
            inner(*args, **kwargs)
    monkeypatch.setattr(imagelib, "write_image", every_other)
    out = _run(tiny_spec, cell, tmp_path)
    assert out["correct"] is False
    assert out["check"]["missing"][0] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, tiny_spec, tmp_path,
                                       monkeypatch):
    """Every view mirrored as the resampling launch produces it."""
    from gs360x_torch.kernels import remap_cuda, warp_cuda
    owner, name = ((warp_cuda, "warp_equirect_to_views_cuda")
                   if cell.startswith("perspcut")
                   else (remap_cuda, "remap_planes"))
    inner = getattr(owner, name)
    monkeypatch.setattr(owner, name,
                        lambda *a, **k: inner(*a, **k).flip(-1))
    out = _run(tiny_spec, cell, tmp_path)
    assert out["correct"] is False
    assert out["check"]["mae_lsb"][0] > out["check"]["mae_lsb"][1]


def test_jax_loaded_refuses_the_run(tiny_spec, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(RuntimeError, match="JAX"):
        _run(tiny_spec, CELLS[0], tmp_path)


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
