"""The port's FrameSelector (:mod:`gs360x_torch.tools.frameselector`)
against the JAX package's (:mod:`gs360x.tools.frameselector`) on the CPU.

The copied host code (grouping, segment selection, boundary
re-optimization, gap/motion/low-light augmentation, pruning, the hybrid
normalization, CSV write/read) gives the same sets and CSV rows on seeded
metrics. The CLI (``--device cpu``: the plain version of ``planarize.cu``
and the plain torch metrics) runs beside the JAX CLI on the ``make_frame``
fixtures of ``tests/test_frameselector_cli.py``: CSVs equal except the
float columns (rtol 1e-4), and the same files kept and moved — for every
``--metric``, ``--score_backend ffmpeg``, pair mode (the circle mask), both
flow methods, ``--prune_motion``, ``--augment_motion``,
``--augment_lowlight``, and ``-a`` / ``-r`` replay."""

import csv
import shutil

import numpy as np
import pytest
import torch

from gs360x.io import image as im
from gs360x.tools import frameselector as jfs
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.tools import frameselector as tfs
from test_frameselector_cli import make_frame

torch.set_num_threads(1)

RTOL = 1e-4
FLOAT_COLUMNS = ("score", "brightness_mean", "group_score", "flow_motion")
SHARPNESS = [0.2, 0.3, 0.25, 0.9, 0.2, 0.3, 0.2, 0.25, 0.3, 0.95, 0.25, 0.2]


# --- host code: the JAX tool's, copied -----------------------------------

def _metrics(module, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = module.FrameMetrics(
            score=None if i % 11 == 5 else float(rng.random() * 10),
            lap=float(rng.random() * 1e4), ten=float(rng.random() * 1e3),
            fft=float(rng.random() * 50),
            brightness=float(rng.random()),
            brightness_weight=float(0.5 + 0.5 * rng.random()),
            motion_factor=float(0.6 + 0.4 * rng.random()),
            flow=float(rng.random() * 4) if i % 7 else 9999.0)
        out.append(m)
    return out


def _records(module, n, tmp_path, missing=()):
    recs = []
    for i in range(n):
        p = tmp_path / f"f_{i:04d}.png"
        if i not in missing:
            p.touch()
        recs.append(module.Record(index=i, input_mode="single",
                                  file_paths=[p]))
    return recs


@pytest.mark.parametrize("seed,segment", [(0, 6), (1, 5), (2, 10), (3, 3)])
def test_selection_pipeline_equals_jax(tmp_path, seed, segment):
    n = 47
    rj, rt = (_records(m, n, tmp_path, missing={4, 30})
              for m in (jfs, tfs))
    mj, mt = _metrics(jfs, n, seed), _metrics(tfs, n, seed)
    min_diff = jfs.round_half_up(segment * jfs.MIN_DIFF_FRAMES_RATIO)
    assert min_diff == tfs.round_half_up(segment * tfs.MIN_DIFF_FRAMES_RATIO)
    jfs.hybrid_normalize(mj)
    tfs.hybrid_normalize(mt)
    gj, gt = jfs.build_groups(rj, mj, segment), tfs.build_groups(rt, mt,
                                                                 segment)
    assert [vars(g) for g in gj] == [vars(g) for g in gt]
    sj = jfs.initial_segment_selection(rj, mj, gj)
    st = tfs.initial_segment_selection(rt, mt, gt)
    assert sj == st
    sj = jfs.boundary_reopt(rj, mj, gj, sj, min_diff)
    st = tfs.boundary_reopt(rt, mt, gt, st, min_diff)
    assert sj == st
    existing = [i for i in range(n) if rj[i].exists()]
    max_spacing = int(segment * (1 + jfs.MAX_SPACING_RATIO))
    for mode in ("single", "strict"):
        assert jfs.augment_spacing(sj, existing, mj, max_spacing, min_diff,
                                   mode) == \
            tfs.augment_spacing(st, existing, mt, max_spacing, min_diff,
                                mode)
    assert jfs.prune_low_motion(sj, mj) == tfs.prune_low_motion(st, mt)
    assert jfs.augment_lowlight_groups(sj, rj, mj, gj, min_diff) == \
        tfs.augment_lowlight_groups(st, rt, mt, gt, min_diff)
    assert jfs.augment_motion_segments(sj, gj, existing, mj, min_diff) == \
        tfs.augment_motion_segments(st, gt, existing, mt, min_diff)

    jfs.write_csv(tmp_path / "j.csv", rj, mj, sj, "single")
    tfs.write_csv(tmp_path / "t.csv", rt, mt, st, "single")
    assert (tmp_path / "j.csv").read_text() == (tmp_path / "t.csv").read_text()
    mj2, mt2 = _metrics(jfs, n, 99), _metrics(tfs, n, 99)
    assert jfs.load_csv(tmp_path / "j.csv", rj, mj2) == \
        tfs.load_csv(tmp_path / "j.csv", rt, mt2)
    assert [vars(m) for m in mj2] == [vars(m) for m in mt2]


def test_gather_records_equals_jax(tmp_path):
    for name in ("c_0010.png", "c_0002.jpg", "c_0001.tif", "p_X.png",
                 "p_Y.png", "notes.txt"):
        (tmp_path / name).touch()
    for ext in tfs.EXT_CHOICES:
        for sort in ("lastnum", "firstnum", "name"):
            for mode in ("auto", "single", "pair"):
                rj, mj = jfs.gather_records(tmp_path, ext, sort, mode)
                rt, mt = tfs.gather_records(tmp_path, ext, sort, mode)
                assert mj == mt
                assert [vars(r) for r in rj] == [vars(r) for r in rt]


# --- the whole CLI -------------------------------------------------------

@pytest.fixture
def frames_dir(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    for i, s in enumerate(SHARPNESS):
        im.write_image(d / f"frame_{i:04d}.png", make_frame(s, seed=i))
    return d


@pytest.fixture
def pairs_dir(tmp_path):
    d = tmp_path / "pairs"
    d.mkdir()
    for i in range(6):
        s = 0.9 if i == 2 else 0.2
        im.write_image(d / f"f{i:03d}_X.png", make_frame(s, seed=i))
        im.write_image(d / f"f{i:03d}_Y.png", make_frame(s, seed=i + 50))
    return d


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _assert_csv_close(got_path, ref_path):
    ref, got = _rows(ref_path), _rows(got_path)
    assert len(got) == len(ref) and ref
    assert list(got[0]) == list(ref[0]) == jfs.CSV_HEADER
    for g, r in zip(got, ref):
        for key in jfs.CSV_HEADER:
            if key in FLOAT_COLUMNS:
                assert float(g[key]) == pytest.approx(float(r[key]),
                                                      rel=RTOL, abs=1e-9), key
            else:
                assert g[key] == r[key], key


def _tree(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*.png"))


def _run_both(tmp_path, src, args):
    """Both CLIs on copies of ``src``; returns the two copies."""
    ref_dir, got_dir = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(src, ref_dir)
    shutil.copytree(src, got_dir)
    assert jfs.main(["-i", str(ref_dir)] + args) == 0
    warp_cuda.reset_counters()
    assert tfs.main(["-i", str(got_dir), "--device", "cpu"] + args) == 0
    assert warp_cuda.LAUNCHES["planarize"] == 0
    return ref_dir, got_dir


@pytest.mark.parametrize("extra", [
    ["-m", "hybrid"], ["-m", "lapvar"], ["-m", "tenengrad"], ["-m", "fft"],
    ["--score_backend", "ffmpeg"], ["--score_backend", "opencv"],
    ["--compute_optical_flow"],
    ["--compute_optical_flow", "--flow_method", "farneback"],
    ["--prune_motion"], ["--augment_motion"], ["--augment_lowlight"],
    ["--no-ignore-highlights", "--no_augment_gaps"]])
def test_cli_matches_jax(tmp_path, frames_dir, extra):
    ref_dir, got_dir = _run_both(tmp_path, frames_dir,
                                 ["-n", "6", "-c", "sel.csv"] + extra)
    # one planarize per scored image
    assert warp_cuda.PLAIN_CALLS["planarize"] == len(SHARPNESS)
    _assert_csv_close(got_dir / "sel.csv", ref_dir / "sel.csv")
    assert _tree(got_dir) == _tree(ref_dir)
    assert (ref_dir / "blur").is_dir()
    kept = [r["filename"] for r in _rows(got_dir / "sel.csv")
            if r["selected(1=keep)"] == "1"]
    assert "frame_0003.png" in kept and "frame_0009.png" in kept


def test_pair_mode_matches_jax(tmp_path, pairs_dir):
    ref_dir, got_dir = _run_both(tmp_path, pairs_dir,
                                 ["-n", "6", "--no_augment_gaps", "-c",
                                  "p.csv"])
    assert warp_cuda.PLAIN_CALLS["planarize"] == 12
    _assert_csv_close(got_dir / "p.csv", ref_dir / "p.csv")
    assert _tree(got_dir) == _tree(ref_dir)
    assert sorted(p.name for p in got_dir.glob("*.png")) == \
        ["f002_X.png", "f002_Y.png"]


@pytest.mark.parametrize("mode", ["apply", "reselect"])
def test_csv_replay_matches_jax(tmp_path, frames_dir, mode):
    assert jfs.main(["-i", str(frames_dir), "-n", "6", "-d", "-c", "sel.csv",
                     "--no_augment_gaps"]) == 0
    args = (["-a", "sel.csv"] if mode == "apply"
            else ["-r", "sel.csv", "-n", "3", "--no_augment_gaps"])
    ref_dir, got_dir = _run_both(tmp_path, frames_dir, args)
    assert warp_cuda.PLAIN_CALLS["planarize"] == 0   # nothing rescored
    assert _tree(got_dir) == _tree(ref_dir)
    assert (got_dir / "sel.csv").read_text() == \
        (ref_dir / "sel.csv").read_text()


def test_per_frame_blur_mode_matches_jax(tmp_path, frames_dir):
    ref_dir, got_dir = _run_both(tmp_path, frames_dir,
                                 ["-n", "0", "-d", "--blur-percent", "25",
                                  "-c", "pf.csv"])
    _assert_csv_close(got_dir / "pf.csv", ref_dir / "pf.csv")


def test_exit_codes_and_messages_match_jax(tmp_path, capsys):
    cases = [["-i", str(tmp_path / "missing")]]
    empty = tmp_path / "empty"
    empty.mkdir()
    cases.append(["-i", str(empty)])
    cases.append(["-i", str(empty), "-a", "none.csv"])
    cases.append(["-i", str(empty), "-r", "none.csv"])
    im.write_image(empty / "a_0001.png", make_frame(0.5))
    for args in cases:
        rc_ref = jfs.main(args)
        ref = capsys.readouterr()
        assert tfs.main(args + ["--device", "cpu"]) == rc_ref
        got = capsys.readouterr()
        assert got.err == ref.err


def test_cuda_device_without_a_card_raises(frames_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cuda"):
        tfs.main(["-i", str(frames_dir), "-d"])
