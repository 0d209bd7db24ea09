"""dualfisheye's pair decode on two threads, on the CPU without JAX: each
pair's lens X (and its mask) on the decode-ahead stage's thread while a
helper of that thread decodes lens Y (and its mask), with
``dualfisheye.read_image`` wrapped to sleep a given time on each lens.
At ``--workers 1`` the two lenses overlap (``lens_overlap`` and
``[STATS]``), a pair's ``decode`` span is shorter than its lenses' reads
together, and ``[STATS]`` keeps one ``decode`` a pair; pairs reach the loop
in order whichever lens is slower; an image or mask read that raises, of
X or Y, fails its own pair only, with the exception the one-thread decode
reported (X's image, Y's image, X's mask, Y's mask: the first that
raised); each mask stays with its own lens; ``--workers`` 1 and 2 write the
same bytes, the masks equal to the plain reference and the views within
the masked cell's limits; no helper thread outlives ``main``."""

import pathlib
import re
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gs360x_torch.runtime.profiling import spans
from gs360x_torch.tools import dualfisheye as tdf
from portbench.reference import compare, fisheye
from portbench.reference import mask as maskref
from test_torch_dualfisheye_masks import (CFG, DRIVER, LAYOUT, TIE_TOL,
                                          TRAFFIC, _constant_png, _rig)

torch.set_num_threads(1)

PAIRS = 3
BASES = [f"s{k:04d}" for k in range(PAIRS)]


def _argv(argv, out, workers):
    """``argv`` writing to ``out`` with ``--workers workers``."""
    argv = list(argv)
    argv[argv.index("-o") + 1] = str(out)
    argv[argv.index("--workers") + 1] = str(workers)
    return argv


class Reads:
    """``dualfisheye.read_image`` wrapped: a read of lens ``L``'s image
    (``kind`` "image") or mask ("mask") sleeps ``delays[(L, kind)]`` s
    first and raises ``OSError`` where ``(base, L, kind)`` is in ``fail``;
    every read is kept as (name, kind, native thread id, start, end)."""

    def __init__(self, monkeypatch, delays=None, fail=()):
        self.inner = tdf.read_image
        self.delays, self.fail = dict(delays or {}), set(fail)
        self.calls = []
        self._lock = threading.Lock()
        monkeypatch.setattr(tdf, "read_image", self.read)

    def read(self, path, **kwargs):
        path = pathlib.Path(path)
        base, lens = path.stem.split("_")
        kind = "mask" if path.parent.name == "masks" else "image"
        t0 = time.perf_counter()
        try:
            time.sleep(self.delays.get((lens, kind), 0.0))
            if (base, lens, kind) in self.fail:
                raise OSError(f"cannot read {path.name}")
            return self.inner(path, **kwargs)
        finally:
            with self._lock:
                self.calls.append((path.name, kind,
                                   threading.get_native_id(), t0,
                                   time.perf_counter()))

    def of(self, name, kind):
        return [c for c in self.calls if c[0] == name and c[1] == kind]


def _files(out):
    return {p.relative_to(out): p.read_bytes() for p in out.rglob("*")
            if p.is_file()}


def _run(argv, capsys):
    code = tdf.main(argv)
    cap = capsys.readouterr()
    return code, cap.out, cap.err


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """3 pairs over the masked cell's tiny inputs, and the files and lines
    of a run at ``--workers 1`` with no delay."""
    _pairs, _masks, distinct, argv = _rig(tmp_path_factory.mktemp("rig"),
                                          23, pairs=PAIRS)
    out = pathlib.Path(argv[argv.index("-o") + 1])
    assert tdf.main(_argv(argv, out, 1)) == 0
    return argv, distinct, _files(out)


def test_one_worker_decodes_a_pairs_lenses_at_once(rig, tmp_path,
                                                   monkeypatch, capsys):
    argv, _distinct, files = rig
    reads = Reads(monkeypatch, {("X", "image"): 0.15, ("Y", "image"): 0.15})
    before = tdf.lens_overlap()
    since = time.perf_counter()
    code, out, _err = _run(_argv(argv, tmp_path / "out", 1), capsys)
    assert code == 0
    after = tdf.lens_overlap()
    assert {k: after[k] - before[k] for k in after} == \
        {"pairs": PAIRS, "overlapped": PAIRS}
    assert tdf.lens_overlap(since, time.perf_counter()) == \
        {"pairs": PAIRS, "overlapped": PAIRS}
    stats = [ln for ln in out.splitlines() if ln.startswith("[STATS]")][-1]
    assert stats.endswith(f"| masks 6 of 6 | lens overlap {PAIRS} of "
                          f"{PAIRS}")
    assert {name: int(n) for name, _s, n in
            DRIVER.STATS.findall(stats)}["decode"] == PAIRS
    decodes = [s for s in spans(since) if s[0] == "decode"]
    for base in BASES:
        (_, _, x_tid, x0, x1), = reads.of(f"{base}_X.jpg", "image")
        (_, _, y_tid, y0, y1), = reads.of(f"{base}_Y.jpg", "image")
        assert x_tid != y_tid and max(x0, y0) < min(x1, y1), base
        # each mask on its lens's thread, after its image
        for lens, tid, t1 in (("X", x_tid, x1), ("Y", y_tid, y1)):
            (_, _, m_tid, m0, _m1), = reads.of(f"{base}_{lens}.png", "mask")
            assert m_tid == tid and m0 >= t1, (base, lens)
        lenses = sum(c[4] - c[3] for c in reads.calls
                     if c[0].startswith(base))
        # the pair's decode on the stage's thread (X's), the helper's
        # ring-only lens decode around Y's reads
        (p0, p1), = [(s[2], s[3]) for s in decodes
                     if s[1] == x_tid and s[2] <= x0 <= x1 <= s[3]]
        assert len([s for s in decodes if s[1] == y_tid
                    and p0 <= s[2] <= y0 <= y1 <= s[3] <= p1]) == 1
        assert p1 - p0 < lenses, base
    assert _files(tmp_path / "out") == files


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("slow", ["X", "Y"])
def test_pairs_reach_the_loop_in_order(rig, tmp_path, monkeypatch, capsys,
                                       slow, workers):
    """One lens much slower than the other: the pairs still come in
    order, each written as without the delay."""
    argv, _distinct, files = rig
    Reads(monkeypatch, {(slow, "image"): 0.12, (slow, "mask"): 0.03})
    code, out, err = _run(_argv(argv, tmp_path / "out", workers), capsys)
    assert code == 0 and "[WARN]" not in err
    progress = [ln for ln in out.splitlines()
                if re.fullmatch(r"\[\d+/\d+\] s\d{4}", ln)]
    assert progress == [f"[{k + 1}/{PAIRS}] {b}" for k, b in
                        enumerate(BASES)]
    assert out.splitlines()[-1] == f"[OK] processed={PAIRS} failed=0"
    assert _files(tmp_path / "out") == files


# (the reads that raise in pair s0001, the one the one-thread decode named)
FAILURES = [
    ({("X", "image")}, ("X", "image")),
    ({("Y", "image")}, ("Y", "image")),
    ({("X", "mask")}, ("X", "mask")),
    ({("Y", "mask")}, ("Y", "mask")),
    ({("X", "image"), ("Y", "image")}, ("X", "image")),
    ({("Y", "image"), ("X", "mask")}, ("Y", "image")),
    ({("X", "mask"), ("Y", "mask")}, ("X", "mask")),
]


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("fail,named", FAILURES,
                         ids=["-".join(f"{lens}{kind}" for lens, kind in
                                       sorted(f)) for f, _ in FAILURES])
def test_a_failed_read_fails_its_own_pair(rig, tmp_path, monkeypatch, capsys,
                                          fail, named, workers):
    argv, _distinct, files = rig
    # the other lens slower, so that a failing read ends first
    Reads(monkeypatch, {(lens, "image"): 0.05 for lens in "XY"
                        if (lens, "image") not in fail},
          fail={("s0001", lens, kind) for lens, kind in fail})
    code, out, err = _run(_argv(argv, tmp_path / "out", workers), capsys)
    lens, kind = named
    ext = "jpg" if kind == "image" else "png"
    assert code == 2
    assert [ln for ln in err.splitlines() if ln.startswith("[WARN]")] == \
        [f"[WARN] pair s0001 failed: cannot read s0001_{lens}.{ext}"]
    lines = out.splitlines()
    assert [ln for ln in lines if re.fullmatch(r"\[\d+/\d+\] s\d{4}", ln)] \
        == [f"[{k + 1}/{PAIRS}] {b}" for k, b in enumerate(BASES)]
    assert lines[-1] == f"[OK] processed={PAIRS - 1} failed=1"
    got = _files(tmp_path / "out")
    assert got == {p: b for p, b in files.items()
                   if not p.name.startswith("s0001_")}


@pytest.mark.parametrize("slow", ["X", "Y"])
def test_each_mask_follows_its_own_lens(tmp_path, monkeypatch, capsys, slow):
    """Lens X's mask all 255, lens Y's all 0: X's views carry the model's
    valid area as their mask, Y's views none of it."""
    _pairs, masks, _distinct, argv = _rig(tmp_path, 29, pairs=1)
    for lens, value in (("X", 255), ("Y", 0)):
        (masks / f"s0000_{lens}.png").unlink()
        _constant_png(masks / f"s0000_{lens}.png", value)
    Reads(monkeypatch, {(slow, "image"): 0.08})
    code, _out, _err = _run(argv, capsys)
    assert code == 0
    maps = fisheye.view_maps(CFG, torch.float64)
    lenses = set()
    for view in LAYOUT:
        lens, _mx, _my, valid = maps[view["id"]]
        path = (tmp_path / "out" / "perspective" / "masks"
                / f"s0000_{view['id']}.png")
        got = torch.from_numpy(np.array(Image.open(path)))
        inside = 255 if lens == "X" else 0
        assert torch.equal(got, torch.where(valid, inside, 0).to(
            torch.uint8)), view["id"]
        lenses.add(lens)
    assert lenses == {"X", "Y"}


def test_two_workers_write_one_workers_bytes_and_the_reference(
        rig, tmp_path, monkeypatch, capsys):
    """``--workers 2`` against the one-worker run, byte for byte; the
    masks equal to the plain reference but at rounding ties, the views
    within the masked cell's limits; no helper thread alive after
    ``main``."""
    argv, distinct, files = rig
    reads = Reads(monkeypatch, {("Y", "image"): 0.02})
    code, _out, _err = _run(_argv(argv, tmp_path / "out", 2), capsys)
    assert code == 0
    assert _files(tmp_path / "out") == files
    helpers = {c[2] for c in reads.calls if c[0].endswith("_Y.jpg")}
    assert len(helpers) >= 1
    assert not helpers & {t.native_id for t in threading.enumerate()
                          if t.is_alive()}
    maps = fisheye.view_maps(CFG, torch.float64)
    n_distinct = len(distinct) // 2
    keys = [(k % n_distinct, v) for k in range(PAIRS) for v in LAYOUT]
    refs = DRIVER._PAIRS.reference(CFG, distinct, keys, torch.float64,
                                   torch.device("cpu"), TRAFFIC, tmp_path)
    views = []
    root = tmp_path / "out" / "perspective"
    for k, base in enumerate(BASES):
        for view in LAYOUT:
            views.append((compare.read_u8(root / "images"
                                          / f"{base}_{view['id']}.jpg"),
                          refs[(k % n_distinct, view["id"])]))
    found = compare.numbers(views, 0)
    assert compare.verdict(found, TRAFFIC["limits"]), found
    mask_dir = pathlib.Path(argv[argv.index("--mask-input-dir") + 1])
    for k, base in enumerate(BASES):
        for view in LAYOUT:
            lens, *view_maps = maps[view["id"]]
            src = maskref.read_mask(mask_dir / f"{base}_{lens}.png")
            ref = maskref.cowarp(src, tuple(view_maps))
            got = torch.from_numpy(np.array(Image.open(
                root / "masks" / f"{base}_{view['id']}.png")))
            tie = maskref.near_tie(tuple(view_maps), TIE_TOL)
            assert torch.equal(got[~tie], ref[~tie]), (base, view["id"])
