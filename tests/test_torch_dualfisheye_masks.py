"""The port's dual-fisheye tool with MaskSeg's masks (``--mask-input-dir``)
on the CPU, against the benchmark's plain reference
(``portbench/reference/mask.py``) with no JAX: each view's mask, co-warped
through ``dualfisheye.main`` from seeded lens masks named ``<stem>.png``
beside JPEG lens pairs, equal to the reference's but at pixels whose
coordinate lies within 1e-3 of a rounding tie; the lookup (the file of
the image's own name wins over ``<stem>.png``, which is found; a lens with
neither is counted, written without masks and named in one ``[WARN]``
line); the ``mask_decode``, ``mask_remap+fetch`` and ``mask_encode`` spans,
their threads and counts, the views' ``encode`` spans without masks, and
``[STATS]`` as the benchmark's driver parses it; the mask counter read by
window through its reader; the roofline reader's kernel names; the cell
in ``BENCHMARK.json``; and the masks half a pixel off or through bfloat16
maps over the cell's ``far_pct`` limit."""

import json
import pathlib
import re
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gs360x_torch.runtime import profiling as tprof
from gs360x_torch.tools import dualfisheye as tdf
from portbench import harness
from portbench.mask_work import is_mask_launch
from portbench.reference import fisheye
from portbench.reference import mask as maskref

torch.set_num_threads(1)

DRIVER = harness.load_module(harness.HERE / "drivers"
                             / "dualfisheye_masks.py")
CONFIG = "dualfisheye-masks-osmo360-sfm10"
CELL = "dualfisheye-masks.osmo360-sfm10.png-masks"
# the co-warp is exact but where the tool's float32 maps and the
# reference's float64 maps may round a coordinate to different texels
TIE_TOL = 1e-3


def _tiny(name: str, module: str, kind: str) -> dict:
    tiny = harness.load_module(harness.HERE / "tests" / "tiny"
                               / f"{CONFIG}.py")
    data = harness.load_json(harness.HERE / kind / f"{name}.json")
    return getattr(tiny, module)(data)


CFG = _tiny(CONFIG, "config", "configs")
TRAFFIC = _tiny(CELL, "traffic", "workloads")
LAYOUT = CFG["views"]["layout"]


def _rig(tmp_path, seed: int, pairs: int = 2):
    """The tiny configuration's calibration, ``pairs`` linked lens pairs
    ``s000k_X.jpg`` / ``_Y.jpg`` and their masks ``s000k_X.png`` under
    ``masks``: (pair dir, mask dir, distinct inputs, argv)."""
    distinct = DRIVER.inputs(CFG, TRAFFIC, seed, tmp_path)
    names = [f"s{k:04d}_{lens}" for k in range(pairs) for lens in "XY"]
    for sub, ext, targets in (
            ("pairs", "jpg", distinct),
            ("masks", "png", [DRIVER.mask_path(distinct, k, tmp_path)
                              for k in range(len(distinct))])):
        d = tmp_path / sub
        d.mkdir()
        for k, name in enumerate(names):
            (d / f"{name}.{ext}").symlink_to(targets[k % len(targets)])
    xml = DRIVER.write_calibration(CFG["calibration"],
                                   tmp_path / "calibration.xml")
    argv = ["-i", str(tmp_path / "pairs"), "-o", str(tmp_path / "out"),
            "--camera-xml", str(xml), "--device", "cpu", "--stats",
            *DRIVER._mask_dir_args(CFG["args"], tmp_path / "masks")]
    return tmp_path / "pairs", tmp_path / "masks", distinct, argv


def _written_mask(tmp_path, base: str, vid: str) -> torch.Tensor:
    path = tmp_path / "out" / "perspective" / "masks" / f"{base}_{vid}.png"
    return torch.from_numpy(np.array(Image.open(path)))


@pytest.mark.parametrize("seed", [3, 2 ** 35 + 17])
def test_cowarp_matches_the_plain_reference(tmp_path, seed):
    _pairs, _masks, distinct, argv = _rig(tmp_path, seed)
    assert tdf.main(argv) == 0
    maps = fisheye.view_maps(CFG, torch.float64)
    lens_masks = [maskref.read_mask(DRIVER.mask_path(distinct, k, tmp_path))
                  for k in range(len(distinct))]
    seen, ties = set(), 0
    for pair in range(2):
        for view in LAYOUT:
            lens, *view_maps = maps[view["id"]]
            ref = maskref.cowarp(lens_masks[2 * pair + "XY".index(lens)],
                                 tuple(view_maps))
            got = _written_mask(tmp_path, f"s{pair:04d}", view["id"])
            tie = maskref.near_tie(tuple(view_maps), TIE_TOL)
            assert got.shape == ref.shape
            assert torch.equal(got[~tie], ref[~tie]), (pair, view["id"])
            seen |= set(got.unique().tolist())
            ties += int(tie.sum())
    # both the subject and the rest reach the views; ties are rare
    assert seen == {0, 255}
    assert ties < 0.01 * 2 * len(LAYOUT) * CFG["views"]["size"] ** 2


def _constant_png(path: pathlib.Path, value: int) -> None:
    Image.fromarray(np.full((192, 192), value, np.uint8)).save(path)


@pytest.mark.parametrize("case", ["own_name_wins", "stem_png",
                                  "missing"])
def test_mask_lookup(tmp_path, capsys, case):
    """The X lens's mask under its own name (``.jpg``, all 0) beside a
    ``<stem>.png`` (all 255): the first wins; ``<stem>.png`` alone is
    found; a lens without either is written without masks and named."""
    _pairs, masks, _distinct, argv = _rig(tmp_path, 11, pairs=1)
    for lens in "XY":
        (masks / f"s0000_{lens}.png").unlink()
        if not (case == "missing" and lens == "Y"):
            _constant_png(masks / f"s0000_{lens}.png", 255)
    if case == "own_name_wins":
        Image.fromarray(np.zeros((192, 192), np.uint8)).save(
            masks / "s0000_X.jpg", quality=95)
    before = tdf.mask_counts()
    assert tdf.main(argv) == 0
    out, err = capsys.readouterr()
    after = tdf.mask_counts()
    found = 1 if case == "missing" else 2
    assert {k: after[k] - before[k] for k in after} == \
        {"looked_up": 2, "found": found}
    assert f"| masks {found} of 2" in out
    warns = [ln for ln in err.splitlines() if ln.startswith("[WARN]")]
    if case == "missing":
        assert len(warns) == 1 and warns[0].startswith(
            "[WARN] 1 of 2 lens image(s) had no mask in ")
    else:
        assert not warns
    maps = fisheye.view_maps(CFG, torch.float64)
    written = {p.stem for p in (tmp_path / "out" / "perspective"
                                / "masks").iterdir()}
    for view in LAYOUT:
        lens, _mx, _my, valid = maps[view["id"]]
        if case == "missing" and lens == "Y":
            assert f"s0000_{view['id']}" not in written
            continue
        got = _written_mask(tmp_path, "s0000", view["id"])
        inside = 0 if case == "own_name_wins" and lens == "X" else 255
        assert torch.equal(got, torch.where(valid, inside, 0).to(
            torch.uint8)), view["id"]
    views = list((tmp_path / "out" / "perspective" / "images").iterdir())
    assert len(views) == len(LAYOUT)


def _by_name(held):
    out = {}
    for name, tid, t0, t1, cpu in held:
        out.setdefault(name, []).append((tid, t0, t1, cpu))
    return out


def test_mask_spans_threads_counts_and_stats(tmp_path, capsys):
    """2 pairs: a ``mask_decode`` a lens inside its lens's ``decode`` on
    the thread that decodes the lens (the pair's on the decode thread, the
    Y lens's ring-only one on its helper), a ``mask_remap+fetch`` a lens on
    the loop, a ``mask_encode`` a mask on the writers; the views' ``encode``
    spans count views only; ``[STATS]`` parses with the benchmark's regex, one
    ``decode`` a pair in it."""
    *_, argv = _rig(tmp_path, 5)
    since = time.perf_counter()
    assert tdf.main(argv) == 0
    out = capsys.readouterr().out
    spans = _by_name(tprof.spans(since))
    main = threading.get_native_id()
    counts = {name: len(v) for name, v in spans.items()}
    assert {k: counts[k] for k in ("decode", "mask_decode", "upload",
                                   "remap+fetch", "mask_remap+fetch",
                                   "encode", "mask_encode")} == {
        "decode": 4, "mask_decode": 4, "upload": 2, "remap+fetch": 4,
        "mask_remap+fetch": 4, "encode": 20, "mask_encode": 20}
    decoders = {tid for tid, *_ in spans["decode"]}
    assert {tid for tid, *_ in spans["mask_decode"]} == decoders
    assert main not in decoders
    for tid, t0, t1, _cpu in spans["mask_decode"]:
        assert any(d_tid == tid and d0 <= t0 <= t1 <= d1
                   for d_tid, d0, d1, _ in spans["decode"])
    assert {tid for tid, *_ in spans["mask_remap+fetch"]} == {main}
    writers = {tid for tid, *_ in spans["mask_encode"]}
    assert writers and not writers & (decoders | {main})
    line = [ln for ln in out.splitlines() if ln.startswith("[STATS]")][-1]
    stats = {name: int(n) for name, _s, n in DRIVER.STATS.findall(line)}
    assert stats == {**counts, "decode": 2}
    assert re.search(r"\| masks 4 of 4 \| lens overlap [0-2] of 2$", line)
    images = tmp_path / "out" / "perspective" / "images"
    assert len(list(images.iterdir())) == counts["encode"]


def test_mask_cowarp_reader_reads_the_window(tmp_path):
    """The counter's lookups that started in a window, through the
    benchmark's reader: all found in the run's window, none before."""
    *_, argv = _rig(tmp_path, 7, pairs=1)
    start = time.perf_counter()
    assert tdf.main(argv) == 0
    end = time.perf_counter()
    reader = harness.load_module(harness.HERE / "metrics"
                                 / "mask_cowarp_pct.py")

    class Window:
        def __init__(self, a, b):
            self.bench = type("B", (), {"start": a, "end": b})()
    assert reader.read(Window(start, end)) == 100.0
    assert tdf.mask_counts(start, end) == {"looked_up": 2, "found": 2}
    assert reader.read(Window(start - 1e-3, start)) is None


@pytest.mark.parametrize("name,mask", [
    ("void (anonymous namespace)::remap_kernel<gs360x::Planes<unsigned "
     "char, 1>, unsigned char, 0>(gs360x::Planes<unsigned char, 1>, float "
     "const*, float const*, unsigned char const*, unsigned char*, "
     "(anonymous namespace)::Geometry)", True),
    ("void (anonymous namespace)::remap_kernel<gs360x::Texels, unsigned "
     "char, 3>(gs360x::Texels, float const*, float const*, unsigned char "
     "const*, unsigned char*, (anonymous namespace)::Geometry)", False),
    ("void (anonymous namespace)::remap_kernel<gs360x::Planes<float, 3>, "
     "unsigned char, 3>(gs360x::Planes<float, 3>, float const*, float "
     "const*, unsigned char const*, unsigned char*, (anonymous "
     "namespace)::Geometry)", False),
    ("void (anonymous namespace)::remap_kernel<gs360x::Planes<unsigned "
     "char, 1>, unsigned char, 1>(...)", False),
])
def test_mask_launches_told_apart(name, mask):
    assert is_mask_launch(name) is mask


def test_benchmark_lists_the_cell_and_its_metrics():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells[CELL]["config"] == CONFIG and cells[CELL]["chips"] == 1
    mine = {m["name"] for m in spec["per_layer"]
            if CELL in m.get("workloads", [])}
    assert mine == {"mask_decode_ms_per_pair", "mask_cowarp_pct",
                    "mask_remap_fetch_ms_per_pair",
                    "mask_encode_ms_per_pair", "mask_remap_roofline",
                    "lens_overlap_pct.dualfisheye"}
    (rate,) = [m for m in spec["end_to_end"] if m["name"] == "pairs_per_s"]
    assert CELL in rate["workloads"]


@pytest.mark.parametrize("control", ["floor", "bfloat16"])
def test_mask_controls_fail_the_limit(tmp_path, control):
    """The masks co-warped half a pixel off, or through maps computed in
    bfloat16, in the program's place: over the cell's ``far_pct`` limit
    (the readings at the cell's size are in PERF.md)."""
    found = DRIVER.mask_control(CFG, TRAFFIC, 2 ** 33 + 1,
                                torch.device("cpu"), tmp_path, control)
    assert found["far_pct"] > TRAFFIC["limits"]["far_pct"]
