"""Drives the dual-fisheye tool: ``gs360x_torch.tools.dualfisheye.main`` with
the configuration's flags over a folder of ``_X``/``_Y`` lens pairs.

``main`` loads the calibration and builds its host maps on every call and
has no stop, so one call serves the whole run: the first
``warmup_pairs`` pairs warm up, and the window opens when ``main`` prints
that pair's progress line (``[W/N] <base>``) and closes when ``main``
returns, its writer pool drained. The folder lists ``warmup_pairs`` plus
``pairs_per_s_sizing × --seconds`` linked pairs (``--limit`` says as
much), so the window lasts about ``--seconds`` at the rate the traffic
file was sized at; a faster program finishes the same pairs sooner.
``pairs_per_s`` is the views written inside the window, over the views a
pair, over the window: encodes of warm-up pairs that finish inside the
window count as the work they are.
"""

from __future__ import annotations

import math
import pathlib
import re
import time
import xml.etree.ElementTree as ET

import torch

from portbench import harness, scenes, work
from portbench.reference import compare, cube, fisheye


def write_calibration(calib: dict, path: pathlib.Path) -> pathlib.Path:
    """A Metashape calibration XML of one equisolid fisheye sensor."""
    doc = ET.Element("document", {"version": "1.2.0"})
    chunk = ET.SubElement(doc, "chunk")
    sensors = ET.SubElement(chunk, "sensors")
    sensor = ET.SubElement(sensors, "sensor", {"id": "0",
                                               "type": "equisolid_fisheye"})
    res = {"width": str(calib["width"]), "height": str(calib["height"])}
    ET.SubElement(sensor, "resolution", res)
    cal = ET.SubElement(sensor, "calibration", {"type": "equisolid_fisheye",
                                                "class": "adjusted"})
    ET.SubElement(cal, "resolution", res)
    for key in ("f", "cx", "cy", "k1", "k2", "k3", "k4", "p1", "p2"):
        if key in calib:
            ET.SubElement(cal, key).text = repr(float(calib[key]))
    ET.ElementTree(doc).write(path, encoding="utf-8", xml_declaration=True)
    return path


STATS = re.compile(r"([\w+]+) ([0-9.]+)s/(\d+)")
# the remap launch's return value is the views as the cell produces them
PRODUCES = ("gs360x_torch.kernels.remap_cuda", "remap_planes")


def lut_path(work_dir: pathlib.Path) -> pathlib.Path:
    return work_dir / "lut.cube"


def inputs(cfg: dict, traffic: dict, seed: int,
           work_dir: pathlib.Path) -> list:
    """The traffic's distinct lens pairs, as JPEG files under
    ``work_dir / "inputs"`` (X and Y of each pair in turn), and, where the
    traffic names a LUT, its seeded ``.cube`` at ``lut_path(work_dir)``."""
    if traffic.get("lut"):
        scenes.write_cube(lut_path(work_dir), scenes.cube_table(
            seed, int(traffic["lut"]["size"])))
    return scenes.make_inputs(seed, (cfg["calibration"]["width"],), traffic,
                              work_dir / "inputs")


def reference(cfg: dict, distinct, keys, dtype: torch.dtype,
              device: torch.device, traffic: dict,
              work_dir: pathlib.Path) -> dict:
    """The reference's u8 view of each (distinct pair, view) of ``keys``,
    computed in ``dtype`` from the lens images (``distinct``: X and Y of
    each pair in turn) and, where the traffic has one, the ``.cube`` under
    ``work_dir``: ``{(pair, view id): (size, size, 3) u8}``."""
    table = cube.read_cube(lut_path(work_dir)) if traffic.get("lut") \
        else None
    maps = fisheye.view_maps(cfg, dtype, device)
    sources, refs = {}, {}
    for pair, view in keys:
        lens, *view_maps = maps[view["id"]]
        if (pair, lens) not in sources:
            img = compare.read_u8(distinct[2 * pair + "XY".index(lens)])
            src = torch.from_numpy(img.copy()).to(device).to(dtype) / 255
            if table is not None:
                src = cube.rec709_to_srgb(cube.apply_lut(src, table))
            sources[(pair, lens)] = src
        if (pair, view["id"]) not in refs:
            refs[(pair, view["id"])] = fisheye.render(
                sources[(pair, lens)], view_maps, cfg["interp"], cfg["fill"])
    return refs


def run(cell: harness.Cell, bench: harness.Bench) -> harness.Outcome:
    from gs360x_torch.io import image as imagelib
    from gs360x_torch.kernels import _build
    from gs360x_torch.tools import dualfisheye

    cfg, traffic, wd = cell.config, cell.traffic, cell.work
    calib = cfg["calibration"]
    layout = cfg["views"]["layout"]
    t = time.perf_counter()
    distinct = inputs(cfg, traffic, cell.seed, wd)
    bench.notes["inputs_s"] = round(time.perf_counter() - t, 6)
    bench.notes["input_bytes"] = [p.stat().st_size for p in distinct]
    n_warm = int(traffic["warmup_pairs"])
    n_pairs = n_warm + max(1, math.ceil(cell.seconds
                                        * traffic["pairs_per_s_sizing"]))
    bases = [f"s{k:06d}" for k in range(n_pairs)]
    scenes.link_names(distinct, [f"{b}_{lens}.jpg" for b in bases
                                 for lens in "XY"], wd / "pairs")
    out_dir = wd / "out"
    argv = ["-i", str(wd / "pairs"), "-o", str(out_dir), "--limit",
            str(n_pairs), "--stats", "--device", cell.device.type,
            *cfg["args"]]
    lut = None
    if traffic.get("lut"):
        lut = lut_path(wd)
        argv += ["--input-lut", str(lut)]
    if cfg["program_calibration"] == "xml":
        argv += ["--camera-xml",
                 str(write_calibration(calib, wd / "calibration.xml"))]
    bench.notes["pairs"] = f"{n_warm} warm-up + {n_pairs - n_warm} timed"

    if cell.device.type == "cuda":
        t = time.perf_counter()
        _build.load()
        bench.notes["library_s"] = round(time.perf_counter() - t, 6)
        bench.notes["library_build_s"] = round(_build.build_seconds, 6)
    if cell.traced:
        bench.notes["remap_bound"] = work.remap_launches(
            cfg, lut is not None, cell.device)

    # every run counts the views written, and when (the window's count)
    written = []
    inner_write = imagelib.write_image

    def counted_write(*args, **kwargs):
        inner_write(*args, **kwargs)
        written.append(time.perf_counter())
    bench.patch(imagelib, "write_image", counted_write)
    # host spans, by which the breakdown's idle gaps are named
    bench.wrap(dualfisheye, "read_image", "decode")
    bench.wrap(dualfisheye, "prepare_input_planes", "upload")
    bench.wrap(dualfisheye._LensViews, "render", "remap+fetch")
    bench.wrap(imagelib, "write_image", "encode")

    mark = f"[{n_warm}/{n_pairs}] "
    lines, ticks = [], []

    def on_line(line: str) -> None:
        lines.append(line)
        if line.startswith(mark):
            bench.window_start()
        if bench.is_open() and line.startswith("["):
            ticks.append(time.perf_counter())

    with harness.program_output(wd / "program.log", on_line):
        try:
            rc = dualfisheye.main(argv)
        finally:
            bench.window_end()
    if bench.start is None:
        raise RuntimeError(f"dualfisheye exited {rc} before pair {n_warm}: "
                           + " | ".join(lines[-5:]))
    ok = [ln for ln in lines if ln.startswith("[OK] processed=")]
    m = re.match(r"\[OK\] processed=(\d+) failed=(\d+)", ok[-1] if ok else "")
    processed, failed = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
    if rc != 0 or not m:
        failed = max(failed, n_pairs - processed)
    stats = [ln for ln in lines if ln.startswith("[STATS]")]
    stage_seconds, stage_counts = {}, {}
    for name, secs, count in STATS.findall(stats[-1] if stats else ""):
        stage_seconds[name], stage_counts[name] = float(secs), int(count)
    in_window = sum(1 for t in written if t >= bench.start)
    if len(ticks) > 1:
        bench.notes["longest_pair_gap_s"] = round(
            max(b - a for a, b in zip(ticks, ticks[1:])), 3)
    bench.notes["views_in_window"] = in_window
    bench.notes["rc"] = rc

    def check(dtype: torch.dtype) -> dict:
        images = out_dir / "perspective" / "images"
        expected = [(k, v) for k in range(n_warm, n_pairs) for v in layout]
        paths = [images / f"{bases[k]}_{v['id']}.jpg" for k, v in expected]
        present = [p.is_file() and p.stat().st_size > 0 for p in paths]
        picks = harness.sample(cell.seed, len(paths), traffic["check_sample"])
        n_distinct = len(distinct) // 2
        keys = [(expected[i][0] % n_distinct, expected[i][1]) for i in picks]
        refs = reference(cfg, distinct, keys, dtype, cell.device, traffic,
                         cell.work)
        pairs = [(compare.read_u8(paths[i]), refs[(d, v["id"])])
                 for i, (d, v) in zip(picks, keys) if present[i]]
        return compare.numbers(pairs, present.count(False))

    return harness.Outcome(
        e2e={"pairs_per_s": in_window / len(layout) / bench.window_s},
        attempted=max(0, n_pairs - n_warm), failed=failed, check=check,
        counts={"pairs": in_window / len(layout), "views": in_window,
                "views_per_pair": len(layout)},
        stage_seconds=stage_seconds, stage_counts=stage_counts,
        work={"remap": bench.notes.get("remap_bound", {})})
