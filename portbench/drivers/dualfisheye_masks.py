"""Drives the dual-fisheye tool over lens pairs with MaskSeg's masks:
``gs360x_torch.tools.dualfisheye.main`` with the configuration's flags,
``--mask-input-dir`` pointed at the run's mask folder, over a folder of
``_X``/``_Y`` lens pairs.

The pairs, the calibration, the views and the window are the jpg-pairs
driver's (``drivers/dualfisheye.py``, loaded as the harness loads a
driver): one ``main`` call, the window from the progress line of the
``warmup_pairs``-th pair to ``main``'s return. Beside each lens image
``<base>_X.jpg`` lies its mask ``<base>_X.png``, as MaskSeg's ``--mode
mask`` writes it: an 8-bit gray PNG of the lens's size, Pillow's default
encoder, the subject 0 and the rest 255 (:func:`mask_image`). The tool
writes 10 views and 10 masks a pair; ``pairs_per_s`` is the files written
inside the window, views and masks alike, over the 20 a pair, over the
window. A run that writes views and no mask raises: a program without the
lookup of ``<stem>.png`` co-warps nothing, and is not a faster program.

The check holds views and masks to the cell's three numbers: ``missing``
counts absent views and absent masks; a seeded sample of (pair, view)
compares the view against the jpg-pairs reference and its mask against
:mod:`portbench.reference.mask`, in ``compare.numbers`` together (a mask's
pixel that differs is 255 LSB off, so ``far_pct`` reads the share of a
mask's pixels that differ).
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import pathlib
import re
import time

import numpy as np
import torch
from PIL import Image, ImageDraw

from portbench import harness, mask_work, scenes
from portbench.reference import compare, fisheye
from portbench.reference import mask as maskref

_PAIRS = harness.load_module(pathlib.Path(__file__).resolve().parent
                             / "dualfisheye.py")
STATS = _PAIRS.STATS
write_calibration = _PAIRS.write_calibration
# the remap launch's return value is the views and the masks as the cell
# produces them
PRODUCES = ("gs360x_torch.kernels.remap_cuda", "remap_planes")
MASK_FLAG = "--mask-input-dir"


def mask_inputs_dir(work_dir: pathlib.Path) -> pathlib.Path:
    return work_dir / "mask_inputs"


def _figure(draw: ImageDraw.ImageDraw, rng: np.random.Generator,
            x: float, y: float, h: float) -> None:
    """A passer-by ``h`` tall, feet at (x, y): a head and a body."""
    w = h * (0.28 + 0.08 * rng.random())
    head = h * 0.14
    draw.ellipse([x - head / 2, y - h, x + head / 2, y - h + head], fill=0)
    lean = (rng.random() - 0.5) * 0.2 * w
    draw.polygon([(x - w / 2, y - h + head * 1.1), (x + w / 2,
                  y - h + head * 1.1), (x + w / 3 + lean, y),
                  (x - w / 3 + lean, y)], fill=0)


def mask_image(seed: int, index: int, size: int, params: dict) -> np.ndarray:
    """The ``index``-th lens mask of ``seed``, (size, size) u8, as MaskSeg
    marks a lens image of a handheld Osmo 360: the operator's body and the
    selfie stick entering at the image circle's lower edge, and
    ``passers_by`` figures around the horizon, 0; the rest 255 (outside the
    image circle too: nothing is detected in the black)."""
    rng = scenes.rng_for(seed, 1 << 22, index)
    img = Image.new("L", (size, size), 255)
    draw = ImageDraw.Draw(img)
    c = (size - 1) / 2.0
    r = float(params["circle"]) * size / 2.0
    # the stick: a wedge from the circle's lower edge towards the nadir
    sx = c + (rng.random() - 0.5) * 0.06 * size
    half = size * (0.018 + 0.012 * rng.random())
    tip = c + r * (0.70 + 0.1 * rng.random())
    draw.polygon([(sx - half, size), (sx + half, size),
                  (sx + half / 3, tip), (sx - half / 3, tip)], fill=0)
    # the operator: body and arm over the lower edge, beside the stick
    side = 1.0 if rng.random() < 0.5 else -1.0
    ox = sx + side * size * (0.08 + 0.08 * rng.random())
    oy = c + r * (0.88 + 0.08 * rng.random())
    rx, ry = size * (0.12 + 0.08 * rng.random()), size * (0.08 + 0.05
                                                          * rng.random())
    draw.ellipse([ox - rx, oy - ry, ox + rx, oy + ry], fill=0)
    draw.polygon([(ox - side * rx * 0.3, oy - ry * 0.5), (sx, tip + size
                  * 0.02), (sx, tip + size * 0.06), (ox, oy)], fill=0)
    # passers-by, feet around the horizon, inside the circle
    for _ in range(int(params["passers_by"])):
        ang = (rng.random() - 0.5) * 1.6 * math.pi
        rad = r * (0.15 + 0.6 * rng.random())
        x = c + rad * math.sin(ang)
        y = c + r * (0.05 + 0.2 * rng.random())
        _figure(draw, rng, x, y, size * (0.05 + 0.1 * rng.random()))
    out = np.array(img)
    ax = (np.arange(size, dtype=np.float32) - c) / (size / 2.0)
    inside = (ax[None, :] ** 2 + ax[:, None] ** 2) \
        <= float(params["circle"]) ** 2
    out[~inside] = 255
    return out


def inputs(cfg: dict, traffic: dict, seed: int,
           work_dir: pathlib.Path) -> list:
    """The jpg-pairs driver's lens pairs (X and Y of each pair in turn),
    and one mask a lens image beside them, ``p<i>_X.png`` / ``p<i>_Y.png``
    under :func:`mask_inputs_dir`, written as MaskSeg writes one."""
    distinct = _PAIRS.inputs(cfg, traffic, seed, work_dir)
    out = mask_inputs_dir(work_dir)
    out.mkdir(parents=True, exist_ok=True)
    size = cfg["calibration"]["width"]
    params = dict(traffic["masks"], circle=traffic["scene"]["circle"])

    def make(k):
        path = out / f"{distinct[k].stem}.png"
        Image.fromarray(mask_image(seed, k, size, params)).save(path)
        return path
    with cf.ThreadPoolExecutor(8) as pool:
        list(pool.map(make, range(len(distinct))))
    return distinct


def mask_path(distinct, k: int, work_dir: pathlib.Path) -> pathlib.Path:
    return mask_inputs_dir(work_dir) / f"{distinct[k].stem}.png"


# the views' reference is the jpg-pairs driver's
reference = _PAIRS.reference


def mask_reference(cfg: dict, distinct, keys, dtype: torch.dtype,
                   device: torch.device, work_dir: pathlib.Path,
                   rounding=torch.round) -> dict:
    """The reference's mask of each (distinct pair, view) of ``keys``,
    through maps computed in ``dtype`` and rounded by ``rounding``, as
    the written PNG reads back through ``compare.read_u8``: ``{(pair, view
    id): (size, size, 3) u8}``."""
    maps = fisheye.view_maps(cfg, dtype, device)
    lens_masks, refs = {}, {}
    for pair, view in keys:
        lens, *view_maps = maps[view["id"]]
        k = 2 * pair + "XY".index(lens)
        if k not in lens_masks:
            lens_masks[k] = maskref.read_mask(mask_path(distinct, k,
                                                        work_dir))
        if (pair, view["id"]) not in refs:
            m = maskref.cowarp(lens_masks[k], tuple(view_maps), rounding)
            refs[(pair, view["id"])] = m[..., None].expand(-1, -1, 3)
    return refs


def mask_control(cfg: dict, traffic: dict, seed: int, device: torch.device,
                 work_dir: pathlib.Path, control: str) -> dict:
    """The check's numbers for the masks of a control in the program's
    place, over every (distinct pair, view): ``bfloat16`` (the maps
    computed in bfloat16) or ``floor`` (the float64 maps rounded down:
    each mask half a pixel off)."""
    distinct = inputs(cfg, traffic, seed, work_dir)
    keys = [(d, v) for d in range(len(distinct) // 2)
            for v in cfg["views"]["layout"]]
    ref = mask_reference(cfg, distinct, keys, torch.float64, device,
                         work_dir)
    low = mask_reference(cfg, distinct, keys,
                         torch.bfloat16 if control == "bfloat16"
                         else torch.float64, device, work_dir,
                         torch.floor if control == "floor" else torch.round)
    return compare.numbers([(low[k].cpu().numpy(), ref[k]) for k in ref], 0)


def mask_share(distinct, work_dir: pathlib.Path) -> list:
    """Each distinct lens mask's share of pixels marked as subject (0)."""
    return [round(float((maskref.read_mask(mask_path(distinct, k, work_dir))
                         == 0).double().mean()), 6)
            for k in range(len(distinct))]


def _mask_dir_args(args: list, mask_dir: pathlib.Path) -> list:
    """The configuration's flags with ``--mask-input-dir`` pointed at the
    run's mask folder."""
    out = list(args)
    at = out.index(MASK_FLAG) + 1
    out[at] = str(mask_dir)
    return out


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
    bench.notes["mask_bytes"] = [mask_path(distinct, k, wd).stat().st_size
                                 for k in range(len(distinct))]
    bench.notes["mask_share"] = mask_share(distinct, wd)
    n_warm = int(traffic["warmup_pairs"])
    n_pairs = n_warm + max(1, math.ceil(cell.seconds
                                        * traffic["pairs_per_s_sizing"]))
    bases = [f"s{k:06d}" for k in range(n_pairs)]
    names = [f"{b}_{lens}" for b in bases for lens in "XY"]
    scenes.link_names(distinct, [f"{n}.jpg" for n in names], wd / "pairs")
    scenes.link_names([mask_path(distinct, k, wd)
                       for k in range(len(distinct))],
                      [f"{n}.png" for n in names], wd / "masks")
    out_dir = wd / "out"
    images = out_dir / "perspective" / "images"
    masks = out_dir / "perspective" / "masks"
    argv = ["-i", str(wd / "pairs"), "-o", str(out_dir), "--limit",
            str(n_pairs), "--stats", "--device", cell.device.type,
            *_mask_dir_args(cfg["args"], wd / "masks")]
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
        bench.notes["mask_remap_bound"] = mask_work.mask_remap_launches(
            cfg, cell.device)

    # every run counts the files written, and when (the window's count),
    # and the writes the program starts, masks among them
    written, started, mask_writes = [], [], []
    inner_write = imagelib.write_image

    def counted_write(path, *args, **kwargs):
        started.append(path)
        if pathlib.Path(path).parent == masks:
            mask_writes.append(path)
        inner_write(path, *args, **kwargs)
        written.append(time.perf_counter())
    bench.patch(imagelib, "write_image", counted_write)
    # host spans, by which the breakdown's idle gaps are named (a mask's
    # read, render and write are a decode, a remap+fetch and an encode)
    bench.wrap(dualfisheye, "read_image", "decode")
    bench.wrap(dualfisheye, "prepare_input_planes", "upload")
    bench.wrap(dualfisheye._LensViews, "render", "remap+fetch")
    bench.wrap(imagelib, "write_image", "encode")

    per_pair = 2 * len(layout)
    mark = f"[{n_warm}/{n_pairs}] "
    lines, ticks = [], []

    def no_mask(at_least: int) -> None:
        # the writers start their files in submission order, a view's
        # mask right behind it
        if len(started) >= at_least and not mask_writes:
            raise RuntimeError(
                f"the program co-warped no mask: {len(started)} views "
                f"written, no mask (MaskSeg's <stem>.png masks under "
                f"{wd / 'masks'} not found)")

    def on_line(line: str) -> None:
        lines.append(line)
        if line.startswith(mark):
            # a program that finds no mask stops here, not a window later
            no_mask(4)
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
    no_mask(1)
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
    bench.notes["files_in_window"] = in_window
    bench.notes["rc"] = rc

    def check(dtype: torch.dtype) -> dict:
        expected = [(k, v) for k in range(n_warm, n_pairs) for v in layout]
        views = [images / f"{bases[k]}_{v['id']}.jpg" for k, v in expected]
        mask_files = [masks / f"{bases[k]}_{v['id']}.png"
                      for k, v in expected]
        present = [p.is_file() and p.stat().st_size > 0
                   for p in views + mask_files]
        picks = harness.sample(cell.seed, len(views), traffic["check_sample"])
        n_distinct = len(distinct) // 2
        keys = [(expected[i][0] % n_distinct, expected[i][1]) for i in picks]
        refs = reference(cfg, distinct, keys, dtype, cell.device, traffic,
                         cell.work)
        mrefs = mask_reference(cfg, distinct, keys, dtype, cell.device,
                               cell.work)
        pairs, mask_pairs = [], []
        for i, (d, v) in zip(picks, keys):
            if present[i]:
                pairs.append((compare.read_u8(views[i]), refs[(d, v["id"])]))
            if present[len(views) + i]:
                mask_pairs.append((compare.read_u8(mask_files[i]),
                                   mrefs[(d, v["id"])]))
        harness.info("masks alone: " + " | ".join(
            f"{k} {v}" for k, v in compare.numbers(
                mask_pairs, present[len(views):].count(False)).items()))
        return compare.numbers(pairs + mask_pairs, present.count(False))

    return harness.Outcome(
        e2e={"pairs_per_s": in_window / per_pair / bench.window_s},
        attempted=max(0, n_pairs - n_warm), failed=failed, check=check,
        counts={"pairs": in_window / per_pair, "files": in_window,
                "files_per_pair": per_pair},
        stage_seconds=stage_seconds, stage_counts=stage_counts,
        work={"mask_remap": bench.notes.get("mask_remap_bound", {})})
