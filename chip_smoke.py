#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``gs360x_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``gs360x_torch/csrc`` (into
``build/gs360x_torch/``), holds each kernel against its plain torch
version on the card at the main paths' shapes and times both (planarize
for every input/output type and every variant on an 8K frame, a 3840²
lens image and a ragged, unaligned view; the equirect warp on yaw-ring,
pitched, pole and fisheye views of an 8K frame; the remap on the Osmo 360
undistort map and the 10 SFM10 maps),
then drives each main path once through the port's CLIs and checks that
it went through the kernels only and that its pixels are right:

* ``gs360x-torch-perspcut`` on 2 synthetic 8K frames with the
  ``default``, ``fisheyelike`` and ``fisheyeXY`` presets (PNG);
* ``gs360x-torch-dualfisheye`` on 2 synthetic 3840² pairs with the
  generated default calibration, undistorted fisheyes, the 10 SFM10
  views and one mask pair (PNG), then once more through a 33³ ``.cube``
  LUT decode with sRGB output;
* ``gs360x-torch-video2frames`` on a 4-frame 8K 4:2:0 Y4M (PNG at 2 fps),
  then ``--fisheye-perspective`` on a 3840² lens Y4M;
* ``gs360x-torch-frameselector`` on 10 8K frames of graded sharpness with
  optical flow (Lucas–Kanade, then Farneback), and in pair mode on 4
  3840² ``_X``/``_Y`` pairs.

Phases print one line each; any failure raises and the exit code is not
0. Without CUDA, or without the rest of the checkout, it exits non-zero
and prints no result. The last line is the JSON result.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import concurrent.futures as cf
import csv
import io
from contextlib import redirect_stdout

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from gs360x_torch.core import camera as cam
from gs360x_torch.core import color as colorlib
from gs360x_torch.kernels import _build, flow as flowk, remap_cuda
from gs360x_torch.kernels import sharpness as sharp
from gs360x_torch.kernels import warp as twin
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.rig.presets import PerspCutConfig, build_view_plan
from gs360x_torch.runtime.executor import _view_groups
from gs360x_torch.tools import (dualfisheye, frameselector, perspcut,
                                video2frames)

SRC_H, SRC_W = 3840, 7680                 # 8K equirect frame
RING = [float(45 * k) for k in range(8)]  # yaw ring, 180 = the seam view
HEADLINE = dict(width=1920, height=1080, hfov_deg=112.6, vfov_deg=73.7)
# the default preset: 12 mm on a 36 mm square sensor, --size 1600
DEFAULT_FOV = math.degrees(2.0 * math.atan(36.0 / 24.0))
MAIN = dict(width=1600, height=1600, hfov_deg=DEFAULT_FOV,
            vfov_deg=DEFAULT_FOV)
E2E_FRAMES = 2
FISH = 3840                               # Osmo 360 lens image, 3840²
SFM10_SIZE = 1750                         # dualfisheye --perspective-size
# f32 kernel vs plain twin on a smooth frame: both evaluate the same f32
# formulas on the same card; the residue is the f64-derived rotation table
# vs the twin's f32 trig composition and FMA contraction, ~1e-6.
F32_TOL = 1e-4
LSB_SHARE_TOL = 0.001   # quantized: <= 1 LSB apart on <= 0.1% of pixels
# views whose image holds a pole (and fisheye hemispheres, whose rim
# touches the poles) are ill-conditioned in u: the v360 oracle's gate,
# <= 2 LSB and <= 1% of samples more than 1 LSB apart. The max is taken
# off the polar pixels (source row within one row of a pole): there every
# longitude meets, the synthetic lon/lat frame is not continuous, and u is
# undefined; they are counted and reported, and held by the share.
ORACLE_LSB, ORACLE_SHARE = 2, 0.01
# rim pixels where the kernel's image circle differs from the plain
# version's: the kernel computes r with round-to-nearest intrinsics, the
# same f32 expression as the twin, so none
RIM_TOL = 0
REMAP_F32_TOL = 1e-5
# planarize: (label, H, W, storage offset in elements) — the 8K frame, the
# Osmo 360 lens, and a ragged shape on an unaligned base (the scalar path),
# frame-sized: at a few MB the wrapper's host time per call exceeds the
# kernel's, and back-to-back events would time the host
PLANARIZE_SHAPES = [("8K", SRC_H, SRC_W, 0), (f"lens {FISH}²", FISH, FISH, 0),
                    ("ragged 3839x7679 +1", SRC_H - 1, SRC_W - 1, 1)]
PLANARIZE_PAIRS = [("u8->u8", torch.uint8, 1.0, torch.uint8),
                   ("u8->f32", torch.uint8, 1.0 / 255.0, torch.float32),
                   ("u16->f32", torch.uint16, 1.0 / 65535.0, torch.float32),
                   ("f32->f32", torch.float32, 1.0, torch.float32)]
HBM_TBS = 3.35   # published H100 SXM device-memory bandwidth, TB/s
V2F_FRAMES, V2F_FPS, V2F_RATE = 4, 4.0, 2.0   # 1 s of video, -f 2: 2 frames
FS_FRAMES, FS_SEGMENT = 10, 5    # frameselector: 2 segments of 5 8K frames
FS_SHARP = (2, 7)                # the one sharp frame of each segment
FS_PAIRS, FS_PAIR_SHARP = 4, 1   # pair mode: 4 3840² pairs, pair 1 sharp
LUT_SIZE = 33
# score_frame on the card against the same code on the CPU
SCORE_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, batches: int = 5, warmup: int = 2) -> float:
    """Device time of one ``fn`` in ms: CUDA events around ``reps`` runs
    back to back, so the host's work for the next launch overlaps the
    device's run; the median over ``batches`` such means."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def launch_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median time of ``fn`` in ms with CUDA events around each single
    run: an idle device waits between the events for the host to launch,
    so the host's per-call work counts too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def lonlat_frame(h: int, w: int, shift: float, device) -> torch.Tensor:
    """Self-checking (H, W, 3) u8 panorama: a view at yaw psi has center
    ch0 = 255*(0.5+0.5*sin(psi+shift)), ch1 = 127.5 at pitch 0."""
    xs = (2.0 * torch.arange(w, device=device, dtype=torch.float64) + 1.0) \
        / w - 1.0
    ys = (2.0 * torch.arange(h, device=device, dtype=torch.float64) + 1.0) \
        / h - 1.0
    lat, lon = torch.meshgrid(ys * (math.pi / 2), xs * math.pi,
                              indexing="ij")
    img = torch.stack([0.5 + 0.5 * torch.sin(lon + shift),
                       0.5 + 0.5 * torch.sin(lat),
                       0.5 + 0.5 * torch.cos(2 * lon)], dim=-1)
    return (img * 255).to(torch.uint8)


def fisheye_frame(size: int, seed: int, device) -> torch.Tensor:
    """Smooth textured (size, size, 3) u8 lens image with a little noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ys, xs = torch.meshgrid(
        torch.arange(size, device=device, dtype=torch.float32) / size,
        torch.arange(size, device=device, dtype=torch.float32) / size,
        indexing="ij")
    img = torch.stack([xs, ys, 0.5 + 0.4 * torch.sin(40.0 * xs + seed)
                       * torch.cos(30.0 * ys)], dim=-1)
    img = img + 0.02 * torch.rand(img.shape, generator=gen, device=device)
    return torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int32)


def read_png(path: pathlib.Path) -> np.ndarray:
    with Image.open(path) as pil:
        return np.asarray(pil)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load()
    load_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernels built in {_build.build_seconds:.2f}s "
        f"(load {load_s:.2f}s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")
    return {"kind": name, "smi": smi}


def _planarize_rows_input(h: int, w: int, dtype, offset: int, seed: int,
                          dev) -> torch.Tensor:
    """Random (h, 3w) rows of ``dtype`` on the card: a contiguous view
    ``offset`` elements into its storage (offset > 0: an unaligned base)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 3 * h * w + offset
    if dtype == torch.float32:
        flat = torch.rand(n, generator=gen, device=dev)
    elif dtype == torch.uint16:   # int16 bits, read as u16
        flat = torch.randint(-32768, 32768, (n,), generator=gen,
                             dtype=torch.int16, device=dev).view(dtype)
    else:
        flat = torch.randint(0, 256, (n,), generator=gen, dtype=dtype,
                             device=dev)
    return flat[offset:].view(h, 3 * w)


def phase_planarize(dev) -> dict:
    """Every (in, out) pair at the main paths' shapes and one ragged,
    unaligned shape: bitwise against the plain version, for the variant
    the main path takes and for every other variant the shape allows;
    each timed beside the plain version."""
    stats = {}
    for label, h, w, offset in PLANARIZE_SHAPES:
        for pair, dtype, scale, out_dtype in PLANARIZE_PAIRS:
            rows = _planarize_rows_input(h, w, dtype, offset, len(stats), dev)
            ref = warp_cuda.planarize_rows_plain(rows, scale, out_dtype)
            got = warp_cuda.planarize_rows(rows, scale, out_dtype)
            kept = warp_cuda.planarize_variant(rows, got)
            others = [v for v in warp_cuda.PLANARIZE_VARIANTS if v != kept] \
                if kept != "scalar" else []
            outs = {v: warp_cuda.planarize_rows(rows, scale, out_dtype,
                                                variant=v) for v in others}
            torch.cuda.synchronize()
            for variant, out in [(kept, got), *outs.items()]:
                if not torch.equal(out.view(torch.uint8),
                                   ref.view(torch.uint8)):
                    raise AssertionError(f"planarize {label} {pair} "
                                         f"{variant}: kernel != plain")
            err = float((got.float() - ref.float()).abs().max())
            ms = cuda_ms(lambda: warp_cuda.planarize_rows(rows, scale,
                                                          out_dtype))
            plain_ms = cuda_ms(lambda: warp_cuda.planarize_rows_plain(
                rows, scale, out_dtype))
            other_ms = {v: cuda_ms(lambda v=v: warp_cuda.planarize_rows(
                rows, scale, out_dtype, variant=v)) for v in others}
            moved = h * w * 3 * (rows.element_size() + got.element_size())
            gbs = moved / ms / 1e6
            bound_ms = moved / (HBM_TBS * 1e9)
            extra = ", ".join(
                f"{v}{'' if v == 'scalar' else ' (variant not kept)'} "
                f"{t:.4f} ms" for v, t in other_ms.items())
            if not stats:   # 8K u8 -> u8: also timed one launch at a time
                one = launch_ms(lambda: warp_cuda.planarize_rows(
                    rows, scale, out_dtype))
                one_plain = launch_ms(lambda: warp_cuda.planarize_rows_plain(
                    rows, scale, out_dtype))
                extra += (f", per launch: kernel {one:.4f} ms, plain "
                          f"{one_plain:.4f} ms")
            log(f"[planarize] {label} {pair}: bitwise equal "
                f"({', '.join([kept + ' (main path)', *others])}) | kernel "
                f"{kept} {ms:.4f} ms ({gbs:.1f} GB/s, {gbs / HBM_TBS / 10:.1f}"
                f"% of {HBM_TBS} TB/s; bound {bound_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms{' | ' + extra if extra else ''}")
            stats[(label, pair)] = {"max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms}
            del rows, ref, got, outs
    return stats[(PLANARIZE_SHAPES[0][0], PLANARIZE_PAIRS[0][0])]


def _compare_warp(rows: torch.Tensor, geom: dict, interp: str, smooth: bool,
                  label: str) -> float:
    zeros = [0.0] * len(RING)
    got = warp_cuda.warp_equirect_to_views_cuda(
        rows, RING, zeros, zeros, interp=interp, planar=True, **geom)
    ref = warp_cuda.warp_equirect_to_views_plain(
        rows, RING, zeros, zeros, interp=interp, planar=True, **geom)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"warp {label}: non-finite output")
    err = float((got - ref).abs().max())
    lsb = (quantize(got) - quantize(ref)).abs()
    max_lsb = int(lsb.max())
    share = float((lsb > 0).float().mean())
    log(f"[warp] {label} {interp}: max|diff| f32 {err:.3e}, quantized max "
        f"{max_lsb} LSB, {share:.5%} of pixels differ")
    if max_lsb > 1:
        raise AssertionError(f"warp {label} {interp}: {max_lsb} LSB apart")
    if smooth:
        if err > F32_TOL:
            raise AssertionError(f"warp {label} {interp}: f32 diff {err}")
        if share > LSB_SHARE_TOL:
            raise AssertionError(f"warp {label} {interp}: {share:.4%} "
                                 "of pixels differ")
    return err


def phase_warp(dev) -> dict:
    smooth = lonlat_frame(SRC_H, SRC_W, 0.3, dev).reshape(SRC_H, SRC_W * 3)
    gen = torch.Generator(device=dev).manual_seed(1)
    noise = torch.randint(0, 256, (SRC_H, SRC_W * 3), generator=gen,
                          dtype=torch.uint8, device=dev)
    errs = []
    for interp in ("bicubic", "bilinear"):
        errs.append(_compare_warp(smooth, HEADLINE, interp, True,
                                  "headline 8x1920x1080 smooth"))
        # noise has ~100 LSB/px gradients, so a 1e-4 px coordinate residue
        # flips roundings on a few % of pixels: gate at <= 1 LSB only
        _compare_warp(noise, HEADLINE, interp, False,
                      "headline 8x1920x1080 noise")
    main_err = _compare_warp(smooth, MAIN, "bicubic", True,
                             "main-path 8x1600x1600 smooth")
    planes = warp_cuda.planarize_rows(smooth, 1.0, torch.uint8)
    src_f32 = smooth.reshape(SRC_H, SRC_W, 3).to(torch.float32) / 255.0
    zeros = [0.0] * len(RING)
    ms = cuda_ms(lambda: warp_cuda.warp_planes(
        planes, RING, zeros, zeros, interp="bicubic", **HEADLINE))
    plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
        src_f32, RING, zeros, zeros, interp="bicubic", **HEADLINE))
    bil_ms = cuda_ms(lambda: warp_cuda.warp_planes(
        planes, RING, zeros, zeros, interp="bilinear", **HEADLINE))
    bil_plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
        src_f32, RING, zeros, zeros, interp="bilinear", **HEADLINE))
    main_ms = cuda_ms(lambda: warp_cuda.warp_planes(
        planes, RING, zeros, zeros, interp="bicubic", **MAIN))
    main_plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
        src_f32, RING, zeros, zeros, interp="bicubic", **MAIN))
    log(f"[warp] headline 8x1920x1080 from 8K u8: bicubic kernel {ms:.4f} ms "
        f"({8000.0 / ms:.1f} views/s), plain {plain_ms:.4f} ms | bilinear "
        f"kernel {bil_ms:.4f} ms, plain {bil_plain_ms:.4f} ms | main-path "
        f"8x1600x1600 bicubic kernel {main_ms:.4f} ms, plain "
        f"{main_plain_ms:.4f} ms")
    return {"headline": {"max_abs_err": max(errs), "ms": ms,
                         "plain_ms": plain_ms},
            "main": {"max_abs_err": main_err, "ms": main_ms,
                     "plain_ms": main_plain_ms}}


def _preset_plan(preset: str, size, files, out_dir: pathlib.Path):
    """A preset's plan and its view groups as the executor launches them:
    [((projection, w, h, hfov, vfov), [job index, ...]), ...]."""
    cfg = PerspCutConfig(preset=preset, size=size or 1600, ext="png",
                         size_explicit=size is not None)
    plan = build_view_plan(cfg, files, out_dir)
    return plan, list(_view_groups([job.view for job in plan.jobs]).items())


def _angles(plan, idxs):
    return [[getattr(plan.jobs[i].view, name) for i in idxs]
            for name in ("yaw_deg", "pitch_deg", "roll_deg")]


def _compare_views(rows, planes, src_f32, key, yaws, pitches, rolls,
                   label: str, smooth_gate: bool) -> dict:
    """One view group, kernel vs plain on the card: f32 gap, LSB gate,
    image-circle disagreements (fisheye), CUDA-event times."""
    projection, width, height, hfov, vfov = key
    kw = dict(width=width, height=height, hfov_deg=hfov, vfov_deg=vfov,
              projection=projection, interp="bicubic")
    got = warp_cuda.warp_equirect_to_views_cuda(rows, yaws, pitches, rolls,
                                                planar=True, **kw)
    ref = warp_cuda.warp_equirect_to_views_plain(rows, yaws, pitches, rolls,
                                                 planar=True, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"warp {label}: non-finite output")
    lsb = (quantize(got) - quantize(ref)).abs()
    share = float((lsb > 1).float().mean())
    _u, v, _valid = twin.view_uv_from_equirect(
        width, height, hfov, vfov, projection,
        *[torch.tensor(a, dtype=torch.float32, device=rows.device)
          for a in (yaws, pitches, rolls)], SRC_W, SRC_H,
        device=rows.device)
    polar = ((v < 0.5) | (v > SRC_H - 1.5))[:, None].expand_as(lsb)
    gap = (got - ref).abs()
    err = float(gap[~polar].max())
    max_lsb = int(lsb[~polar].max())
    polar_n = int(polar[:, 0].sum())
    polar_lsb = int(lsb[polar].max()) if polar_n else 0
    polar_err = float(gap[polar].max()) if polar_n else 0.0
    rim = 0
    if projection != "perspective":
        model = "equidistant" if projection == "fisheye_v360" else "equisolid"
        _rays, valid = cam.fisheye_rays(width, height, hfov, model=model,
                                        device=rows.device)
        rim = int(((got == 0).all(dim=1) != ~valid[None]).sum())
    ms = cuda_ms(lambda: warp_cuda.warp_planes(
        planes, yaws, pitches, rolls, **kw))
    plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
        src_f32, yaws, pitches, rolls, **kw))
    log(f"[warp] {label} ({len(yaws)}x{width}x{height} {projection} "
        f"hfov {hfov:.2f}): max|diff| f32 {err:.3e}, max {max_lsb} LSB "
        f"({polar_n} polar pixels: f32 {polar_err:.3e}, max {polar_lsb} "
        f"LSB), {share:.5%} of "
        f"pixels > 1 LSB, rim-mask disagreements {rim} | "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if rim > RIM_TOL:
        raise AssertionError(f"warp {label}: {rim} rim pixels disagree")
    if max_lsb > ORACLE_LSB or share > ORACLE_SHARE:
        raise AssertionError(f"warp {label}: {max_lsb} LSB, {share:.4%} "
                             "of pixels > 1 LSB")
    if smooth_gate and err > F32_TOL:
        raise AssertionError(f"warp {label}: f32 diff {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_warp_tilted(dev) -> dict:
    # no pixel of the smooth frame is 0, so an all-zero output pixel is the
    # kernel's "outside the image circle"
    frame = lonlat_frame(SRC_H, SRC_W, 0.3, dev).clamp_min(1)
    rows = frame.reshape(SRC_H, SRC_W * 3)
    planes = warp_cuda.planarize_rows(rows, 1.0, torch.uint8)
    src_f32 = frame.to(torch.float32) / 255.0
    files = [pathlib.Path("frame.png")]
    cover_plan, ((cover_key, cover_idx),) = _preset_plan(
        "full360coverage", 1600, files, pathlib.Path("out"))
    fish_plan, ((fish_key, fish_idx),) = _preset_plan(
        "fisheyeXY", None, files, pathlib.Path("out"))
    cover = _angles(cover_plan, cover_idx)
    fish = _angles(fish_plan, fish_idx)
    pole_key = ("perspective", 1600, 1600, cover_key[3], cover_key[4])
    solid_key = ("equisolid", 2048, 2048, 190.0, 190.0)
    return {
        "pitched": _compare_views(rows, planes, src_f32, cover_key, *cover,
                                  "full360coverage --size 1600", True),
        "pole": _compare_views(rows, planes, src_f32, pole_key, [30.0],
                               [90.0], [0.0], "pole view pitch 90", False),
        "fisheye": _compare_views(rows, planes, src_f32, fish_key, *fish,
                                  "fisheyeXY hemispheres", False),
        "equisolid": _compare_views(rows, planes, src_f32, solid_key,
                                    [90.0], [-20.0], [10.0],
                                    "equisolid view", False),
    }


def _remap_check(prep_call, plain_call, label: str, exact: bool) -> dict:
    got = prep_call()
    ref = plain_call()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"remap {label}: non-finite output")
    err = float((got - ref).abs().max())
    lsb = int((quantize(got) - quantize(ref)).abs().max())
    ms = cuda_ms(prep_call)
    plain_ms = cuda_ms(plain_call)
    log(f"[remap] {label}: max|diff| f32 {err:.3e}, quantized max {lsb} LSB"
        f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if err > REMAP_F32_TOL or lsb > (0 if exact else 1):
        raise AssertionError(f"remap {label}: f32 {err}, {lsb} LSB")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_remap(dev) -> dict:
    xml = dualfisheye.default_calibration_path()
    sensors, _cams = dualfisheye.load_metashape_calibration(xml)
    calib = sensors["0"]
    t0 = time.perf_counter()
    cache = dualfisheye.build_remap_cache(calib, None, 190.0)
    specs = dualfisheye.build_sfm10_specs(SFM10_SIZE, 14.0, "36 36", 40.0,
                                          40.0)
    views = dualfisheye.build_perspective_spec_maps(
        sensors, "0", "0", specs, 0.0, 180.0, 190.0)
    maps_s = time.perf_counter() - t0

    img = fisheye_frame(FISH, 3, dev)
    planes_u8 = remap_cuda.source_planes(img, FISH, FISH, dev)
    planes_f32 = (planes_u8.to(torch.float32) / 255.0).contiguous()
    mask = (img[..., 0] > 128).to(torch.uint8) * 255
    mask_planes = remap_cuda.source_planes(mask, FISH, FISH, dev)

    und = remap_cuda.PreparedRemap(cache.map_x, cache.map_y, cache.valid,
                                   src_w=FISH, src_h=FISH, device=dev)
    batch = remap_cuda.PreparedRemapBatch(
        [(views[s["view_id"]]["map_x"], views[s["view_id"]]["map_y"],
          views[s["view_id"]]["valid"]) for s in specs],
        src_w=FISH, src_h=FISH, interp="catmull-rom", device=dev)
    nearest = batch.with_interp("nearest")

    def plain(prep, planes, interp):
        return remap_cuda.remap_planes_plain(
            planes, prep.map_x, prep.map_y, prep.valid, interp=interp,
            fill=0.0)

    out = {
        "undistort_f32": _remap_check(
            lambda: und(planes_f32, interp="catmull-rom")[None],
            lambda: plain(und, planes_f32, "catmull-rom"),
            f"undistort {FISH}² catmull-rom f32 source", False),
        "undistort": _remap_check(
            lambda: und(planes_u8, interp="catmull-rom")[None],
            lambda: plain(und, planes_u8, "catmull-rom"),
            f"undistort {FISH}² catmull-rom u8 source", False),
        "batch_f32": _remap_check(
            lambda: batch(planes_f32), lambda: plain(batch, planes_f32,
                                                     "catmull-rom"),
            f"SFM10 batch 10x{SFM10_SIZE}² catmull-rom f32 source", False),
        "batch": _remap_check(
            lambda: batch(planes_u8), lambda: plain(batch, planes_u8,
                                                    "catmull-rom"),
            f"SFM10 batch 10x{SFM10_SIZE}² catmull-rom u8 source", False),
        "mask": _remap_check(
            lambda: nearest(mask_planes), lambda: plain(nearest, mask_planes,
                                                        "nearest"),
            f"SFM10 mask batch 10x{SFM10_SIZE}² nearest C=1", True),
    }
    log(f"[remap] default Osmo 360 calibration, auto zoom "
        f"{cache.undistort_zoom:.4f}; maps built on the host in "
        f"{maps_s:.2f}s")
    return {"checks": out, "calib": calib, "cache": cache, "specs": specs,
            "views": views}


def phase_perspcut(dev, src_dir: pathlib.Path, frames: dict, tmp,
                   preset: str, size=None) -> dict:
    out_dir = tmp / f"out_{preset}"
    args = ["-i", str(src_dir), "-o", str(out_dir), "--preset", preset,
            "--ext", "png", "--device", dev.type, "--stats"]
    if size:
        args += ["--size", str(size)]
    stem = "pano_0001"
    plan, groups = _preset_plan(preset, size, [src_dir / f"{stem}.png"],
                                out_dir)

    warp_cuda.reset_counters()
    remap_cuda.reset_counters()
    t0 = time.perf_counter()
    rc = perspcut.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {**warp_cuda.LAUNCHES, **remap_cuda.LAUNCHES}
    plain = {**warp_cuda.PLAIN_CALLS, **remap_cuda.PLAIN_CALLS}
    if rc != 0:
        raise AssertionError(f"perspcut --preset {preset} exited {rc}")
    # one planarize and one warp per (view group, frame)
    want = {"planarize": E2E_FRAMES * len(groups),
            "warp": E2E_FRAMES * len(groups), "remap": 0}
    if launches != want:
        raise AssertionError(f"{preset}: kernel launches {launches}, "
                             f"expected {want}")
    if any(plain.values()):
        raise AssertionError(f"{preset}: plain versions ran on the main "
                             f"path: {plain}")
    written = sorted(p.name for p in out_dir.iterdir())
    if len(written) != E2E_FRAMES * len(plan.jobs):
        raise AssertionError(f"{preset}: {len(written)} outputs, expected "
                             f"{E2E_FRAMES * len(plan.jobs)}")

    # frame 1's outputs against the plain warp on the card
    rows = torch.from_numpy(frames[stem][1].reshape(SRC_H, SRC_W * 3)).to(
        dev)
    worst, share = 0, 0.0
    for (projection, width, height, hfov, vfov), idxs in groups:
        ref = quantize(warp_cuda.warp_equirect_to_views_plain(
            rows, *_angles(plan, idxs), width=width, height=height,
            hfov_deg=hfov, vfov_deg=vfov, projection=projection,
            interp="bicubic", planar=True)).permute(0, 2, 3, 1).cpu()
        for j, i in enumerate(idxs):
            img = torch.from_numpy(read_png(
                out_dir / plan.jobs[i].output_name).astype(np.int32))
            if tuple(img.shape) != (height, width, 3):
                raise AssertionError(f"{plan.jobs[i].output_name}: shape "
                                     f"{tuple(img.shape)}")
            diff = (img - ref[j]).abs()
            worst = max(worst, int(diff.max()))
            share = max(share, float((diff > 1).float().mean()))
    if worst > ORACLE_LSB or share > ORACLE_SHARE:
        raise AssertionError(f"{preset}: outputs {worst} LSB from the plain "
                             f"warp, {share:.4%} of pixels > 1 LSB")
    extra = ""
    if preset == "default":
        centers = 0.0
        for stem_k, (shift, _frame) in frames.items():
            for k, v in enumerate("ABCDEFGH"):
                img = read_png(out_dir / f"{stem_k}_{v}.png")
                center = img[799:801, 799:801, 0].astype(np.float64).mean()
                want_c = 255.0 * (0.5 + 0.5 * math.sin(
                    math.radians(RING[k]) + shift))
                centers = max(centers, abs(center - want_c))
        if centers > 2.0:
            raise AssertionError(f"view centers off by {centers:.2f} LSB")
        extra = f" | view centers within {centers:.2f} LSB"
    log(f"[e2e] perspcut --preset {preset}, {E2E_FRAMES} 8K frames, "
        f"{len(written)} outputs: wall {wall_s:.3f}s | launches {launches} "
        f"plain {plain} | frame 1 vs plain warp on the card: max {worst} "
        f"LSB, {share:.5%} > 1 LSB{extra}")
    return {"launches": launches, "wall_s": wall_s}


def phase_dualfisheye(dev, tmp, remap: dict) -> dict:
    in_dir, mask_dir, out_dir = tmp / "pairs", tmp / "masks", tmp / "dfe"
    in_dir.mkdir()
    mask_dir.mkdir()
    t0 = time.perf_counter()
    images = {}
    for k in range(2):
        for lens in "XY":
            name = f"osmo_{k + 1:04d}_{lens}.png"
            img = fisheye_frame(FISH, 10 * k + (lens == "Y"), dev).cpu()
            images[name] = img.numpy()
            # fast zlib level: the inputs are set-up, not the path
            Image.fromarray(images[name]).save(in_dir / name,
                                               compress_level=1)
            if k == 0:   # one mask pair
                mask = np.where(images[name][..., 1] > 100, 255, 0)
                Image.fromarray(mask.astype(np.uint8)).save(
                    mask_dir / name, compress_level=1)
    setup_s = time.perf_counter() - t0

    warp_cuda.reset_counters()
    remap_cuda.reset_counters()
    t0 = time.perf_counter()
    rc = dualfisheye.main([
        "--input-dir", str(in_dir), "--output-dir", str(out_dir),
        "--save-fisheye-output", "--perspective-ext", ".png",
        "--mask-input-dir", str(mask_dir), "--report-json",
        str(tmp / "report.json"), "--device", dev.type, "--stats"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {**warp_cuda.LAUNCHES, **remap_cuda.LAUNCHES}
    plain = {**warp_cuda.PLAIN_CALLS, **remap_cuda.PLAIN_CALLS}
    report = json.loads((tmp / "report.json").read_text())
    if rc != 0 or report["failed"] != 0 or report["processed"] != 2:
        raise AssertionError(f"dualfisheye exited {rc}, report {report}")
    # per pair: 2 lens planarizes; 2 undistorts + 2 lens view groups,
    # + 2 mask groups for the pair with masks
    want = {"planarize": 4, "warp": 0, "remap": 10}
    if launches != want:
        raise AssertionError(f"dualfisheye launches {launches}, expected "
                             f"{want}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    views = sorted((out_dir / "perspective" / "images").iterdir())
    masks = sorted((out_dir / "perspective" / "masks").iterdir())
    unds = sorted(out_dir.glob("osmo_*.png"))
    if (len(unds), len(views), len(masks)) != (4, 20, 10):
        raise AssertionError(f"outputs: {len(unds)} undistorted, "
                             f"{len(views)} views, {len(masks)} masks")

    # pair 1 against the plain remap on the card
    worst = 0
    planes = {lens: remap_cuda.source_planes(
        images[f"osmo_0001_{lens}.png"], FISH, FISH, dev) for lens in "XY"}
    mplanes = {lens: remap_cuda.source_planes(
        read_png(mask_dir / f"osmo_0001_{lens}.png"), FISH, FISH, dev)
        for lens in "XY"}

    def plain_u8(src, mx, my, valid, interp):
        out = remap_cuda.remap_planes_plain(
            src, torch.as_tensor(mx, device=dev)[None],
            torch.as_tensor(my, device=dev)[None],
            torch.as_tensor(valid, device=dev)[None], interp=interp,
            fill=0.0)[0]
        return quantize(out).permute(1, 2, 0).cpu()

    cache = remap["cache"]
    for lens in "XY":
        ref = plain_u8(planes[lens], cache.map_x, cache.map_y, cache.valid,
                       "catmull-rom")
        got = torch.from_numpy(read_png(out_dir / f"osmo_0001_{lens}.png")
                               .astype(np.int32))
        worst = max(worst, int((got - ref).abs().max()))
    mask_equal = True
    for spec in remap["specs"]:
        m = remap["views"][spec["view_id"]]
        lens = m["lens_key"]
        ref = plain_u8(planes[lens], m["map_x"], m["map_y"], m["valid"],
                       "catmull-rom")
        got = torch.from_numpy(read_png(
            out_dir / "perspective" / "images" /
            f"osmo_0001_{spec['view_id']}.png").astype(np.int32))
        worst = max(worst, int((got - ref).abs().max()))
        ref_m = plain_u8(mplanes[lens], m["map_x"], m["map_y"], m["valid"],
                         "nearest")[..., 0]
        got_m = torch.from_numpy(read_png(
            out_dir / "perspective" / "masks" /
            f"osmo_0001_{spec['view_id']}.png").astype(np.int32))
        mask_equal &= torch.equal(got_m, ref_m)
    if worst > 1 or not mask_equal:
        raise AssertionError(f"dualfisheye pair 1: {worst} LSB from the "
                             f"plain remap, masks equal: {mask_equal}")
    log(f"[e2e] dualfisheye 2 pairs {FISH}², default calibration, "
        f"{len(unds)} undistorted + {len(views)} views + {len(masks)} masks:"
        f" wall {wall_s:.3f}s (set-up {setup_s:.2f}s) | launches {launches}"
        f" plain {plain} | pair 1 vs plain remap on the card: max {worst} "
        f"LSB, masks equal")
    return {"launches": launches, "wall_s": wall_s, "in_dir": in_dir,
            "mask_dir": mask_dir, "out_dir": out_dir, "images": images}


def write_y4m_420(path: pathlib.Path, frames, fps: float) -> None:
    """(H, W, 3) u8 frames on the card → a YUV4MPEG2 C420jpeg file:
    BT.601 limited-range YUV, chroma averaged over 2×2 blocks."""
    h, w = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{int(fps)}:1 Ip A1:1 C420jpeg\n"
                .encode("ascii"))
        for frame in frames:
            rgb = frame.to(torch.float32)
            r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
            y = 0.299 * r + 0.587 * g + 0.114 * b
            u = (b - y) / 1.772 * (224.0 / 255.0) + 128.0
            v = (r - y) / 1.402 * (224.0 / 255.0) + 128.0
            y = y * (219.0 / 255.0) + 16.0
            planes = [y] + [F.avg_pool2d(c[None, None], 2)[0, 0]
                            for c in (u, v)]
            f.write(b"FRAME\n")
            for plane in planes:
                f.write(torch.round(plane).clamp(0, 255).to(torch.uint8)
                        .cpu().numpy().tobytes())


def _lsb_check(got: np.ndarray, ref: torch.Tensor, label: str) -> tuple:
    """Output file pixels (H, W, 3) against a quantized (3, H, W) plain
    reference: (max LSB, share of pixels > 0 LSB apart); fails past 1 LSB
    or past ``LSB_SHARE_TOL`` of pixels."""
    diff = (torch.from_numpy(got.astype(np.int32)).to(ref.device)
            - ref.permute(1, 2, 0)).abs()
    worst = int(diff.max())
    share = float((diff > 0).any(dim=-1).float().mean())
    if worst > 1 or share > LSB_SHARE_TOL:
        raise AssertionError(f"{label}: {worst} LSB from the plain path, "
                             f"{share:.4%} of pixels differ")
    return worst, share


def phase_video2frames(dev, tmp) -> dict:
    """gs360x-torch-video2frames on an 8K 4:2:0 Y4M, then with
    --fisheye-perspective on a 3840² lens Y4M: launches, and the files
    against the plain versions on the card."""
    t0 = time.perf_counter()
    clips = {"8K": tmp / "pano8k.y4m", "fisheye": tmp / "lens.y4m"}
    write_y4m_420(clips["8K"], [lonlat_frame(SRC_H, SRC_W, 0.3 * k, dev)
                                for k in range(V2F_FRAMES)], V2F_FPS)
    write_y4m_420(clips["fisheye"], [fisheye_frame(FISH, 20 + k, dev)
                                     for k in range(V2F_FRAMES)], V2F_FPS)
    setup_s = time.perf_counter() - t0
    hfov = cam.hfov_from_focal_mm(8.0, 36.0)     # the tool's defaults
    cut = video2frames.FisheyeCut(FISH, hfov, 190.0, "equisolid", dev)
    out = {}
    for label, clip in clips.items():
        out_dir = tmp / f"v2f_{label}"
        args = ["-i", str(clip), "-o", str(out_dir), "-f", str(V2F_RATE),
                "-e", "png", "--device", dev.type, "--stats"]
        if label == "fisheye":
            args.append("--fisheye-perspective")
        warp_cuda.reset_counters()
        remap_cuda.reset_counters()
        t0 = time.perf_counter()
        rc = video2frames.main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {**warp_cuda.LAUNCHES, **remap_cuda.LAUNCHES}
        plain = {**warp_cuda.PLAIN_CALLS, **remap_cuda.PLAIN_CALLS}
        if rc != 0:
            raise AssertionError(f"video2frames {label} exited {rc}")
        n = int(V2F_FRAMES / V2F_FPS * V2F_RATE)
        want = {"planarize": n, "warp": 0,
                "remap": n if label == "fisheye" else 0}
        if launches != want:
            raise AssertionError(f"video2frames {label}: launches "
                                 f"{launches}, expected {want}")
        if any(plain.values()):
            raise AssertionError(f"video2frames {label}: plain versions "
                                 f"ran on the main path: {plain}")
        names = sorted(p.name for p in out_dir.iterdir())
        if names != [f"out_{i:07d}.png" for i in range(n)]:
            raise AssertionError(f"video2frames {label}: outputs {names}")
        # every file against the plain versions on the card
        worst, share = 0, 0.0
        for idx, _t, rgb in video2frames.decoded_frames(clip, fps=V2F_RATE):
            rows = torch.from_numpy(rgb.reshape(rgb.shape[0], -1)).to(dev)
            ref = colorlib.video_color_move_planar(
                warp_cuda.planarize_rows_plain(rows, 1.0 / 255.0,
                                               torch.float32))
            if label == "fisheye":
                prep = cut.prepared(FISH, FISH)
                ref = remap_cuda.remap_planes_plain(
                    ref, prep.map_x, prep.map_y, prep.valid,
                    interp="bicubic", fill=0.0)[0]
            lsb = _lsb_check(read_png(out_dir / f"out_{idx:07d}.png"),
                             quantize(ref), f"video2frames {label} {idx}")
            worst, share = max(worst, lsb[0]), max(share, lsb[1])
        out[label] = {"launches": launches, "wall_s": wall_s}
        log(f"[video2frames] {label} ({clip.name}, {V2F_FRAMES} frames at "
            f"{V2F_FPS:g} fps, -f {V2F_RATE:g}): {n} PNGs, wall "
            f"{wall_s:.3f}s | launches {launches} plain {plain} | vs plain "
            f"versions on the card: max {worst} LSB, {share:.5%} of pixels "
            f"differ")
    planes = warp_cuda.planarize_rows(
        lonlat_frame(SRC_H, SRC_W, 0.0, dev).reshape(SRC_H, -1),
        1.0 / 255.0, torch.float32)
    move_ms = cuda_ms(lambda: colorlib.video_color_move_planar(planes))
    lens = warp_cuda.planarize_rows(fisheye_frame(FISH, 3, dev)
                                    .reshape(FISH, -1), 1.0 / 255.0,
                                    torch.float32)
    prep = cut.prepared(FISH, FISH)
    got = prep(lens, interp="bicubic", fill=0.0)
    ref = remap_cuda.remap_planes_plain(lens, prep.map_x, prep.map_y,
                                        prep.valid, interp="bicubic",
                                        fill=0.0)[0]
    err = float((got - ref).abs().max())
    if err > REMAP_F32_TOL:
        raise AssertionError(f"fisheye remap: f32 diff {err}")
    remap_ms = cuda_ms(lambda: prep(lens, interp="bicubic", fill=0.0))
    plain_ms = cuda_ms(lambda: remap_cuda.remap_planes_plain(
        lens, prep.map_x, prep.map_y, prep.valid, interp="bicubic",
        fill=0.0))
    log(f"[video2frames] 8K colour move (Rec.709 -> SMPTE-170M + sRGB, f32 "
        f"planes) {move_ms:.4f} ms | fisheye -> perspective {FISH}² "
        f"bicubic: max|diff| f32 {err:.3e}, kernel {remap_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms | set-up (Y4M writes) {setup_s:.2f}s")
    return out


def texture_frame(h: int, w: int, shift: int, dev) -> torch.Tensor:
    """(3, H, W) f32 in [0, 1]: structure from 4 px to 400 px, so that a
    box blur lowers every sharpness metric and the flow's ≤320 px grays
    still hold corners; shifted ``shift`` px to the right."""
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32)
                            - shift, indexing="ij")
    fine = torch.sin(xs / 1.3) * torch.cos(ys / 1.7)
    coarse = torch.sin(xs / 400.0) * torch.cos(ys / 300.0) \
        + 0.5 * torch.sin((xs + ys) / 250.0)
    img = torch.stack([0.5 + 0.15 * fine + 0.2 * coarse,
                       0.5 + 0.15 * fine * torch.sin(ys / 90.0)
                       + 0.2 * coarse,
                       0.5 - 0.2 * coarse + 0.1 * fine])
    return img.clamp(0.0, 1.0)


def _write_graded(pool, path: pathlib.Path, img: torch.Tensor, radius: int):
    """A box blur of ``radius`` (0: sharp) on the card, then a PNG written
    by ``pool``."""
    if radius:
        img = F.avg_pool2d(img[None], 2 * radius + 1, stride=1,
                           padding=radius, count_include_pad=False)[0]
    u8 = torch.round(img * 255.0).to(torch.uint8).permute(1, 2, 0)
    pixels = u8.contiguous().cpu().numpy()
    return pool.submit(lambda: Image.fromarray(pixels).save(
        path, compress_level=1))


def _run_frameselector(args, label: str, want_planarize: int) -> tuple:
    warp_cuda.reset_counters()
    remap_cuda.reset_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = frameselector.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {**warp_cuda.LAUNCHES, **remap_cuda.LAUNCHES}
    plain = {**warp_cuda.PLAIN_CALLS, **remap_cuda.PLAIN_CALLS}
    if rc != 0:
        raise AssertionError(f"frameselector {label} exited {rc}: "
                             f"{buf.getvalue()[-2000:]}")
    want = {"planarize": want_planarize, "warp": 0, "remap": 0}
    if launches != want:
        raise AssertionError(f"frameselector {label}: launches {launches}, "
                             f"expected {want}")
    if any(plain.values()):
        raise AssertionError(f"frameselector {label}: plain versions ran "
                             f"on the main path: {plain}")
    stats = [line for line in buf.getvalue().splitlines()
             if line.startswith("[STATS]")]
    return launches, wall_s, stats[-1] if stats else ""


def _kept(csv_path: pathlib.Path, column: str = "filename") -> list:
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    flows = [float(r["flow_motion"]) for r in rows]
    if not all(math.isfinite(x) for x in flows):
        raise AssertionError(f"{csv_path.name}: non-finite flow {flows}")
    return [r[column] for r in rows if r["selected(1=keep)"] == "1"], flows


def phase_frameselector(dev, tmp) -> dict:
    """gs360x-torch-frameselector on 10 8K frames (one sharp frame per
    segment of 5, the rest box-blurred with growing radius, the scene
    panning 48 px a frame) with Lucas–Kanade flow, then Farneback, then
    pair mode on 4 3840² pairs; score_frame on the card against the CPU;
    device times of the scoring and the flows."""
    frames_dir, pairs_dir = tmp / "fs_frames", tmp / "fs_pairs"
    frames_dir.mkdir()
    pairs_dir.mkdir()
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        writes = []
        for k in range(FS_FRAMES):
            radius = 0 if k in FS_SHARP else 1 + k % FS_SEGMENT
            writes.append(_write_graded(
                pool, frames_dir / f"frame_{k:04d}.png",
                texture_frame(SRC_H, SRC_W, 48 * k, dev), radius))
        for k in range(FS_PAIRS):
            for lens in "XY":
                writes.append(_write_graded(
                    pool, pairs_dir / f"pair_{k:04d}_{lens}.png",
                    texture_frame(FISH, FISH, 16 * k + (lens == "Y") * 7,
                                  dev), 0 if k == FS_PAIR_SHARP else 1 + k))
        for write in writes:
            write.result()
    setup_s = time.perf_counter() - t0
    runs, lines = {}, []
    for method in ("lucas_kanade", "farneback"):
        csv_path = tmp / f"fs_{method}.csv"
        launches, wall_s, stats = _run_frameselector(
            ["-i", str(frames_dir), "-n", str(FS_SEGMENT),
             "--compute_optical_flow", "--flow_method", method, "-d", "-c",
             str(csv_path), "--device", dev.type, "--stats"], method,
            FS_FRAMES)
        kept, flows = _kept(csv_path)
        want = {f"frame_{k:04d}.png" for k in FS_SHARP}
        if not want <= set(kept):
            raise AssertionError(f"frameselector {method}: kept {kept}, "
                                 f"the sharp frames are {sorted(want)}")
        runs[method] = {"launches": launches, "wall_s": wall_s}
        lines.append(f"{method}: kept {kept}, flow {min(flows):.3f}.."
                     f"{max(flows):.3f} px, wall {wall_s:.3f}s, {stats}")
    csv_path = tmp / "fs_pairs.csv"
    launches, wall_s, stats = _run_frameselector(
        ["-i", str(pairs_dir), "-n", str(FS_PAIRS), "-d", "-c",
         str(csv_path), "--device", dev.type, "--stats"], "pairs",
        2 * FS_PAIRS)
    kept, _flows = _kept(csv_path)
    if kept != [f"pair_{FS_PAIR_SHARP:04d}"]:
        raise AssertionError(f"frameselector pairs: kept {kept}")
    runs["pairs"] = {"launches": launches, "wall_s": wall_s}
    lines.append(f"pairs: kept {kept}, wall {wall_s:.3f}s, {stats}")
    for line in lines:
        log(f"[frameselector] {line}")

    # score_frame of 2 frames on the card against the CPU, and its times
    worst = 0.0
    for k in FS_SHARP[0], FS_SHARP[0] + 1:
        img = read_png(frames_dir / f"frame_{k:04d}.png")
        gray = frameselector.device_gray(img, dev)
        ys, xs = sharp.crop_by_ratio(tuple(gray.shape),
                                     frameselector.DEFAULT_CROP_RATIO)
        gray = gray[ys, xs].contiguous()
        got = torch.stack(sharp.score_frame(gray, None, metric="hybrid",
                                            use_mask=False)).cpu()
        ref = torch.stack(sharp.score_frame(gray.cpu(), None,
                                            metric="hybrid", use_mask=False))
        rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-12)).max())
        worst = max(worst, rel)
        if not torch.allclose(got, ref, rtol=SCORE_RTOL, atol=1e-6):
            raise AssertionError(f"score_frame frame {k}: card {got.tolist()}"
                                 f" vs CPU {ref.tolist()}")
    parts = {
        "score_frame hybrid": lambda: sharp.score_frame(
            gray, None, metric="hybrid", use_mask=False),
        "lapvar": lambda: sharp.laplacian_variance(gray),
        "tenengrad": lambda: sharp.tenengrad(gray),
        "fft": lambda: sharp.fft_energy(gray),
    }
    ms = {name: cuda_ms(fn, reps=5, batches=3) for name, fn in parts.items()}
    small = []
    for k in (0, 1):
        g = frameselector._load_gray(frames_dir / f"frame_{k:04d}.png")
        g = sharp.downscale_max_long(g, frameselector.FLOW_DOWNSCALE)
        ys, xs = sharp.crop_by_ratio(g.shape, frameselector.FLOW_CROP_RATIO)
        small.append(torch.from_numpy(np.ascontiguousarray(g[ys, xs]))
                     .to(dev))
    lk_ms = launch_ms(lambda: flowk.mean_flow_magnitude(*small), reps=5)
    fb_ms = launch_ms(lambda: flowk.mean_flow_magnitude_farneback(*small),
                      reps=5)
    log(f"[frameselector] score_frame on the card vs CPU ({gray.shape[1]}x"
        f"{gray.shape[0]} crop of 8K, 2 frames): max rel diff {worst:.3e} | "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f" | per pair ({small[0].shape[1]}x{small[0].shape[0]} grays): LK "
        f"{lk_ms:.4f} ms, Farneback {fb_ms:.4f} ms | set-up (PNG writes) "
        f"{setup_s:.2f}s")
    return runs


def write_cube(path: pathlib.Path, n: int, seed: int) -> None:
    """A .cube file of a seeded smooth colour function (red fastest)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.6, 1.4, 3)
    g = np.linspace(0.0, 1.0, n)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")   # file order
    table = np.stack([r ** a[0] * (0.9 + 0.1 * gg),
                      gg ** a[1] * (0.85 + 0.15 * b),
                      b ** a[2] * (0.8 + 0.2 * r)], -1).reshape(-1, 3)
    lines = [f'TITLE "chip smoke {seed}"', f"LUT_3D_SIZE {n}"]
    lines += [f"{x:.6f} {y:.6f} {z:.6f}" for x, y, z in table]
    path.write_text("\n".join(lines) + "\n")


def phase_dualfisheye_lut(dev, tmp, remap: dict, dfe: dict) -> dict:
    """The dualfisheye phase's pairs once more through a 33³ .cube with
    sRGB output: launches, and pair 1 against the plain path on the
    card."""
    cube = tmp / "decode.cube"
    write_cube(cube, LUT_SIZE, 5)
    out_dir = tmp / "dfe_lut"
    warp_cuda.reset_counters()
    remap_cuda.reset_counters()
    t0 = time.perf_counter()
    rc = dualfisheye.main([
        "--input-dir", str(dfe["in_dir"]), "--output-dir", str(out_dir),
        "--save-fisheye-output", "--perspective-ext", ".png",
        "--mask-input-dir", str(dfe["mask_dir"]), "--input-lut", str(cube),
        "--lut-output-color-space", "srgb", "--report-json",
        str(tmp / "report_lut.json"), "--device", dev.type, "--stats"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {**warp_cuda.LAUNCHES, **remap_cuda.LAUNCHES}
    plain = {**warp_cuda.PLAIN_CALLS, **remap_cuda.PLAIN_CALLS}
    report = json.loads((tmp / "report_lut.json").read_text())
    if rc != 0 or report["failed"] != 0 or report["processed"] != 2:
        raise AssertionError(f"dualfisheye --input-lut exited {rc}, "
                             f"report {report}")
    want = {"planarize": 4, "warp": 0, "remap": 10}
    if launches != want:
        raise AssertionError(f"dualfisheye --input-lut launches {launches}, "
                             f"expected {want}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")

    lut = colorlib.load_cube_lut(cube)
    table = colorlib.lut_table(lut, dev)

    def plain_planes(img):
        rows = torch.from_numpy(img.reshape(img.shape[0], -1)).to(dev)
        planes = warp_cuda.planarize_rows_plain(rows, 1.0 / 255.0,
                                                torch.float32)
        return colorlib.rec709_to_srgb(
            colorlib.apply_cube_lut_planar(planes, lut, table))

    def plain_remap(planes, mx, my, valid, interp):
        return quantize(remap_cuda.remap_planes_plain(
            planes, torch.as_tensor(mx, device=dev)[None],
            torch.as_tensor(my, device=dev)[None],
            torch.as_tensor(valid, device=dev)[None], interp=interp,
            fill=0.0)[0])

    planes = {lens: plain_planes(dfe["images"][f"osmo_0001_{lens}.png"])
              for lens in "XY"}
    cache = remap["cache"]
    worst, share = 0, 0.0
    checks = [(f"osmo_0001_{lens}.png", planes[lens],
               (cache.map_x, cache.map_y, cache.valid)) for lens in "XY"]
    for spec in remap["specs"]:
        m = remap["views"][spec["view_id"]]
        checks.append((f"perspective/images/osmo_0001_{spec['view_id']}.png",
                       planes[m["lens_key"]],
                       (m["map_x"], m["map_y"], m["valid"])))
    for name, src, maps in checks:
        lsb = _lsb_check(read_png(out_dir / name),
                         plain_remap(src, *maps, "catmull-rom"),
                         f"dualfisheye --input-lut {name}")
        worst, share = max(worst, lsb[0]), max(share, lsb[1])
    masks_equal = all(
        np.array_equal(read_png(out_dir / "perspective" / "masks" / p.name),
                       read_png(p))
        for p in (dfe["out_dir"] / "perspective" / "masks").iterdir())
    if not masks_equal:
        raise AssertionError("dualfisheye --input-lut: masks differ from "
                             "the run without a LUT")
    lut_ms = cuda_ms(lambda: colorlib.apply_cube_lut_planar(
        planes["X"], lut, table))
    log(f"[dualfisheye-lut] 2 pairs {FISH}² through a {LUT_SIZE}³ .cube + "
        f"sRGB: wall {wall_s:.3f}s | launches {launches} plain {plain} | "
        f"pair 1 vs plain path on the card: max {worst} LSB, {share:.5%} of "
        f"pixels differ, masks equal | LUT apply {FISH}² {lut_ms:.4f} ms")
    return {"launches": launches, "wall_s": wall_s}


def main() -> int:
    info = phase_device()
    dev = torch.device("cuda", torch.cuda.current_device())
    plan = phase_planarize(dev)
    warp = phase_warp(dev)
    tilted = phase_warp_tilted(dev)
    with tempfile.TemporaryDirectory(prefix="gs360x_smoke_") as tmp_name:
        tmp = pathlib.Path(tmp_name)
        # the default calibration is generated under ~/.gs360x: keep it in
        # this run's directory
        os.environ["HOME"] = str(tmp)
        remap = phase_remap(dev)

        src_dir = tmp / "panos"
        src_dir.mkdir()
        frames = {}
        t0 = time.perf_counter()
        for k, shift in enumerate([0.0, 0.5][:E2E_FRAMES]):
            stem = f"pano_{k + 1:04d}"
            frame = lonlat_frame(SRC_H, SRC_W, shift, dev).cpu().numpy()
            Image.fromarray(frame).save(src_dir / f"{stem}.png")
            frames[stem] = (shift, frame)
        log(f"[e2e] wrote {E2E_FRAMES} 8K PNG frames in "
            f"{time.perf_counter() - t0:.2f}s (set-up)")
        runs = {
            "default": phase_perspcut(dev, src_dir, frames, tmp, "default",
                                      1600),
            "fisheyelike": phase_perspcut(dev, src_dir, frames, tmp,
                                          "fisheyelike"),
            "fisheyeXY": phase_perspcut(dev, src_dir, frames, tmp,
                                        "fisheyeXY"),
        }
        dfe = phase_dualfisheye(dev, tmp, remap)
        dfe_lut = phase_dualfisheye_lut(dev, tmp, remap, dfe)
        v2f = phase_video2frames(dev, tmp)
        fsel = phase_frameselector(dev, tmp)

    def total(kernel: str) -> int:
        return sum(r["launches"].get(kernel, 0)
                   for r in [*runs.values(), dfe, dfe_lut, *v2f.values(),
                             *fsel.values()])

    checks = remap["checks"]

    def row(name, source, replaces, kernel, stats):
        return {"name": name, "route": "cuda",
                "source": f"gs360x_torch/csrc/{source}",
                "replaces": f"gs360x/kernels/{replaces}",
                "launches": total(kernel),
                "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
                "plain_ms": stats["plain_ms"]}

    kernels = [
        row("planarize (_planarize_mxu_kernel)", "planarize.cu",
            "warp_pallas.py:3234", "planarize", plan),
        row("planarize (_planarize_kernel)", "planarize.cu",
            "warp_pallas.py:3193", "planarize", plan),
        row("warp_equirect (_warp_kernel_yaw2: yaw ring 8x1920x1080)",
            "warp_equirect.cu", "warp_pallas.py:1032", "warp",
            warp["headline"]),
        row("warp_equirect (_warp_kernel_yaw: yaw ring 8x1600x1600)",
            "warp_equirect.cu", "warp_pallas.py:734", "warp", warp["main"]),
        row("warp_equirect (_warp_kernel: pitched full360coverage)",
            "warp_equirect.cu", "warp_pallas.py:613", "warp",
            tilted["pitched"]),
        row("warp_equirect (_warp_kernel_wide3: fisheyeXY hemispheres)",
            "warp_equirect.cu", "warp_pallas.py:2814", "warp",
            tilted["fisheye"]),
        row("warp_equirect (_warp_kernel_wide2: pole view)",
            "warp_equirect.cu", "warp_pallas.py:1671", "warp",
            tilted["pole"]),
        row("warp_equirect (_warp_kernel_wide: equisolid view)",
            "warp_equirect.cu", "warp_pallas.py:1182", "warp",
            tilted["equisolid"]),
        row("remap (_remap_kernel: undistort 3840²)", "remap.cu",
            "remap_pallas.py:110", "remap", checks["undistort"]),
        row("remap (_remap_kernel_wide3: SFM10 10x1750²)", "remap.cu",
            "remap_pallas.py:283", "remap", checks["batch"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
