#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``gs360x_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``gs360x_torch/csrc`` (into
``build/gs360x_torch/``), holds each kernel against its plain torch
version on the card at the main paths' shapes and times both (planarize
for every input/output type, the RGBX texel mode and every variant on an 8K
frame, a 3840² lens image and a ragged, unaligned view; the equirect warp
on yaw-ring, pitched, pole and fisheye views of an 8K frame; the remap on
the Osmo 360 undistort map and the 10 SFM10 maps; warp and remap with the
f32 store against the plain version and with the u8 / u16 store bitwise
against the plain quantize of the f32 store),
then drives each main path once through the port's CLIs and checks that
it went through the kernels only and that its pixels are right:

* ``gs360x-torch-perspcut`` on 2 synthetic 8K frames with the
  ``default``, ``fisheyelike`` and ``fisheyeXY`` presets (PNG);
* the trace hook (``[trace]``): ``perspcut --preset default`` on the same
  frames with ``GS360X_TRACE_DIR`` set, between two runs without it; the
  trace under ``<dir>/run_plan/`` holds exactly the kernels the launch
  counters count, and gives the device's busy share of ``run_plan``;
* ``gs360x-torch-dualfisheye`` on 2 synthetic 3840² pairs with the
  generated default calibration, undistorted fisheyes, the 10 SFM10
  views and one mask pair (PNG), then once more through a 33³ ``.cube``
  LUT decode with sRGB output;
* ``gs360x-torch-video2frames`` on a 4-frame 8K 4:2:0 Y4M (PNG at 2 fps),
  then ``--fisheye-perspective`` on a 3840² lens Y4M;
* the batched video path (``[mesh]``, ``runtime/mesh.py``): one
  ``warp_equirect.cu`` launch for 4 8K frames × the yaw ring and the
  ``default`` views, bitwise the per-frame launches, for u8 and u16
  batches and the colour route; ``gs360x-torch-perspcut`` in video mode
  on a 6-frame 8K Y4M at ``--preset default``, 4 frames a launch (one
  full batch, a 2-frame tail) against 1, files byte-equal; the batch
  statistics card vs CPU;
* ``gs360x-torch-frameselector`` on 6 8K frames of graded sharpness with
  optical flow (Lucas–Kanade, then Farneback), and in pair mode on 4
  3840² ``_X``/``_Y`` pairs;
* ``gs360x-torch-ms360xml --persp-cut`` on a Metashape spherical XML of the
  2 8K frames at the tool's default preset (``full360coverage``, 12 views
  of 1600² a frame), then ``--format all --points-ply`` (host only);
* ``gs360x-torch-dualfisheye --camera-extrinsics-xml`` on the 2 pairs
  (the pixels of the run without the flag, plus the perspective Metashape
  XML and ``sparse/0``), then ``--metadata-only``;
* ``gs360x-torch-maskseg`` in every output mode on 4 views of 1600², 2 of
  1920×1080 and one 8K frame (synthetic photo-style scenes, two manual add
  layers), held to the same tool on the CPU; the U-Net (f32 convs), the
  morphology and the inpaint on the card against the CPU; the shipped
  weights' four capability gates on the card; the device ms of each step
  and the tool's wall by stage. MaskSeg launches none of the kernels;
* the U-Net's training (``[segtrain]``): (a) three steps of the default
  width at 256², batch 8, on the card and on the CPU from one init, and a
  step's device ms by both conv routes; (b) ``gs360x-torch-segtrain`` on
  32 synthseg image / mask pairs at 512², its weights read back bitwise,
  then MaskSeg with them; (c) ``--make-default -o``, then MaskSeg's
  default resolution with it; (d) the ``tools/seg_eval.py`` recipe
  trained on the card, its four capability numbers held to the floor of
  the JAX package's seeds (``tests/torch_seg_floor.py``); (e) the
  data-parallel step over two replicas on the one card against one
  replica, and one replica bitwise the step without a mesh; (b) prints
  ``devices 1``, the mesh of every visible card;
* ``gs360x-torch-plyopt`` (``[plyopt]``) on an 8M-point dense cloud in
  every mode (the target search, ``-v`` with each ``--keep-strategy``, the
  spatial hash, the adaptive octree, the sky dome with an appended PLY),
  a COLMAP round trip, every mode card vs ``--device cpu`` on 1M points,
  the 8M picks equal over two card runs, the voxel count and reduce's
  device ms;
* ``gs360x-torch-scene`` (``[scene]``) on each format ``[ms360xml]``
  exported, the cameras agreeing across them. None of the three launches
  a hand-written kernel;
* ``gs360x-torch-warmup --all`` in this process (``[warmup]``): the
  kernel library, one 8K frame through every preset's view sets and the
  SFM10 remap at 1750², the launches held to what the view sets need;
  then ``--preset default`` in a subprocess, which must not build again;
* the GUI's headless modules (``[gui]``; ``gui/app.py`` needs a display
  and is not imported): the PerspCut tab's argv through
  ``ProcessRunner.run``, its files byte-equal to the direct run's; a
  FrameSelector + MaskSeg ``run_queue`` watched by an ``OutputMonitor``;
  the segmentation preview card vs CPU; the selection CSV in the score
  review, and its apply through the runner;
* ``python -m gs360x_torch.tools.micro_ops``: the 14 primitive kernels of
  ``micro_ops.cu``, each first held to its plain version on the card, then
  timed on the device without the wrapper's host time (events around a
  CUDA graph's replay of 10 launches) beside its event time, its time with
  no loop and a loop's marginal time, its bound and, where one torch call
  computes an application, that call over the grid's blocks; the two
  products (three TF32 passes on the tensor cores, their HGMMA
  instructions counted in the built library) beside one cuBLAS f32 call a
  step; concat and the counted loop with their FADD instructions counted
  likewise, the (8,128) mul and where with their FMUL (and where with no
  FSEL), the (8,128) gather with its FADD and no BAR; where's, mul8's and
  the (8,128) gather's launch with no loop on one block beside the
  grid's; the two axis-1 gathers and the composite beside the floor of
  their shared-memory wavefronts; then the primitives ranked by launches
  × (device − the larger of bound and floor).

Phases print one line each; any failure raises and the exit code is not
0. Without CUDA, or without the rest of the checkout (it then says what it
lacks), it exits non-zero and prints no result. The last line is the JSON
result.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import concurrent.futures as cf
import csv
import io
from contextlib import contextmanager, redirect_stdout

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

try:
    from gs360x_torch.core import camera as cam
    from gs360x_torch.core import color as colorlib
    from gs360x_torch import checks, native
    from gs360x_torch.io import image as imagelib
    from gs360x_torch.io import ply as plyio
    from gs360x_torch.io import scene as scene_io
    from gs360x_torch.io.formats import colmap_text
    from gs360x_torch.io.formats import metashape as msxml
    from gs360x_torch.io.formats import model as colmap_model
    from gs360x_torch.kernels import _build, flow as flowk, remap_cuda
    from gs360x_torch.kernels import micro_ops_cuda as mo
    from gs360x_torch.kernels import morphology as morph
    from gs360x_torch.kernels import sharpness as sharp
    from gs360x_torch.kernels import voxel
    from gs360x_torch.kernels import warp as twin
    from gs360x_torch.kernels import warp_cuda
    from gs360x_torch.models import synthseg
    from gs360x_torch.models import segmentation as seg
    from gs360x_torch.rig.presets import PerspCutConfig, build_view_plan
    from gs360x_torch.io import video as videolib
    from gs360x_torch.runtime import executor
    from gs360x_torch.runtime import mesh as meshlib
    from gs360x_torch.runtime.executor import _view_groups
    from gs360x_torch.runtime.profiling import (StageTimers, cuda_ms,
                                                device_ms, maybe_trace,
                                                read_trace)
    from gs360x_torch.tools import (dualfisheye, frameselector, maskseg,
                                    ms360xml, perspcut, plyopt, segtrain,
                                    video2frames)
    from gs360x_torch.tools import scene as scene_tool
    from gs360x_torch.tools import micro_ops as micro_ops_tool
    from gs360x_torch.tools import warmup
    from gs360x_torch.core import pose as posemath
    from gs360x_torch.gui import forms, scorereview, segpreview
    from gs360x_torch.gui import monitor as gui_monitor
    from gs360x_torch.gui import runner as gui_runner
except ModuleNotFoundError as exc:
    if not (exc.name or "").startswith("gs360x_torch"):
        raise
    raise SystemExit(
        f"chip_smoke: {exc}. Run it from the root of a checkout: it drives "
        "the gs360x_torch package beside it and builds the kernels from "
        "gs360x_torch/csrc") from None

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
# f32 instructions an output pixel of the resampling kernels must issue,
# for the operations side of a bound: a mul + add that the kernel contracts
# into an FMA is one, a lone op one. A cubic pixel: 3 channels x (16 tap
# FMAs along the rows + 4 FMAs down the column) and two 4-tap weight sets
# (t², t³ and four cubics in Horner form, ~12 a set); a bilinear one: 3
# channels x 3 lerps (a multiply and an FMA each) and 1 - fx, 1 - fy; a
# nearest one: the scale. The warp adds the ray (~54: the pixel centre 4,
# the normalised perspective ray 7, its rotation 9, atan2 ~16 and asin ~12
# as polynomials, u and v 2, floor and fraction 4), which the remap, whose
# coordinates come from maps, does not have
TAP_INSNS_PER_PX = {"bicubic": 3 * (16 + 4) + 24,
                    "catmull-rom": 3 * (16 + 4) + 24,
                    "bilinear": 3 * 3 * 2 + 2, "nearest": 3}
WARP_RAY_INSNS_PER_PX = 54
# the plain versions take 5-55 ms a call: fewer repeats than the kernels
PLAIN_TIMING = dict(reps=3, batches=3, warmup=1)
# ms360xml --persp-cut writes JPEG (q98, 4:4:4: the cut's default, which
# the tool's flags cannot change). A 1-LSB flip before the encode spreads
# over its 8x8 block, so the files are held to the JPEG of the plain
# twin's views at the [e2e] share gate (<= 1% of pixels more than 1 LSB
# apart) and at JPEG_MAX_LSB at most
JPEG_MAX_LSB = 8
V2F_FRAMES, V2F_FPS, V2F_RATE = 4, 4.0, 2.0   # 1 s of video, -f 2: 2 frames
# [mesh]: a batch of 4 8K frames (the JAX executor's frames a batch on an
# accelerator); perspcut's video mode on 6 frames: one full batch of 4 and
# a 2-frame tail, against 1 frame a launch
MESH_BATCH = 4
MESH_FRAMES = 6
FS_FRAMES, FS_SEGMENT = 6, 3     # frameselector: 2 segments of 3 8K frames
FS_SHARP = (1, 4)                # the one sharp frame of each segment
FS_PAIRS, FS_PAIR_SHARP = 4, 1   # pair mode: 4 3840² pairs, pair 1 sharp
LUT_SIZE = 33
# score_frame on the card against the same code on the CPU
SCORE_RTOL = 1e-4
# [maskseg]: four views of the default preset (1600²), two of the headline
# ring (1920×1080) and one 8K frame (view id, H, W); manual add layers for
# B and F, so every output mode sees a non-empty mask
MS_VIEWS = [("A", 1600, 1600), ("B", 1600, 1600), ("C", 1600, 1600),
            ("D", 1600, 1600), ("E", 1080, 1920), ("F", 1080, 1920),
            ("G", SRC_H, SRC_W)]
MS_LAYERS = ("B", "F")
MS_MODES = ("mask", "alpha", "cutout", "keep_person", "remove_person",
            "inpaint")
# card against CPU, TF32 off in both: the card's and the CPU's f32 convs
# differ in summation order only (~1e-4 on logits up to ~50)
LOGIT_TOL = 1e-3
PROB_TOL = 1e-3
# a mask pixel may flip where the probability lies within MASK_BAND of the
# threshold; masks may differ on at most MASK_SHARE_TOL of their pixels
MASK_BAND = 1e-4
MASK_SHARE_TOL = 1e-4
INPAINT_TOL = 1e-5

# [segtrain]: (a) card vs CPU at the default width
ST_SIZE, ST_BATCH, ST_STEPS = 256, 8, 3
ST_LOSS_RTOL = 1e-5          # step 1's loss, relative
ST_LATER_LOSS_RTOL = 1e-4    # steps 2-3, after Adam's first updates
ST_GRAD_TOL = 5e-4           # step 1's gradients, of the largest |gradient|
# (e): the data-parallel step over two replicas on the one card against
# one replica, by the im2col route: every step's loss within ST_LOSS_RTOL,
# step 1's gradients within ST_GRAD_TOL
ST_REPLICAS = 2
ST_CLI_SCENES = 32           # (b): 512² image / mask pairs, trained at
ST_CLI_SIZE = 256            # --size 256 --batch-size 8 --epochs 3
CAP_STEPS = 3000             # (d): the tools/seg_eval.py recipe
CAP_PROFILED = 20            # of them, the last steps under the profiler
# (d)'s floor: the lowest of the JAX package's seeds 0-2 trained by the
# same recipe on the CPU, less 0.05 a metric
# (python3 tests/torch_seg_floor.py)
CAP_FLOOR = {"heldout": 0.750262341998569, "photo": 0.6496503496503496,
             "transfer": 0.5912310286677909, "AP@0.5": 0.6314449917898194}

# [plyopt]
PLY_POINTS = 8_000_000
PLY_SUBSET = 1_000_000       # card vs --device cpu
PLY_VOXEL = 0.1              # -v, metres
PLY_TARGET = 1_000_000       # -t, and --downsample-method spatial-hash -t
PLY_ADAPTIVE = 50_000        # --adaptive -t

SCENE_TOL = 1e-4             # [scene]: camera centres across formats


def log(msg: str) -> None:
    print(msg, flush=True)


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
    log("[device] host library (native/gs360x_native.cpp, interleave and "
        "YUV on the CPU): " + ("built with g++ and loaded"
                               if native.HAS_NATIVE else "numpy fallback"))
    report = _build.ptxas_report()
    for fn, _regs, _spill, text in report:
        log(f"[ptxas] {fn}: {text}")
    spilling = [fn for fn, _regs, spill, _text in report if spill]
    log(f"[ptxas] {len(report)} kernels, "
        f"{min((r[1] for r in report), default=0)}-"
        f"{max((r[1] for r in report), default=0)} registers, "
        f"{len(spilling)} with spills")
    if spilling:
        raise AssertionError(f"ptxas spilled registers in {spilling}")
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


def _planarize_library(rows: torch.Tensor, h: int, w: int, scale: float,
                       out_dtype):
    """The one PyTorch call that computes planarize on ``rows``: a strided
    copy for an exact de-interleave, ``torch.mul`` into planes when the
    scale is fused (None for u16, which takes two calls). Timed beside
    the kernel; the port never calls it."""
    hwc = rows.view(h, w, 3).permute(2, 0, 1)
    planes = torch.empty((3, h, w), dtype=out_dtype, device=rows.device)
    if rows.dtype == out_dtype and scale == 1.0:
        return lambda: planes.copy_(hwc)
    if rows.dtype == torch.uint16:      # torch has no uint16 arithmetic
        return None
    return lambda: torch.mul(hwc, scale, out=planes)


def _check_texelize(label: str, h: int, w: int, offset: int, dev) -> dict:
    """The texel mode (u8 rows -> RGBX texels) at one shape: bitwise against
    its plain version on every path the shape allows, timed against its
    bound (3 bytes read and 4 written a pixel)."""
    rows = _planarize_rows_input(h, w, torch.uint8, offset, 99, dev)
    ref = warp_cuda.texelize_rows_plain(rows)
    got = warp_cuda.texelize_rows(rows)
    kept = warp_cuda.planarize_variant(rows, got)
    others = ["scalar"] if kept != "scalar" else []
    outs = {v: warp_cuda.texelize_rows(rows, variant=v) for v in others}
    torch.cuda.synchronize()
    for variant, out in [(kept, got), *outs.items()]:
        if not torch.equal(out, ref):
            raise AssertionError(f"planarize {label} u8->texels {variant}: "
                                 "kernel != plain")
    ms = cuda_ms(lambda: warp_cuda.texelize_rows(rows))
    plain_ms = cuda_ms(lambda: warp_cuda.texelize_rows_plain(rows))
    other_ms = {v: cuda_ms(lambda v=v: warp_cuda.texelize_rows(
        rows, variant=v)) for v in others}
    moved = h * w * (3 + 4)
    gbs = moved / ms / 1e6
    bound_ms = moved / (HBM_TBS * 1e9)
    log(f"[planarize] {label} u8->texels (RGBX): bitwise equal "
        f"({', '.join([kept + ' (main path)', *others])}) | kernel {kept} "
        f"{ms:.4f} ms ({gbs:.1f} GB/s, {gbs / HBM_TBS / 10:.1f}% of "
        f"{HBM_TBS} TB/s; bound {bound_ms:.4f} ms), plain = one torch call "
        f"(F.pad) {plain_ms:.4f} ms"
        + "".join(f" | {v} {t:.4f} ms" for v, t in other_ms.items()))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": plain_ms}


def phase_planarize(dev) -> dict:
    """Every (in, out) pair and the texel mode at the main paths' shapes
    and one ragged, unaligned shape: bitwise against the plain version, for
    the variant the main path takes and for every other variant the shape
    allows; each timed beside the plain version."""
    stats = {}
    for label, h, w, offset in PLANARIZE_SHAPES:
        stats[(label, "texels")] = _check_texelize(label, h, w, offset, dev)
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
            library = _planarize_library(rows, h, w, scale, out_dtype)
            library_ms = cuda_ms(library) if library else None
            other_ms = {v: cuda_ms(lambda v=v: warp_cuda.planarize_rows(
                rows, scale, out_dtype, variant=v)) for v in others}
            moved = h * w * 3 * (rows.element_size() + got.element_size())
            gbs = moved / ms / 1e6
            bound_ms = moved / (HBM_TBS * 1e9)
            extra = ", ".join(f"{v} {t:.4f} ms" for v, t in other_ms.items())
            if (label, pair) == (PLANARIZE_SHAPES[0][0], "u8->u8"):
                # also timed one launch at a time
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
                f"{plain_ms:.4f} ms, one torch call "
                + (f"{library_ms:.4f} ms" if library else "n/a")
                + (f" | {extra}" if extra else ""))
            stats[(label, pair)] = {"max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms,
                                    "bound_ms": bound_ms, "bound_by": "bytes",
                                    "library_ms": library_ms}
            del rows, ref, got, outs
    main_shape = PLANARIZE_SHAPES[0][0]
    planes = stats[(main_shape, "u8->u8")]
    # the u8 main paths' source pass is the texel mode; the u8 planes of the
    # same frame stand beside it
    return {"exact": {**stats[(main_shape, "texels")],
                      "ms_u8_planes": planes["ms"],
                      "bound_ms_u8_planes": planes["bound_ms"]},
            "scaled": stats[(main_shape, "u8->f32")]}


def _check_stores(label: str, got: torch.Tensor, launch) -> None:
    """``launch(out_dtype)`` with the u8 and the u16 store against the plain
    four-pass quantize of the same kernel's f32 store ``got``: bitwise."""
    for out_dtype in (torch.uint8, torch.uint16):
        stored = launch(out_dtype)
        torch.cuda.synchronize()
        if stored.dtype != out_dtype or not torch.equal(
                stored, warp_cuda.quantize_plain(got, out_dtype)):
            raise AssertionError(f"{label}: the {out_dtype} store is not the "
                                 "plain quantize of the f32 store")


def _time_warp(rows: torch.Tensor, texels: torch.Tensor, got: torch.Tensor,
               angles, kw: dict, label: str) -> dict:
    """Device times of one view set of a u8 frame: the kernel with the f32
    and the u8 store, the four-pass quantize of its f32 views, and source
    pass + resample + quantize a (group, frame) by the route through u8
    planes, the f32 store and the plain quantize, and by the image-mode
    main path (texels, u8 store)."""
    u8 = torch.uint8
    ms_f32 = cuda_ms(lambda: warp_cuda.warp_texels(texels, *angles, **kw))
    ms_u8 = cuda_ms(lambda: warp_cuda.warp_texels(texels, *angles,
                                                  out_dtype=u8, **kw))
    quant_ms = cuda_ms(lambda: warp_cuda.quantize_plain(got, u8))
    unfused_ms = cuda_ms(lambda: warp_cuda.quantize_plain(
        warp_cuda.warp_planes(warp_cuda.planarize_rows(rows, 1.0, u8),
                              *angles, **kw), u8))
    route_ms = cuda_ms(lambda: warp_cuda.warp_texels(
        warp_cuda.texelize_rows(rows), *angles, out_dtype=u8, **kw))
    log(f"[warp] {label}: kernel f32 store {ms_f32:.4f} ms, u8 store "
        f"{ms_u8:.4f} ms, four-pass quantize of the f32 views "
        f"{quant_ms:.4f} ms | device ms a (group, frame): planes + f32 store "
        f"+ quantize {unfused_ms:.4f} -> texels + u8 store {route_ms:.4f}")
    return {"ms": ms_u8, "ms_f32_out": ms_f32, "quantize_ms": quant_ms,
            "route_unfused_ms": unfused_ms, "route_ms": route_ms}


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
    _check_stores(f"warp {label} {interp}", got,
                  lambda dt: warp_cuda.warp_equirect_to_views_cuda(
                      rows, RING, zeros, zeros, interp=interp, planar=True,
                      out_dtype=dt, **geom))
    err = float((got - ref).abs().max())
    lsb = (quantize(got) - quantize(ref)).abs()
    max_lsb = int(lsb.max())
    share = float((lsb > 0).float().mean())
    log(f"[warp] {label} {interp}: max|diff| f32 {err:.3e}, quantized max "
        f"{max_lsb} LSB, {share:.5%} of pixels differ | u8 and u16 stores "
        f"bitwise the plain quantize of the f32 store")
    if max_lsb > 1:
        raise AssertionError(f"warp {label} {interp}: {max_lsb} LSB apart")
    if smooth:
        if err > F32_TOL:
            raise AssertionError(f"warp {label} {interp}: f32 diff {err}")
        if share > LSB_SHARE_TOL:
            raise AssertionError(f"warp {label} {interp}: {share:.4%} "
                                 "of pixels differ")
    return err


def _resample_bound(bytes_moved: int, op_pixels: int, insns_per_px: int
                    ) -> dict:
    """The least time the card could take for a resampling launch: the
    bytes it must move (each input read once, the output written once)
    over the memory rate, or its f32 instructions (``op_pixels`` sampled
    output pixels of ``insns_per_px`` each) over the issue rate."""
    by_bytes = bytes_moved / (HBM_TBS * 1e9)
    by_ops = op_pixels * insns_per_px / (mo.FP32_ISSUE_T * 1e9)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def _touched_texels(u: torch.Tensor, v: torch.Tensor, valid, src_h: int,
                    src_w: int, interp: str, equirect: bool) -> int:
    """The distinct source texels under the tap windows of the output
    pixels at (u, v) (no tap where ``valid`` is False), by the plain
    samplers' own boundary rules: on an equirect source columns wrap and
    rows reflect over the poles, on a lens image both clamp. These are the
    source bytes a launch must read: a view set covers a band of the
    frame, seldom the whole of it."""
    offsets = {"nearest": (0,), "bilinear": (0, 1)}.get(interp, (-1, 0, 1, 2))
    base = torch.round if interp == "nearest" else torch.floor
    x0, y0 = base(u).to(torch.int64), base(v).to(torch.int64)
    if valid is not None:
        keep = valid.expand_as(u)
        x0, y0 = x0[keep], y0[keep]
    seen = torch.zeros(src_h * src_w, dtype=torch.bool, device=u.device)
    for dy in offsets:
        if equirect:
            yi, over = twin._reflect_y(y0 + dy, src_h)
            shift = twin._half_shift(over, src_w)
        else:
            yi, shift = torch.clamp(y0 + dy, 0, src_h - 1), 0
        for dx in offsets:
            xi = twin._wrap_x(x0 + dx + shift, src_w, equirect)
            seen[(yi * src_w + xi).reshape(-1)] = True
    return int(seen.sum())


def _sampled_pixels(u: torch.Tensor, valid) -> int:
    return u.numel() if valid is None else int(valid.expand_as(u).sum())


def _store_bounds(bytes_in: int, out_values: int, op_pixels: int,
                  insns_per_px: int) -> dict:
    """The bound of a resampling launch with the u8 store (what the
    image-mode main path launches), and beside it that of the f32 store."""
    bound = _resample_bound(bytes_in + out_values, op_pixels, insns_per_px)
    f32 = _resample_bound(bytes_in + out_values * 4, op_pixels, insns_per_px)
    bound["bound_ms_f32_out"] = f32["bound_ms"]
    bound["bound_by_f32_out"] = f32["bound_by"]
    return bound


def _warp_bound(u: torch.Tensor, v: torch.Tensor, valid,
                interp: str = "bicubic") -> dict:
    """Bound of one warp launch of a u8 frame over the (V, h, w) source
    coordinates of its views: 3 bytes of every touched texel read once
    (whatever the layout: the X byte of a texel is the design's cost, not
    the function's need), the views written once."""
    texels = _touched_texels(u, v, valid, SRC_H, SRC_W, interp, True)
    bound = _store_bounds(texels * 3, u.numel() * 3,
                          _sampled_pixels(u, valid),
                          TAP_INSNS_PER_PX[interp] + WARP_RAY_INSNS_PER_PX)
    bound["source_share"] = texels / (SRC_H * SRC_W)
    return bound


def _bound_text(bound: dict) -> str:
    return (f"u8 store {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
            f"f32 store {bound['bound_ms_f32_out']:.4f} ms "
            f"({bound['bound_by_f32_out']})")


def _ring_uv(geom: dict, dev) -> tuple:
    ring = torch.tensor(RING, dtype=torch.float32, device=dev)
    return twin.view_uv_from_equirect(
        geom["width"], geom["height"], geom["hfov_deg"], geom["vfov_deg"],
        "perspective", ring, torch.zeros_like(ring), torch.zeros_like(ring),
        SRC_W, SRC_H, device=dev)


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
    texels = warp_cuda.texelize_rows(smooth)
    src_f32 = smooth.reshape(SRC_H, SRC_W, 3).to(torch.float32) / 255.0
    zeros = [0.0] * len(RING)
    ring = (RING, zeros, zeros)
    out = {}
    for key, geom, label in (("headline", HEADLINE, "headline 8x1920x1080"),
                             ("main", MAIN, "main-path 8x1600x1600")):
        kw = dict(interp="bicubic", **geom)
        got = warp_cuda.warp_texels(texels, *ring, **kw)
        times = _time_warp(smooth, texels, got, ring, kw,
                           f"{label} bicubic from 8K u8")
        del got
        plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
            src_f32, *ring, **kw), **PLAIN_TIMING)
        bound = _warp_bound(*_ring_uv(geom, dev))
        log(f"[warp] {label}: plain {plain_ms:.4f} ms "
            f"({8000.0 / times['ms']:.1f} views/s with the u8 store) | "
            f"bounds: {_bound_text(bound)}, {bound['source_share']:.1%} of "
            f"the source touched")
        out[key] = {"plain_ms": plain_ms, **times, **bound}
    bil = dict(interp="bilinear", **HEADLINE)
    bil_ms = cuda_ms(lambda: warp_cuda.warp_texels(texels, *ring, **bil))
    bil_u8_ms = cuda_ms(lambda: warp_cuda.warp_texels(
        texels, *ring, out_dtype=torch.uint8, **bil))
    bil_plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
        src_f32, *ring, **bil), **PLAIN_TIMING)
    log(f"[warp] headline 8x1920x1080 bilinear: kernel f32 store "
        f"{bil_ms:.4f} ms, u8 store {bil_u8_ms:.4f} ms, plain "
        f"{bil_plain_ms:.4f} ms")
    out["headline"]["max_abs_err"] = max(errs)
    out["main"]["max_abs_err"] = main_err
    return out


def _preset_plan(preset: str, size, files, out_dir: pathlib.Path,
                 ext: str = "png"):
    """A preset's plan and its view groups as the executor launches them:
    [((projection, w, h, hfov, vfov), [job index, ...]), ...]."""
    cfg = PerspCutConfig(preset=preset, size=size or 1600, ext=ext,
                         size_explicit=size is not None)
    plan = build_view_plan(cfg, files, out_dir)
    return plan, list(_view_groups([job.view for job in plan.jobs]).items())


def _angles(plan, idxs):
    return [[getattr(plan.jobs[i].view, name) for i in idxs]
            for name in ("yaw_deg", "pitch_deg", "roll_deg")]


def _compare_views(rows, texels, src_f32, key, yaws, pitches, rolls,
                   label: str, smooth_gate: bool) -> dict:
    """One view group, kernel vs plain on the card: f32 gap, LSB gate,
    image-circle disagreements (fisheye), the u8 / u16 stores against the
    plain quantize of the f32 store, CUDA-event times."""
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
    _check_stores(f"warp {label}", got,
                  lambda dt: warp_cuda.warp_equirect_to_views_cuda(
                      rows, yaws, pitches, rolls, planar=True, out_dtype=dt,
                      **kw))
    lsb = (quantize(got) - quantize(ref)).abs()
    share = float((lsb > 1).float().mean())
    u, v, valid = twin.view_uv_from_equirect(
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
    del ref, lsb, gap
    times = _time_warp(rows, texels, got, (yaws, pitches, rolls), kw, label)
    del got
    plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
        src_f32, yaws, pitches, rolls, **kw), **PLAIN_TIMING)
    bound = _warp_bound(u, v, valid)
    log(f"[warp] {label} ({len(yaws)}x{width}x{height} {projection} "
        f"hfov {hfov:.2f}): max|diff| f32 {err:.3e}, max {max_lsb} LSB "
        f"({polar_n} polar pixels: f32 {polar_err:.3e}, max {polar_lsb} "
        f"LSB), {share:.5%} of "
        f"pixels > 1 LSB, rim-mask disagreements {rim}, u8 and u16 stores "
        f"bitwise the plain quantize | plain {plain_ms:.4f} ms, bounds: "
        f"{_bound_text(bound)}, {bound['source_share']:.1%} of the source "
        f"touched")
    if rim > RIM_TOL:
        raise AssertionError(f"warp {label}: {rim} rim pixels disagree")
    if max_lsb > ORACLE_LSB or share > ORACLE_SHARE:
        raise AssertionError(f"warp {label}: {max_lsb} LSB, {share:.4%} "
                             "of pixels > 1 LSB")
    if smooth_gate and err > F32_TOL:
        raise AssertionError(f"warp {label}: f32 diff {err}")
    return {"max_abs_err": err, "plain_ms": plain_ms, **times, **bound}


def phase_warp_tilted(dev) -> dict:
    # no pixel of the smooth frame is 0, so an all-zero output pixel is the
    # kernel's "outside the image circle"
    frame = lonlat_frame(SRC_H, SRC_W, 0.3, dev).clamp_min(1)
    rows = frame.reshape(SRC_H, SRC_W * 3)
    texels = warp_cuda.texelize_rows(rows)
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
        "pitched": _compare_views(rows, texels, src_f32, cover_key, *cover,
                                  "full360coverage --size 1600", True),
        "pole": _compare_views(rows, texels, src_f32, pole_key, [30.0],
                               [90.0], [0.0], "pole view pitch 90", False),
        "fisheye": _compare_views(rows, texels, src_f32, fish_key, *fish,
                                  "fisheyeXY hemispheres", False),
        "equisolid": _compare_views(rows, texels, src_f32, solid_key,
                                    [90.0], [-20.0], [10.0],
                                    "equisolid view", False),
    }


def _remap_check(launch, plain_call, label: str, exact: bool,
                 bytes_in: int, op_pixels: int, insns_per_px: int,
                 routes=None) -> dict:
    """``launch(out_dtype)`` against the plain version (f32 store, at the
    gates) and against the plain quantize of its own f32 store (u8 and u16
    stores, bitwise), with the times of both stores and of the four-pass
    quantize. ``bytes_in``: the source texels and the map entries the
    launch must read (:func:`_remap_bytes_in`); the output is counted from
    the result. ``routes``: (planes + f32 store + quantize, texels + u8
    store) callables of a u8 image's whole device path, timed as device ms
    a lens."""
    got = launch(None)
    ref = plain_call()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"remap {label}: non-finite output")
    _check_stores(f"remap {label}", got, launch)
    err = float((got - ref).abs().max())
    lsb = int((quantize(got) - quantize(ref)).abs().max())
    del ref
    u8 = torch.uint8
    ms_f32 = cuda_ms(lambda: launch(None))
    ms_u8 = cuda_ms(lambda: launch(u8))
    quant_ms = cuda_ms(lambda: warp_cuda.quantize_plain(got, u8))
    plain_ms = cuda_ms(plain_call, **PLAIN_TIMING)
    bound = _store_bounds(bytes_in, got.numel(), op_pixels, insns_per_px)
    times = {"ms": ms_u8, "ms_f32_out": ms_f32, "quantize_ms": quant_ms}
    route = ""
    if routes is not None:
        times["route_unfused_ms"] = cuda_ms(routes[0])
        times["route_ms"] = cuda_ms(routes[1])
        route = (f" | device ms a lens: planes + f32 store + quantize "
                 f"{times['route_unfused_ms']:.4f} -> texels + u8 store "
                 f"{times['route_ms']:.4f}")
    log(f"[remap] {label}: max|diff| f32 {err:.3e}, quantized max {lsb} LSB,"
        f" u8 and u16 stores bitwise the plain quantize | kernel f32 store "
        f"{ms_f32:.4f} ms, u8 store {ms_u8:.4f} ms, four-pass quantize "
        f"{quant_ms:.4f} ms, plain {plain_ms:.4f} ms, bounds: "
        f"{_bound_text(bound)}{route}")
    if err > REMAP_F32_TOL or lsb > (0 if exact else 1):
        raise AssertionError(f"remap {label}: f32 {err}, {lsb} LSB")
    return {"max_abs_err": err, "plain_ms": plain_ms, **times, **bound}


def _remap_bytes_in(prep, channels: int, element_size: int,
                    interp: str) -> tuple:
    """(bytes a remap launch must read, output pixels it samples, f32
    instructions a sampled pixel): the touched texels of the source (``channels`` values of ``element_size``
    bytes each, whatever the layout), the valid plane, and the two map
    entries of each valid pixel."""
    texels = _touched_texels(prep.map_x, prep.map_y, prep.valid, prep.src_h,
                             prep.src_w, interp, False)
    sampled = _sampled_pixels(prep.map_x, prep.valid)
    maps = sampled * (prep.map_x.element_size() + prep.map_y.element_size())
    if prep.valid is not None:
        maps += prep.valid.numel() * prep.valid.element_size()
    return (texels * channels * element_size + maps, sampled,
            TAP_INSNS_PER_PX[interp] * channels // 3)


def _bilinear_vs_grid_sample(und, planes_f32: torch.Tensor) -> dict:
    """The bilinear remap has a library counterpart: ``F.grid_sample``
    (bilinear, border padding, ``align_corners=True``) over the same maps
    in normalized units. Timed beside ``remap.cu`` at the undistort shape
    and held to it where the map is valid (``grid_sample`` knows no valid
    mask or fill); the port never calls it. The catmull-rom and Lagrange
    kernels have none: ``grid_sample``'s bicubic is the a = -0.75 kernel,
    another function."""
    src_h, src_w = planes_f32.shape[1:]
    grid = torch.stack([und.map_x[0] * (2.0 / (src_w - 1)) - 1.0,
                        und.map_y[0] * (2.0 / (src_h - 1)) - 1.0], -1)[None]
    src = planes_f32[None]

    def library():
        return F.grid_sample(src, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    got = und(planes_f32, interp="bilinear")
    ref = library()[0]
    valid = und.valid[0] if und.valid is not None else \
        torch.ones_like(got[0], dtype=torch.bool)
    err = float(((got - ref).abs() * valid).max())
    # grid_sample recomputes pixel coordinates from the normalized grid in
    # f32: ~1e-3 px at 3840 px, times the frame's gradient (noise of 5 LSB
    # between neighbours); a wrong convention would be off by > 0.05
    if err > 1e-2:
        raise AssertionError(f"remap bilinear vs grid_sample: {err}")
    ms = cuda_ms(lambda: und(planes_f32, interp="bilinear"))
    library_ms = cuda_ms(library)
    log(f"[remap] undistort {src_h}² bilinear f32 source: kernel {ms:.4f} "
        f"ms, F.grid_sample {library_ms:.4f} ms, max|diff| on valid pixels "
        f"{err:.3e}")
    return {"ms": ms, "library_ms": library_ms, "max_abs_err": err}


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
    rows = img.reshape(FISH, FISH * 3)
    texels = remap_cuda.remap_source(img, FISH, FISH, dev)
    if not warp_cuda.is_texels(texels):
        raise AssertionError("a u8 lens image did not become texels")
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

    def call(prep, src, interp, out_dtype):
        if prep is und:
            return prep(src, interp=interp, out_dtype=out_dtype)[None]
        return prep(src, out_dtype=out_dtype)

    def check(prep, src, interp, label, exact=False):
        # the plain version reads planes; a texel source is the u8 image
        planes = planes_u8 if src is texels else src
        routes = None
        if src is texels:   # the whole device path of a u8 lens image
            routes = (
                lambda: warp_cuda.quantize_plain(call(
                    prep, warp_cuda.planarize_rows(rows, 1.0, torch.uint8),
                    interp, None), torch.uint8),
                lambda: call(prep, warp_cuda.texelize_rows(rows), interp,
                             torch.uint8))
        return _remap_check(
            lambda dt: call(prep, src, interp, dt),
            lambda: remap_cuda.remap_planes_plain(
                planes, prep.map_x, prep.map_y, prep.valid, interp=interp,
                fill=0.0),
            label, exact,
            *_remap_bytes_in(prep, planes.shape[0], planes.element_size(),
                             interp), routes)

    out = {
        "undistort_f32": check(und, planes_f32, "catmull-rom",
                               f"undistort {FISH}² catmull-rom f32 planes"),
        "undistort": check(und, texels, "catmull-rom",
                           f"undistort {FISH}² catmull-rom u8 texels"),
        "batch_f32": check(batch, planes_f32, "catmull-rom",
                           f"SFM10 batch 10x{SFM10_SIZE}² catmull-rom f32 "
                           f"planes"),
        "batch": check(batch, texels, "catmull-rom",
                       f"SFM10 batch 10x{SFM10_SIZE}² catmull-rom u8 "
                       f"texels"),
        "mask": check(nearest, mask_planes, "nearest",
                      f"SFM10 mask batch 10x{SFM10_SIZE}² nearest C=1",
                      exact=True),
    }
    planes_ms = cuda_ms(lambda: call(batch, planes_u8, "catmull-rom", None))
    log(f"[remap] SFM10 batch from u8 planes (f32 store): {planes_ms:.4f} ms "
        f"against {out['batch']['ms_f32_out']:.4f} ms from texels")
    out["bilinear_library"] = _bilinear_vs_grid_sample(und, planes_f32)
    log(f"[remap] default Osmo 360 calibration, auto zoom "
        f"{cache.undistort_zoom:.4f}; maps built on the host in "
        f"{maps_s:.2f}s")
    return {"checks": out, "calib": calib, "cache": cache, "specs": specs,
            "views": views}


def _counters() -> tuple:
    """(launches, plain calls) of every kernel wrapper, merged; the plain
    calls include ``quantize``, the runs of the four-pass plain quantize:
    0 on an image-mode path, whose kernels' stores quantize."""
    return ({**warp_cuda.LAUNCHES, **remap_cuda.LAUNCHES, **mo.LAUNCHES},
            {**warp_cuda.PLAIN_CALLS, **remap_cuda.PLAIN_CALLS,
             **mo.PLAIN_CALLS, **warp_cuda.QUANTIZE_PASSES})


def _reset_counters() -> None:
    warp_cuda.reset_counters()
    remap_cuda.reset_counters()
    mo.reset_counters()


def _launches(planarize: int = 0, warp: int = 0, remap: int = 0) -> dict:
    """The launch counts a main-path phase expects (no micro_ops launch)."""
    return {"planarize": planarize, "warp": warp, "remap": remap,
            "micro_ops": 0}


def _texel_decodes(before: dict) -> tuple:
    """(requested, served) ``read_image(..., texels=True)`` calls since
    ``before`` (an ``imagelib.texel_decode_counts()``)."""
    now = imagelib.texel_decode_counts()
    return (now["requested"] - before["requested"],
            now["served"] - before["served"])


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

    _reset_counters()
    decodes = imagelib.texel_decode_counts()
    t0 = time.perf_counter()
    rc = perspcut.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, plain = _counters()
    decodes = _texel_decodes(decodes)
    if rc != 0:
        raise AssertionError(f"perspcut --preset {preset} exited {rc}")
    # each 8-bit RGB frame decodes to Pillow's RGBX block, uploaded as the
    # warp's texels: one warp per (view group, frame), no planarize
    want = _launches(warp=E2E_FRAMES * len(groups))
    if launches != want or decodes != (E2E_FRAMES, E2E_FRAMES):
        raise AssertionError(f"{preset}: kernel launches {launches}, "
                             f"expected {want}; texel decodes (asked, "
                             f"served) {decodes}")
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
        f"plain {plain} | texel decodes {decodes[1]} of {decodes[0]} | "
        f"frame 1 vs plain warp on the card: max {worst} LSB, {share:.5%} "
        f"> 1 LSB{extra}")
    return {"launches": launches, "wall_s": wall_s}


# the kernels of each launch counter by function name, as they appear in
# a trace's names (mangled, in an anonymous namespace, or demangled)
TRACE_FAMILIES = {"planarize": ("planarize_regs", "planarize_scalar",
                                "texelize_regs", "texelize_scalar"),
                  "warp": ("warp_equirect_kernel",),
                  "remap": ("remap_kernel",)}


def _trace_family(name: str) -> str:
    """The launch counter a kernel event of the trace counts under."""
    for family, functions in TRACE_FAMILIES.items():
        if any(fn in name for fn in functions):
            return family
    return "other"


def phase_trace(dev, src_dir: pathlib.Path, tmp) -> dict:
    """[trace]: perspcut --preset default on the 2 8K frames with
    GS360X_TRACE_DIR set, between two runs without it (which must write
    no trace): the trace under <dir>/run_plan/ holds exactly the
    planarize and warp_equirect launches the counters count, and gives
    the device's busy share of run_plan's window."""
    trace_dir = tmp / "trace"
    runs = {}

    def written() -> list:
        return sorted(trace_dir.rglob("*")) if trace_dir.exists() else []
    try:
        for key in ("plain", "traced", "plain again"):
            if key == "traced":
                os.environ["GS360X_TRACE_DIR"] = str(trace_dir)
            else:
                os.environ.pop("GS360X_TRACE_DIR", None)
            before = written()
            _reset_counters()
            t0 = time.perf_counter()
            rc = perspcut.main([
                "-i", str(src_dir), "-o", str(tmp / f"trace_{key[:5]}"),
                "--preset", "default", "--size", "1600", "--ext", "png",
                "--device", dev.type])
            torch.cuda.synchronize()
            runs[key] = (time.perf_counter() - t0, _counters()[0])
            if rc != 0:
                raise AssertionError(f"[trace] perspcut ({key}) exited {rc}")
            if key != "traced" and written() != before:
                raise AssertionError(f"[trace] a run without "
                                     f"GS360X_TRACE_DIR wrote under "
                                     f"{trace_dir}")
        # the profiler's own start, stop and write, with nothing traced:
        # after the traced run, so that run pays the first session's set-up
        os.environ["GS360X_TRACE_DIR"] = str(tmp / "trace_empty")
        t0 = time.perf_counter()
        with maybe_trace("empty"):
            pass
        empty_s = time.perf_counter() - t0
    finally:
        os.environ.pop("GS360X_TRACE_DIR", None)
    if sorted(p.name for p in trace_dir.iterdir()) != ["run_plan"]:
        raise AssertionError(f"[trace] {sorted(trace_dir.iterdir())}")
    got = read_trace(trace_dir, "run_plan")
    trace_mb = sum(f.stat().st_size for f in trace_dir.rglob("*.json")) / 1e6
    launches = runs["traced"][1]
    counted = {}
    for name, _ts, _dur in got["kernels"]:
        family = _trace_family(name)
        counted[family] = counted.get(family, 0) + 1
    want = {k: launches[k] for k in ("planarize", "warp", "remap")}
    if {k: counted.get(k, 0) for k in want} != want or not want["warp"]:
        raise AssertionError(f"[trace] kernels in the trace {counted}, "
                             f"launches {launches}")
    busy = got["busy_us"] / got["window_us"]
    log(f"[trace] perspcut --preset default, {E2E_FRAMES} 8K frames, "
        f"GS360X_TRACE_DIR set: {trace_dir.name}/run_plan/ holds "
        f"{len(got['kernels'])} kernel events ({counted}), the launch "
        f"counters {launches} | run_plan window {got['window_us'] / 1e3:.3f}"
        f" ms, kernels busy {got['busy_us'] / 1e3:.3f} ms = {busy:.4%} "
        f"(idle {1 - busy:.4%}) | wall without / with / without the trace "
        f"{runs['plain'][0]:.3f} / {runs['traced'][0]:.3f} / "
        f"{runs['plain again'][0]:.3f} s, of the traced wall "
        f"{runs['traced'][0] - got['window_us'] / 1e6:.3f} s outside the "
        f"window (the profiler's start and the trace's write, "
        f"{trace_mb:.2f} MB of JSON); an empty trace later {empty_s:.3f} s "
        "| the runs without it wrote no trace")
    return {"launches": launches, "busy": busy}


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

    _reset_counters()
    decodes = imagelib.texel_decode_counts()
    t0 = time.perf_counter()
    rc = dualfisheye.main([
        "--input-dir", str(in_dir), "--output-dir", str(out_dir),
        "--save-fisheye-output", "--perspective-ext", ".png",
        "--mask-input-dir", str(mask_dir), "--report-json",
        str(tmp / "report.json"), "--device", dev.type, "--stats"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, plain = _counters()
    decodes = _texel_decodes(decodes)
    report = json.loads((tmp / "report.json").read_text())
    if rc != 0 or report["failed"] != 0 or report["processed"] != 2:
        raise AssertionError(f"dualfisheye exited {rc}, report {report}")
    # per pair: each lens decodes to Pillow's RGBX block, the remaps'
    # texels (no planarize); 2 undistorts + 2 lens view groups, + 2 mask
    # groups for the pair with masks
    want = _launches(remap=10)
    if launches != want or decodes != (4, 4):
        raise AssertionError(f"dualfisheye launches {launches}, expected "
                             f"{want}; texel decodes (asked, served) "
                             f"{decodes}")
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
        f" plain {plain} | texel decodes {decodes[1]} of {decodes[0]} | "
        f"pair 1 vs plain remap on the card: max {worst} LSB, masks equal")
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
        _reset_counters()
        t0 = time.perf_counter()
        rc = video2frames.main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, plain = _counters()
        if rc != 0:
            raise AssertionError(f"video2frames {label} exited {rc}")
        n = int(V2F_FRAMES / V2F_FPS * V2F_RATE)
        want = _launches(planarize=n,
                         remap=n if label == "fisheye" else 0)
        if launches != want:
            raise AssertionError(f"video2frames {label}: launches "
                                 f"{launches}, expected {want}")
        # the colour move stands between the kernels and the quantize here:
        # one plain quantize a frame, and no plain version of a kernel
        if plain.pop("quantize") != n or any(plain.values()):
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


def _batch_vs_frames(label: str, batch_fn, frame_fn, n: int) -> tuple:
    """``batch_fn()`` against ``frame_fn(f)`` for each of the ``n`` frames:
    bitwise, with the launches of each side (batch, per-frame routes)."""
    _reset_counters()
    got = batch_fn()
    torch.cuda.synchronize()
    batch_launches = _counters()[0]
    _reset_counters()
    for f in range(n):
        one = frame_fn(f)
        torch.cuda.synchronize()
        if not torch.equal(got[f], one):
            raise AssertionError(f"[mesh] {label}: frame {f} of the batch is "
                                 "not the per-frame route's")
        del one
    frame_launches = _counters()[0]
    return got, batch_launches, frame_launches


def _mesh_batched_u8(rows: torch.Tensor, src_f32: list, geom: dict,
                     label: str) -> dict:
    """(a): the 4-frame u8 batch through one source pass and one warp
    launch (u8 store) against the 4 per-frame routes, frame 0's views
    within the warp's gates of the plain version, the f32 store of every
    frame against it, device ms, the bound and the plain version's ms."""
    n = rows.shape[0]
    zeros = [0.0] * len(RING)
    ring = (RING, zeros, zeros)
    kw = dict(interp="bicubic", planar=True, **geom)
    u8 = torch.uint8
    got, b_launch, f_launch = _batch_vs_frames(
        f"{label} u8 store",
        lambda: warp_cuda.warp_equirect_to_views_cuda(rows, *ring,
                                                      out_dtype=u8, **kw),
        lambda f: warp_cuda.warp_equirect_to_views_cuda(rows[f], *ring,
                                                        out_dtype=u8, **kw),
        n)
    if b_launch != _launches(planarize=1, warp=1) \
            or f_launch != _launches(planarize=n, warp=n):
        raise AssertionError(f"[mesh] {label}: launches {b_launch} a batch, "
                             f"{f_launch} per frame")
    plain_kw = dict(interp="bicubic", **geom)
    err, worst, share = 0.0, 0, 0.0
    f32 = warp_cuda.warp_equirect_to_views_cuda(rows, *ring, **kw)
    for f in range(n):
        ref = twin.warp_equirect_to_views(src_f32[f], *ring,
                                          **plain_kw).permute(0, 3, 1, 2)
        err = max(err, float((f32[f] - ref).abs().max()))
        if f == 0:
            lsb = (got[0].to(torch.int32) - quantize(ref)).abs()
            worst, share = int(lsb.max()), float((lsb > 0).float().mean())
        del ref
    del f32
    if err > F32_TOL or worst > 1 or share > LSB_SHARE_TOL:
        raise AssertionError(f"[mesh] {label}: f32 {err:.3e} from the plain "
                             f"version, frame 0 u8 {worst} LSB on {share:.4%}")
    texels = warp_cuda.texelize_rows(rows.reshape(-1, rows.shape[2])).view(
        n, rows.shape[1], -1, 4)
    singles = [warp_cuda.texelize_rows(r) for r in rows]
    ms = cuda_ms(lambda: warp_cuda.warp_texels(texels, *ring, out_dtype=u8,
                                               **plain_kw))
    frames_ms = cuda_ms(lambda: [warp_cuda.warp_texels(
        t, *ring, out_dtype=u8, **plain_kw) for t in singles])
    route_ms = cuda_ms(lambda: warp_cuda.warp_equirect_to_views_cuda(
        rows, *ring, out_dtype=u8, **kw))
    frame_route_ms = cuda_ms(lambda: [warp_cuda.warp_equirect_to_views_cuda(
        r, *ring, out_dtype=u8, **kw) for r in rows])
    plain_ms = cuda_ms(lambda: [twin.warp_equirect_to_views(
        s, *ring, **plain_kw) for s in src_f32], **PLAIN_TIMING)
    one = _warp_bound(*_ring_uv(geom, rows.device))
    bound = {"bound_ms": n * one["bound_ms"], "bound_by": one["bound_by"],
             "library_ms": None}
    del texels, singles
    log(f"[mesh] (a) {label}, {n} 8K u8 frames, bicubic, u8 store: batch "
        f"bitwise the {n} per-frame routes | launches {b_launch['planarize']}"
        f" planarize + {b_launch['warp']} warp a batch, {f_launch['planarize']}"
        f" + {f_launch['warp']} per frame | f32 store {err:.3e} from the "
        f"plain version, frame 0 u8 {worst} LSB on {share:.5%} | device ms: "
        f"batched warp {ms:.4f} against {n} launches {frames_ms:.4f}; "
        f"source pass + warp {route_ms:.4f} against {frame_route_ms:.4f} | "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, {n} x "
        f"{one['bound_ms']:.4f}), {bound['bound_ms'] / ms:.1%} of it | plain "
        f"{plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "frames_ms": frames_ms, "route_ms": route_ms,
            "frame_route_ms": frame_route_ms, **bound}


def _mesh_u16_and_colour(rows: torch.Tensor, mesh) -> None:
    """(b): a u16 batch (f32 and u16 stores) and the video colour route
    (f32 store, colour move, plain quantize) of u8 and u16 batches, each
    bitwise its per-frame route."""
    n = rows.shape[0]
    zeros = [0.0] * len(RING)
    ring = (RING, zeros, zeros)
    kw = dict(interp="bicubic", planar=True, **HEADLINE)
    # 10-bit-like content: the 8-bit frame in the high bits, a ramp below
    ramp = torch.arange(rows.shape[2], device=rows.device) % 256
    rows16 = (rows.to(torch.int32) * 256 + ramp).to(torch.uint16)
    del ramp
    for out_dtype in (None, torch.uint16):
        got, b_launch, f_launch = _batch_vs_frames(
            f"u16 batch, {out_dtype or torch.float32} store",
            lambda: warp_cuda.warp_equirect_to_views_cuda(
                rows16, *ring, out_dtype=out_dtype, **kw),
            lambda f: warp_cuda.warp_equirect_to_views_cuda(
                rows16[f], *ring, out_dtype=out_dtype, **kw), n)
        if out_dtype is None:
            src = rows16[0].reshape(SRC_H, SRC_W, 3).to(torch.float32) \
                / 65535.0
            ref = twin.warp_equirect_to_views(
                src, *ring, interp="bicubic", **HEADLINE).permute(0, 3, 1, 2)
            err = float((got[0] - ref).abs().max())
            del src, ref
            if err > F32_TOL:
                raise AssertionError(f"[mesh] u16 batch: f32 {err:.3e} from "
                                     "the plain version")
            f32 = got
        elif not torch.equal(got, warp_cuda.quantize_plain(f32, out_dtype)):
            raise AssertionError("[mesh] u16 batch: the u16 store is not the "
                                 "plain quantize of the f32 store")
        del got
    del f32
    if b_launch != _launches(planarize=1, warp=1):
        raise AssertionError(f"[mesh] u16 batch: launches {b_launch}")
    times = {}
    for label, src, bits in (("u8", rows, 8), ("u16", rows16, 16)):
        route = dict(keep_rec709=False, quantize_bits=bits, interp="bicubic",
                     **HEADLINE)

        def batch(src=src, route=route):
            return meshlib.warp_frames_sharded_cuda(mesh, src, *ring,
                                                    **route)[0]

        def frame(f, src=src, route=route):
            return meshlib.warp_frames_sharded_cuda(mesh, src[f:f + 1],
                                                    *ring, **route)[0][0]

        _got, c_launch, _ = _batch_vs_frames(f"{label} colour route", batch,
                                             frame, n)
        del _got
        if c_launch != _launches(planarize=1, warp=1):
            raise AssertionError(f"[mesh] {label} colour route: launches "
                                 f"{c_launch} a batch")
        plain = _counters()[1]
        times[label] = (cuda_ms(batch, reps=3, batches=3),
                        cuda_ms(lambda: [frame(f) for f in range(n)],
                                reps=3, batches=3))
        log(f"[mesh] (b) {label} batch, colour route (f32 store -> "
            f"Rec.709 -> SMPTE-170M + sRGB -> {bits}-bit quantize): bitwise "
            f"the per-frame route | launches {c_launch} a batch, plain "
            f"{plain} for the {n} frames | device ms {times[label][0]:.4f} "
            f"a batch against {times[label][1]:.4f} per frame")
    log(f"[mesh] (b) u16 batch, f32 and u16 stores: bitwise the per-frame "
        f"launches, f32 {err:.3e} from the plain version, u16 store the "
        f"plain quantize of the f32 store | launches {b_launch} a batch, "
        f"{f_launch} per frame")
    del rows16


def _mesh_e2e(dev, tmp) -> dict:
    """(c): perspcut video mode at --preset default on a 6-frame 8K 4:2:0
    Y4M, batched (4 frames a launch: one full batch, a 2-frame tail) and
    per frame, in turns (batched, per-frame, per-frame, batched), every
    run's files byte-equal to the first's."""
    clip = tmp / "mesh8k.y4m"
    t0 = time.perf_counter()
    write_y4m_420(clip, [lonlat_frame(SRC_H, SRC_W, 0.3 * k, dev)
                         for k in range(MESH_FRAMES)], MESH_FRAMES)
    setup_s = time.perf_counter() - t0
    per_launch = {"batched": MESH_BATCH, "per-frame": 1}
    runs = {"batched": [], "per-frame": []}
    out_dirs = []
    for turn, label in enumerate(("batched", "per-frame", "per-frame",
                                  "batched")):
        out_dirs.append(tmp / f"mesh_{turn}_{label}")
        args = ["-i", str(clip), "-o", str(out_dirs[-1]), "--preset",
                "default", "--size", str(MAIN["width"]), "-f",
                str(MESH_FRAMES), "--ext", "png", "--device", dev.type,
                "--stats"]
        saved = executor.CARD_FRAMES_PER_LAUNCH
        executor.CARD_FRAMES_PER_LAUNCH = per_launch[label]
        try:
            _reset_counters()
            t0 = time.perf_counter()
            rc, lines = _quiet(perspcut.main, args)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            executor.CARD_FRAMES_PER_LAUNCH = saved
        launches, plain = _counters()
        if rc != 0:
            raise AssertionError(f"[mesh] perspcut video {label} exited {rc}:"
                                 f" {lines[-3:]}")
        n_batches = -(-MESH_FRAMES // per_launch[label])
        want = _launches(planarize=n_batches, warp=n_batches)
        # the colour move stands between the warp and the quantize: one
        # plain quantize a (group, batch); default has one view group
        if launches != want or plain.pop("quantize") != n_batches \
                or any(plain.values()):
            raise AssertionError(f"[mesh] perspcut video {label}: launches "
                                 f"{launches} (expected {want}), plain "
                                 f"{plain}")
        stats = next((line for line in lines if line.startswith("[STATS]")),
                     "")
        runs[label].append({"launches": launches, "wall_s": wall_s,
                            "stats": stats})
        log(f"[mesh] (c) perspcut video --preset default, {MESH_FRAMES} 8K "
            f"frames, turn {turn + 1} {label}: wall {wall_s:.3f}s | launches "
            f"{launches} | {stats}")
    names = sorted(p.name for p in out_dirs[0].iterdir())
    if len(names) != MESH_FRAMES * len(RING):
        raise AssertionError(f"[mesh] perspcut video: {len(names)} outputs")
    for out_dir in out_dirs[1:]:
        differ = [name for name in names
                  if (out_dirs[0] / name).read_bytes()
                  != (out_dir / name).read_bytes()]
        if differ or sorted(p.name for p in out_dir.iterdir()) != names:
            raise AssertionError(f"[mesh] {out_dir.name}'s files differ "
                                 f"from {out_dirs[0].name}'s: {differ[:4]}")
    # frame 0's views against the plain chain on the card
    _idx, _t, rgb = next(iter(videolib.iter_frames(clip, fps=MESH_FRAMES)))
    src = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
    zeros = [0.0] * len(RING)
    ref = quantize(colorlib.video_color_move_planar(
        warp_cuda.warp_equirect_to_views_plain(
            src, RING, zeros, zeros, interp="bicubic", planar=True, **MAIN)))
    # the colour move's slope (up to 12.92 near black) turns the warp's
    # ~1e-6 f32 residue into rounding flips on more pixels than the bare
    # warp's 0.1%: <= 1 LSB, on <= ORACLE_SHARE of pixels
    worst, share = 0, 0.0
    for k, v in enumerate("ABCDEFGH"):
        img = torch.from_numpy(read_png(
            out_dirs[0] / f"mesh8k_{0:07d}_{v}.png").astype(np.int32))
        diff = (img.to(dev) - ref[k].permute(1, 2, 0)).abs()
        worst = max(worst, int(diff.max()))
        share = max(share, float((diff > 0).any(dim=-1).float().mean()))
    if worst > 1 or share > ORACLE_SHARE:
        raise AssertionError(f"[mesh] frame 0: {worst} LSB from the plain "
                             f"chain, {share:.4%} of pixels differ")
    walls = {label: statistics.mean(r["wall_s"] for r in turns)
             for label, turns in runs.items()}
    log(f"[mesh] (c) {len(names)} files byte-equal over the 4 runs | mean "
        f"wall batched {walls['batched']:.3f}s, per-frame "
        f"{walls['per-frame']:.3f}s | frame 0 vs plain chain on the card: "
        f"max {worst} LSB, {share:.5%} of pixels differ | set-up (Y4M "
        f"write) {setup_s:.2f}s")
    return runs


def phase_mesh(dev, tmp) -> dict:
    """[mesh]: the batched video path (runtime/mesh.py and the executor's
    batches): (a) one warp launch for 4 8K frames × the view set, bitwise
    the per-frame launches; (b) u16 batches and the colour route; (c)
    perspcut's video mode batched against per-frame; (d) the batch stats,
    card against CPU."""
    t_phase = time.perf_counter()
    mesh = meshlib.data_mesh()
    shifts = [0.4 * f for f in range(MESH_BATCH)]
    rows = torch.stack([lonlat_frame(SRC_H, SRC_W, s, dev).reshape(
        SRC_H, SRC_W * 3) for s in shifts])
    src_f32 = [r.reshape(SRC_H, SRC_W, 3).to(torch.float32) / 255.0
               for r in rows]
    out = {"ring": _mesh_batched_u8(rows, src_f32, HEADLINE,
                                    "yaw ring 8x1920x1080")}
    _mesh_batched_u8(rows, src_f32, MAIN, "default 8x1600x1600")
    del src_f32
    _mesh_u16_and_colour(rows, mesh)
    out["e2e"] = _mesh_e2e(dev, tmp)
    frames = rows.reshape(MESH_BATCH, SRC_H, SRC_W, 3).to(torch.float32) \
        / 255.0
    del rows
    got = meshlib.sharded_batch_stats(mesh, frames)
    ref = meshlib.sharded_batch_stats(meshlib.data_mesh([torch.device("cpu")]),
                                      frames.cpu())
    rel = max(abs(float(g) - float(r)) / abs(float(r))
              for g, r in zip(got, ref))
    if rel > SCORE_RTOL:
        raise AssertionError(f"[mesh] batch stats: card {got}, CPU {ref}")
    log(f"[mesh] (d) sharded_batch_stats over {mesh.size} card(s): mean luma "
        f"{float(got[0]):.6f}, mean tenengrad {float(got[1]):.4f}, "
        f"{rel:.2e} from the CPU | phase wall "
        f"{time.perf_counter() - t_phase:.1f}s")
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
    _reset_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = frameselector.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, plain = _counters()
    if rc != 0:
        raise AssertionError(f"frameselector {label} exited {rc}: "
                             f"{buf.getvalue()[-2000:]}")
    want = _launches(planarize=want_planarize)
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
    """gs360x-torch-frameselector on 6 8K frames (one sharp frame per
    segment of 3, the rest box-blurred with growing radius, the scene
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
    _reset_counters()
    decodes = imagelib.texel_decode_counts()
    t0 = time.perf_counter()
    rc = dualfisheye.main([
        "--input-dir", str(dfe["in_dir"]), "--output-dir", str(out_dir),
        "--save-fisheye-output", "--perspective-ext", ".png",
        "--mask-input-dir", str(dfe["mask_dir"]), "--input-lut", str(cube),
        "--lut-output-color-space", "srgb", "--report-json",
        str(tmp / "report_lut.json"), "--device", dev.type, "--stats"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, plain = _counters()
    decodes = _texel_decodes(decodes)
    report = json.loads((tmp / "report_lut.json").read_text())
    if rc != 0 or report["failed"] != 0 or report["processed"] != 2:
        raise AssertionError(f"dualfisheye --input-lut exited {rc}, "
                             f"report {report}")
    # the LUT reads the packed decode: a lens planarize each, no texels
    want = _launches(planarize=4, remap=10)
    if launches != want or decodes != (0, 0):
        raise AssertionError(f"dualfisheye --input-lut launches {launches}, "
                             f"expected {want}; texel decodes (asked, "
                             f"served) {decodes}")
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


def _spherical_xml(path: pathlib.Path, labels) -> None:
    """A Metashape alignment XML of one camera a label, each at its own
    position and heading (4x4 camera-to-world transforms)."""
    cams = []
    for k, label in enumerate(labels):
        c, s_ = math.cos(0.4 * k), math.sin(0.4 * k)
        mat = [c, 0.0, s_, 1.5 * k, 0.0, 1.0, 0.0, 0.25 * k,
               -s_, 0.0, c, -0.5 * k, 0.0, 0.0, 0.0, 1.0]
        cams.append(f'   <camera id="{k}" label="{label}" sensor_id="0">\n'
                    f'    <transform>{" ".join(repr(v) for v in mat)}'
                    f'</transform>\n   </camera>')
    path.write_text(
        "<?xml version='1.0'?>\n<document version=\"1.2.0\">\n"
        " <chunk label=\"smoke\" enabled=\"true\">\n"
        "  <sensors next_id=\"1\"><sensor id=\"0\" type=\"spherical\"/>"
        "</sensors>\n"
        f"  <cameras next_id=\"{len(cams)}\">\n" + "\n".join(cams)
        + "\n  </cameras>\n </chunk>\n</document>\n")


def phase_ms360xml(dev, src_dir: pathlib.Path, frames: dict, tmp) -> dict:
    """gs360x-torch-ms360xml --persp-cut on a spherical XML of the 8K
    frames, at the tool's defaults (preset full360coverage, 1600 px JPEG
    views, the card): the perspective XML, the cut's launches, its files
    against the plain twin; then --format all --points-ply (host only)."""
    xml = tmp / "cameras_360.xml"
    _spherical_xml(xml, sorted(frames))
    out_dir, cut_dir = tmp / "ms_out", tmp / "ms_cut"
    preset = "full360coverage"
    stem = sorted(frames)[0]
    # the cut's own plan: 12 views of 1600 px, written as JPEG
    plan, groups = _preset_plan(preset, None, [src_dir / f"{stem}.png"],
                                cut_dir, ext="jpg")

    _reset_counters()
    decodes = imagelib.texel_decode_counts()
    t0 = time.perf_counter()
    rc = ms360xml.main([str(xml), "--format", "metashape", "--persp-cut",
                        "--cut-input", str(src_dir), "--cut-out",
                        str(cut_dir), "-o", str(out_dir)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, plain = _counters()
    decodes = _texel_decodes(decodes)
    if rc != 0:
        raise AssertionError(f"ms360xml --persp-cut exited {rc}")
    n_views = len(plan.jobs)
    # the cut's frames decode to RGBX texels: no planarize
    want = _launches(warp=E2E_FRAMES * len(groups))
    if launches != want or decodes != (E2E_FRAMES, E2E_FRAMES):
        raise AssertionError(f"ms360xml: kernel launches {launches}, "
                             f"expected {want}; texel decodes (asked, "
                             f"served) {decodes}")
    if any(plain.values()):
        raise AssertionError(f"ms360xml: plain versions ran on the main "
                             f"path: {plain}")
    records, width, height = msxml.read_perspective_xml(
        out_dir / "perspective_cams.xml")
    if len(records) != E2E_FRAMES * n_views or (width, height) != (1600, 1600):
        raise AssertionError(f"ms360xml: {len(records)} cameras of "
                             f"{width}x{height} in the perspective XML")
    written = sorted(p.name for p in cut_dir.iterdir())
    labels = sorted(f"{r['name']}" for r in records)
    if len(written) != E2E_FRAMES * n_views or \
            [pathlib.Path(n).stem for n in written] != \
            [pathlib.Path(n).stem for n in labels]:
        raise AssertionError(f"ms360xml: the cut wrote {len(written)} files "
                             f"({written[:3]}...), the XML names "
                             f"{labels[:3]}...")

    # frame 1's files against the JPEG of the plain twin's views
    rows = torch.from_numpy(frames[stem][1].reshape(SRC_H, SRC_W * 3)).to(dev)
    worst, share = 0, 0.0
    for (projection, w, h, hfov, vfov), idxs in groups:
        ref = quantize(warp_cuda.warp_equirect_to_views_plain(
            rows, *_angles(plan, idxs), width=w, height=h, hfov_deg=hfov,
            vfov_deg=vfov, projection=projection, interp="bicubic",
            planar=True)).permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()
        for j, i in enumerate(idxs):
            name = plan.jobs[i].output_name
            ref_path = tmp / f"ms_ref_{name}"
            imagelib.write_image(ref_path, ref[j])
            diff = np.abs(imagelib.read_image(cut_dir / name).astype(np.int32)
                          - imagelib.read_image(ref_path).astype(np.int32))
            if diff.shape != (h, w, 3):
                raise AssertionError(f"{name}: shape {diff.shape}")
            worst = max(worst, int(diff.max()))
            share = max(share, float((diff > 1).mean()))
    if worst > JPEG_MAX_LSB or share > ORACLE_SHARE:
        raise AssertionError(f"ms360xml cut: {worst} LSB from the JPEG of "
                             f"the plain warp, {share:.4%} of pixels > 1 LSB")

    # the host-only exports, with a small point cloud
    rng = np.random.default_rng(12)
    ply = tmp / "points.ply"
    plyio.save_ply_xyz_rgb(ply, rng.normal(size=(2000, 3)).astype(np.float32),
                           rng.integers(0, 256, (2000, 3), dtype=np.uint8))
    all_dir = tmp / "ms_all"
    _reset_counters()
    t0 = time.perf_counter()
    rc = ms360xml.main([str(xml), "--format", "all", "--points-ply", str(ply),
                        "--pc-rotate-x-plus180", "-o", str(all_dir)])
    all_s = time.perf_counter() - t0
    if rc != 0 or any(_counters()[0].values()):
        raise AssertionError(f"ms360xml --format all exited {rc}, launches "
                             f"{_counters()[0]}")
    model = colmap_text.read_model(all_dir / "sparse" / "0")
    xmps = list((all_dir / "cameras_RealityScan").glob("*.xmp"))
    tf = json.loads((all_dir / "transforms.json").read_text())
    xyz, _rgb = plyio.load_ply_xyz_rgb(
        all_dir / "pointcloud_for_transforms.ply")
    n_cams = E2E_FRAMES * n_views
    if (len(model.images), len(model.points), len(xmps), len(tf["frames"]),
            xyz.shape) != (n_cams, 2000, n_cams, n_cams, (2000, 3)) \
            or not (all_dir / "perspective_cams.xml").is_file():
        raise AssertionError("ms360xml --format all: outputs incomplete")
    log(f"[ms360xml] --persp-cut, preset {preset}, {E2E_FRAMES} 8K frames: "
        f"{len(records)} cameras in the perspective XML, {len(written)} JPEG "
        f"views of {width}x{height}, wall {wall_s:.3f}s | launches {launches}"
        f" plain {plain} | frame 1 vs the JPEG of the plain warp: max "
        f"{worst} LSB, {share:.5%} of pixels > 1 LSB | --format all "
        f"--points-ply: transforms.json, sparse/0 ({len(model.images)} images"
        f", {len(model.points)} points), {len(xmps)} XMP, rotated PLY in "
        f"{all_s:.2f}s, no launch")
    return {"launches": launches, "wall_s": wall_s}


def _metadata_files(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix in (".xml", ".txt")}


def phase_dualfisheye_xml(dev, tmp, dfe: dict) -> dict:
    """The dualfisheye phase's run again with --camera-extrinsics-xml: the
    same launches and byte-equal pixel files, plus the perspective
    Metashape XML and sparse/0; then --metadata-only: the same metadata,
    no launch."""
    names = sorted(dfe["images"])
    xml = tmp / "rig_extrinsics.xml"
    _spherical_xml(xml, [pathlib.Path(n).stem for n in names])
    out_dir, meta_dir = tmp / "dfe_xml", tmp / "dfe_meta"
    common = ["--perspective-ext", ".png", "--camera-extrinsics-xml",
              str(xml)]
    _reset_counters()
    t0 = time.perf_counter()
    rc = dualfisheye.main([
        "--input-dir", str(dfe["in_dir"]), "--output-dir", str(out_dir),
        "--save-fisheye-output", "--mask-input-dir", str(dfe["mask_dir"]),
        "--report-json", str(tmp / "report_xml.json"), "--stats"] + common)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, plain = _counters()
    report = json.loads((tmp / "report_xml.json").read_text())
    if rc != 0 or report["failed"] != 0 or report["processed"] != 2:
        raise AssertionError(f"dualfisheye --camera-extrinsics-xml exited "
                             f"{rc}, report {report}")
    want = dfe["launches"]
    if launches != want:
        raise AssertionError(f"dualfisheye --camera-extrinsics-xml launches "
                             f"{launches}, expected {want}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    pngs = sorted(p.relative_to(dfe["out_dir"])
                  for p in dfe["out_dir"].rglob("*.png"))
    if len(pngs) != 34 or any(
            (out_dir / rel).read_bytes() != (dfe["out_dir"] / rel).read_bytes()
            for rel in pngs):
        raise AssertionError("dualfisheye --camera-extrinsics-xml: pixel "
                             "files differ from the run without the flag")
    meta = _metadata_files(out_dir)
    persp = out_dir / "perspective"
    model = colmap_text.read_model(persp / "sparse" / "0")
    records, width, _h = msxml.read_perspective_xml(
        persp / "perspective_cams.xml")
    n_pairs = len(names) // 2
    if sorted(meta) != sorted(f"perspective/{n}" for n in (
            "perspective_cams.xml", "sparse/0/cameras.txt",
            "sparse/0/images.txt", "sparse/0/points3D.txt")) \
            or len(model.images) != 10 * n_pairs \
            or len(records) != 10 * n_pairs or width != SFM10_SIZE:
        raise AssertionError(f"dualfisheye pose export: files {sorted(meta)},"
                             f" {len(model.images)} images")

    _reset_counters()
    t0 = time.perf_counter()
    rc = dualfisheye.main(["--metadata-only", "--output-dir", str(meta_dir)]
                          + common)
    meta_s = time.perf_counter() - t0
    meta_launches, meta_plain = _counters()
    if rc != 0 or any(meta_launches.values()) or any(meta_plain.values()):
        raise AssertionError(f"dualfisheye --metadata-only exited {rc}, "
                             f"launches {meta_launches}, plain {meta_plain}")
    only = _metadata_files(meta_dir)
    if {f"perspective/{k}": v for k, v in only.items()} != meta:
        raise AssertionError("dualfisheye --metadata-only: metadata differs "
                             "from the pixel run's")
    log(f"[dualfisheye-xml] 2 pairs {FISH}² with --camera-extrinsics-xml: "
        f"wall {wall_s:.3f}s | launches {launches} plain {plain} | "
        f"{len(pngs)} pixel files byte-equal to the run without the flag | "
        f"perspective XML + sparse/0: {len(model.images)} cameras of "
        f"{width} px | --metadata-only: the same {len(only)} files in "
        f"{meta_s:.2f}s, launches {meta_launches}")
    return {"launches": launches, "wall_s": wall_s}


def _ms_scene(h: int, w: int, seed: int) -> np.ndarray:
    """A photo-style synthseg scene as u8 (h, w, 3): drawn square at the
    long side and cropped to the middle rows; the 8K frame is the middle
    960 rows of a 1920² scene, each pixel repeated 4×4."""
    rng = np.random.default_rng(seed)
    size = 1920 if h == SRC_H else w
    img, _ = synthseg.generate_scene(rng, size=size, photo_style=True)
    if h == SRC_H:
        img = np.repeat(np.repeat(img[480:1440], 4, 0), 4, 1)
    else:
        img = img[(size - h) // 2:(size - h) // 2 + h]
    return (img * 255).astype(np.uint8)


def _ms_inputs(tmp) -> tuple:
    """The [maskseg] views as PNG files and the manual add layers (a
    200-px band at the bottom centre)."""
    in_dir, manual = tmp / "ms_in", tmp / "ms_manual"
    in_dir.mkdir()
    manual.mkdir()
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        scenes = dict(zip(
            [vid for vid, _h, _w in MS_VIEWS],
            pool.map(lambda v: _ms_scene(v[1], v[2], 100 + ord(v[0])),
                     MS_VIEWS)))
        writes = []
        for k, (vid, h, w) in enumerate(MS_VIEWS):
            path = in_dir / f"scene_{k:04d}_{vid}.png"
            writes.append(pool.submit(
                Image.fromarray(scenes[vid]).save, path, compress_level=1))
            if vid in MS_LAYERS:
                layer = np.zeros((h, w), np.uint8)
                layer[h - 120:, w // 2 - 100:w // 2 + 100] = 255
                Image.fromarray(layer).save(manual / f"view__{vid}__add.png")
        for write in writes:
            write.result()
    files = {vid: in_dir / f"scene_{k:04d}_{vid}.png"
             for k, (vid, _h, _w) in enumerate(MS_VIEWS)}
    return in_dir, manual, files, scenes


def _ms_run(in_dir, manual, out_dir, mode: str, device: str) -> tuple:
    """One maskseg CLI run with the stage timers; counters set to 0 just
    before it and read just after."""
    timers = StageTimers()
    _reset_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = maskseg.main(["-i", str(in_dir), "-o", str(out_dir), "--mode",
                           mode, "--manual-mask-dir", str(manual),
                           "--device", device], timers=timers)
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, plain = _counters()
    lines = buf.getvalue().splitlines()
    if rc != 0 or len(list(out_dir.iterdir())) != len(MS_VIEWS):
        raise AssertionError(f"maskseg --mode {mode} --device {device} "
                             f"exited {rc}: {lines[-3:]}")
    # MaskSeg runs no hand-written kernel: library convs and torch ops only
    if any(launches.values()) or any(plain.values()):
        raise AssertionError(f"maskseg --mode {mode}: launches {launches}, "
                             f"plain {plain}")
    found = sum("(subject found)" in line for line in lines)
    return {"wall_s": wall_s, "timers": timers, "launches": launches,
            "found": found}


def _ms_capability(predictor) -> str:
    """The four gates of tests/test_synthseg.py through the port's model
    on ``predictor``'s device."""
    def logits(images):
        x = torch.from_numpy(np.ascontiguousarray(images)).permute(
            0, 3, 1, 2).to(predictor.device)
        return predictor.logits(x).cpu().numpy()

    got = checks.capability(logits)
    gates = {"heldout": 0.78, "photo": 0.70, "transfer": 0.68,
             "AP@0.5": 0.65}
    if got["n_gt"] < 20 or any(got[k] < gate for k, gate in gates.items()):
        raise AssertionError(f"capability on the card: {got} (gates {gates})")
    return ", ".join(f"{k} {got[k]:.3f} (>= {gate})"
                     for k, gate in gates.items())


def phase_maskseg(dev, tmp, smi: str) -> dict:
    """gs360x-torch-maskseg on 4 views of 1600², 2 of 1920×1080 and one 8K
    frame (photo-style synthseg scenes, add layers on B and F), every
    output mode on the card with the stage timers; the mask mode again
    with --device cpu, its masks against the card's; the other modes'
    files against write_output on the CPU from the card's masks (the
    inpaint on the 1920×1080 views); the U-Net's logits and the person
    probabilities card against CPU with TF32 off; the morphology bitwise
    and the inpaint; the four capability gates on the card; device ms of
    each step."""
    t0 = time.perf_counter()
    in_dir, manual, files, scenes = _ms_inputs(tmp)
    setup_s = time.perf_counter() - t0

    runs = {mode: _ms_run(in_dir, manual, tmp / f"ms_{mode}", mode,
                          dev.type) for mode in MS_MODES}
    cpu_run = _ms_run(in_dir, manual, tmp / "ms_mask_cpu", "mask", "cpu")
    if runs["mask"]["found"] != cpu_run["found"]:
        raise AssertionError(f"maskseg: subjects found in "
                             f"{runs['mask']['found']} files on the card, "
                             f"{cpu_run['found']} on the CPU")

    state = synthseg.load_packaged_weights()
    card = seg.SegmentationPredictor(state, device=dev)
    cpu = seg.SegmentationPredictor(state, device=torch.device("cpu"))
    person = [seg.CLASS_TO_INDEX["person"]]

    # masks, card against CPU; then every mode's files against the CPU's
    # write_output of the card's mask
    worst_share, flipped, band_total, masks = 0.0, 0, 0, {}
    for vid, path in files.items():
        got = read_png(tmp / "ms_mask" / path.name)
        ref = read_png(tmp / "ms_mask_cpu" / path.name)
        diff = int((got != ref).sum())
        if diff:
            rgb01 = scenes[vid].astype(np.float32) / 255.0
            p = cpu.probabilities(rgb01, person)[0].numpy()
            band = int((np.abs(p - seg.MASK_THRESH) < MASK_BAND).sum())
            band_total += band
            if band == 0:
                raise AssertionError(f"maskseg {path.name}: {diff} mask "
                                     "pixels differ, none near the threshold")
        share = diff / got.size
        worst_share, flipped = max(worst_share, share), flipped + diff
        if share > MASK_SHARE_TOL:
            raise AssertionError(f"maskseg {path.name}: {share:.4%} of the "
                                 "mask differs between card and CPU")
        masks[vid] = 255 - got
    worst_lsb, inpaint_checked = 0, 0
    for mode in MS_MODES[1:]:
        ref_dir = tmp / f"ms_ref_{mode}"
        for vid, path in files.items():
            mask = masks[vid] if masks[vid].any() else None
            got = read_png(next((tmp / f"ms_{mode}").glob(f"{path.stem}*")))
            if mode == "inpaint" and (mask is None or vid not in "EF"):
                keep = slice(None) if mask is None else mask == 0
                if not np.array_equal(got[keep], scenes[vid][keep]):
                    raise AssertionError(f"maskseg inpaint {path.name}: "
                                         "pixels outside the mask moved")
                continue
            ref = read_png(maskseg.write_output(
                mode, path, ref_dir, scenes[vid], mask,
                device=torch.device("cpu")))
            lsb = int(np.abs(got.astype(int) - ref.astype(int)).max())
            inpaint_checked += mode == "inpaint"
            if lsb > (1 if mode == "inpaint" else 0):
                raise AssertionError(f"maskseg {mode} {path.name}: {lsb} LSB "
                                     "from the CPU")
            worst_lsb = max(worst_lsb, lsb)
    if not inpaint_checked:
        raise AssertionError("maskseg: no 1920x1080 view had a mask to "
                             "inpaint")

    # the U-Net and the probabilities, card against CPU, and device ms of
    # each step at the three sizes
    errs, times = [], []
    for vid in "AEG":
        rgb01 = scenes[vid].astype(np.float32) / 255.0
        h, w = rgb01.shape[:2]
        size = seg.inference_size(h, w)
        x_cpu = seg.resize_linear(cpu.upload(rgb01), size)
        up = card.upload(rgb01)
        x = seg.resize_linear(up, size)
        in_err = float((x.cpu() - x_cpu).abs().max())
        lg_err = float((card.logits(x_cpu.to(dev)).cpu()
                        - cpu.logits(x_cpu)).abs().max())
        p_err = float((card.probabilities(rgb01, person).cpu()
                       - cpu.probabilities(rgb01, person)).abs().max())
        if lg_err > LOGIT_TOL or p_err > PROB_TOL:
            raise AssertionError(f"maskseg {h}x{w}: logits {lg_err:.3e}, "
                                 f"probabilities {p_err:.3e} card vs CPU")
        errs.append(f"{h}x{w} -> {size[0]}x{size[1]}: resize in "
                    f"{in_err:.2e}, logits {lg_err:.2e}, person p "
                    f"{p_err:.2e}")
        lg = card.logits(x)
        probs = torch.softmax(lg, dim=1)
        ms = [cuda_ms(lambda: seg.resize_linear(up, size)),
              cuda_ms(lambda: card.logits(x)),
              cuda_ms(lambda: torch.softmax(lg, dim=1)),
              cuda_ms(lambda: seg.resize_linear(probs[:, person], (h, w)))]
        times.append(f"{h}x{w}: " + " + ".join(f"{t:.4f}" for t in ms)
                     + f" = {sum(ms):.4f} ms")

    def cudnn_logits(model, x, tf32: bool):
        """The U-Net through cuDNN, the route f32_convs leaves out."""
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=tf32), torch.inference_mode():
            return model(x)

    unet = []
    for h, w in ((576, 1024), (640, 640)):
        x = torch.rand((1, 3, h, w), generator=torch.Generator(
            device=dev).manual_seed(h), device=dev)
        used = card.logits(x)
        moved = [float((cudnn_logits(card.model, x, tf32) - used).abs().max())
                 for tf32 in (False, True)]
        unet.append(
            f"{h}x{w} f32 (used) {cuda_ms(lambda: card.logits(x)):.4f} ms; "
            "cuDNN f32 "
            f"{cuda_ms(lambda: cudnn_logits(card.model, x, False)):.4f} ms "
            f"(logits move {moved[0]:.2e}), cuDNN TF32 "
            f"{cuda_ms(lambda: cudnn_logits(card.model, x, True)):.4f} ms "
            f"(logits move {moved[1]:.2e})")
    wide = seg.SegmentationPredictor(None, device=dev)
    wide_cudnn_ms = cuda_ms(lambda: cudnn_logits(wide.model, x, False),
                            reps=1, batches=3, warmup=1)
    unet.append(
        f"default width {wide.features} at 640x640 f32 (used) "
        f"{cuda_ms(lambda: wide.logits(x)):.4f} ms; cuDNN f32 "
        f"{wide_cudnn_ms:.4f} ms; cuDNN TF32 "
        f"{cuda_ms(lambda: cudnn_logits(wide.model, x, True)):.4f} ms")

    # morphology bitwise and the inpaint, card against CPU, on view E
    m_cpu = torch.from_numpy(masks["E"] > 0)
    m = m_cpu.to(dev)
    for k in (5, 31, 51):
        for fn in (morph.dilate, morph.erode, morph.close_mask):
            if not torch.equal(fn(m, k).cpu(), fn(m_cpu, k)):
                raise AssertionError(f"{fn.__name__} k={k}: card and CPU "
                                     "differ")
    img_cpu = torch.from_numpy(scenes["E"].astype(np.float32) / 255.0)
    img = img_cpu.to(dev)
    filled = morph.diffusion_inpaint(img, m).cpu()
    ref = morph.diffusion_inpaint(img_cpu, m_cpu)
    inpaint_err = float((filled - ref).abs().max())

    def u8(t):
        return torch.clamp(t * 255.0 + 0.5, 0, 255).to(torch.uint8).int()
    inpaint_lsb = int((u8(filled) - u8(ref)).abs().max())
    if inpaint_err > INPAINT_TOL or inpaint_lsb > 1:
        raise AssertionError(f"diffusion_inpaint card vs CPU {inpaint_err:.2e}"
                             f", {inpaint_lsb} LSB")
    refine_ms = cuda_ms(lambda: morph.dilate(morph.close_mask(m, 5), 31))
    inpaint_ms = cuda_ms(lambda: morph.diffusion_inpaint(img, m), reps=2,
                         batches=3, warmup=1)

    gates = _ms_capability(card)
    log(f"[maskseg] {len(files)} views (4 x 1600², 2 x 1920x1080, 1 x 8K; "
        f"set-up {setup_s:.2f}s) | subjects found in "
        f"{runs['mask']['found']} | launches of the hand-written kernels "
        f"{runs['mask']['launches']} (MaskSeg has none: torch ops only)"
        f" | masks card vs CPU: {flipped} pixels differ (worst "
        f"{worst_share:.5%}, {band_total} pixels within {MASK_BAND:g} of the "
        f"threshold), other modes' files against the CPU max {worst_lsb} "
        f"LSB ({inpaint_checked} inpainted)")
    log(f"[maskseg] card vs CPU, TF32 off: " + "; ".join(errs)
        + f" | morphology k=5/31/51 bitwise | inpaint 1920x1080 "
        f"{inpaint_err:.2e} f32, {inpaint_lsb} LSB")
    log(f"[maskseg] capability on the card: {gates}")
    log(f"[maskseg] {smi} | device ms an image, resize in + U-Net + softmax "
        f"+ resize out (person only): " + "; ".join(times))
    log(f"[maskseg] {smi} | U-Net: " + " | ".join(unet)
        + f" | close k=5 + expand k=31 on 1920x1080 {refine_ms:.4f} ms | "
        f"inpaint 256 steps 1920x1080 {inpaint_ms:.4f} ms")
    for mode in MS_MODES:
        run = runs[mode]
        log(f"[maskseg] {smi} | --mode {mode}: wall {run['wall_s']:.3f}s "
            f"over {len(files)} files | {run['timers'].report()}")
    log(f"[maskseg] --mode mask --device cpu: wall {cpu_run['wall_s']:.3f}s "
        f"| {cpu_run['timers'].report()}")
    return {"launches": runs["mask"]["launches"]}


def _micro_check(key, op, tensors, loops, grid) -> float:
    """One launch of ``key`` at ``loops`` against its plain version at its
    gate; returns the error relative to max|plain|."""
    got = mo.micro_op(key, tensors, loops, grid)
    ref = op.plain(*tensors, loops)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"micro_ops {key}: non-finite output")
    err = float((got - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    tol = mo.rel_tolerance(key, loops)
    if (tol == 0.0 and not torch.equal(got, ref)) or rel > tol:
        raise AssertionError(f"micro_ops {key}: kernel vs plain rel "
                             f"{rel:.3e} (abs {err:.3e}) at {loops} loops, "
                             f"gate {tol:g}")
    return rel


def _sass_kernels() -> dict:
    """Each kernel of ``mo.SASS_CHECKS``: its instructions of each check's
    opcodes in the built library, ``{key: "FMUL/FMUL32I 32, FSEL 0"}``,
    read once from ``cuobjdump -sass``; fails where a count is not the one
    the table asks for (or none where it asks for at least one)."""
    rows = mo.sass_checks(_build.sass_counts(mo.SASS_OPCODES))
    found = {}
    for key, ops, n, _want, _ok in rows:
        found.setdefault(key, []).append(f"{'/'.join(ops)} {n}")
    log("[micro_ops] instructions in cuobjdump -sass (the products' "
        "HGMMA/HMMA; one FADD or FMUL for each element a thread holds; "
        "where's multiplies predicated, no FSEL; no block barrier, BAR, in "
        "the (8,128) gather): " + ", ".join(
            f"{key} {'/'.join(ops)} {n} (wants "
            f"{'some' if want is None else want})"
            for key, ops, n, want, _ok in rows))
    wrong = [row[:4] for row in rows if not row[4]]
    if wrong:
        raise AssertionError(f"micro_ops: SASS counts (key, opcodes, "
                             f"found, wanted) {wrong}")
    return {key: ", ".join(got) for key, got in found.items()}


# the primitives with rows of their own in the kernels line, and the Pallas
# body each replaces (root micro_ops.py); they are also held bitwise across
# grids 1 / 11 / GRID and two launches
MICRO_ROWS = {"matmul64": 119, "matmul8": 132, "gather_lane64": 77,
              "chunk": 196, "concat": 109, "loop": 159, "where": 100,
              "mul8": 59, "gather_lane8": 68}
# the fixed cost of a launch split from its blocks: no loop on one block
# (grid 8: kChains) beside no loop on the grid's 256
FIXED_COST_KEYS = ("where", "mul8", "gather_lane8")
ONE_BLOCK_GRID = 8


def _micro_library(key: str, tensors: list, grid: int):
    """(one PyTorch call that computes one application of ``key`` over the
    ``grid`` blocks stacked, what of the primitive it leaves out), or
    (None, why there is none). Inputs are stacked before the call."""
    if key == "chunk":
        return None, "none: no one call gathers, weighs and sums the taps"

    def stack(t):
        return t.expand(grid, *t.shape).contiguous()

    x = stack(tensors[0])
    if key in mo.PRODUCTS:
        b = tensors[1]
        return (lambda: torch.matmul(x, b)), "cuBLAS f32, TF32 off"
    if key in ("mul8", "mul64"):
        return (lambda: torch.mul(x, 1.0001)), "torch.mul"
    if key in ("gather_lane8", "gather_lane64", "gather_sub8"):
        axis = 2 if key != "gather_sub8" else 1
        idx = stack(tensors[1].long())
        left = "+ 0.5" if axis == 2 else "the accumulating add"
        return (lambda: torch.gather(x, axis, idx)), \
            f"torch.gather along axis {axis - 1}, {left} left out"
    if key == "where":
        mask, scaled = stack(tensors[1] == 0), x * 1.0001
        return (lambda: torch.where(mask, x, scaled)), \
            "torch.where, the compare and the multiply left out"
    if key == "concat":
        return (lambda: torch.cat([x] * 8, 1)), \
            "torch.cat, the accumulating add left out"
    if key == "dyn_roll":
        shift = int(tensors[1][0, 0])
        return (lambda: torch.roll(x, shift, 2)), \
            "torch.roll, the accumulating add left out"
    if key == "loop":
        return (lambda: torch.add(x, 1.0)), "torch.add"
    if key == "when_rmw":
        return (lambda: torch.add(x, 1.0, out=x)), "torch.add in place"
    if key == "dyn_slice":
        start = (int(tensors[1][0, 0]) % 8) * 8
        acc = torch.zeros_like(x[:, :8])
        return (lambda: torch.add(acc, x[:, start:start + 8])), \
            "torch.add of a row slice (a view)"
    raise KeyError(key)


def phase_micro_ops(dev, smi: str) -> dict:
    """Each of the 14 micro_ops kernels against its plain version on the
    card (movers and the counted loop bitwise, arithmetic at 1e-6, the
    products at 1e-5 a step; the redesigned ones, ``MICRO_ROWS``, at the
    depths of ``mo.CHECK_LOOPS`` and bitwise across grids and launches),
    each timed at grid 2048 (composite 256), reps 64 beside its bound, its
    plain version and, where one PyTorch call computes one application,
    that call over the whole grid's blocks times the loops
    (``library_ms``; TF32 off). A kernel's ``ms`` is its device time
    without the wrapper's host time (``device_ms``, events around a CUDA
    graph of 10 launches), its share of the bound is taken of that, and
    ``cuda_ms``'s event time of the same launches stands beside it, as do
    its time with no loop and a loop's marginal time (from the nominal
    loops to four times as many). The kernels of ``mo.WAVEFRONT_MODELS``
    also beside their shared-memory wavefront floor. Then the tool itself,
    whose lines are printed and whose launches are the path's, and the
    ranking of the primitives by launches × (device − the larger of bound
    and floor)."""
    sass = _sass_kernels()
    inputs = mo.make_inputs(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stats = {}
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # the function is f32
    try:
        for key, op in mo.OPS.items():
            tensors = [inputs[name] for name in op.inputs]
            loops = mo.bench_loops(op)
            grid = op.grid or mo.GRID
            product = key in mo.PRODUCTS
            checks = mo.CHECK_LOOPS.get(key, (loops,))
            rel = max(_micro_check(key, op, tensors, n, grid)
                      for n in checks)
            if key in MICRO_ROWS:
                n = max(checks)
                runs = [mo.micro_op(key, tensors, n, g)
                        for g in (1, 11, grid, grid)]
                if not all(torch.equal(runs[0], r) for r in runs[1:]):
                    raise AssertionError(f"micro_ops {key}: the block "
                                         "differs across grids or launches")
            library, what = _micro_library(key, tensors, grid)
            library_ms = None if library is None else \
                device_ms(library)[0] * loops
            launch = (lambda: mo.micro_op(key, tensors, loops, grid))
            ms, kernels = device_ms(launch)
            if kernels != 1:
                raise AssertionError(f"micro_ops {key}: {kernels} kernels "
                                     "a launch")
            events_ms = cuda_ms(launch)
            plain_ms = cuda_ms(lambda: op.plain(*tensors, loops),
                               **PLAIN_TIMING)
            bound, by, times = mo.bound_ms(op, loops)
            stats[key] = {"max_abs_err": rel, "ms": ms,
                          "events_ms": events_ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by,
                          "library_ms": library_ms, "library": what}
            extra = ""
            if product:
                extra = f" | FMA bound {times['f32']:.4f} ms"
            if key in sass:
                extra += f" | {sass[key]} in the kernel"
            if key in mo.WAVEFRONT_MODELS:
                waves = mo.block_loop_wavefronts(key, inputs)
                floor = mo.wavefront_floor_ms(key, inputs, loops, sms)
                stats[key]["wavefront_floor_ms"] = floor
                extra += (f" | shared-memory wavefronts a block-loop "
                          + " + ".join(f"{k} {n}" for k, n in waves.items()
                                       if k != "bound")
                          + f" (the bound counts {waves['bound']}): floor "
                          f"{floor:.4f} ms on {sms} SMs at "
                          f"{mo.SMEM_CLOCK_GHZ} GHz, {floor / ms:.1%} of "
                          "the device time")
            # what holds the launch: the launch with no loop (loads and
            # store) and the marginal loop
            zero_ms = device_ms(lambda: mo.micro_op(key, tensors, 0, grid))[0]
            deep_ms = device_ms(
                lambda: mo.micro_op(key, tensors, 4 * loops, grid))[0]
            loop_ms = (deep_ms - ms) / (3 * loops)
            stats[key].update(zero_loop_ms=zero_ms, loop_ms=loop_ms)
            if key in FIXED_COST_KEYS:
                stats[key]["one_block_zero_ms"] = device_ms(
                    lambda: mo.micro_op(key, tensors, 0, ONE_BLOCK_GRID))[0]
            floor = stats[key].get("wavefront_floor_ms")
            extra += (f" | 0 loops {zero_ms:.4f} ms, a loop {loop_ms:.6f} ms "
                      f"(from {loops} to {4 * loops}; the bound's "
                      f"{bound / loops:.6f}"
                      + ("" if floor is None else
                         f", the floor's {floor / loops:.6f}") + ")")
            if key in MICRO_ROWS:
                extra += f" | bitwise across grids 1/11/{grid} and launches"
            gate = ("bitwise" if mo.rel_tolerance(key, loops) == 0.0
                    else f"rel {rel:.2e}")
            lib = what if library_ms is None else \
                f"{library_ms:.4f} ms ({what}, x{loops})"
            log(f"[micro_ops] {smi} | {key}: {gate} at loops "
                f"{'/'.join(map(str, checks))} | device {ms:.4f} ms "
                f"(events {events_ms:.4f}), bound {bound:.5f} ms by {by} "
                f"({bound / ms:.1%} of device), plain {plain_ms:.4f} ms "
                f"(one block) | library {lib}{extra}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    for key in FIXED_COST_KEYS:
        st = stats[key]
        log(f"[micro_ops] {smi} | fixed cost {key}: 0 loops on one block "
            f"(grid {ONE_BLOCK_GRID}) {st['one_block_zero_ms']:.4f} ms, on "
            f"the grid's {-(-mo.GRID // ONE_BLOCK_GRID)} blocks (grid "
            f"{mo.GRID}) {st['zero_loop_ms']:.4f} ms, "
            f"{mo.bench_loops(mo.OPS[key])} loops there {st['ms']:.4f} ms")

    _reset_counters()
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = micro_ops_tool.main([])
    torch.cuda.synchronize()
    plain = _counters()[1]
    per_op = dict(mo.OP_LAUNCHES)
    lines = buf.getvalue().splitlines()
    if rc != 0 or sum("ns/op" in ln for ln in lines) != len(mo.OPS):
        raise AssertionError(f"micro_ops tool exited {rc}: {lines[-5:]}")
    if not all(per_op.values()) or any(plain.values()):
        raise AssertionError(f"micro_ops tool: launches {per_op}, plain "
                             f"{plain}")
    for line in lines:
        log(f"[micro_ops] {line}")
    for key, st in stats.items():
        st["launches"] = per_op[key]
        st["least_ms"] = max(st["bound_ms"],
                             st.get("wavefront_floor_ms", 0.0))
        st["gap"] = st["launches"] * (st["ms"] - st["least_ms"])

    def ranked(keys) -> str:
        return ", ".join(
            f"{k} {stats[k]['launches']} x ({stats[k]['ms']:.4f} - "
            f"{stats[k]['least_ms']:.4f}) = {stats[k]['gap']:.3f}"
            for k in sorted(keys, key=lambda k: -stats[k]["gap"]))
    log("[micro_ops] ranking by launches in the tool's run x (device ms - "
        "the larger of the bound and the wavefront floor), largest first; "
        "the primitives never redesigned: "
        + ranked(k for k in stats if k not in MICRO_ROWS)
        + " | the redesigned ones: " + ranked(MICRO_ROWS))
    return stats


# what bounds a primitive (micro_ops_cuda.bound_ms), as the kernels line
# names it
BOUND_BY = {"f32": "operations", "tensor cores": "operations",
            "shared memory": "bytes", "device memory": "bytes"}


def _micro_rows(micro: dict) -> list:
    """The ``kernels`` rows of ``[micro_ops]``: one for each of
    ``MICRO_ROWS``, then the other primitives summed. ``ms`` is the device
    time (``events_ms`` the event time beside it)."""
    keys = ("launches", "max_abs_err", "ms", "events_ms", "plain_ms",
            "bound_ms", "library_ms", "zero_loop_ms", "loop_ms")
    rows = []
    for key, line in MICRO_ROWS.items():
        st = micro[key]
        how = {"tensor cores": "three TF32 passes on the tensor cores",
               "f32": "bound by f32 instruction issue at 33.5 T a second",
               "shared memory": "bound by shared-memory bytes at 33.5 TB/s"
               }[st["bound_by"]] + "; error relative to max|plain|" + (
                   " at 8 steps" if key in mo.PRODUCTS else "")
        grid = mo.OPS[key].grid or mo.GRID
        rows.append({
            "name": f"micro_ops {key} ({mo.OPS[key].label}: {how}, grid "
                    f"{grid}, reps 64; ms without the wrapper's host time; "
                    f"library: {st['library']})",
            "route": "cuda", "source": "gs360x_torch/csrc/micro_ops.cu",
            "replaces": f"micro_ops.py:{line}",
            **{k: st[k] for k in keys},
            "bound_by": BOUND_BY[st["bound_by"]]})
    rest = {key: st for key, st in micro.items() if key not in MICRO_ROWS}
    by_smem = sum(st["bound_ms"] for st in rest.values()
                  if st["bound_by"] == "shared memory")
    bound = sum(st["bound_ms"] for st in rest.values())
    rows.append({
        "name": f"micro_ops (bench: the {len(rest)} other primitives, grid "
                "2048, reps 64, summed; ms without the wrapper's host "
                "time; bounds by f32 instruction issue or shared memory, "
                "bound_by names the larger share; error relative to "
                "max|plain|; library: one torch call an application of "
                "each, summed)",
        "route": "cuda", "source": "gs360x_torch/csrc/micro_ops.cu",
        "replaces": "micro_ops.py:22",
        **{k: sum(st[k] for st in rest.values())
           for k in ("launches", "ms", "events_ms", "plain_ms",
                     "library_ms", "zero_loop_ms")},
        "max_abs_err": max(st["max_abs_err"] for st in rest.values()),
        "bound_ms": bound,
        "bound_by": "bytes" if by_smem >= bound / 2 else "operations"})
    return rows


# --- [segtrain]: the U-Net's training step, segtrain, --make-default and a
# model trained on the card ------------------------------------------------

def _seg_batches(n: int, size: int, batch: int, seed: int) -> list:
    """``n`` batches of ``batch`` photo-style synthseg scenes at size²."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pairs = [synthseg.generate_scene(rng, size=size, photo_style=True)
                 for _ in range(batch)]
        out.append((np.stack([p[0] for p in pairs]),
                    np.stack([p[1] for p in pairs]).astype(np.int64)))
    return out


def _grads(state) -> dict:
    return {n: p.grad.detach().cpu().clone()
            for n, p in state.model.named_parameters()}


def _profiled(step, n: int) -> tuple:
    """(wall ms a step, kernel ms a step, the device's busy share of the
    wall) over ``n`` calls of ``step`` under ``torch.profiler``, ending in
    a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    kernel_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / n
    return wall_ms, kernel_ms, kernel_ms / wall_ms


@contextmanager
def _im2col_convs():
    """``seg.train_step`` with the convolutions of inference
    (``seg.f32_convs``): the im2col route, whose weights are the same in
    every process. The cuDNN route's autotuner may pick other algorithms
    in another process."""
    shipped = seg.train_convs
    seg.train_convs = seg.f32_convs
    try:
        yield
    finally:
        seg.train_convs = shipped


def _step_split(state, x, y) -> dict:
    """Device ms of a training step's parts on one uploaded batch by CUDA
    events over back-to-back runs: the forward with its loss, the forward
    and backward (the backward is the difference) and the AdamW update."""
    def forward():
        with seg.train_convs():
            return seg.loss_fn(state.model(x.permute(0, 3, 1, 2)), y, 4.0)

    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        with seg.train_convs():
            forward().backward()
    fwd = cuda_ms(forward, reps=3, batches=3, warmup=2)
    both = cuda_ms(forward_backward, reps=3, batches=3, warmup=2)
    opt = cuda_ms(state.optimizer.step, reps=3, batches=3, warmup=2)
    return {"forward": fwd, "backward": both - fwd, "adamw": opt}


def _segtrain_parity(dev) -> tuple:
    """(a): the default width at 256², batch 8, 3 steps on the card and on
    the CPU from one init and the same batches, and again on the card,
    bitwise the first card run; then the device ms of a step by the
    training route (cuDNN) and by the im2col route of inference."""
    params = seg.init_params(torch.Generator().manual_seed(0))
    batches = _seg_batches(ST_STEPS, ST_SIZE, ST_BATCH, seed=21)
    card = seg.create_train_state(None, 1e-3, device=dev, params=params)
    cpu = seg.create_train_state(None, 1e-3, device=torch.device("cpu"),
                                 params=params)
    losses, worst = [], {}
    t0 = time.perf_counter()
    for step, (im, lb) in enumerate(batches):
        got = float(seg.train_step(card, torch.from_numpy(im).to(dev),
                                   torch.from_numpy(lb).to(dev), 4.0))
        ref = float(seg.train_step(cpu, torch.from_numpy(im),
                                   torch.from_numpy(lb), 4.0))
        losses.append((got, ref))
        tol = ST_LOSS_RTOL if step == 0 else ST_LATER_LOSS_RTOL
        if abs(got - ref) > tol * abs(ref):
            raise AssertionError(f"segtrain step {step + 1}: loss {got!r} on "
                                 f"the card, {ref!r} on the CPU")
        if step == 0:
            g_card, g_cpu = _grads(card), _grads(cpu)
            gmax = max(float(g.abs().max()) for g in g_cpu.values())
            worst = max(((float((g_card[n] - g).abs().max()) / gmax, n)
                         for n, g in g_cpu.items()))
            if worst[0] > ST_GRAD_TOL:
                raise AssertionError(f"segtrain step 1: gradient of "
                                     f"{worst[1]} {worst[0]:.3e} of the "
                                     f"largest apart, card vs CPU")
    pair_s = time.perf_counter() - t0
    again = seg.create_train_state(None, 1e-3, device=dev, params=params)
    for step, (im, lb) in enumerate(batches):
        got = float(seg.train_step(again, torch.from_numpy(im).to(dev),
                                   torch.from_numpy(lb).to(dev), 4.0))
        if got != losses[step][0]:
            raise AssertionError(f"segtrain step {step + 1}: two card runs "
                                 f"give losses {got!r} and "
                                 f"{losses[step][0]!r}")
    if not all(torch.equal(a, b) for a, b in zip(
            again.model.state_dict().values(),
            card.model.state_dict().values())):
        raise AssertionError("segtrain: two card runs give other weights")

    x = torch.from_numpy(batches[0][0]).to(dev)
    y = torch.from_numpy(batches[0][1]).to(dev)
    im2col = seg.create_train_state(None, 1e-3, device=dev, params=params)
    with _im2col_convs():
        im2col_ms = cuda_ms(lambda: seg.train_step(im2col, x, y, 4.0),
                            reps=3, batches=3, warmup=2)
    state = seg.create_train_state(None, 1e-3, device=dev, params=params)
    ms = {"im2col": im2col_ms,
          "cudnn": cuda_ms(lambda: seg.train_step(state, x, y, 4.0),
                           reps=3, batches=3, warmup=2)}
    state = seg.create_train_state(None, 1e-3, device=dev, params=params)
    split = _step_split(state, x, y)

    def step():                       # a host batch: upload, then a step
        im, lb = batches[step.k % len(batches)]
        step.k += 1
        seg.train_step(state, torch.from_numpy(im).to(dev),
                       torch.from_numpy(lb).to(dev), 4.0)
    step.k = 0
    split["wall"], split["kernels"], split["busy"] = _profiled(step, 6)
    return losses, worst, ms, split, pair_s


def _segtrain_mesh(dev) -> dict:
    """(e): the data-parallel step (``train_step`` over a data mesh) at the
    default width, 256², batch 8, fg_weight 4, 3 steps, by the im2col
    route (:func:`_im2col_convs`: the same convolutions at any block size
    and in any process), over a mesh of ``ST_REPLICAS`` replicas on the
    one card against a mesh of one, and the one-replica run bitwise the
    step without a mesh; then the device ms of a step of each mesh."""
    params = seg.init_params(torch.Generator().manual_seed(0))
    batches = _seg_batches(ST_STEPS, ST_SIZE, ST_BATCH, seed=23)
    meshes = {"one": meshlib.data_mesh([dev]),
              "two": meshlib.data_mesh([dev] * ST_REPLICAS)}
    losses, worst = [], (0.0, "")
    with _im2col_convs():
        plain = seg.create_train_state(None, 1e-3, device=dev,
                                       params=params)
        states = {k: seg.create_train_state(None, 1e-3, params=params,
                                            mesh=m)
                  for k, m in meshes.items()}
        if states["one"].replicas or \
                len(states["two"].replicas) != ST_REPLICAS - 1:
            raise AssertionError("segtrain (e): replicas "
                                 f"{[len(st.replicas) for st in states.values()]}")
        for step, (im, lb) in enumerate(batches):
            x = torch.from_numpy(im).to(dev)
            y = torch.from_numpy(lb).to(dev)
            ref = float(seg.train_step(states["one"], x, y, 4.0))
            got = float(seg.train_step(states["two"], x, y, 4.0))
            base = float(seg.train_step(plain, x, y, 4.0))
            losses.append((got, ref))
            if base != ref:
                raise AssertionError(f"segtrain (e) step {step + 1}: loss "
                                     f"{ref!r} over a one-replica mesh, "
                                     f"{base!r} without a mesh")
            if abs(got - ref) > ST_LOSS_RTOL * abs(ref):
                raise AssertionError(f"segtrain (e) step {step + 1}: loss "
                                     f"{got!r} over {ST_REPLICAS} replicas, "
                                     f"{ref!r} over one")
            if step == 0:
                g_one, g_two = _grads(states["one"]), _grads(states["two"])
                gmax = max(float(g.abs().max()) for g in g_one.values())
                worst = max((float((g_two[n] - g).abs().max()) / gmax, n)
                            for n, g in g_one.items())
                if worst[0] > ST_GRAD_TOL:
                    raise AssertionError(
                        f"segtrain (e) step 1: gradient of {worst[1]} "
                        f"{worst[0]:.3e} of the largest apart, "
                        f"{ST_REPLICAS} replicas vs one")
        main = states["two"].model.state_dict()
        if not all(torch.equal(v, main[k]) for r in states["two"].replicas
                   for k, v in r.state_dict().items()):
            raise AssertionError("segtrain (e): a replica's weights are "
                                 "not the first device's")
        if not all(torch.equal(a, b) for a, b in zip(
                states["one"].model.state_dict().values(),
                plain.model.state_dict().values())):
            raise AssertionError("segtrain (e): a one-replica mesh's weights "
                                 "are not those of the step without a mesh")
        x = torch.from_numpy(batches[0][0]).to(dev)
        y = torch.from_numpy(batches[0][1]).to(dev)
        ms = {k: cuda_ms(lambda st=st: seg.train_step(st, x, y, 4.0),
                         reps=3, batches=3, warmup=2)
              for k, st in states.items()}
    return {"losses": losses, "worst": worst, "ms": ms}


def _write_pairs(root: pathlib.Path, n: int, size: int) -> tuple:
    """``n`` photo-style synthseg scenes at size² as PNG image and class
    mask pairs under root/img and root/mask."""
    img_dir, mask_dir = root / "img", root / "mask"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir()

    def one(k):
        img, lab = synthseg.generate_scene(np.random.default_rng(300 + k),
                                           size=size, photo_style=True)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            img_dir / f"s{k:03d}.png", compress_level=1)
        Image.fromarray(lab.astype(np.uint8)).save(mask_dir / f"s{k:03d}.png")
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(one, range(n)))
    return img_dir, mask_dir


def _quiet(fn, *args, **kw) -> tuple:
    """(return value, stdout lines) of one call."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(*args, **kw)
    return rc, buf.getvalue().splitlines()


def _no_launch(label: str) -> None:
    launches, plain = _counters()
    if any(launches.values()) or any(plain.values()):
        raise AssertionError(f"{label}: launches {launches}, plain {plain}")


def _segtrain_cli(dev, tmp, ms_in: pathlib.Path) -> dict:
    """(b): gs360x-torch-segtrain on 32 scenes at 512², then maskseg with
    the weights it wrote; (c): --make-default -o, then maskseg's default
    resolution loads it."""
    t0 = time.perf_counter()
    img_dir, mask_dir = _write_pairs(tmp / "st_pairs", ST_CLI_SCENES, 512)
    setup_s = time.perf_counter() - t0
    out = tmp / "st_weights.msgpack"
    saved = {}
    save = seg.save_weights

    def keep(path, params):
        saved.update({k: v.detach().cpu().clone() for k, v in params.items()})
        save(path, params)
    seg.save_weights = keep
    _reset_counters()
    t0 = time.perf_counter()
    try:
        rc, lines = _quiet(segtrain.main, [
            "-i", str(img_dir), "-m", str(mask_dir), "-o", str(out),
            "--size", str(ST_CLI_SIZE), "--batch-size", "8", "--epochs",
            "3"])
    finally:
        seg.save_weights = save
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    _no_launch("segtrain")
    n_val = max(1, int(ST_CLI_SCENES * 0.1))
    steps = 3 * ((ST_CLI_SCENES - n_val) // 8)
    train_s = float(re.search(r"\(([\d.]+)s\)$", lines[-1]).group(1)) \
        if rc == 0 else None
    if rc != 0 or not lines[-1].startswith(f"[OK] checkpoint: {out}") \
            or sum(ln.startswith("[INFO] epoch ") for ln in lines) != 3:
        raise AssertionError(f"segtrain exited {rc}: {lines[-4:]}")
    # the CLI trains over every visible card: one on this machine
    want = (f"[INFO] {ST_CLI_SCENES} pairs, size {ST_CLI_SIZE}, devices "
            f"{torch.cuda.device_count()}")
    if lines[0] != want:
        raise AssertionError(f"segtrain: {lines[0]!r}, expected {want!r}")
    back = seg.load_weights(out)
    if back.keys() != saved.keys() or not all(
            torch.equal(back[k], saved[k]) for k in saved):
        raise AssertionError("segtrain: the written weights do not read back "
                             "bitwise equal to the trained state_dict")
    rc, ms_lines = _quiet(maskseg.main, [
        "-i", str(ms_in), "-o", str(tmp / "st_masks"), "--mode", "mask",
        "--checkpoint", str(out)])
    _no_launch("maskseg --checkpoint")
    if rc != 0 or len(list((tmp / "st_masks").iterdir())) != len(MS_VIEWS):
        raise AssertionError(f"maskseg --checkpoint exited {rc}: "
                             f"{ms_lines[-3:]}")

    default = tmp / "st_default.msgpack"
    _reset_counters()
    t0 = time.perf_counter()
    rc, mk_lines = _quiet(segtrain.main, ["--make-default", "-o",
                                          str(default)])
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    _no_launch("segtrain --make-default")
    if rc != 0 or mk_lines[-1] != \
            f"[synthseg] default checkpoint saved: {default}":
        raise AssertionError(f"--make-default exited {rc}: {mk_lines[-3:]}")
    last_loss = float(mk_lines[-2].rsplit(" ", 1)[1])
    # the port's cached default, in a cache of this run's own
    cache = tmp / "st_cache" / synthseg.default_weights_path().name
    cache.parent.mkdir()
    shutil.copyfile(default, cache)
    paths = synthseg.packaged_weights_path, synthseg.default_weights_path
    synthseg.packaged_weights_path = lambda: tmp / "no_shipped.msgpack"
    synthseg.default_weights_path = lambda: cache
    try:
        rc, def_lines = _quiet(maskseg.main, [
            "-i", str(ms_in), "-o", str(tmp / "st_default_masks"),
            "--mode", "mask"])
    finally:
        synthseg.packaged_weights_path, synthseg.default_weights_path = paths
    if rc != 0 or f"[INFO] loaded default checkpoint: {cache}" \
            not in def_lines:
        raise AssertionError(f"maskseg with the default built on the card "
                             f"exited {rc}: {def_lines[:3]}")
    return {"setup_s": setup_s, "cli_s": cli_s, "train_s": train_s,
            "steps": steps, "first": lines[0], "epochs": [ln for ln in lines
                                       if ln.startswith("[INFO] epoch ")],
            "make_s": make_s, "make_loss": last_loss}


def _train_capability(dev, convs=_im2col_convs) -> tuple:
    """(d): the tools/seg_eval.py recipe on the card — features (16, 32,
    64), 64², batch 16, lr 3e-3 with the warmup-cosine schedule over 3000
    steps, 448 scenes at photo_frac 0.7, corpus seed 0, batch rng 1, flips,
    augment_batch, fg_weight 4 — by the port's train_step in the scope
    ``convs``, and the four capability numbers of the trained model on the
    card. The gate trains with the im2col convs (:func:`_im2col_convs`):
    by the cuDNN route users train by, 3000 steps carry the autotuner's
    choice of the process into a model of other numbers, whose AP@0.5 fell
    below the floor in one of eight processes, so the gate would read a
    draw; by im2col it reads one model. ``tests/torch_seg_floor.py
    --port-runs`` measures the cuDNN route's spread."""
    images, labels = synthseg.generate_corpus(448, size=64, seed=0,
                                              photo_frac=0.7)
    state = seg.create_train_state(torch.Generator().manual_seed(0), 3e-3,
                                   (16, 32, 64), CAP_STEPS, device=dev)
    rng = np.random.default_rng(1)
    host_s = 0.0

    def step():
        nonlocal host_s
        t = time.perf_counter()
        idx = rng.integers(0, len(images), 16)
        im, lb = images[idx].copy(), labels[idx]
        if rng.random() < 0.5:
            im = im[:, :, ::-1].copy()
            lb = lb[:, :, ::-1].copy()
        im = synthseg.augment_batch(rng, im)
        host_s += time.perf_counter() - t
        return seg.train_step(state, torch.from_numpy(im).to(dev),
                              torch.from_numpy(lb).to(dev), 4.0)
    t0 = time.perf_counter()
    with convs():
        for _ in range(CAP_STEPS - CAP_PROFILED - 1):
            step()
        split = dict(zip(("wall", "kernels", "busy"),
                         _profiled(step, CAP_PROFILED)))
        final = float(step())
    train_s = time.perf_counter() - t0
    split["host"] = 1e3 * host_s / CAP_STEPS
    model = state.model.eval()

    def logits(images):
        x = torch.from_numpy(np.ascontiguousarray(images)).permute(
            0, 3, 1, 2).to(dev)
        with torch.inference_mode(), seg.f32_convs():
            return model(x).cpu().numpy()
    return checks.capability(logits), train_s, final, split


def phase_segtrain(dev, tmp, smi: str) -> dict:
    """[segtrain] (a)-(e); none of the 11 kernels launches."""
    losses, worst, ms, split, pair_s = _segtrain_parity(dev)
    _reset_counters()
    dp = _segtrain_mesh(dev)
    _no_launch("segtrain (e)")
    cli = _segtrain_cli(dev, tmp, tmp / "ms_in")
    _reset_counters()
    got, cap_s, cap_loss, cap_split = _train_capability(dev)
    _no_launch("segtrain capability")
    short = {k: got[k] - CAP_FLOOR[k] for k in CAP_FLOOR}
    log(f"[segtrain] (a) default width {seg.DEFAULT_FEATURES}, "
        f"{ST_SIZE}², batch {ST_BATCH}, {ST_STEPS} steps card vs CPU from one "
        f"init: losses " + ", ".join(f"{g:.6f}/{r:.6f}" for g, r in losses)
        + f" (step 1 within {ST_LOSS_RTOL:g} rel, later "
        f"{ST_LATER_LOSS_RTOL:g})"
        f" | step-1 gradients max {worst[0]:.3e} of the largest ({worst[1]}; "
        f"tolerance {ST_GRAD_TOL:g}) | {pair_s:.1f}s | a second card run: "
        f"losses and weights bitwise the first's")
    log(f"[segtrain] {smi} | device ms of one train step (forward + "
        f"backward + AdamW, TF32 off) at {ST_SIZE}², batch {ST_BATCH}: "
        f"im2col route (cuDNN off) {ms['im2col']:.4f} ms, cuDNN "
        f"(autotuned, deterministic) {ms['cudnn']:.4f} ms; the port trains "
        f"by the cuDNN route | cuDNN: forward {split['forward']:.4f} + "
        f"backward {split['backward']:.4f} + AdamW {split['adamw']:.4f} ms; a "
        f"step with its upload, under the profiler: wall "
        f"{split['wall']:.3f} ms, kernels {split['kernels']:.3f} ms, device "
        f"busy {split['busy']:.1%}")
    log(f"[segtrain] (b) {smi} | gs360x-torch-segtrain on {ST_CLI_SCENES} "
        f"scenes at 512² (written in {cli['setup_s']:.2f}s, set-up), --size "
        f"{ST_CLI_SIZE} --batch-size 8 --epochs 3: wall {cli['cli_s']:.2f}s, "
        f"training {cli['train_s']}s for {cli['steps']} steps = "
        f"{1e3 * cli['train_s'] / cli['steps']:.1f} ms a step (host batch, "
        f"loss fetch and validation included) | "
        + " | ".join(ln[7:] for ln in cli["epochs"])
        + f" | first line {cli['first']!r} | the weights read back bitwise "
        "| maskseg --checkpoint on the [maskseg] views: exit 0")
    log(f"[segtrain] (c) {smi} | --make-default -o: wall "
        f"{cli['make_s']:.2f}s for 400 steps of batch 16 at 128² (corpus "
        f"generation included) = {1e3 * cli['make_s'] / 400:.1f} ms a step, "
        f"last loss {cli['make_loss']:.3f} | maskseg resolves the cached "
        "default and runs: exit 0")
    log(f"[segtrain] (d) {smi} | the seg_eval recipe ({CAP_STEPS} steps, "
        f"(16, 32, 64) at 64², batch 16) trained on the card by the im2col "
        f"route in {cap_s:.1f}s"
        f" ({1e3 * cap_s / CAP_STEPS:.2f} ms a step, host batch included), "
        f"final loss {cap_loss:.4f} | host batch {cap_split['host']:.3f} ms "
        f"a step; the last {CAP_PROFILED} steps under the profiler: wall "
        f"{cap_split['wall']:.3f} ms, kernels {cap_split['kernels']:.3f} ms, "
        f"device busy {cap_split['busy']:.1%} | " + ", ".join(
            f"{k} {got[k]:.4f} (floor {CAP_FLOOR[k]:.4f})" for k in CAP_FLOOR)
        + f", {got['n_gt']} instances")
    log(f"[segtrain] (e) {smi} | the data-parallel step, default width, "
        f"{ST_SIZE}², batch {ST_BATCH}, fg_weight 4, im2col route, "
        f"{ST_STEPS} steps over {ST_REPLICAS} replicas on the one card vs "
        f"one: losses " + ", ".join(f"{g:.6f}/{r:.6f}"
                                    for g, r in dp["losses"])
        + f" (within {ST_LOSS_RTOL:g} rel) | step-1 gradients max "
        f"{dp['worst'][0]:.3e} of the largest ({dp['worst'][1]}; tolerance "
        f"{ST_GRAD_TOL:g}) | the one-replica mesh bitwise the step without "
        f"a mesh, the replicas bitwise the first | ms a step (CUDA events): "
        f"one replica {dp['ms']['one']:.4f}, {ST_REPLICAS} replicas "
        f"{dp['ms']['two']:.4f}")
    if min(short.values()) < 0:
        raise AssertionError(f"segtrain capability below the JAX seeds' "
                             f"floor: {got} (floor {CAP_FLOOR})")
    return {"launches": _counters()[0]}


# --- [plyopt]: the voxel path on a dense cloud -------------------------------

def _dense_cloud(n: int, seed: int) -> tuple:
    """A PGM-like dense cloud of ``n`` points (f32 xyz, u8 rgb): a noisy
    ground plane whose density falls off from the capture centre, two noisy
    walls, four spheres of radii 0.5-3 m, and 3% uniform outliers in the
    bounding box, shuffled."""
    rng = np.random.default_rng(seed)
    n_out = n * 3 // 100
    n_ground = n * 45 // 100
    n_wall = n * 8 // 100
    n_sph = (n - n_out - n_ground - 2 * n_wall) // 4
    parts = []
    r = rng.exponential(8.0, n_ground)
    a = rng.uniform(0, 2 * np.pi, n_ground)
    parts.append(np.stack([r * np.cos(a), r * np.sin(a),
                           rng.normal(0, 0.01, n_ground)], 1))
    for axis, at in ((0, -15.0), (1, 12.0)):
        w = rng.uniform(-20, 20, (n_wall, 3))
        w[:, 2] = rng.uniform(0, 6, n_wall)
        w[:, axis] = at + rng.normal(0, 0.02, n_wall)
        parts.append(w)
    for c, rad in (((3, 2, 1), 1.0), ((-6, 5, 2), 3.0), ((8, -7, 0.5), 0.5),
                   ((-2, -9, 1.5), 1.5)):
        d = rng.normal(size=(n_sph, 3))
        d *= (rad + rng.normal(0, 0.005, (n_sph, 1))) \
            / np.linalg.norm(d, axis=1, keepdims=True)
        parts.append(d + np.asarray(c))
    body = np.concatenate(parts)
    lo, hi = body.min(0), body.max(0)
    parts.append(rng.uniform(lo, hi, (n - len(body), 3)))
    xyz = np.concatenate(parts).astype(np.float32)
    xyz = xyz[rng.permutation(n)]
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return xyz, rgb


def _plyopt_cli(args: list, label: str) -> tuple:
    """One gs360x-torch-plyopt run with the stage timers: (stdout lines,
    timers, wall s); counters at 0 just before and read just after."""
    timers = StageTimers()
    _reset_counters()
    t0 = time.perf_counter()
    rc, lines = _quiet(plyopt.main, args, timers=timers)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    _no_launch(f"plyopt {label}")
    if rc != 0 or not any(ln.startswith("[OK]") for ln in lines):
        raise AssertionError(f"plyopt {label} exited {rc}: {lines[-3:]}")
    return lines, timers, wall_s


def _pick_check(label: str, rep: str, xyz: np.ndarray, size: float, got,
                ref, ties: list) -> None:
    """Card picks against CPU picks at voxel ``size``: equal, or for
    ``centroid`` apart only in near-tie voxels (counted into ``ties``)."""
    if np.array_equal(got, ref):
        ties.append(0)
        return
    if rep != "centroid" or len(got) != len(ref):
        raise AssertionError(f"plyopt {label} {rep}: card picks differ from "
                             f"the CPU's ({len(got)} vs {len(ref)})")
    keys = voxel.grid_keys(torch.from_numpy(xyz), size,
                           torch.from_numpy(xyz.min(0))).numpy()
    differ, far = checks.centroid_pick_differences(xyz, keys, got, ref)
    if far:
        raise AssertionError(f"plyopt {label}: {far} of {differ} differing "
                             "centroid picks are not near-ties")
    ties.append(differ)


def phase_plyopt(dev, tmp, smi: str) -> dict:
    """gs360x-torch-plyopt on an 8M-point dense cloud on the card in every
    mode; every mode card vs --device cpu on a 1M subset; the 8M picks
    equal over two card runs; device ms of the voxel count and reduce."""
    t0 = time.perf_counter()
    xyz, rgb = _dense_cloud(PLY_POINTS, seed=31)
    src = tmp / "dense.ply"
    plyio.save_ply_xyz_rgb(src, xyz, rgb)
    extra = tmp / "extra.ply"
    plyio.save_ply_xyz_rgb(extra, *_dense_cloud(5000, seed=32))
    setup_s = time.perf_counter() - t0
    size_mb = src.stat().st_size / 1e6
    cpu = torch.device("cpu")

    runs = {}
    modes = {
        "-t": ["-t", str(PLY_TARGET)],
        **{f"-v -k {k}": ["-v", str(PLY_VOXEL), "-k", k]
           for k in ("centroid", "center", "first", "random")},
        "spatial-hash -t": ["--downsample-method", "spatial-hash", "-t",
                            str(PLY_TARGET)],
        "--adaptive -t": ["--adaptive", "-t", str(PLY_ADAPTIVE)],
        "-v --sky-axis +Z -a": ["-v", str(PLY_VOXEL), "--sky-axis", "+Z",
                                "-a", str(extra)],
    }
    for label, flags in modes.items():
        out = tmp / f"plyopt_{len(runs)}.ply"
        lines, timers, wall_s = _plyopt_cli(
            ["-i", str(src), "-o", str(out)] + flags, label)
        n_out = len(plyio.load_ply_xyz_rgb(out)[0])
        runs[label] = (lines, timers, wall_s, n_out)
    probes = sum(ln.startswith("[iter ") for ln in runs["-t"][0])
    n_search = runs["-t"][3]
    if abs(n_search - PLY_TARGET) > 0.02 * PLY_TARGET:
        raise AssertionError(f"plyopt -t {PLY_TARGET} kept {n_search} points")
    n_unique = voxel.unique_voxel_count(torch.from_numpy(xyz).to(dev),
                                        PLY_VOXEL)
    for k in ("centroid", "center", "first", "random"):
        if runs[f"-v -k {k}"][3] != n_unique:
            raise AssertionError(f"plyopt -v -k {k}: {runs[f'-v -k {k}'][3]}"
                                 f" points, {n_unique} voxels occupied")
    if runs["-v --sky-axis +Z -a"][3] != n_unique + 5000 + 4000 or \
            runs["--adaptive -t"][3] > PLY_ADAPTIVE:
        raise AssertionError("plyopt sky/append or adaptive counts wrong")

    # the 8M cloud on the card twice: equal picks
    xyz_dev = torch.from_numpy(xyz).to(dev)
    again = {}
    for rep in ("centroid", "center", "first", "random"):
        picks = [voxel.voxel_downsample_by_size(
            xyz, rgb, PLY_VOXEL, representative=rep, device=dev,
            xyz_dev=xyz_dev)[2] for _ in range(2)]
        if not np.array_equal(*picks):
            raise AssertionError(f"plyopt 8M {rep}: two card runs differ")
        again[rep] = len(picks[0])
    searches = [voxel.voxel_downsample_to_target(
        xyz, rgb, PLY_TARGET, log=lambda *a: None, device=dev)[2]
        for _ in range(2)]
    if not np.array_equal(*searches):
        raise AssertionError("plyopt 8M search: two card runs differ")
    out_a, out_b = tmp / "plyopt_again_a.ply", tmp / "plyopt_again_b.ply"
    for out in (out_a, out_b):
        _plyopt_cli(["-i", str(src), "-o", str(out), "-v", str(PLY_VOXEL)],
                    "-v again")
    if out_a.read_bytes() != out_b.read_bytes():
        raise AssertionError("plyopt 8M -v centroid: two card runs wrote "
                             "different files")

    # card against the CPU on a 1M subset: every mode
    sub, sub_rgb = xyz[:PLY_SUBSET], rgb[:PLY_SUBSET]
    ties = []
    t0 = time.perf_counter()
    for rep in ("centroid", "center", "first", "random"):
        got = voxel.voxel_downsample_by_size(sub, sub_rgb, PLY_VOXEL,
                                             representative=rep,
                                             device=dev)[2]
        ref = voxel.voxel_downsample_by_size(sub, sub_rgb, PLY_VOXEL,
                                             representative=rep,
                                             device=cpu)[2]
        _pick_check("-v", rep, sub, PLY_VOXEL, got, ref, ties)
    target = PLY_SUBSET // 8
    for label in ("-t", "spatial-hash"):
        logs, picks = {}, {}
        for name, d in (("card", dev), ("cpu", cpu)):
            logs[name] = []
            if label == "-t":
                picks[name] = voxel.voxel_downsample_to_target(
                    sub, sub_rgb, target, log=logs[name].append, device=d)[2]
            else:
                picks[name] = voxel.spatial_hash_downsample(
                    sub, sub_rgb, target_points=target,
                    log=logs[name].append, device=d)[2]
        if logs["card"] != logs["cpu"]:
            raise AssertionError(f"plyopt {label}: the card's probes differ "
                                 f"from the CPU's: {logs}")
        # the search's last probe is the voxel it keeps
        size = float(re.search(r"voxel=([\d.e+-]+)",
                               logs["card"][-1]).group(1))
        _pick_check(label, "centroid", sub, size, picks["card"],
                    picks["cpu"], ties)
    sub_src = tmp / "dense_1m.ply"
    plyio.save_ply_xyz_rgb(sub_src, sub, sub_rgb)
    for flags in (["-v", str(PLY_VOXEL), "-k", "first"],
                  ["--adaptive", "-t", str(PLY_ADAPTIVE // 2)],
                  ["-v", str(PLY_VOXEL), "--sky-axis", "+Z", "-a",
                   str(extra), "-k", "random"]):
        files = []
        for d in ("cuda", "cpu"):
            out = tmp / f"plyopt_1m_{d}.ply"
            _plyopt_cli(["-i", str(sub_src), "-o", str(out), "--device", d]
                        + flags, " ".join(flags))
            files.append(out.read_bytes())
        if files[0] != files[1]:
            raise AssertionError(f"plyopt 1M {flags}: card and CPU files "
                                 "differ")
    cpu_s = time.perf_counter() - t0

    # a COLMAP model round trip, small: its text I/O is host work
    model = colmap_model.ColmapModel()
    cid = model.add_camera("PINHOLE", 1600, 1600, [800, 800, 800, 800])
    track = " ".join(f"{k}.0 {k}.0 {k + 1}" for k in range(0, 4000, 7))
    model.images.append(colmap_model.Image(1, 1, 0, 0, 0, 0, 0, 0, cid,
                                           "a.jpg", points2d_line=track))
    for j, p in enumerate(sub[:20000]):
        model.points.append(colmap_model.Point3(j + 1, *map(float, p), 10,
                                                20, 30))
    colmap_text.write_model(tmp / "cm_in", model)
    _plyopt_cli(["-i", str(tmp / "cm_in"), "-o", str(tmp / "cm_out"), "-v",
                 "0.5"], "colmap")
    back = colmap_text.read_model(tmp / "cm_out")
    kept = {p.id for p in back.points}
    toks = back.images[0].points2d_line.split()
    if not 0 < len(back.points) < 20000 or any(
            int(t) not in kept for t in toks[2::3]):
        raise AssertionError("plyopt COLMAP round trip: observations of "
                             "dropped points were kept")

    # device ms of the voxel path at 8M
    lo = xyz_dev.min(dim=0).values
    keys = voxel.grid_keys(xyz_dev, PLY_VOXEL, lo)
    rand = torch.rand(len(xyz), device=dev)
    count_ms = cuda_ms(lambda: voxel.unique_voxel_count(xyz_dev, PLY_VOXEL,
                                                        lo), reps=5)
    reduce_ms = {rep: cuda_ms(lambda: voxel._voxel_reduce_impl(
        xyz_dev, keys, rand, representative=rep, xyz_min=lo,
        voxel=PLY_VOXEL), reps=5) for rep in ("centroid", "center", "first")}

    log(f"[plyopt] {PLY_POINTS:,}-point dense cloud ({size_mb:.1f} MB binary "
        f"PLY, written in {setup_s:.2f}s, set-up): -t {PLY_TARGET} kept "
        f"{n_search:,} after {probes} probes; -v {PLY_VOXEL} kept "
        f"{n_unique:,} with every --keep-strategy | launches of the "
        "hand-written kernels: none in any mode")
    log(f"[plyopt] {PLY_POINTS:,} on the card twice: equal picks ({again}), "
        f"equal search"
        f" picks, byte-equal -v files | card vs --device cpu on a "
        f"{PLY_SUBSET:,}-point subset, every mode: first/random/center picks "
        f"equal, centroid picks apart in {ties} voxels (all near-ties), CLI "
        f"files byte-equal for -k first, --adaptive, sky + append ({cpu_s:.1f}"
        f"s) | COLMAP round trip: {len(back.points)} of 20000 points kept, "
        "observations filtered")
    log(f"[plyopt] {smi} | device ms at {PLY_POINTS:,} points: "
        f"unique_voxel_count {count_ms:.4f} ms (keys + sort + heads + count "
        f"fetch), _voxel_reduce_impl centroid {reduce_ms['centroid']:.4f} ms, "
        f"center {reduce_ms['center']:.4f} ms, first "
        f"{reduce_ms['first']:.4f} ms")
    for label, (_lines, timers, wall_s, n_out) in runs.items():
        log(f"[plyopt] {smi} | {' '.join(modes[label])}: wall {wall_s:.3f}s, "
            f"{n_out:,} points "
            f"| {timers.report()}")
    return {"count_ms": count_ms, "reduce_ms": reduce_ms}


# --- [scene]: the scene loader on ms360xml's exports -------------------------

def phase_scene(tmp) -> dict:
    """gs360x-torch-scene on each format [ms360xml] --format all
    --points-ply wrote, with --export-ply: the cameras of sparse/0 in each,
    centres agreeing to SCENE_TOL."""
    root = tmp / "ms_all"
    model = colmap_text.read_model(root / "sparse" / "0")
    want = {pathlib.Path(img.name).stem: img.center for img in model.images}
    sources = {"colmap": [str(root / "sparse" / "0")],
               "transforms": [str(root / "transforms.json"), "--ply",
                              str(root / "pointcloud_for_transforms.ply")],
               "realityscan xmp": [str(root / "cameras_RealityScan")],
               "metashape xml": [str(root / "perspective_cams.xml")]}
    worst, t0 = 0.0, time.perf_counter()
    _reset_counters()
    for name, args in sources.items():
        out = tmp / f"scene_{name.replace(' ', '_')}.ply"
        rc, lines = _quiet(scene_tool.main, args + ["--export-ply", str(out)])
        if rc != 0 or f"[OK] normalized scene PLY: {out}" not in lines:
            raise AssertionError(f"scene {name} exited {rc}: {lines[-3:]}")
        loaded = scene_io.load_scene(*args[:1], ply_path=(
            args[2] if len(args) > 2 else None))
        got = {pathlib.Path(c.name).stem: c.center for c in loaded.cameras}
        if got.keys() != want.keys():
            raise AssertionError(f"scene {name}: cameras {sorted(got)[:3]}..."
                                 f" ({len(got)}), sparse/0 has {len(want)}")
        worst = max(worst, max(float(np.abs(got[k] - want[k]).max())
                               for k in want))
        xyz, _rgb = plyio.load_ply_xyz_rgb(out)
        if len(xyz) != len(loaded.points_xyz) + len(want):
            raise AssertionError(f"scene {name}: {len(xyz)} points exported")
    _no_launch("scene")
    if worst > SCENE_TOL:
        raise AssertionError(f"scene: camera centres {worst:.2e} apart "
                             "across formats")
    log(f"[scene] gs360x-torch-scene on the [ms360xml] --format all exports "
        f"({', '.join(sources)}): {len(want)} cameras each, centres within "
        f"{worst:.2e} of sparse/0's (tolerance {SCENE_TOL:g}), normalized "
        f"PLYs written, {time.perf_counter() - t0:.2f}s, host only")
    return {}


# --- [warmup] and [gui]: gs360x-torch-warmup, and the GUI's headless modules
# driving the tools as the app does ------------------------------------------

# the parity cases of [warp] / [warp-tilted] a view falls in, and the Pallas
# kernels whose rows they hold (warp_equirect.cu computes every one)
VIEW_CASES = {"yaw ring": "_warp_kernel_yaw2, _warp_kernel_yaw",
              "pitched or rolled": "_warp_kernel",
              "pole in view": "_warp_kernel_wide2",
              "fisheye": "_warp_kernel_wide3",
              "equisolid": "_warp_kernel_wide"}


def _view_case(view) -> str:
    """Which of ``VIEW_CASES`` a perspcut view falls in: its projection,
    then whether either pole lies inside a perspective view's frustum, then
    whether it is pitched or rolled."""
    if view.projection != "perspective":
        return "fisheye" if view.projection == "fisheye_v360" else \
            "equisolid"
    rot = posemath.view_rotation_cv(view.yaw_deg, view.pitch_deg,
                                    view.roll_deg)
    tx = math.tan(math.radians(view.hfov_deg) / 2.0)
    ty = math.tan(math.radians(view.vfov_deg) / 2.0)
    for pole in (1.0, -1.0):
        x, y, z = rot.T @ np.array([0.0, pole, 0.0])
        if z > 0 and abs(x / z) <= tx and abs(y / z) <= ty:
            return "pole in view"
    if view.pitch_deg % 360.0 or view.roll_deg % 360.0:
        return "pitched or rolled"
    return "yaw ring"


def phase_warmup(dev) -> dict:
    """``warmup.main(["--all"])`` in this process on the card, at the JAX
    tool's sizes (8K source, every preset at its default size and at 1600,
    the SFM10 remap at 1750² on a 3840² lens): one planarize and one warp
    per (view group, view set), two texelize + remap launches for the
    remap, no plain call; each view set's wall. Then ``python -m
    gs360x_torch.tools.warmup --preset default`` in a subprocess, which
    must find the library built."""
    args = warmup.build_arg_parser().parse_args(["--all"])
    sets = warmup.view_sets(args)
    groups = sum(len(_view_groups(views)) for _p, _s, views in sets)
    cases = {}
    for preset, size, views in sets:
        for view in views:
            cases.setdefault(_view_case(view), set()).add(f"{preset}@{size}")
    _reset_counters()
    t0 = time.perf_counter()
    rc, lines = _quiet(warmup.main, ["--all"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, plain = _counters()
    if rc != 0 or lines[-1] != f"[OK] warmed {len(sets)} configuration(s)":
        raise AssertionError(f"warmup --all exited {rc}: {lines[-3:]}")
    want = _launches(planarize=groups + 2, warp=groups, remap=2)
    if launches != want or any(plain.values()):
        raise AssertionError(f"warmup --all: launches {launches} (expected "
                             f"{want}), plain {plain}")
    for line in lines:
        log(f"[warmup] {line}")
    log(f"[warmup] --all: {len(sets)} view sets, {groups} view groups, "
        f"launches {launches} as the view sets need, plain {plain} | "
        f"phase wall {wall_s:.2f}s | view cases reached (the Pallas kernels "
        "their [warp] parity rows stand for): " + "; ".join(
            f"{case} ({VIEW_CASES[case]}): {', '.join(sorted(where))}"
            for case, where in cases.items()))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gs360x_torch.tools.warmup", "--preset",
         "default"], capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    out = proc.stdout.splitlines()
    if proc.returncode != 0 or not any(
            ln.startswith("[INFO] kernels already built") for ln in out) \
            or any(ln.startswith("[INFO] kernels built") for ln in out):
        raise AssertionError(f"warmup --preset default exited "
                             f"{proc.returncode}, expected no build: "
                             f"{out[-4:]} {proc.stderr[-2000:]}")
    log(f"[warmup] python -m gs360x_torch.tools.warmup --preset default in "
        f"a subprocess: no build ({out[1]}); wall {sub_s:.2f}s")
    return {"launches": launches, "wall_s": wall_s}


def _gui_wait(done: list, what: str, timeout_s: float = 600.0) -> int:
    t_end = time.perf_counter() + timeout_s
    while not done:
        if time.perf_counter() > t_end:
            raise AssertionError(f"[gui] {what}: no end in {timeout_s:.0f}s")
        time.sleep(0.05)
    return done[0]


def _gui_run(proc_runner, key: str, module: str, argv: list) -> tuple:
    """One tool through ``ProcessRunner.run`` as a tab's Run button
    launches it: (its lines, wall s); fails unless it exits 0."""
    lines, done = [], []
    t0 = time.perf_counter()
    if not proc_runner.run(key, gui_runner.tool_argv(module, argv),
                           lines.append, done.append):
        raise AssertionError(f"[gui] {key} did not start")
    rc = _gui_wait(done, key)
    if rc != 0:
        raise AssertionError(f"[gui] {module} exited {rc}: "
                             f"{''.join(lines[-8:])}")
    return lines, time.perf_counter() - t0


def _preview_check(label: str, in_dir: pathlib.Path, dev, params) -> str:
    """``segpreview.preview_first_image`` on the card and on the CPU: rows
    equal, overlays equal wherever the CPU's probability of the target
    lies outside MASK_BAND of the threshold; the card's device ms of the
    preview's U-Net pass (resize in, U-Net, softmax, resize out)."""
    t0 = time.perf_counter()
    name, (card_overlay, card_rows) = segpreview.preview_first_image(
        in_dir, device=dev, params=params)
    card_s = time.perf_counter() - t0
    _name, (cpu_overlay, cpu_rows) = segpreview.preview_first_image(
        in_dir, device=torch.device("cpu"), params=params)
    if card_rows != cpu_rows:
        raise AssertionError(f"[gui] preview {label}: rows {card_rows} on "
                             f"the card, {cpu_rows} on the CPU")
    # the preview's own downscale of the first image
    img = imagelib.read_image(in_dir / name)
    h, w = img.shape[:2]
    scale = max(h, w) / 640.0
    if scale > 1.0:
        nh, nw = int(round(h / scale)), int(round(w / scale))
        img = img[(np.arange(nh) * (h / nh)).astype(int)][
            :, (np.arange(nw) * (w / nw)).astype(int)]
    img01 = img.astype(np.float32) / 255.0
    cpu = seg.SegmentationPredictor(params, device=torch.device("cpu"))
    prob = cpu.probabilities(
        img01, [seg.CLASS_TO_INDEX["person"]])[0].numpy()
    band = np.abs(prob - seg.MASK_THRESH) < MASK_BAND
    differ = (card_overlay != cpu_overlay).any(axis=-1)
    if (differ & ~band).any():
        raise AssertionError(f"[gui] preview {label}: overlays differ on "
                             f"{int((differ & ~band).sum())} pixels outside "
                             "the threshold band")
    card = seg.SegmentationPredictor(params, device=dev)
    preview_ms = cuda_ms(lambda: card.probabilities(img01), reps=5,
                         warmup=2)
    return (f"preview {label} ({name}, {img.shape[1]}x{img.shape[0]}): "
            f"{len(card_rows)} instance(s), rows equal card vs CPU, overlays "
            f"equal outside the band ({int(band.sum())} band pixels, "
            f"{int(differ.sum())} differing); upload + resize in + U-Net + "
            f"softmax + resize out {preview_ms:.4f} ms device, preview wall "
            f"{card_s:.2f}s")


def phase_gui(dev, src_dir: pathlib.Path, tmp) -> dict:
    """The GUI's headless modules driving the port's tools as the app does
    (no display: ``gui/app.py`` is not imported): (a) the PerspCut tab's
    argv from ``forms`` through ``ProcessRunner.run`` on the 2 8K frames,
    its files byte-equal to ``[e2e]``'s ``default`` run; (b) a two-step
    ``run_queue``, FrameSelector then MaskSeg on (a)'s views at the forms'
    defaults, with an ``OutputMonitor`` counting MaskSeg's files to their
    total; (c) ``segpreview.preview_first_image`` card vs CPU on (a)'s
    views and on [maskseg]'s; (d) (b)'s CSV in ``scorereview``, its chart,
    and ``apply_argv`` through the runner."""
    proc_runner = gui_runner.ProcessRunner()
    steps = {}

    # (a)
    views = tmp / "gui_perspcut"
    values = {key: default for key, _l, _k, default in forms.PERSPCUT_FIELDS}
    values.update(input_dir=str(src_dir), out_dir=str(views),
                  preset="default", size=1600, ext="png")
    argv = forms.build_perspcut_argv(values)
    _lines, steps["a"] = _gui_run(proc_runner, "perspcut", "perspcut", argv)
    direct = tmp / "out_default"
    names = sorted(p.name for p in direct.iterdir())
    if sorted(p.name for p in views.iterdir()) != names or any(
            (views / n).read_bytes() != (direct / n).read_bytes()
            for n in names):
        raise AssertionError("[gui] (a): the runner's perspcut files are "
                             f"not byte-equal to [e2e]'s {direct}")
    log(f"[gui] (a) PerspCut tab argv {argv} through ProcessRunner.run: "
        f"{len(names)} files byte-equal to [e2e]'s default run, wall "
        f"{steps['a']:.2f}s")

    # (b)
    sel_csv, masks = tmp / "gui_selection.csv", tmp / "gui_masks"
    masks.mkdir()
    fs_values = {k: d for k, _l, _k, d in forms.FRAMESELECTOR_FIELDS}
    fs_values.update(in_dir=str(views), csv=str(sel_csv))
    ms_values = {k: d for k, _l, _k, d in forms.MASKSEG_FIELDS}
    ms_values.update(input_dir=str(views), output_dir=str(masks))
    queue = [gui_runner.tool_argv("frameselector",
                                  forms.build_frameselector_argv(fs_values)),
             gui_runner.tool_argv("maskseg",
                                  forms.build_maskseg_argv(ms_values))]
    reports, lines, done = [], [], []
    mon = gui_monitor.OutputMonitor(masks, ["*.png"], len(names),
                                    lambda *r: reports.append(r),
                                    interval_sec=0.25)
    if not mon.start():
        raise AssertionError("[gui] (b): the output monitor did not start")
    t0 = time.perf_counter()
    proc_runner.run_queue("queue", queue, lines.append, done.append)
    rc = _gui_wait(done, "the FrameSelector + MaskSeg queue")
    steps["b"] = time.perf_counter() - t0
    t_end = time.perf_counter() + 5.0
    while (not reports or reports[-1][0] != 100) \
            and time.perf_counter() < t_end:
        time.sleep(0.05)
    mon.stop()
    queued = sum(ln.startswith("[queue ") for ln in lines)
    if rc != 0 or queued != 2 or not sel_csv.exists():
        raise AssertionError(f"[gui] (b): queue rc {rc}, {queued} steps, "
                             f"csv {sel_csv.exists()}: {''.join(lines[-6:])}")
    if not reports or reports[-1] != (100, len(names), len(names)):
        raise AssertionError(f"[gui] (b): monitor reports {reports}, "
                             f"expected the last (100, {len(names)}, "
                             f"{len(names)})")
    log(f"[gui] (b) run_queue FrameSelector {queue[0][3:]} then MaskSeg "
        f"{queue[1][3:]}: rc 0, OutputMonitor reports "
        f"{[r[:2] for r in reports]} of {len(names)} masks, wall "
        f"{steps['b']:.2f}s")

    # (c)
    t0 = time.perf_counter()
    params = synthseg.load_packaged_weights()
    for label, in_dir in (("on (a) views", views),
                          ("on [maskseg] scenes", tmp / "ms_in")):
        log(f"[gui] (c) {_preview_check(label, in_dir, dev, params)}")
    steps["c"] = time.perf_counter() - t0

    # (d)
    t0 = time.perf_counter()
    session = scorereview.ReviewSession.load(sel_csv)
    chart = scorereview.render_chart(session, 960, 240)
    dropped = [e.filename for e in session.entries if not e.keep]
    if len(session.entries) != len(names) or chart.shape != (240, 960, 3):
        raise AssertionError(f"[gui] (d): {len(session.entries)} rows, "
                             f"chart {chart.shape}")
    _lines, _s = _gui_run(proc_runner, "apply", "frameselector",
                          scorereview.apply_argv(sel_csv, views))
    moved = sorted(p.name for p in (views / "blur").iterdir()) \
        if (views / "blur").exists() else []
    if moved != sorted(dropped):
        raise AssertionError(f"[gui] (d): moved {moved}, dropped {dropped}")
    steps["d"] = time.perf_counter() - t0
    log(f"[gui] (d) ReviewSession of (b)'s CSV: {len(session.entries)} rows, "
        f"{session.kept_count()} kept, {len(session.suspects())} suspects, "
        f"chart {chart.shape}; apply_argv through the runner moved "
        f"{len(moved)} dropped frames to blur/; wall {steps['d']:.2f}s")
    log("[gui] walls " + ", ".join(f"({k}) {v:.2f}s" for k, v in
                                   steps.items()))
    return {"wall_s": sum(steps.values())}


def main() -> int:
    t_start = time.perf_counter()
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
        trace = phase_trace(dev, src_dir, tmp)
        dfe = phase_dualfisheye(dev, tmp, remap)
        dfe_lut = phase_dualfisheye_lut(dev, tmp, remap, dfe)
        v2f = phase_video2frames(dev, tmp)
        mesh = phase_mesh(dev, tmp)
        fsel = phase_frameselector(dev, tmp)
        ms_xml = phase_ms360xml(dev, src_dir, frames, tmp)
        dfe_xml = phase_dualfisheye_xml(dev, tmp, dfe)
        masks = phase_maskseg(dev, tmp, info["smi"])
        for name, phase in (
                ("segtrain", lambda: phase_segtrain(dev, tmp, info["smi"])),
                ("plyopt", lambda: phase_plyopt(dev, tmp, info["smi"])),
                ("scene", lambda: phase_scene(tmp))):
            t0 = time.perf_counter()
            phase()
            log(f"[{name}] phase wall {time.perf_counter() - t0:.1f}s")
        warm = phase_warmup(dev)
        gui = phase_gui(dev, src_dir, tmp)
        log(f"[warmup] + [gui] phase wall "
            f"{warm['wall_s'] + gui['wall_s']:.1f}s")
    micro = phase_micro_ops(dev, info["smi"])

    def total(kernel: str) -> int:
        return sum(r["launches"].get(kernel, 0)
                   for r in [*runs.values(), trace, dfe, dfe_lut,
                             *v2f.values(),
                             mesh["e2e"]["batched"][0], *fsel.values(),
                             ms_xml, dfe_xml, masks, warm])

    checks = remap["checks"]

    def row(name, source, replaces, kernel, stats, launches=None):
        """A warp or remap row's ms and bound are those of the launch the
        image-mode main path makes (u8 store); the f32 store's, the
        four-pass quantize it replaces and the device routes stand beside
        them. The first planarize row is the texel mode, with the u8
        planes' time beside it. ``launches`` defaults to the kernel's
        launches over every phase's main path."""
        extra = {k: stats[k] for k in (
            "ms_f32_out", "bound_ms_f32_out", "bound_by_f32_out",
            "quantize_ms", "route_unfused_ms", "route_ms", "ms_u8_planes",
            "bound_ms_u8_planes") if k in stats}
        return {"name": name, "route": "cuda",
                "source": f"gs360x_torch/csrc/{source}",
                "replaces": replaces,
                "launches": total(kernel) if launches is None else launches,
                "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
                "plain_ms": stats["plain_ms"],
                "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
                "library_ms": stats["library_ms"], **extra}

    kernels = [
        row("planarize (_planarize_mxu_kernel: 8K u8 -> RGBX texels, the "
            "source pass of the u8 main paths)", "planarize.cu",
            "gs360x/kernels/warp_pallas.py:3234", "planarize", plan["exact"]),
        row("planarize (_planarize_kernel: 8K u8 -> f32 x1/255)",
            "planarize.cu", "gs360x/kernels/warp_pallas.py:3193", "planarize",
            plan["scaled"]),
        row("warp_equirect (_warp_kernel_yaw2: yaw ring 8x1920x1080, u8 "
            "store)",
            "warp_equirect.cu", "gs360x/kernels/warp_pallas.py:1032", "warp",
            warp["headline"]),
        row("warp_equirect (_warp_kernel_yaw: yaw ring 8x1600x1600)",
            "warp_equirect.cu", "gs360x/kernels/warp_pallas.py:734", "warp",
            warp["main"]),
        row("warp_equirect (_warp_kernel: pitched full360coverage)",
            "warp_equirect.cu", "gs360x/kernels/warp_pallas.py:613", "warp",
            tilted["pitched"]),
        row("warp_equirect (_warp_kernel_wide3: fisheyeXY hemispheres)",
            "warp_equirect.cu", "gs360x/kernels/warp_pallas.py:2814", "warp",
            tilted["fisheye"]),
        row("warp_equirect (_warp_kernel_wide2: pole view)",
            "warp_equirect.cu", "gs360x/kernels/warp_pallas.py:1671", "warp",
            tilted["pole"]),
        row("warp_equirect (_warp_kernel_wide: equisolid view)",
            "warp_equirect.cu", "gs360x/kernels/warp_pallas.py:1182", "warp",
            tilted["equisolid"]),
        row("warp_equirect batched (mesh.warp_frames_sharded_pallas: 4 8K "
            "u8 frames x yaw ring 8x1920x1080 in one launch, u8 store; "
            "launches: the batched warp launches of [mesh] (c)'s first "
            "batched perspcut run)",
            "warp_equirect.cu", "gs360x/runtime/mesh.py:93", "warp",
            mesh["ring"],
            launches=mesh["e2e"]["batched"][0]["launches"]["warp"]),
        row("remap (_remap_kernel: undistort 3840², u8 store)", "remap.cu",
            "gs360x/kernels/remap_pallas.py:110", "remap",
            checks["undistort"]),
        row("remap (_remap_kernel_wide3: SFM10 10x1750²)", "remap.cu",
            "gs360x/kernels/remap_pallas.py:283", "remap", checks["batch"]),
    ]
    kernels += _micro_rows(micro)
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError("a kernel of the main paths was never launched: "
                             + str([k["name"] for k in kernels
                                    if k["launches"] <= 0]))
    log(f"[chip_smoke] wall {time.perf_counter() - t_start:.1f}s, the "
        f"kernels' build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
