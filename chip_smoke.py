#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``gs360x_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a card::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``gs360x_torch/csrc`` (into
``build/gs360x_torch/``), holds each kernel against its plain torch
version on the card at the main path's shapes and times both, then drives
the perspcut main path once (image-directory mode, ``default`` preset,
``--size 1600``, 8K equirect frames) through the port's CLI and checks
that it went through the kernels and that its pixels are right.

Phases print one line each; any failure raises and the exit code is not
0. Without CUDA, or without the rest of the checkout, it exits non-zero
and prints no result. The last line is the JSON result.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image

from gs360x_torch.kernels import _build, warp_cuda
from gs360x_torch.kernels import warp as twin
from gs360x_torch.tools import perspcut

SRC_H, SRC_W = 3840, 7680                 # 8K equirect frame
RING = [float(45 * k) for k in range(8)]  # yaw ring, 180 = the seam view
HEADLINE = dict(width=1920, height=1080, hfov_deg=112.6, vfov_deg=73.7)
# the default preset: 12 mm on a 36 mm square sensor, --size 1600
DEFAULT_FOV = math.degrees(2.0 * math.atan(36.0 / 24.0))
MAIN = dict(width=1600, height=1600, hfov_deg=DEFAULT_FOV,
            vfov_deg=DEFAULT_FOV)
E2E_FRAMES = 3
# f32 kernel vs plain twin on a smooth frame: both evaluate the same f32
# formulas on the same card; the residue is the f64-derived rotation table
# vs the twin's f32 trig composition and FMA contraction, ~1e-6.
F32_TOL = 1e-4
LSB_SHARE_TOL = 0.001   # quantized: <= 1 LSB apart on <= 0.1% of pixels


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each run)."""
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


def quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int32)


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
    return {"kind": name, "smi": smi}


def phase_planarize(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randint(0, 256, (SRC_H, SRC_W * 3), generator=gen,
                         dtype=torch.uint8, device=dev)
    got_u8 = warp_cuda.planarize_rows(rows, 1.0, torch.uint8)
    ref_u8 = warp_cuda.planarize_rows_plain(rows, 1.0, torch.uint8)
    got_f = warp_cuda.planarize_rows(rows, 1.0 / 255.0, torch.float32)
    ref_f = warp_cuda.planarize_rows_plain(rows, 1.0 / 255.0, torch.float32)
    torch.cuda.synchronize()
    if not torch.equal(got_u8, ref_u8):
        raise AssertionError("planarize u8 out: kernel != plain")
    if not torch.equal(got_f.view(torch.int32), ref_f.view(torch.int32)):
        raise AssertionError("planarize f32 out: kernel != plain (bitwise)")
    err = float((got_f - ref_f).abs().max())
    ms = cuda_ms(lambda: warp_cuda.planarize_rows(rows, 1.0, torch.uint8))
    plain_ms = cuda_ms(
        lambda: warp_cuda.planarize_rows_plain(rows, 1.0, torch.uint8))
    log(f"[planarize] 8K u8 {SRC_H}x{SRC_W * 3} -> (3,{SRC_H},{SRC_W}): "
        f"bitwise equal (u8 out, f32*1/255 out) | kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    errs.append(_compare_warp(smooth, MAIN, "bicubic", True,
                              "main-path 8x1600x1600 smooth"))
    planes = warp_cuda.planarize_rows(smooth, 1.0, torch.uint8)
    src_f32 = smooth.reshape(SRC_H, SRC_W, 3).to(torch.float32) / 255.0
    zeros = [0.0] * len(RING)
    ms = cuda_ms(lambda: warp_cuda.warp_planes(
        planes, RING, zeros, zeros, interp="bicubic", **HEADLINE))
    plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
        src_f32, RING, zeros, zeros, interp="bicubic", **HEADLINE),
        reps=5, warmup=1)
    bil_ms = cuda_ms(lambda: warp_cuda.warp_planes(
        planes, RING, zeros, zeros, interp="bilinear", **HEADLINE))
    bil_plain_ms = cuda_ms(lambda: twin.warp_equirect_to_views(
        src_f32, RING, zeros, zeros, interp="bilinear", **HEADLINE),
        reps=5, warmup=1)
    main_ms = cuda_ms(lambda: warp_cuda.warp_planes(
        planes, RING, zeros, zeros, interp="bicubic", **MAIN))
    log(f"[warp] headline 8x1920x1080 from 8K u8: bicubic kernel {ms:.4f} ms "
        f"({8000.0 / ms:.1f} views/s), plain {plain_ms:.4f} ms | bilinear "
        f"kernel {bil_ms:.4f} ms, plain {bil_plain_ms:.4f} ms | main-path "
        f"8x1600x1600 bicubic kernel {main_ms:.4f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def phase_end_to_end(dev) -> dict:
    with tempfile.TemporaryDirectory(prefix="gs360x_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        src_dir, out_dir = tmp / "panos", tmp / "out"
        src_dir.mkdir()
        shifts = [0.0, 0.5, 1.0][:E2E_FRAMES]
        frames = {}
        t0 = time.perf_counter()
        for k, shift in enumerate(shifts):
            stem = f"pano_{k + 1:04d}"
            frame = lonlat_frame(SRC_H, SRC_W, shift, dev).cpu().numpy()
            Image.fromarray(frame).save(src_dir / f"{stem}.png")
            frames[stem] = (shift, frame)
        setup_s = time.perf_counter() - t0

        warp_cuda.reset_counters()
        t0 = time.perf_counter()
        rc = perspcut.main(["-i", str(src_dir), "-o", str(out_dir),
                            "--preset", "default", "--size", "1600",
                            "--ext", "png", "--device", dev.type,
                            "--stats"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(warp_cuda.LAUNCHES)
        plain = dict(warp_cuda.PLAIN_CALLS)
        if rc != 0:
            raise AssertionError(f"perspcut exited {rc}")
        if launches != {"planarize": E2E_FRAMES, "warp": E2E_FRAMES}:
            raise AssertionError(f"kernel launches {launches}: expected one "
                                 f"of each per frame ({E2E_FRAMES})")
        if any(plain.values()):
            raise AssertionError(f"plain versions ran on the main path: "
                                 f"{plain}")

        letters = "ABCDEFGH"
        expected = sorted(f"{stem}_{v}.png" for stem in frames
                          for v in letters)
        names = sorted(p.name for p in out_dir.iterdir())
        if names != expected:
            raise AssertionError(f"outputs {names} != planned {expected}")
        worst = 0.0
        for stem, (shift, _frame) in frames.items():
            for k, v in enumerate(letters):
                with Image.open(out_dir / f"{stem}_{v}.png") as pil:
                    img = np.asarray(pil.convert("RGB"))
                if img.shape != (1600, 1600, 3):
                    raise AssertionError(f"{stem}_{v}: shape {img.shape}")
                center = img[799:801, 799:801, 0].astype(np.float64).mean()
                want = 255.0 * (0.5 + 0.5 * math.sin(
                    math.radians(RING[k]) + shift))
                worst = max(worst, abs(center - want))
        if worst > 2.0:
            raise AssertionError(f"view centers off by {worst:.2f} LSB")

        # pitched views are outside this slice's kernel gate: on the card
        # the plan raises before any work, never runs the plain twin
        try:
            perspcut.main(["-i", str(src_dir), "-o", str(tmp / "gated"),
                           "--preset", "fisheyelike", "--device", dev.type])
        except NotImplementedError as exc:
            gated = str(exc).split(":")[0]
        else:
            raise AssertionError("fisheyelike preset ran outside the gate")
        if dict(warp_cuda.PLAIN_CALLS) != plain or (tmp / "gated").exists():
            raise AssertionError("gated plan did work before raising")

        # per-frame device time of the warp path at this shape
        rows = torch.from_numpy(frames["pano_0001"][1].reshape(
            SRC_H, SRC_W * 3)).to(dev)
        zeros = [0.0] * len(RING)
        frame_ms = cuda_ms(lambda: warp_cuda.warp_equirect_to_views_cuda(
            rows, RING, zeros, zeros, interp="bicubic", planar=True, **MAIN))
    log(f"[e2e] perspcut default preset --size 1600, {E2E_FRAMES} 8K frames, "
        f"{len(expected)} outputs: wall {wall_s:.3f}s (set-up {setup_s:.2f}s) "
        f"| launches {launches} plain {plain} | view centers within "
        f"{worst:.2f} LSB | per-frame warp (planarize+warp) {frame_ms:.4f} ms"
        f" | fisheyelike raises: {gated}")
    return {"launches": launches}


def main() -> int:
    info = phase_device()
    dev = torch.device("cuda", torch.cuda.current_device())
    plan = phase_planarize(dev)
    warp = phase_warp(dev)
    e2e = phase_end_to_end(dev)
    kernels = [
        {"name": "planarize", "route": "cuda",
         "source": "gs360x_torch/csrc/planarize.cu",
         "replaces": "gs360x/kernels/warp_pallas.py:3234",
         "launches": e2e["launches"]["planarize"],
         "max_abs_err": plan["max_abs_err"], "ms": plan["ms"],
         "plain_ms": plan["plain_ms"]},
        {"name": "warp_equirect", "route": "cuda",
         "source": "gs360x_torch/csrc/warp_equirect.cu",
         "replaces": "gs360x/kernels/warp_pallas.py:1032",
         "launches": e2e["launches"]["warp"],
         "max_abs_err": warp["max_abs_err"], "ms": warp["ms"],
         "plain_ms": warp["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
