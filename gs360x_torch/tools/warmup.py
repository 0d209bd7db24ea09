"""gs360x-torch-warmup — build the kernel library and run every kernel
class a production run would use once, ahead of time.

The counterpart of ``gs360x-warmup``. On the card the compile cache is the
kernel library that :func:`gs360x_torch.kernels._build.load` builds from
``gs360x_torch/csrc`` at first use into ``build/gs360x_torch/`` (one
``nvcc`` a source, in parallel); a checkout that has it starts hot. This
tool builds it (or says it is already there), then runs one dummy frame
through the warp of every (preset view set × interp) combination asked
for, the source pass included, and fetches each output; with ``--all`` also
the dual-fisheye SFM10 remap. ``--device cuda`` (the default) raises
without a card; ``--device cpu`` runs the plain versions.

Examples::

    gs360x-torch-warmup --src 7680x3840 --size 1600 --preset default
    gs360x-torch-warmup --src 5760x2880 --size 1600 --preset fisheyelike \\
                        --interp bicubic bilinear
    gs360x-torch-warmup --all
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

from gs360x_torch.device import DEVICE_CHOICES, resolve_device


def parse_wh(text: str):
    for sep in ("x", "X", ","):
        if sep in text:
            w, h = text.split(sep, 1)
            return int(w), int(h)
    raise argparse.ArgumentTypeError(f"expected WxH, got {text!r}")


def build_arg_parser() -> argparse.ArgumentParser:
    from gs360x_torch.rig.presets import PRESET_CHOICES

    ap = argparse.ArgumentParser(
        description="Build the CUDA kernels and run the warp for given "
                    "shapes so production runs start hot.")
    ap.add_argument("--src", type=parse_wh, default=(7680, 3840),
                    help="Equirect source size WxH (default 7680x3840)")
    ap.add_argument("--size", type=int, nargs="+", default=[1600],
                    help="View sizes to warm (square px)")
    ap.add_argument("--preset", choices=PRESET_CHOICES, nargs="+",
                    default=["default"],
                    help="Presets whose view sets to warm")
    ap.add_argument("--interp", choices=["bicubic", "bilinear"], nargs="+",
                    default=["bicubic"])
    ap.add_argument("--all", action="store_true",
                    help="Warm the full production matrix: every preset at "
                         "its default size (plus the given --size list), "
                         "and the dual-fisheye SFM10 remap at 1750 px.")
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "available; cpu runs the plain versions")
    return ap


def build_kernels() -> str:
    """Load the kernel library, building it if this checkout has none;
    says which it was."""
    from gs360x_torch.kernels import _build

    loaded = _build.library_path is not None
    t0 = time.perf_counter()
    _build.load()
    if not loaded and _build.build_seconds > 0:
        return (f"[INFO] kernels built in {_build.build_seconds:.1f}s: "
                f"{_build.library_path}")
    return (f"[INFO] kernels already built: {_build.library_path} "
            f"(loaded in {time.perf_counter() - t0:.2f}s, no build)")


def warm_remap(src_size: int = 3840, view_px: int = 1750, *,
               device: torch.device) -> list:
    """Run the dual-fisheye direct-perspective remap (the first SFM10 view
    of the default Osmo 360 calibration) over a zero lens image, bicubic
    then bilinear; returns the two outputs, fetched."""
    from gs360x_torch import templates
    from gs360x_torch.kernels import remap_cuda
    from gs360x_torch.tools import dualfisheye as df

    calib_path = templates.default_osmo360_calibration_path()
    if not calib_path.exists():
        templates.write_osmo360_default_calibration(calib_path)
    sensor_map, _ = df.load_metashape_calibration(calib_path)
    calib = next(iter(sensor_map.values()))
    spec = df.build_sfm10_specs(view_px, 12.0, "36 36", 45.0, 45.0)[0]
    mx, my, valid = df.build_direct_perspective_map(
        calib, spec["yaw_deg"], spec["pitch_deg"], spec["hfov_deg"],
        spec["vfov_deg"], view_px, view_px, 190.0)
    prep = remap_cuda.PreparedRemap(mx, my, valid.astype(np.float32),
                                    src_w=src_size, src_h=src_size,
                                    device=device)
    frame = np.zeros((src_size, src_size * 3), np.uint8)
    return [prep(frame, interp=interp).cpu().numpy()
            for interp in ("bicubic", "bilinear")]


def view_sets(args) -> list:
    """``(preset, size, views)`` of every view set the tool warms, in its
    order: each ``--preset`` at each ``--size``, or with ``--all`` every
    preset at its own default size, then at each ``--size``; a view set
    already listed (a preset's default equal to an explicit size, etc.) is
    left out."""
    from gs360x_torch.rig.presets import (PRESET_CHOICES, PerspCutConfig,
                                          build_view_plan)

    combos = [(p, s, True) for p in args.preset for s in args.size]
    if args.all:
        # every preset at its own default size (size_explicit=False lets
        # the preset pick), plus the explicit --size list
        combos = [(p, args.size[0], False) for p in PRESET_CHOICES]
        combos += [(p, s, True) for p in PRESET_CHOICES
                   for s in args.size]
    sets = []
    seen = set()
    for preset, size, explicit in combos:
        cfg = PerspCutConfig(preset=preset, size=size,
                             size_explicit=explicit)
        plan = build_view_plan(cfg, [pathlib.Path("warmup.jpg")],
                               pathlib.Path("."))
        views = plan.unique_views()
        vkey = tuple(sorted((v.yaw_deg, v.pitch_deg, v.width, v.height,
                             v.hfov_deg, v.projection) for v in views))
        if vkey not in seen:
            seen.add(vkey)
            sets.append((preset, size, views))
    return sets


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)

    from gs360x_torch.runtime.executor import _warp_frame_views

    src_w, src_h = args.src
    rng = np.random.default_rng(0)
    frame = (rng.random((src_h, src_w, 3)) * 255).astype(np.uint8)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"[INFO] device: {name}  source {src_w}x{src_h}")
    if device.type == "cuda":
        print(build_kernels())
    if args.all:
        t0 = time.time()
        print("[INFO] warming dual-fisheye SFM10 remap (1750 px)")
        warm_remap(src_size=3840, device=device)
        print(f"[OK] remap warmed in {time.time() - t0:.1f}s")

    n = 0
    for preset, size, views in view_sets(args):
        for interp in args.interp:
            t0 = time.time()
            outs = _warp_frame_views(frame, views, interp=interp,
                                     backend="auto", device=device,
                                     quantize_bits=8)
            for out in {id(out): out for out, _j in outs}.values():
                out.cpu()
            n += 1
            print(f"[OK] {preset} size={size} {interp}: "
                  f"{len(views)} views in {time.time() - t0:.1f}s "
                  "(kernels warm)")
    print(f"[OK] warmed {n} configuration(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
