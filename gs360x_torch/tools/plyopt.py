"""gs360x-torch-plyopt — point-cloud optimizer (PGM → 3DGS seeds), on an
NVIDIA GPU.

Port of :mod:`gs360x.tools.plyopt`: the same flags, messages, output files
and exit codes (1 on bad input, 130 on SIGINT), plus ``--device {cuda,cpu}``
(default ``cuda``; ``cuda`` without a card raises), where the voxel keys,
sorts and segment reductions of :mod:`gs360x_torch.kernels.voxel` run.

Rebuild of ``gs360_PlyOptimizer``
(``cli_tools/gs360_PlyOptimizer.py``): loads binary/ascii
PLY (incl. 3DGS ``f_dc_*`` colors) or a COLMAP text model; downsamples with
the device voxel kernels (fixed size, binary-search-to-target, one-pass
spatial hash, adaptive octree) with selectable per-voxel representatives;
appends extra PLYs; synthesizes a hemispherical sky dome; saves a PLY or a
COLMAP model with observation filtering.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional, Tuple

import numpy as np

from gs360x_torch.device import DEVICE_CHOICES, resolve_device
from gs360x_torch.kernels import voxel as vox
from gs360x_torch.runtime.profiling import StageTimers


def parse_sky_color(text: Optional[str]) -> np.ndarray:
    default = np.array([135, 206, 250], np.uint8)
    if not text or not text.strip():
        return default
    value = text.strip()
    if "," in value:
        parts = [p.strip() for p in value.split(",")]
        if len(parts) != 3:
            raise ValueError("expected R,G,B components")
        comps = [int(float(p)) for p in parts]
    elif value.startswith("#"):
        hexval = value[1:]
        if len(hexval) == 3:
            hexval = "".join(ch * 2 for ch in hexval)
        if len(hexval) != 6:
            raise ValueError("hex color must be #RGB or #RRGGBB")
        comps = [int(hexval[i:i + 2], 16) for i in (0, 2, 4)]
    else:
        raise ValueError("use #RRGGBB or R,G,B format")
    return np.array([max(0, min(255, c)) for c in comps], np.uint8)


def print_stats(xyz: np.ndarray, label: str = "input") -> None:
    if xyz.shape[0] == 0:
        print(f"[stats] {label}: empty cloud")
        return
    mn, mx = xyz.min(axis=0), xyz.max(axis=0)
    ext = mx - mn
    vol = float(np.prod(np.maximum(ext, 1e-12)))

    def f3(a):
        return "({:.6g}, {:.6g}, {:.6g})".format(*a)

    print(f"[stats] {label}: points={xyz.shape[0]:,}")
    print(f"[aabb] min={f3(mn)}  max={f3(mx)}  extent={f3(ext)}  "
          f"volume~{vol:.6g}")


def create_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="PointCloudOptimizer",
        description=("PGM to 3DGS point-cloud optimizer (PLY / COLMAP text "
                     "model, downsampling, append)"))
    ap.add_argument("-i", "--in", dest="input", required=True,
                    help="Input PLY file or COLMAP text-model folder")
    ap.add_argument("-o", "--out", dest="output", default=None,
                    help="Output PLY file or COLMAP folder (omit = stats only)")
    ap.add_argument("-t", "--target-points", type=int, default=None,
                    help="Target point count (overrides --voxel-size)")
    ap.add_argument("-r", "--target-percent", type=float, default=None,
                    help="Target percentage of the input point count")
    ap.add_argument("-v", "--voxel-size", type=float, default=None,
                    help="Fixed voxel size")
    ap.add_argument("--downsample-method",
                    choices=("voxel", "spatial-hash", "adaptive"),
                    default="voxel")
    ap.add_argument("--adaptive", action="store_true",
                    help="Alias for --downsample-method adaptive")
    ap.add_argument("--adaptive-weight", type=float, default=1.0)
    ap.add_argument("-a", "--append-ply", action="append", default=[],
                    help="Additional PLYs appended after downsampling")
    ap.add_argument("-k", "--keep-strategy",
                    choices=("centroid", "center", "first", "random"),
                    default="centroid")
    ap.add_argument("--sky-axis", choices=sorted(vox.SKY_AXES), default=None,
                    help="Add a synthetic sky dome from this axis")
    ap.add_argument("--sky-scale", type=float, default=100.0)
    ap.add_argument("--sky-count", type=int, default=4000)
    ap.add_argument("--sky-percent", type=float, default=50.0)
    ap.add_argument("--sky-color", type=str, default="#87cefa")
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "present; cpu runs the voxel path on the CPU")
    return ap


def load_input(path: pathlib.Path):
    """Returns (xyz, rgb, colmap_model_or_None)."""
    from gs360x_torch.io import ply as plyio
    from gs360x_torch.io.formats import colmap_text

    if path.is_dir():
        model = colmap_text.read_model(path)
        xyz = np.array([[p.x, p.y, p.z] for p in model.points], np.float32)
        rgb = np.array([[p.r, p.g, p.b] for p in model.points], np.uint8)
        if xyz.size == 0:
            xyz = xyz.reshape(0, 3)
            rgb = rgb.reshape(0, 3)
        return xyz, rgb, model
    xyz, rgb = plyio.load_ply_xyz_rgb(path)
    return xyz, rgb, None


def run_downsample(args, xyz, rgb, device
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dispatch the selected method. Returns (xyz, rgb, source_indices)
    where source index -1 marks synthesized points (none here)."""
    n = xyz.shape[0]
    target = args.target_points
    if args.target_percent is not None:
        target = max(1, int(round(n * args.target_percent / 100.0)))
        print(f"[target-percent] {args.target_percent:g}% of {n:,} "
              f"-> target={target:,}")
    method = "adaptive" if args.adaptive else args.downsample_method

    if method == "adaptive":
        if not target:
            print("[WARN] adaptive mode needs --target-points/--target-"
                  "percent; skipping downsample")
            return xyz, rgb, np.arange(n, dtype=np.int64)
        return vox.adaptive_voxel_downsample(
            xyz, rgb, target, weight_power=args.adaptive_weight,
            min_voxel_size=args.voxel_size,
            representative=args.keep_strategy)
    if method == "spatial-hash":
        if not target and not args.voxel_size:
            return xyz, rgb, np.arange(n, dtype=np.int64)
        return vox.spatial_hash_downsample(
            xyz, rgb, target_points=target, voxel_size=args.voxel_size,
            representative=args.keep_strategy, device=device)
    # default voxel mode
    if target:
        print(f"[target] input_points={n:,}  target={target:,}")
        return vox.voxel_downsample_to_target(
            xyz, rgb, target, representative=args.keep_strategy,
            device=device)
    if args.voxel_size:
        out = vox.voxel_downsample_by_size(
            xyz, rgb, args.voxel_size, representative=args.keep_strategy,
            device=device)
        print(f"[voxel] size={args.voxel_size:g} -> {out[0].shape[0]:,} points")
        return out
    return xyz, rgb, np.arange(n, dtype=np.int64)


def save_colmap_filtered(out_dir, model, xyz, rgb, source_idx) -> None:
    """Write a COLMAP model keeping only surviving points; image
    observations referencing dropped points are filtered out; synthesized
    points (source index -1) get fresh ids with empty tracks."""
    from gs360x_torch.io.formats import colmap_text
    from gs360x_torch.io.formats.model import ColmapModel, Point3

    kept_ids = set()
    new_model = ColmapModel(cameras=model.cameras, images=[], points=[])
    next_id = max((p.id for p in model.points), default=0) + 1
    by_row = {i: p for i, p in enumerate(model.points)}
    for row in range(xyz.shape[0]):
        src = int(source_idx[row]) if row < len(source_idx) else -1
        if src >= 0 and src in by_row:
            pt = by_row[src]
            kept_ids.add(pt.id)
            new_model.points.append(pt)
        else:
            new_model.points.append(Point3(
                id=next_id, x=float(xyz[row, 0]), y=float(xyz[row, 1]),
                z=float(xyz[row, 2]), r=int(rgb[row, 0]), g=int(rgb[row, 1]),
                b=int(rgb[row, 2])))
            next_id += 1

    for img in model.images:
        tokens = (img.points2d_line or "").split()
        kept_tokens = []
        for i in range(0, len(tokens) - 2, 3):
            x, y, pid = tokens[i], tokens[i + 1], tokens[i + 2]
            try:
                pid_i = int(pid)
            except ValueError:
                continue
            if pid_i < 0 or pid_i in kept_ids:
                kept_tokens.extend((x, y, pid))
        img.points2d_line = " ".join(kept_tokens)
        new_model.images.append(img)

    colmap_text.write_model(out_dir, new_model)


def main(argv=None, timers=None) -> int:
    """``timers``: a :class:`~gs360x_torch.runtime.profiling.StageTimers`
    that receives the wall of each stage (load, downsample, save) when
    given."""
    try:
        return _main(argv, timers or StageTimers())
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv, timers) -> int:
    args = create_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    in_path = pathlib.Path(args.input).expanduser().resolve()
    if not in_path.exists():
        print(f"[ERR] input not found: {in_path}", file=sys.stderr)
        return 1
    try:
        sky_color = parse_sky_color(args.sky_color)
    except ValueError as exc:
        print(f"[ERR] --sky-color: {exc}", file=sys.stderr)
        return 1

    try:
        with timers.stage("load"):
            xyz, rgb, model = load_input(in_path)
    except Exception as exc:
        print(f"[ERR] failed to load input: {exc}", file=sys.stderr)
        return 1
    print_stats(xyz)

    if args.output is None:
        return 0

    with timers.stage("downsample"):
        xyz_out, rgb_out, source_idx = run_downsample(args, xyz, rgb, device)

    # append extra PLYs (synthesized: source index -1)
    from gs360x_torch.io import ply as plyio
    base_dir = in_path if in_path.is_dir() else in_path.parent
    for extra in args.append_ply:
        p = pathlib.Path(extra)
        if not p.is_absolute():
            p = base_dir / p
        try:
            ax, ac = plyio.load_ply_xyz_rgb(p)
        except Exception as exc:
            print(f"[WARN] append failed for {p}: {exc}", file=sys.stderr)
            continue
        xyz_out = np.concatenate([xyz_out, ax])
        rgb_out = np.concatenate([rgb_out, ac])
        source_idx = np.concatenate(
            [source_idx, np.full(len(ax), -1, np.int64)])
        print(f"[append] {p.name}: +{len(ax):,} points")

    if args.sky_axis:
        center = xyz.mean(axis=0) if xyz.shape[0] else np.zeros(3)
        sky_xyz, sky_rgb = vox.generate_sky_points(
            center, np.array(vox.SKY_AXES[args.sky_axis], np.float64),
            args.sky_scale, max(1, args.sky_count), sky_color,
            sky_percent=args.sky_percent)
        xyz_out = np.concatenate([xyz_out, sky_xyz])
        rgb_out = np.concatenate([rgb_out, sky_rgb])
        source_idx = np.concatenate(
            [source_idx, np.full(len(sky_xyz), -1, np.int64)])
        print(f"[sky] axis={args.sky_axis} scale={args.sky_scale:g} "
              f"+{len(sky_xyz):,} points")

    print_stats(xyz_out, "output")
    with timers.stage("save"):
        out_path = pathlib.Path(args.output).expanduser().resolve()
        if model is not None and not out_path.suffix:
            save_colmap_filtered(out_path, model, xyz_out, rgb_out, source_idx)
            print(f"[OK] COLMAP model: {out_path}")
        else:
            from gs360x_torch.io.ply import save_ply_xyz_rgb

            out_path.parent.mkdir(parents=True, exist_ok=True)
            save_ply_xyz_rgb(out_path, xyz_out, rgb_out)
            print(f"[OK] PLY: {out_path} ({xyz_out.shape[0]:,} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
