"""gs360x-torch-scene — inspect/normalize camera-pose scenes.

Port of :mod:`gs360x.tools.scene`, with the same flags, messages, files and
exit codes. Nothing here runs on a device, so it has no ``--device``.

Headless CLI over :mod:`gs360x_torch.io.scene` (the GUI-support loader
rebuilt from ``gs360_CameraPoseScene``): loads any supported scene format into the
common display space, prints a summary + normalization log, and optionally
exports the normalized point cloud (with camera positions as colored
markers) to a PLY for external viewers.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from gs360x_torch.io import scene as scenelib


def create_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=("Load a scene (COLMAP dir / transforms.json / "
                     "RealityScan CSV / XMP dir / Metashape XML) into the "
                     "common display space and summarize it."))
    ap.add_argument("source", help="Scene source path (auto-detected)")
    ap.add_argument("--ply", default=None,
                    help="Companion point cloud for transforms/CSV inputs")
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1600)
    ap.add_argument("--export-ply", default=None,
                    help="Write the normalized points (+ camera markers)")
    ap.add_argument("--camera-marker-color", default="255,64,64")
    return ap


def main(argv=None) -> int:
    try:
        return _main(argv)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv=None) -> int:
    args = create_arg_parser().parse_args(argv)
    try:
        scene = scenelib.load_scene(args.source, ply_path=args.ply,
                                    width=args.width, height=args.height)
    except (ValueError, OSError) as exc:
        print(f"[ERR] {exc}", file=sys.stderr)
        return 1

    print(f"[INFO] {scene.info_text}")
    for line in scene.normalization_log:
        print(f"[norm] {line}")
    if len(scene.points_xyz):
        mn = scene.points_xyz.min(axis=0)
        mx = scene.points_xyz.max(axis=0)
        print("[aabb] min=({:.4g}, {:.4g}, {:.4g}) max=({:.4g}, {:.4g}, "
              "{:.4g})".format(*mn, *mx))
    for pose in scene.cameras[:5]:
        c = pose.center
        print(f"[cam] {pose.name}: center=({c[0]:.4g}, {c[1]:.4g}, "
              f"{c[2]:.4g}) half_fov_w={np.degrees(np.arctan(pose.frustum_half_w)):.1f}°")
    if len(scene.cameras) > 5:
        print(f"[cam] ... {len(scene.cameras) - 5} more")

    if args.export_ply:
        from gs360x_torch.io.ply import save_ply_xyz_rgb

        color = np.array([int(x) for x in
                          args.camera_marker_color.split(",")], np.uint8)
        cam_xyz = np.array([p.center for p in scene.cameras],
                           np.float32).reshape(-1, 3)
        cam_rgb = np.tile(color, (len(cam_xyz), 1))
        xyz = np.concatenate([scene.points_xyz, cam_xyz]) \
            if len(scene.points_xyz) else cam_xyz
        rgb = np.concatenate([scene.points_rgb, cam_rgb]) \
            if len(scene.points_rgb) else cam_rgb
        out = pathlib.Path(args.export_ply)
        out.parent.mkdir(parents=True, exist_ok=True)
        save_ply_xyz_rgb(out, xyz, rgb)
        print(f"[OK] normalized scene PLY: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
