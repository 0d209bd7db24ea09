"""Import/export orchestration around the canonical COLMAP model.

Mirrors the reference's one-hub design
(``gs360_CameraFormatConverter.py:1488-1596``): every input becomes a
:class:`~gs360x_torch.io.formats.model.ColmapModel`; every export derives from it.
"""

from __future__ import annotations

import pathlib
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from gs360x_torch.core import pose as posemath
from gs360x_torch.io.formats import (
    colmap_text, metashape, realityscan, transforms_json,
)
from gs360x_torch.io.formats.model import (
    ColmapModel, focal_pixels_to_mm, world_rotation_xyz_deg,
)

DEFAULT_SENSOR_W_MM = 36.0
DEFAULT_SENSOR_H_MM = 36.0
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp", ".exr"}


@dataclass
class ExportOptions:
    out_dir: pathlib.Path
    sensor_width_mm: float = DEFAULT_SENSOR_W_MM
    sensor_height_mm: float = DEFAULT_SENSOR_H_MM
    transforms_x_fix_deg: float = posemath.TRANSFORMS_X_FIX_DEG
    export_colmap: bool = False
    export_csv: bool = False
    export_ply: bool = False
    export_transforms: bool = False
    export_transforms_ply: bool = False
    export_xmp: bool = False
    export_metashape_xml: bool = False
    csv_name: str = "Align_RS_PerspCams.csv"
    ply_name: str = "Align_RS_PerspCams.ply"
    transforms_name: str = "transforms.json"
    transforms_ply_name: str = "pointcloud_for_transforms.ply"
    xmp_dir_name: str = "cameras_RealityScan"
    metashape_xml_name: str = "perspective_cams.xml"
    colmap_dir_name: str = "colmap"
    # world transforms applied before export
    camera_rot_deg: tuple = (0.0, 0.0, 0.0)
    pointcloud_rot_deg: tuple = (0.0, 0.0, 0.0)
    camera_scale: float = 1.0
    pointcloud_scale: float = 1.0


def apply_world_transforms(model: ColmapModel, opts: ExportOptions) -> None:
    if any(abs(v) > 1e-9 for v in opts.camera_rot_deg):
        model.rotate_cameras(world_rotation_xyz_deg(*opts.camera_rot_deg))
    if abs(opts.camera_scale - 1.0) > 1e-9:
        model.scale_cameras(opts.camera_scale)
    if any(abs(v) > 1e-9 for v in opts.pointcloud_rot_deg):
        model.rotate_points(world_rotation_xyz_deg(*opts.pointcloud_rot_deg))
    if abs(opts.pointcloud_scale - 1.0) > 1e-9:
        model.scale_points(opts.pointcloud_scale)


def list_image_files(image_dir) -> List[pathlib.Path]:
    d = pathlib.Path(image_dir)
    return sorted(p for p in d.iterdir()
                  if p.is_file() and p.suffix.lower() in IMAGE_EXTS)


def map_stem_to_image_name(image_dir) -> Dict[str, str]:
    if not image_dir:
        return {}
    return {p.stem: p.name for p in list_image_files(image_dir)}


def infer_image_size_from_dir(image_dir):
    from gs360x_torch.io.image import read_image

    for path in list_image_files(image_dir):
        try:
            img = read_image(path)
        except Exception:
            continue
        h, w = img.shape[:2]
        if w > 0 and h > 0:
            return int(w), int(h)
    raise ValueError(f"failed to read any image for size inference in "
                     f"{image_dir}")


def export_model(model: ColmapModel, opts: ExportOptions) -> List[str]:
    """Run the selected exports; returns log lines."""
    from gs360x_torch.io import ply as plyio

    out_dir = pathlib.Path(opts.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logs: List[str] = []

    if opts.export_colmap:
        d = out_dir / opts.colmap_dir_name
        colmap_text.write_model(d, model)
        logs.append(f"[OK] COLMAP text: {d}")

    # derive RS rows / xmp records / transforms frames per image
    csv_rows = []
    xmp_records = []
    for img in model.images:
        cam = model.camera_for(img)
        fx, fy, _cx, _cy, w, h = cam.pinhole_intrinsics()
        focal_mm = focal_pixels_to_mm(fx, fy, w, h, opts.sensor_width_mm,
                                      opts.sensor_height_mm)
        center_rs = realityscan.colmap_world_to_rs_world(img.center)
        r_xmp = realityscan.colmap_rot_to_rs_rot(img.r_wc)
        heading, pitch, roll = realityscan.rs_rotation_to_hpr(r_xmp)
        csv_rows.append(realityscan.make_csv_row(
            img.name, center_rs[0], center_rs[1], center_rs[2],
            heading, pitch, roll, focal_mm))
        xmp_records.append({"name": img.name, "r_xmp": r_xmp,
                            "pos_rs": center_rs, "focal_mm": focal_mm})

    if opts.export_csv:
        path = out_dir / opts.csv_name
        realityscan.write_csv_rows(path, csv_rows)
        logs.append(f"[OK] RealityScan CSV: {path}")

    if opts.export_ply:
        if model.points:
            xyz, rgb = realityscan.points_to_rs_vertices(model.points)
            path = out_dir / opts.ply_name
            plyio.save_ply_xyz_rgb(path, xyz, rgb)
            logs.append(f"[OK] RealityScan PLY: {path}")
        else:
            logs.append("[WARN] no points; RealityScan PLY skipped")

    if opts.export_transforms_ply:
        if model.points:
            xyz, rgb = realityscan.points_to_transforms_ply_vertices(
                model.points)
            path = out_dir / opts.transforms_ply_name
            plyio.save_ply_xyz_rgb(path, xyz, rgb)
            logs.append(f"[OK] transforms PLY: {path}")
        else:
            logs.append("[WARN] no points; transforms PLY skipped")

    if opts.export_transforms:
        frames, intr = transforms_json.frames_from_model(
            model, x_fix_deg=opts.transforms_x_fix_deg)
        path = out_dir / opts.transforms_name
        transforms_json.write_transforms(path, frames, intr)
        logs.append(f"[OK] transforms.json: {path}")

    if opts.export_xmp:
        d = out_dir / opts.xmp_dir_name
        realityscan.write_xmp_dir(d, xmp_records)
        logs.append(f"[OK] RealityScan XMP: {d}")

    if opts.export_metashape_xml:
        path = out_dir / opts.metashape_xml_name
        metashape.write_perspective_xml(path, model)
        logs.append(f"[OK] Metashape XML: {path}")

    return logs
