"""Scene normalization: any supported camera/point format → one display
space.

Rebuild of ``gs360_CameraPoseScene``
(``cli_tools/gs360_CameraPoseScene.py``): loads a scene
from a COLMAP text dir, transforms.json (+PLY), RealityScan CSV (+PLY),
RealityScan XMP dir, or Metashape perspective XML, and normalizes
everything into a common "COLMAP-like display space": points (xyz f32 /
rgb u8), per-camera center + camera→world rotation + frustum half-extents,
plus a normalization log. The GUI's viewers (and any external consumer)
render this one representation.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from gs360x_torch.core import pose as posemath
from gs360x_torch.io.formats import (
    colmap_text, metashape, realityscan, transforms_json,
)
from gs360x_torch.io.formats.model import ColmapModel


@dataclass
class CameraPose:
    name: str
    center: np.ndarray          # (3,) world position, display space
    rotation_cw: np.ndarray     # (3, 3) camera→world, OpenCV camera frame
    frustum_half_w: float       # tan(hfov/2)
    frustum_half_h: float


@dataclass
class CameraPoseScene:
    source_kind: str
    source_path: pathlib.Path
    points_xyz: np.ndarray
    points_rgb: np.ndarray
    cameras: List[CameraPose]
    info_text: str = ""
    normalization_log: List[str] = field(default_factory=list)


def _poses_from_model(model: ColmapModel) -> List[CameraPose]:
    poses = []
    for img in model.images:
        cam = model.camera_for(img)
        fx, fy, _cx, _cy, w, h = cam.pinhole_intrinsics()
        poses.append(CameraPose(
            name=img.name,
            center=np.asarray(img.center, np.float32),
            rotation_cw=np.asarray(img.r_wc.T, np.float32),
            frustum_half_w=0.5 * w / max(abs(fx), 1e-6),
            frustum_half_h=0.5 * h / max(abs(fy), 1e-6)))
    return poses


def _points_from_model(model: ColmapModel):
    if not model.points:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    xyz = np.array([[p.x, p.y, p.z] for p in model.points], np.float32)
    rgb = np.array([[p.r, p.g, p.b] for p in model.points], np.uint8)
    return xyz, rgb


def _scene(kind, path, model: ColmapModel, log: List[str]) -> CameraPoseScene:
    xyz, rgb = _points_from_model(model)
    info = (f"{kind}: {len(model.images)} camera(s), "
            f"{len(xyz):,} point(s)")
    return CameraPoseScene(source_kind=kind, source_path=pathlib.Path(path),
                           points_xyz=xyz, points_rgb=rgb,
                           cameras=_poses_from_model(model), info_text=info,
                           normalization_log=log)


def load_scene_from_colmap_dir(source_dir) -> CameraPoseScene:
    d = pathlib.Path(source_dir).expanduser().resolve()
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        if not (d / name).is_file():
            raise ValueError("COLMAP text model requires cameras.txt, "
                             "images.txt, and points3D.txt")
    model = colmap_text.read_model(d)
    return _scene("colmap", d, model,
                  ["COLMAP model is already in display space"])


def load_scene_from_transforms(json_path, ply_path=None) -> CameraPoseScene:
    model = transforms_json.model_from_transforms(
        json_path, x_fix_deg=posemath.TRANSFORMS_X_FIX_DEG)
    log = [f"undid transforms.json +{posemath.TRANSFORMS_X_FIX_DEG:g}° "
           "world X fix"]
    if ply_path:
        from gs360x_torch.io import ply as plyio

        xyz, rgb = plyio.load_ply_xyz_rgb(ply_path)
        model.points = realityscan.transforms_ply_vertices_to_points(xyz, rgb)
        log.append(f"undid companion-PLY +{posemath.POINTCLOUD_PLY_X_DEG:g}° "
                   "X rotation")
    return _scene("transforms", json_path, model, log)


def load_scene_from_realityscan_csv(csv_path, ply_path=None, *,
                                    width: int = 1600,
                                    height: int = 1600) -> CameraPoseScene:
    rows = realityscan.read_csv_rows(csv_path)
    model = realityscan.model_from_csv_rows(
        rows, width, height, sensor_w_mm=36.0, sensor_h_mm=36.0)
    log = ["converted RealityScan heading/pitch/roll + Z-up axis to COLMAP"]
    if ply_path:
        from gs360x_torch.io import ply as plyio

        xyz, rgb = plyio.load_ply_xyz_rgb(ply_path)
        model.points = realityscan.rs_vertices_to_points(xyz, rgb)
        log.append("converted RealityScan PLY axis to COLMAP")
    return _scene("realityscan-csv", csv_path, model, log)


def load_scene_from_realityscan_xmp(xmp_dir, *, width: int = 1600,
                                    height: int = 1600,
                                    image_ext: str = "jpg") -> CameraPoseScene:
    rows = realityscan.read_xmp_dir(xmp_dir, image_ext=image_ext)
    model = realityscan.model_from_xmp_rows(
        rows, width, height, sensor_w_mm=36.0, sensor_h_mm=36.0)
    return _scene("realityscan-xmp", xmp_dir, model,
                  ["converted RealityScan XMP rotations to COLMAP"])


def load_scene_from_metashape_xml(xml_path, *, image_ext: str = "jpg"
                                  ) -> CameraPoseScene:
    records, w, h = metashape.read_perspective_xml(xml_path,
                                                   image_ext=image_ext)
    model = metashape.model_from_perspective_records(records, w, h)
    return _scene("metashape-xml", xml_path, model,
                  ["Metashape perspective transforms are already CV c2w"])


def load_scene(path, *, ply_path=None, width: int = 1600,
               height: int = 1600) -> CameraPoseScene:
    """Auto-detect the scene format from the path."""
    p = pathlib.Path(path).expanduser().resolve()
    if p.is_dir():
        if (p / "cameras.txt").exists():
            return load_scene_from_colmap_dir(p)
        if list(p.glob("*.xmp")):
            return load_scene_from_realityscan_xmp(p, width=width,
                                                   height=height)
        raise ValueError(f"cannot detect scene format in directory: {p}")
    suffix = p.suffix.lower()
    if suffix == ".json":
        return load_scene_from_transforms(p, ply_path)
    if suffix == ".csv":
        return load_scene_from_realityscan_csv(p, ply_path, width=width,
                                               height=height)
    if suffix == ".xml":
        return load_scene_from_metashape_xml(p)
    raise ValueError(f"unsupported scene source: {p}")


def frustum_segments(pose: CameraPose, scale: float = 1.0) -> np.ndarray:
    """Wireframe segments (N, 2, 3) of a camera frustum for rendering."""
    hw, hh = pose.frustum_half_w * scale, pose.frustum_half_h * scale
    corners_cam = np.array([
        [-hw, -hh, 1.0], [hw, -hh, 1.0], [hw, hh, 1.0], [-hw, hh, 1.0],
    ]) * scale
    corners = (pose.rotation_cw @ corners_cam.T).T + pose.center
    apex = pose.center
    segs = []
    for i in range(4):
        segs.append([apex, corners[i]])
        segs.append([corners[i], corners[(i + 1) % 4]])
    return np.asarray(segs, np.float32)
