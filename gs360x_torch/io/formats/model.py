"""Canonical COLMAP-style scene model and its pose algebra.

Conventions (identical to COLMAP and the reference converter):

* ``Image`` stores the world→camera rotation as a wxyz quaternion plus
  ``t = -R_wc @ C`` where ``C`` is the camera center in world coords.
* Camera frame is OpenCV: +x right, +y down, +z forward.
* World transforms (rotate/scale about the origin) act on camera centers
  and orientations: ``C' = R_world C``, ``R_wc' = R_wc R_worldᵀ``
  (``gs360_CameraFormatConverter.py:1351-1446``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from gs360x_torch.core import pose as posemath


@dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: List[float]

    def pinhole_intrinsics(self) -> Tuple[float, float, float, float, int, int]:
        """(fx, fy, cx, cy, w, h) for PINHOLE / SIMPLE_PINHOLE / OPENCV."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            f, cx, cy = p[0], p[1], p[2]
            return f, f, cx, cy, self.width, self.height
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return fx, fy, cx, cy, self.width, self.height


@dataclass
class Image:
    image_id: int
    qw: float
    qx: float
    qy: float
    qz: float
    tx: float
    ty: float
    tz: float
    camera_id: int
    name: str
    points2d_line: str = ""

    @property
    def r_wc(self) -> np.ndarray:
        return posemath.mat3_from_quat_wxyz(self.qw, self.qx, self.qy, self.qz)

    @property
    def t_wc(self) -> np.ndarray:
        return np.array([self.tx, self.ty, self.tz])

    @property
    def center(self) -> np.ndarray:
        return -(self.r_wc.T @ self.t_wc)

    def c2w_gl(self) -> np.ndarray:
        return posemath.c2w_gl_from_colmap_pose(self.r_wc, self.t_wc)

    @classmethod
    def from_pose(cls, image_id: int, r_wc: np.ndarray, t_wc: np.ndarray,
                  camera_id: int, name: str) -> "Image":
        qw, qx, qy, qz = posemath.quat_wxyz_from_mat3(r_wc)
        return cls(image_id=image_id, qw=qw, qx=qx, qy=qy, qz=qz,
                   tx=float(t_wc[0]), ty=float(t_wc[1]), tz=float(t_wc[2]),
                   camera_id=camera_id, name=name)

    @classmethod
    def from_c2w_gl(cls, image_id: int, c2w_gl: np.ndarray, camera_id: int,
                    name: str, x_fix_deg: float = 0.0) -> "Image":
        r_wc, t = posemath.colmap_pose_from_c2w_gl(c2w_gl, x_fix_deg)
        return cls.from_pose(image_id, r_wc, t, camera_id, name)


@dataclass
class Point3:
    id: int
    x: float
    y: float
    z: float
    r: int
    g: int
    b: int
    err: float = 0.0
    track_tokens: List[str] = field(default_factory=list)


@dataclass
class ColmapModel:
    cameras: Dict[int, Camera] = field(default_factory=dict)
    images: List[Image] = field(default_factory=list)
    points: List[Point3] = field(default_factory=list)

    def camera_for(self, img: Image) -> Camera:
        return self.cameras[img.camera_id]

    def add_camera(self, model: str, width: int, height: int,
                   params: List[float], *, single: bool = False) -> int:
        """Add (or reuse) a camera; dedupes by rounded intrinsics unless
        ``single`` forces one shared camera."""
        if single and self.cameras:
            return next(iter(self.cameras))
        key = (model, width, height, tuple(round(p, 6) for p in params))
        for cam in self.cameras.values():
            if (cam.model, cam.width, cam.height,
                    tuple(round(p, 6) for p in cam.params)) == key:
                return cam.camera_id
        cam_id = max(self.cameras, default=0) + 1
        self.cameras[cam_id] = Camera(cam_id, model, width, height,
                                      list(params))
        return cam_id

    # ---- world transforms ------------------------------------------------

    def rotate_cameras(self, rot_world: np.ndarray) -> None:
        for i, img in enumerate(self.images):
            r_wc = img.r_wc
            center = img.center
            r_new = r_wc @ rot_world.T
            c_new = rot_world @ center
            t_new = r_new @ (-c_new)
            self.images[i] = Image.from_pose(img.image_id, r_new, t_new,
                                             img.camera_id, img.name)
            self.images[i].points2d_line = img.points2d_line

    def scale_cameras(self, scale: float) -> None:
        if abs(scale - 1.0) <= 1e-12:
            return
        for img in self.images:
            c_new = img.center * scale
            t_new = img.r_wc @ (-c_new)
            img.tx, img.ty, img.tz = (float(t_new[0]), float(t_new[1]),
                                      float(t_new[2]))

    def rotate_points(self, rot_world: np.ndarray) -> None:
        for pt in self.points:
            v = rot_world @ np.array([pt.x, pt.y, pt.z])
            pt.x, pt.y, pt.z = float(v[0]), float(v[1]), float(v[2])

    def scale_points(self, scale: float) -> None:
        if abs(scale - 1.0) <= 1e-12:
            return
        for pt in self.points:
            pt.x *= scale
            pt.y *= scale
            pt.z *= scale


def world_rotation_xyz_deg(rx: float, ry: float, rz: float) -> np.ndarray:
    """World rotation applied X, then Y, then Z (reference order)."""
    return (posemath.rot_z_deg(rz) @ posemath.rot_y_deg(ry)
            @ posemath.rot_x_deg(rx))


# ---- focal conversions ------------------------------------------------------


def focal_pixels_to_mm(fx: float, fy: float, w: int, h: int,
                       sensor_w_mm: float, sensor_h_mm: float) -> float:
    return 0.5 * (fx * sensor_w_mm / w + fy * sensor_h_mm / h)


def focal_mm_to_pixels(f_mm: float, w: int, h: int, sensor_w_mm: float,
                       sensor_h_mm: float) -> Tuple[float, float]:
    return f_mm * w / sensor_w_mm, f_mm * h / sensor_h_mm
