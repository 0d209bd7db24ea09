"""Pose / rotation algebra and the axis-convention constants.

All functions are numpy (host-side — pose math touches at most thousands of
cameras, never pixels). The conventions mirror the reference toolkit so that
exported metadata is interchangeable:

* Canonical camera model = COLMAP: world→camera rotation ``R_wc`` stored as a
  wxyz quaternion plus translation ``t = -R_wc @ C`` (camera center ``C``).
  (``cli_tools/gs360_CameraFormatConverter.py:397-544``.)
* OpenGL camera frame: +x right, +y up, -z forward. OpenCV/COLMAP camera
  frame: +x right, +y down, +z forward. ``CV_TO_GL`` flips y and z
  (``cli_tools/gs360_MS360xmlToPersCams.py:232-237``).
* Dataset axis fixes (``gs360_MS360xmlToPersCams.py:57-64``):
  transforms.json c2w gets a +270° world X rotation, COLMAP +0°, companion
  PLY points +180° X, RealityScan uses ``REALITYSCAN_AXIS``.
* View rotations: positive yaw pans right, positive pitch looks up.
  ``yaw_pitch_to_rot_gl`` matches
  ``gs360_MS360xmlToPersCams.py:348-353`` (GL camera frame ⇒ yaw negated);
  :func:`view_rotation_cv` is the same physical rotation expressed in the
  y-down/z-forward warp frame used by :mod:`gs360x_torch.kernels.warp`.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np

# ---- axis-convention constants (shared across exporters) -------------------

TRANSFORMS_X_FIX_DEG = 270.0      # c2w world X fix baked into transforms.json
COLMAP_X_BASE_DEG = 0.0
POINTCLOUD_PLY_X_DEG = 180.0      # companion PLY rotated to match transforms
REALITYSCAN_AXIS = np.array([
    [1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0],
    [0.0, 1.0, 0.0],
])

CV_TO_GL = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])

# ---- elementary rotations ---------------------------------------------------


def rot_x_deg(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rot_y_deg(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rot_z_deg(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def axis_angle_mat3(axis: Iterable[float], deg: float) -> np.ndarray:
    """Rodrigues rotation about an arbitrary (auto-normalized) axis."""
    a = np.asarray(list(axis), dtype=np.float64)
    n = float(np.linalg.norm(a))
    if n <= 0.0 or abs(deg) < 1e-12:
        return np.eye(3)
    x, y, z = a / n
    r = math.radians(deg)
    c, s, t = math.cos(r), math.sin(r), 1.0 - math.cos(r)
    return np.array([
        [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
        [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
        [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
    ])


def normalize_angle_deg(a: float) -> float:
    """Wrap to (-180, 180], with -180 mapped to +180."""
    a = ((a + 180.0) % 360.0) - 180.0
    return 180.0 if abs(a + 180.0) < 1e-6 else a


# ---- view rotations ---------------------------------------------------------


def yaw_pitch_to_rot_gl(yaw_deg: float, pitch_deg: float) -> np.ndarray:
    """Camera→world rotation of a (yaw, pitch) virtual view, GL camera frame.

    Positive yaw pans right; because GL looks down -z with +y up, that is a
    *negative* rotation about the world Y axis.
    """
    return rot_y_deg(-float(yaw_deg)) @ rot_x_deg(float(pitch_deg))


def view_rotation_cv(yaw_deg: float, pitch_deg: float, roll_deg: float = 0.0) -> np.ndarray:
    """Camera→world rotation in the warp frame (x right, y down, z forward).

    ``d_world = R @ d_cam``; yaw pans right (+longitude), pitch looks up.
    """
    return rot_y_deg(float(yaw_deg)) @ rot_x_deg(float(pitch_deg)) @ rot_z_deg(float(roll_deg))


# ---- 4x4 helpers ------------------------------------------------------------


def mat4_from_rt(r: np.ndarray, t: Iterable[float] = (0.0, 0.0, 0.0)) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = list(t)
    return m


def apply_x_fix_gl(c2w_gl: np.ndarray, deg: float) -> np.ndarray:
    """Pre-rotate a GL c2w matrix by a world X rotation (dataset axis fix)."""
    if deg is None or abs(deg) < 1e-6:
        return c2w_gl
    return mat4_from_rt(rot_x_deg(deg)) @ c2w_gl


def colmap_pose_from_c2w_gl(c2w_gl: np.ndarray, x_fix_deg: float = 0.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """GL c2w → COLMAP (R_wc, t) after an optional world X fix.

    Mirrors ``gs360_MS360xmlToPersCams.py:393-399``: convert the camera frame
    GL→CV, transpose to world→camera, then ``t = R_wc @ (-C)``.
    """
    c2w_cv = apply_x_fix_gl(np.asarray(c2w_gl, dtype=np.float64), x_fix_deg) @ CV_TO_GL
    r_wc = c2w_cv[:3, :3].T
    t = r_wc @ (-c2w_cv[:3, 3])
    return r_wc, t


def c2w_gl_from_colmap_pose(r_wc: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Inverse of :func:`colmap_pose_from_c2w_gl` (with x_fix 0)."""
    r_wc = np.asarray(r_wc, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    c2w_cv = np.eye(4)
    c2w_cv[:3, :3] = r_wc.T
    c2w_cv[:3, 3] = -(r_wc.T @ t)
    return c2w_cv @ CV_TO_GL  # CV_TO_GL is its own inverse


def apply_unit_scale(mat4: np.ndarray, scale: float) -> np.ndarray:
    out = np.array(mat4, dtype=np.float64, copy=True)
    out[:3, 3] *= scale
    return out


# ---- quaternions (wxyz) -----------------------------------------------------


def quat_wxyz_from_mat3(r) -> Tuple[float, float, float, float]:
    """Rotation matrix → unit quaternion (w, x, y, z), Shepperd branching."""
    r = np.asarray(r, dtype=np.float64)
    trace = r[0, 0] + r[1, 1] + r[2, 2]
    if trace > 0.0:
        s = math.sqrt(trace + 1.0) * 2.0
        qw = 0.25 * s
        qx = (r[2, 1] - r[1, 2]) / s
        qy = (r[0, 2] - r[2, 0]) / s
        qz = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = math.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2.0
        qw = (r[2, 1] - r[1, 2]) / s
        qx = 0.25 * s
        qy = (r[0, 1] + r[1, 0]) / s
        qz = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] > r[2, 2]:
        s = math.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2.0
        qw = (r[0, 2] - r[2, 0]) / s
        qx = (r[0, 1] + r[1, 0]) / s
        qy = 0.25 * s
        qz = (r[1, 2] + r[2, 1]) / s
    else:
        s = math.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2.0
        qw = (r[1, 0] - r[0, 1]) / s
        qx = (r[0, 2] + r[2, 0]) / s
        qy = (r[1, 2] + r[2, 1]) / s
        qz = 0.25 * s
    n = math.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    if n == 0.0:
        return 1.0, 0.0, 0.0, 0.0
    return qw / n, qx / n, qy / n, qz / n


def mat3_from_quat_wxyz(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    n = math.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    if n == 0.0:
        return np.eye(3)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])
