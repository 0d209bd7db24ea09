"""Preview-overlay math: project view footprints onto the equirect pano.

Pure numpy mirror of the reference GUI's preview overlay
(``gs360_GUI.py:342-499``): sample each view's border rays,
map them to equirect pixel coordinates, split polylines at the longitude
seam, and compute a label anchor at the view center.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from gs360x_torch.core import pose as posemath
from gs360x_torch.rig.spec import ViewSpec


@dataclass
class ViewOverlay:
    view_id: str
    segments: List[np.ndarray]      # list of (N, 2) pixel polylines
    label_xy: Tuple[float, float]   # anchor for the view-id label


def _border_rays(view: ViewSpec, samples_per_edge: int = 24) -> np.ndarray:
    """Unit rays along the view border (camera frame, y-down z-forward)."""
    t = np.linspace(-1.0, 1.0, samples_per_edge)
    ones = np.ones_like(t)
    edges = np.concatenate([
        np.stack([t, -ones], 1),          # top
        np.stack([ones, t], 1),           # right
        np.stack([t[::-1], ones], 1),     # bottom
        np.stack([-ones, t[::-1]], 1),    # left
    ])
    if view.projection == "perspective":
        half_w = math.tan(math.radians(view.hfov_deg) / 2.0)
        half_h = math.tan(math.radians(view.vfov_deg) / 2.0)
        d = np.stack([edges[:, 0] * half_w, edges[:, 1] * half_h,
                      np.ones(len(edges))], 1)
    else:  # fisheye circle border
        ang = np.linspace(0, 2 * math.pi, 4 * samples_per_edge)
        half = math.radians(view.hfov_deg) / 2.0
        sin_t, cos_t = math.sin(half), math.cos(half)
        d = np.stack([sin_t * np.cos(ang), sin_t * np.sin(ang),
                      cos_t * np.ones_like(ang)], 1)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _rays_to_equirect_px(rays: np.ndarray, pano_w: int,
                         pano_h: int) -> np.ndarray:
    phi = np.arctan2(rays[:, 0], rays[:, 2])
    theta = np.arcsin(np.clip(rays[:, 1], -1.0, 1.0))
    u = (phi / math.pi + 1.0) * (pano_w / 2.0) - 0.5
    v = (theta / (math.pi / 2.0) + 1.0) * (pano_h / 2.0) - 0.5
    return np.stack([u, v], 1)


def _split_at_seam(points: np.ndarray, pano_w: int) -> List[np.ndarray]:
    """Break a polyline where it wraps across the longitude seam."""
    if len(points) < 2:
        return [points]
    segs: List[np.ndarray] = []
    start = 0
    for i in range(1, len(points)):
        if abs(points[i, 0] - points[i - 1, 0]) > pano_w / 2:
            segs.append(points[start:i])
            start = i
    segs.append(points[start:])
    return [s for s in segs if len(s) >= 2]


def view_overlay(view: ViewSpec, pano_w: int, pano_h: int,
                 samples_per_edge: int = 24) -> ViewOverlay:
    rays = _border_rays(view, samples_per_edge)
    rot = posemath.view_rotation_cv(view.yaw_deg, view.pitch_deg,
                                    view.roll_deg)
    world = rays @ rot.T
    px = _rays_to_equirect_px(world, pano_w, pano_h)
    center = rot @ np.array([0.0, 0.0, 1.0])
    label = _rays_to_equirect_px(center[None, :], pano_w, pano_h)[0]
    return ViewOverlay(view_id=view.view_id,
                       segments=_split_at_seam(px, pano_w),
                       label_xy=(float(label[0]), float(label[1])))


def plan_overlays(views: Sequence[ViewSpec], pano_w: int,
                  pano_h: int) -> List[ViewOverlay]:
    return [view_overlay(v, pano_w, pano_h) for v in views]
