"""Software point-cloud rasterizer for the scene viewer.

Rebuild of the reference GUI's PLY viewer
(``gs360_GUI.py:13614-13762``): a numpy z-buffered splat
renderer with a quaternion orbit camera, perspective/orthographic
projection, ground grid and axis gizmos, and interactive LOD subsampling
(100k points while dragging / 5M static — reference constants ``:141-148``).
Pure arrays in, RGB image out — headless-testable; the Tk layer only blits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from gs360x_torch.core import pose as posemath

INTERACTIVE_POINT_BUDGET = 100_000
STATIC_POINT_BUDGET = 5_000_000


@dataclass
class OrbitCamera:
    """Quaternion orbit camera around a target point."""

    target: np.ndarray = field(default_factory=lambda: np.zeros(3))
    distance: float = 10.0
    quat: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)  # wxyz
    fov_deg: float = 50.0
    ortho: bool = False

    def rotation(self) -> np.ndarray:
        return posemath.mat3_from_quat_wxyz(*self.quat)

    def orbit(self, dx_deg: float, dy_deg: float) -> None:
        """Apply a screen-space drag: yaw about world-up, pitch about the
        camera's right axis."""
        r = self.rotation()
        yaw = posemath.axis_angle_mat3([0, 1, 0], dx_deg)
        pitch = posemath.axis_angle_mat3(r[:, 0], dy_deg)
        new_r = pitch @ yaw @ r
        self.quat = posemath.quat_wxyz_from_mat3(new_r)

    def zoom(self, factor: float) -> None:
        self.distance = float(np.clip(self.distance * factor, 1e-3, 1e6))

    def pan(self, dx: float, dy: float) -> None:
        r = self.rotation()
        self.target = self.target + r[:, 0] * dx + r[:, 1] * dy

    def eye(self) -> np.ndarray:
        return self.target + self.rotation()[:, 2] * self.distance

    def fit(self, xyz: np.ndarray) -> None:
        if len(xyz) == 0:
            return
        mn, mx = xyz.min(axis=0), xyz.max(axis=0)
        self.target = (mn + mx) / 2.0
        self.distance = max(float(np.linalg.norm(mx - mn)), 1e-3) * 1.2


def render_points(xyz: np.ndarray, rgb: np.ndarray, camera: OrbitCamera,
                  width: int, height: int, *, splat: int = 1,
                  point_budget: Optional[int] = None,
                  background=(24, 24, 28), grid: bool = True,
                  axes: bool = True,
                  segments: Optional[np.ndarray] = None,
                  segment_color=(255, 96, 96)) -> np.ndarray:
    """Render a point cloud to an (H, W, 3) uint8 image.

    ``segments`` optionally draws wireframes (N, 2, 3) — camera frusta.
    """
    img = np.empty((height, width, 3), np.uint8)
    img[:] = np.asarray(background, np.uint8)
    zbuf = np.full((height, width), np.inf, np.float32)

    if point_budget and len(xyz) > point_budget:
        stride = int(math.ceil(len(xyz) / point_budget))
        xyz = xyz[::stride]
        rgb = rgb[::stride]

    r = camera.rotation()
    eye = camera.eye()

    def project(points: np.ndarray):
        cam = (points - eye) @ r  # world -> camera (r columns are axes)
        x, y, z = cam[:, 0], cam[:, 1], -cam[:, 2]  # +z in front
        if camera.ortho:
            scale = height / max(camera.distance, 1e-6)
            u = width / 2 + x * scale
            v = height / 2 - y * scale
            depth = z
            visible = np.ones(len(points), bool)
        else:
            f = (height / 2) / math.tan(math.radians(camera.fov_deg) / 2)
            visible = z > 1e-6
            zs = np.where(visible, z, 1.0)
            u = width / 2 + f * x / zs
            v = height / 2 - f * y / zs
            depth = z
        return u, v, depth, visible

    def splat_points(points, colors, size):
        if len(points) == 0:
            return
        u, v, depth, visible = project(points)
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        ok = (visible & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height))
        ui, vi, depth = ui[ok], vi[ok], depth[ok]
        cols = colors[ok] if len(colors) == len(points) else \
            np.broadcast_to(colors, (int(ok.sum()), 3))
        # z-buffer via sort-descending then overwrite (nearest wins)
        order = np.argsort(-depth)
        ui, vi, depth, cols = ui[order], vi[order], depth[order], cols[order]
        for dy in range(size):
            for dx in range(size):
                yy = np.clip(vi + dy - size // 2, 0, height - 1)
                xx = np.clip(ui + dx - size // 2, 0, width - 1)
                closer = depth < zbuf[yy, xx] + 1e-9
                yyc, xxc = yy[closer], xx[closer]
                zbuf[yyc, xxc] = depth[closer]
                img[yyc, xxc] = cols[closer]

    if grid:
        extent = camera.distance * 2
        n = 21
        ticks = np.linspace(-extent, extent, n)
        pts = []
        for t in ticks:
            for s in np.linspace(-extent, extent, 128):
                pts.append([t, 0.0, s])
                pts.append([s, 0.0, t])
        gp = np.asarray(pts) + camera.target * np.array([1.0, 0.0, 1.0])
        splat_points(gp, np.array([60, 60, 66], np.uint8), 1)

    if axes:
        L = camera.distance * 0.5
        for axis, color in ((np.array([1, 0, 0]), (230, 80, 80)),
                            (np.array([0, 1, 0]), (80, 220, 80)),
                            (np.array([0, 0, 1]), (90, 120, 255))):
            line = camera.target + np.outer(np.linspace(0, L, 96), axis)
            splat_points(line, np.array(color, np.uint8), 2)

    if segments is not None and len(segments):
        for a, b in segments.reshape(-1, 2, 3):
            line = a + np.outer(np.linspace(0, 1, 48), b - a)
            splat_points(line, np.array(segment_color, np.uint8), 1)

    splat_points(np.asarray(xyz, np.float64), np.asarray(rgb, np.uint8),
                 max(1, splat))
    return img
