"""Perspective views cut out of an equirect frame, the plain way.

Conventions (ffmpeg v360's, which 360PerspCut drives): camera frame +x
right, +y down, +z forward; a view's pixel (i, j) looks along
``((2j + 1)/w - 1) · tan(hfov/2), ((2i + 1)/h - 1) · tan(vfov/2), 1``,
turned by ``Ry(yaw) · Rx(pitch) · Rz(roll)``; longitude ``atan2(x, z)``
and latitude ``asin(y)`` map to ``u = (lon/π + 1) · W/2 - 0.5`` and
``v = (lat/(π/2) + 1) · H/2 - 0.5``. The views and their FOV come from the
configuration file (the preset's table: ids, yaw, pitch; focal length and
sensor width).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.resample import quantize_u8, sample_cubic


def fov_deg(focal_mm: float, sensor_mm: float) -> float:
    """The angle a rectilinear lens of ``focal_mm`` sees across
    ``sensor_mm``."""
    return math.degrees(2.0 * math.atan(sensor_mm / (2.0 * focal_mm)))


def _rotation(yaw: float, pitch: float, roll: float, dtype, device):
    """``Ry(yaw) · Rx(pitch) · Rz(roll)`` in ``dtype``."""
    def t(a):
        return torch.tensor(math.radians(a), dtype=dtype, device=device)
    cy, sy = torch.cos(t(yaw)), torch.sin(t(yaw))
    cp, sp = torch.cos(t(pitch)), torch.sin(t(pitch))
    cr, sr = torch.cos(t(roll)), torch.sin(t(roll))
    o, z = torch.ones_like(cy), torch.zeros_like(cy)
    ry = torch.stack([torch.stack([cy, z, sy]), torch.stack([z, o, z]),
                      torch.stack([-sy, z, cy])])
    rx = torch.stack([torch.stack([o, z, z]), torch.stack([z, cp, -sp]),
                      torch.stack([z, sp, cp])])
    rz = torch.stack([torch.stack([cr, -sr, z]), torch.stack([sr, cr, z]),
                      torch.stack([z, z, o])])
    return ((ry[:, :, None] * rx[None]).sum(1)[:, :, None]
            * rz[None]).sum(1)


def view_uv(view: dict, size: int, hfov: float, vfov: float, src_h: int,
            src_w: int, dtype=torch.float64, device=None):
    """Source coordinates (u, v), each (size, size), of one view."""
    ar = torch.arange(size, dtype=dtype, device=device)
    n = (2 * ar + 1) / size - 1
    ny, nx = torch.meshgrid(n, n, indexing="ij")
    x = nx * math.tan(math.radians(hfov) / 2)
    y = ny * math.tan(math.radians(vfov) / 2)
    z = torch.ones_like(x)
    norm = torch.sqrt(x * x + y * y + z * z)
    ray = torch.stack([x / norm, y / norm, z / norm], -1)
    r = _rotation(view["yaw"], view["pitch"], view.get("roll", 0.0), dtype,
                  device)
    world = (r[None, None] * ray[..., None, :]).sum(-1)
    lon = torch.atan2(world[..., 0], world[..., 2])
    lat = torch.asin(world[..., 1].clamp(-1, 1))
    u = (lon / math.pi + 1) * (src_w / 2) - 0.5
    v = (lat / (math.pi / 2) + 1) * (src_h / 2) - 0.5
    return u, v


def cut_view(frame_u8: torch.Tensor, view: dict, views_cfg: dict,
             dtype=torch.float64) -> torch.Tensor:
    """One (size, size, 3) u8 view of an (H, W, 3) u8 frame, computed in
    ``dtype`` on the frame's device."""
    h, w = frame_u8.shape[:2]
    size = int(views_cfg["size"])
    hfov = fov_deg(views_cfg["focal_mm"], views_cfg["sensor_mm"][0])
    vfov = fov_deg(views_cfg["focal_mm"], views_cfg["sensor_mm"][1])
    u, v = view_uv(view, size, hfov, vfov, h, w, dtype, frame_u8.device)
    src = frame_u8.to(dtype) / 255
    out = sample_cubic(src, u, v, kernel=views_cfg["interp"], equirect=True)
    return quantize_u8(out)
