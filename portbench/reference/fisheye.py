"""SFM10 perspective views of a calibrated equisolid lens pair, the plain
way (gs360_DualFisheyeDistortionCalibration.py's direct perspective export).

A view pixel (i, j) looks along ``(tan(hfov/2) · x, -tan(vfov/2) · y, 1)``
with ``x, y = (j + 0.5)/w · 2 - 1, (i + 0.5)/h · 2 - 1`` (+y up), turned
by the view's pitch and then its yaw relative to the lens (y-up frame);
the equisolid model puts a ray at angle θ from the axis at radius
``2 sin(θ/2)`` on the normalized image plane, the Brown radial and
tangential terms distort it, and the calibration's f, cx, cy (and b1, b2)
place it in pixels. A pixel is valid where θ is inside half the lens FOV
and the source point inside the image. Each view takes the lens whose map
is valid on the larger share of the view (ties: the smaller yaw from the
lens axis). Invalid pixels get the fill value.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.resample import quantize_u8, sample_cubic
from portbench.reference.equirect import fov_deg


def wrap_deg(a: float) -> float:
    return ((float(a) + 180.0) % 360.0) - 180.0


def lens_map(calib: dict, yaw: float, pitch: float, hfov: float,
             vfov: float, size: int, lens_fov: float, dtype=torch.float64,
             device=None):
    """(map_x, map_y, valid), each (size, size), of one view on one lens
    (``yaw`` relative to the lens axis)."""
    ar = torch.arange(size, dtype=dtype, device=device)
    n = (ar + 0.5) / size * 2 - 1
    vv, uu = torch.meshgrid(n, n, indexing="ij")
    x = math.tan(math.radians(min(179.9, max(1e-3, hfov))) / 2) * uu
    y = math.tan(math.radians(min(179.9, max(1e-3, vfov))) / 2) * (-vv)
    z = torch.ones_like(x)
    norm = torch.sqrt(x * x + y * y + z * z).clamp_min(1e-12)
    x, y, z = x / norm, y / norm, z / norm
    cp, sp = math.cos(math.radians(pitch)), math.sin(math.radians(pitch))
    cy, sy = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
    y1 = cp * y + sp * z
    z1 = -sp * y + cp * z
    x2 = cy * x + sy * z1
    z2 = -sy * x + cy * z1
    theta = torch.acos(z2.clamp(-1, 1))
    rho = torch.sqrt(x2 * x2 + y1 * y1)
    scale = torch.where(rho > 1e-12,
                        2 * torch.sin(theta / 2) / rho.clamp_min(1e-12),
                        torch.zeros_like(rho))
    xn, yn = x2 * scale, -y1 * scale
    r2 = xn * xn + yn * yn
    k1, k2, k3, k4 = (calib.get(k, 0.0) for k in ("k1", "k2", "k3", "k4"))
    p1, p2 = calib.get("p1", 0.0), calib.get("p2", 0.0)
    b1, b2 = calib.get("b1", 0.0), calib.get("b2", 0.0)
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = xn * radial + p1 * (r2 + 2 * xn * xn) + 2 * p2 * xn * yn
    yd = yn * radial + p2 * (r2 + 2 * yn * yn) + 2 * p1 * xn * yn
    w, h = calib["width"], calib["height"]
    cx0, cy0 = w * 0.5 + calib["cx"], h * 0.5 + calib["cy"]
    f = calib["f"]
    map_x = cx0 + xd * (f + b1) + yd * b2
    map_y = cy0 + yd * f
    half = math.radians(max(1.0, min(360.0, lens_fov)) * 0.5)
    valid = ((theta <= half) & (map_x >= 0) & (map_x <= w - 1)
             & (map_y >= 0) & (map_y <= h - 1))
    return map_x, map_y, valid


def view_maps(cfg: dict, dtype=torch.float64, device=None) -> dict:
    """``{view id: (lens "X" or "Y", map_x, map_y, valid)}`` of every SFM10
    view of the configuration, the lens chosen as the tool chooses it."""
    views = cfg["views"]
    hfov = fov_deg(views["focal_mm"], views["sensor_mm"][0])
    vfov = fov_deg(views["focal_mm"], views["sensor_mm"][1])
    out = {}
    for view in views["layout"]:
        best = None
        for lens, lens_yaw in (("X", cfg["lens_yaw_deg"][0]),
                               ("Y", cfg["lens_yaw_deg"][1])):
            rel = wrap_deg(view["yaw"] - lens_yaw)
            mx, my, valid = lens_map(cfg["calibration"], rel, view["pitch"],
                                     hfov, vfov, int(views["size"]),
                                     cfg["lens_fov_deg"], dtype, device)
            key = (float(valid.double().mean()), -abs(rel))
            if best is None or key > best[0]:
                best = (key, lens, mx, my, valid)
        out[view["id"]] = best[1:]
    return out


def render(source: torch.Tensor, maps: tuple, interp: str,
           fill: float) -> torch.Tensor:
    """One (size, size, 3) u8 view of a float (H, W, 3) source in [0, 1]
    through ``maps`` = (map_x, map_y, valid)."""
    mx, my, valid = maps
    out = sample_cubic(source, mx, my, kernel=interp, equirect=False)
    out = torch.where(valid[..., None], out,
                      torch.tensor(fill, dtype=out.dtype, device=out.device))
    return quantize_u8(out)
