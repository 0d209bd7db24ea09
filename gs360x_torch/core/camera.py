"""Camera projection models and field-of-view algebra (torch port of
:mod:`gs360x.core.camera`).

* **Scalar algebra** (plain Python floats): focal↔FOV conversions used
  when building render plans and metadata.
* **Ray models** (torch, float32 by default): map output pixel grids to
  unit ray directions in the camera frame, and unit rays in the source
  frame to equirect pixel coordinates.

Conventions are ffmpeg ``v360``'s, as in the JAX package: camera frame
``+x`` right, ``+y`` down, ``+z`` forward; longitude ``phi = atan2(x, z)``
maps to ``u``, latitude ``theta = asin(y)`` maps to ``v``; pixel centers
sit at half-integer offsets.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# --------------------------------------------------------------------------
# Scalar FOV / focal algebra (host-side, plan building)
# --------------------------------------------------------------------------


def hfov_from_focal_mm(f_mm: float, sensor_w_mm: float) -> float:
    """Horizontal FOV (deg) of a rectilinear lens: 2*atan(w / 2f)."""
    return math.degrees(2.0 * math.atan(sensor_w_mm / (2.0 * f_mm)))


def focal_mm_from_hfov(hfov_deg: float, sensor_w_mm: float) -> float:
    """Rectilinear focal length (mm) from horizontal FOV (deg)."""
    return sensor_w_mm / (2.0 * math.tan(math.radians(hfov_deg) / 2.0))


def vfov_from_hfov(hfov_deg: float, width: int, height: int) -> float:
    """Vertical FOV (deg) implied by an hfov and a pixel aspect ratio."""
    half_h = math.tan(math.radians(hfov_deg) / 2.0) * (height / float(width))
    return math.degrees(2.0 * math.atan(half_h))


def vfov_from_sensor(f_mm: float, sensor_h_mm: float) -> float:
    """Vertical FOV (deg) from focal length and sensor height."""
    return math.degrees(2.0 * math.atan(sensor_h_mm / (2.0 * f_mm)))


def focal_px(f_mm: float, sensor_w_mm: float, width_px: int) -> float:
    """Focal length in pixels (the Metashape 'f' users precalibrate with)."""
    return f_mm / (sensor_w_mm / float(width_px))


def focal_35mm_equivalent(f_mm: float, sensor_long_mm: float) -> float:
    """35mm-equivalent focal length (quoted for RealityScan)."""
    return f_mm * (36.0 / sensor_long_mm)


# --------------------------------------------------------------------------
# Pixel grids
# --------------------------------------------------------------------------


def _pixel_ndc(width: int, height: int, dtype=torch.float32,
               device: Optional[torch.device] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized device coords at pixel centers, in [-1, 1].

    v360's convention ``(2*i + 1)/W - 1``. Returns ``(nx, ny)`` each of
    shape ``(height, width)``; ``ny`` grows downward.
    """
    xs = (2.0 * torch.arange(width, dtype=dtype, device=device) + 1.0) \
        / width - 1.0
    ys = (2.0 * torch.arange(height, dtype=dtype, device=device) + 1.0) \
        / height - 1.0
    ny, nx = torch.meshgrid(ys, xs, indexing="ij")
    return nx, ny


# --------------------------------------------------------------------------
# Destination models: pixel grid -> unit rays (camera frame)
# --------------------------------------------------------------------------


def perspective_rays(width: int, height: int, hfov_deg: float,
                     vfov_deg: float, dtype=torch.float32,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Unit rays for a rectilinear (perspective) image. Shape (H, W, 3)."""
    nx, ny = _pixel_ndc(width, height, dtype, device)
    half_w = math.tan(math.radians(hfov_deg) / 2.0)
    half_h = math.tan(math.radians(vfov_deg) / 2.0)
    x = nx * half_w
    y = ny * half_h
    z = torch.ones_like(x)
    d = torch.stack([x, y, z], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def fisheye_rays(width: int, height: int, dfov_deg: float, *,
                 model: str = "equidistant", dtype=torch.float32,
                 device: Optional[torch.device] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit rays for a circular-fisheye image. Shape (H, W, 3) plus the
    validity mask of the image circle (radius 1 in NDC).

    ``equidistant`` is v360's ``output=fisheye``; ``equisolid`` uses
    r = 2 f sin(theta/2).
    """
    nx, ny = _pixel_ndc(width, height, dtype, device)
    r = torch.sqrt(nx * nx + ny * ny)
    half_fov = math.radians(dfov_deg) / 2.0
    if model == "equidistant":
        theta = r * half_fov
    elif model == "equisolid":
        s = torch.clamp(r * math.sin(half_fov / 2.0), -1.0, 1.0)
        theta = 2.0 * torch.asin(s)
    else:
        raise ValueError(f"unknown fisheye model: {model!r}")
    valid = r <= 1.0
    sin_t = torch.sin(theta)
    # avoid 0/0 at the exact center
    safe_r = torch.where(r > 1e-12, r, torch.ones_like(r))
    x = sin_t * (nx / safe_r)
    y = sin_t * (ny / safe_r)
    z = torch.cos(theta)
    return torch.stack([x, y, z], dim=-1), valid


# --------------------------------------------------------------------------
# Source model: unit rays (source frame) -> continuous pixel coords
# --------------------------------------------------------------------------


def equirect_uv(rays: torch.Tensor, width: int, height: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map unit rays to equirect pixel coords (continuous, pixel-center
    at .0). ``u`` wraps horizontally; the sampler wraps it modulo W.
    v360's xyz_to_equirect: ``u = (phi/pi + 1) * W/2 - 0.5``.
    """
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    phi = torch.atan2(x, z)
    theta = torch.asin(torch.clamp(y, -1.0, 1.0))
    u = (phi / math.pi + 1.0) * (width / 2.0) - 0.5
    v = (theta / (math.pi / 2.0) + 1.0) * (height / 2.0) - 0.5
    return u, v


def fisheye_uv(rays: torch.Tensor, width: int, height: int, dfov_deg: float,
               *, model: str = "equidistant"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map unit rays to circular-fisheye pixel coords (``equidistant``:
    r = θ / half-FOV; ``equisolid``: r = sin(θ/2) / sin(half-FOV/2)).
    Returns (u, v, valid): valid inside the image circle and the FOV."""
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    theta = torch.acos(torch.clamp(z, -1.0, 1.0))
    half_fov = math.radians(dfov_deg) / 2.0
    if model == "equidistant":
        r = theta / half_fov
    elif model == "equisolid":
        r = torch.sin(theta / 2.0) / math.sin(half_fov / 2.0)
    else:
        raise ValueError(f"unknown fisheye model: {model!r}")
    h = torch.sqrt(x * x + y * y)
    safe_h = torch.where(h > 1e-12, h, torch.ones_like(h))
    nx = r * x / safe_h
    ny = r * y / safe_h
    valid = (r <= 1.0) & (theta <= half_fov)
    u = (nx + 1.0) * (width / 2.0) - 0.5
    v = (ny + 1.0) * (height / 2.0) - 0.5
    return u, v, valid
