"""The plain torch twin of :mod:`gs360x.kernels.warp` — the gather-interp
warp engine.

Design: ``dst pixel grid → unit ray (camera) → rotate → source UV →
N-tap gather interpolation``, batched over views. It runs on either
device. It is the reference the CUDA kernels are held to (on the card, in
``chip_smoke.py``) and the ``--backend xla`` stand-in of the port.

Interpolation matches ffmpeg v360's kernels: ``bilinear``; ``bicubic`` =
the 4-point Lagrange weights of v360's ``calculate_bicubic_coeffs``;
``nearest`` for masks. The longitude seam wraps modulo W; with
``pole_reflect`` a tap row past a pole reflects over it with a half-width
column shift (v360 ``reflecty``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from gs360x_torch.core import camera as cam

# --------------------------------------------------------------------------
# Rotation helpers
# --------------------------------------------------------------------------


def _rot_x(rad: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(rad), torch.sin(rad)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([o, z, z], -1),
        torch.stack([z, c, -s], -1),
        torch.stack([z, s, c], -1),
    ], -2)


def _rot_y(rad: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(rad), torch.sin(rad)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, z, s], -1),
        torch.stack([z, o, z], -1),
        torch.stack([-s, z, c], -1),
    ], -2)


def _rot_z(rad: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(rad), torch.sin(rad)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z], -1),
        torch.stack([s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as elementwise f32 products and sums: no
    matrix-product kernel, so no reduced-precision (TF32/bf16) pass."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def view_rotation(yaw_deg: torch.Tensor, pitch_deg: torch.Tensor,
                  roll_deg: torch.Tensor) -> torch.Tensor:
    """Camera→world rotation(s) in the warp frame (y down, z forward):
    ``Ry(yaw) · Rx(pitch) · Rz(roll)``. Positive yaw pans right, positive
    pitch looks up. Angles broadcast; returns (..., 3, 3) in full f32 (a
    reduced-precision rotation shifts warp coordinates by 0.5+ px)."""
    d = math.pi / 180.0
    ryx = _compose(_rot_y(yaw_deg * d), _rot_x(pitch_deg * d))
    return _compose(ryx, _rot_z(roll_deg * d))


def rotate_rays(rays: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Apply 3x3 rotation(s) ``r`` (..., 3, 3) to a ray field (..., 3) as
    elementwise multiply-adds (full f32, broadcasting over leading dims)."""
    x, y, z = rays[..., 0], rays[..., 1], rays[..., 2]
    return torch.stack([
        r[..., 0, 0] * x + r[..., 0, 1] * y + r[..., 0, 2] * z,
        r[..., 1, 0] * x + r[..., 1, 1] * y + r[..., 1, 2] * z,
        r[..., 2, 0] * x + r[..., 2, 1] * y + r[..., 2, 2] * z,
    ], dim=-1)


# --------------------------------------------------------------------------
# Interpolation weights
# --------------------------------------------------------------------------


def lagrange_cubic_weights(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """4-point Lagrange interpolation weights at fractional offset t∈[0,1).

    Exactly ffmpeg v360's ``interp=cubic`` kernel (nodes at -1, 0, 1, 2)."""
    tt = t * t
    ttt = tt * t
    w0 = -t / 3.0 + tt / 2.0 - ttt / 6.0
    w1 = 1.0 - t / 2.0 - tt + ttt / 2.0
    w2 = t + tt / 2.0 - ttt / 2.0
    w3 = -t / 6.0 + ttt / 6.0
    return w0, w1, w2, w3


def catmull_rom_weights(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Catmull-Rom (Keys a=-0.5) cubic weights."""
    tt = t * t
    ttt = tt * t
    w0 = -0.5 * ttt + tt - 0.5 * t
    w1 = 1.5 * ttt - 2.5 * tt + 1.0
    w2 = -1.5 * ttt + 2.0 * tt + 0.5 * t
    w3 = 0.5 * ttt - 0.5 * tt
    return w0, w1, w2, w3


# --------------------------------------------------------------------------
# Gather-based samplers
# --------------------------------------------------------------------------


def _flat_gather(src_flat: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Gather pixels from a flattened (H*W, C) source by integer coords."""
    idx = yi * width + xi
    return src_flat[idx.reshape(-1)].reshape(*yi.shape, -1)


def _wrap_x(xi: torch.Tensor, width: int, wrap: bool) -> torch.Tensor:
    if wrap:
        return torch.remainder(xi, width)
    return torch.clamp(xi, 0, width - 1)


def _reflect_y(yi: torch.Tensor, h: int):
    """v360 ``reflecty`` tap-row boundary: a row past a pole reflects
    (``-1-y`` top / ``2h-1-y`` bottom) and the sample continues over the
    pole onto the opposite meridian — the caller shifts the column by
    ``w/2`` wherever ``over`` is set. Returns ``(y_reflected, over)``."""
    over_top = yi < 0
    over_bot = yi >= h
    y_ref = torch.where(over_top, -1 - yi,
                        torch.where(over_bot, 2 * h - 1 - yi, yi))
    return torch.clamp(y_ref, 0, h - 1), over_top | over_bot


def _half_shift(over: torch.Tensor, w: int) -> torch.Tensor:
    return torch.where(over, w // 2, 0)


def sample_bilinear(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                    wrap_x: bool = False,
                    pole_reflect: bool = False) -> torch.Tensor:
    """Bilinear sample of src (H, W, C) at continuous coords (u right, v
    down; pixel centers at integers). Returns (*u.shape, C)."""
    h, w = src.shape[0], src.shape[1]
    src_flat = src.reshape(h * w, -1)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0r = y0.to(torch.int64)
    if pole_reflect:
        y0i, ov0 = _reflect_y(y0r, h)
        y1i, ov1 = _reflect_y(y0r + 1, h)
        sh0 = _half_shift(ov0, w)
        sh1 = _half_shift(ov1, w)
        p00 = _flat_gather(src_flat, y0i, _wrap_x(x0i + sh0, w, True), w)
        p01 = _flat_gather(src_flat, y0i,
                           _wrap_x(x0i + 1 + sh0, w, True), w)
        p10 = _flat_gather(src_flat, y1i, _wrap_x(x0i + sh1, w, True), w)
        p11 = _flat_gather(src_flat, y1i,
                           _wrap_x(x0i + 1 + sh1, w, True), w)
    else:
        y0i = torch.clamp(y0r, 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        xa = _wrap_x(x0i, w, wrap_x)
        xb = _wrap_x(x0i + 1, w, wrap_x)
        p00 = _flat_gather(src_flat, y0i, xa, w)
        p01 = _flat_gather(src_flat, y0i, xb, w)
        p10 = _flat_gather(src_flat, y1i, xa, w)
        p11 = _flat_gather(src_flat, y1i, xb, w)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def sample_nearest(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                   wrap_x: bool = False,
                   pole_reflect: bool = False) -> torch.Tensor:
    h, w = src.shape[0], src.shape[1]
    src_flat = src.reshape(h * w, -1)
    # torch.round rounds half to even, like jnp.round
    xr = torch.round(u).to(torch.int64)
    yr = torch.round(v).to(torch.int64)
    if pole_reflect:
        yi, over = _reflect_y(yr, h)
        xi = _wrap_x(xr + _half_shift(over, w), w, True)
    else:
        xi = _wrap_x(xr, w, wrap_x)
        yi = torch.clamp(yr, 0, h - 1)
    return _flat_gather(src_flat, yi, xi, w)


def sample_bicubic(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                   wrap_x: bool = False,
                   pole_reflect: bool = False) -> torch.Tensor:
    """16-tap separable Lagrange cubic sample (v360 interp=cubic)."""
    h, w = src.shape[0], src.shape[1]
    src_flat = src.reshape(h * w, -1)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    wxs = lagrange_cubic_weights(fx)
    wys = lagrange_cubic_weights(fy)
    out = None
    for dy in range(4):
        if pole_reflect:
            yi, over = _reflect_y(y0i + (dy - 1), h)
            shift = _half_shift(over, w)
        else:
            yi = torch.clamp(y0i + (dy - 1), 0, h - 1)
            shift = None
        row_acc = None
        for dx in range(4):
            xt = x0i + (dx - 1)
            if shift is not None:
                xi = _wrap_x(xt + shift, w, True)
            else:
                xi = _wrap_x(xt, w, wrap_x)
            tap = _flat_gather(src_flat, yi, xi, w) * wxs[dx][..., None]
            row_acc = tap if row_acc is None else row_acc + tap
        term = row_acc * wys[dy][..., None]
        out = term if out is None else out + term
    return out


_SAMPLERS = {
    "bilinear": sample_bilinear,
    "nearest": sample_nearest,
    "bicubic": sample_bicubic,
}


def remap(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
          interp: str = "bilinear", wrap_x: bool = False,
          pole_reflect: bool = False,
          valid: Optional[torch.Tensor] = None,
          fill: float = 0.0) -> torch.Tensor:
    """General remap (``cv2.remap`` semantics): sample src at (u, v) with
    the chosen kernel, filling invalid coords with ``fill``.
    ``pole_reflect`` selects v360's equirect tap boundary."""
    sampler = _SAMPLERS[interp]
    out = sampler(src, u, v, wrap_x=wrap_x, pole_reflect=pole_reflect)
    if valid is not None:
        out = torch.where(valid[..., None], out,
                          torch.tensor(fill, dtype=out.dtype,
                                       device=out.device))
    return out


# --------------------------------------------------------------------------
# View-cut coordinate maps
# --------------------------------------------------------------------------


def view_uv_from_equirect(width: int, height: int, hfov_deg: float,
                          vfov_deg: float, projection: str,
                          yaw_deg, pitch_deg, roll_deg,
                          src_w: int, src_h: int, dtype=torch.float32,
                          device: Optional[torch.device] = None):
    """Source-UV map (and validity) of view cut(s) from an equirect pano.

    ``yaw/pitch/roll`` are scalars or (V,) tensors; with (V,) angles the
    maps come out (V, height, width)."""
    if projection == "perspective":
        rays = cam.perspective_rays(width, height, hfov_deg, vfov_deg, dtype,
                                    device)
        valid = None
    elif projection in ("fisheye_v360", "equisolid"):
        model = "equidistant" if projection == "fisheye_v360" else "equisolid"
        rays, valid = cam.fisheye_rays(width, height, hfov_deg, model=model,
                                       dtype=dtype, device=device)
    else:
        raise ValueError(f"unknown projection: {projection!r}")
    r = view_rotation(torch.as_tensor(yaw_deg, dtype=dtype, device=device),
                      torch.as_tensor(pitch_deg, dtype=dtype, device=device),
                      torch.as_tensor(roll_deg, dtype=dtype, device=device))
    # broadcast (V, 1, 1, 3, 3) rotations over the (H, W, 3) ray field
    world = rotate_rays(rays, r[..., None, None, :, :])
    u, v = cam.equirect_uv(world, src_w, src_h)
    return u, v, valid


def warp_equirect_to_views(src: torch.Tensor, yaws, pitches, rolls, *,
                           width: int, height: int,
                           hfov_deg: float, vfov_deg: float,
                           projection: str = "perspective",
                           interp: str = "bicubic") -> torch.Tensor:
    """Cut V views out of an equirect image, all views in one batch.

    Args:
      src: (H, W, C) float source panorama (any device).
      yaws/pitches/rolls: (V,) per-view angles in degrees.
    Returns: (V, height, width, C) float on ``src``'s device.
    """
    dev = src.device
    src_h, src_w = src.shape[0], src.shape[1]
    as_f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                               device=dev)
    u, v, valid = view_uv_from_equirect(
        width, height, hfov_deg, vfov_deg, projection,
        as_f32(yaws).reshape(-1), as_f32(pitches).reshape(-1),
        as_f32(rolls).reshape(-1), src_w, src_h, device=dev)
    return remap(src, u, v, interp=interp, wrap_x=True, pole_reflect=True,
                 valid=valid)
