"""Cubic resampling of an (H, W, C) source at continuous coordinates
(pixel centres at integers), with the two boundary rules the tools use.

- Equirect sources (perspcut): columns wrap modulo W; a tap row past a pole
  reflects over it (``-1 - y`` at the top, ``2H - 1 - y`` at the bottom)
  and continues on the opposite meridian, half a width away (ffmpeg v360's
  ``reflecty``).
- Lens images (dualfisheye): rows and columns clamp to the image.

Kernels: ``bicubic``, the 4-point Lagrange interpolation of v360's
``interp=cubic`` (nodes -1, 0, 1, 2); ``catmull-rom``, the Keys cubic with
a = -0.5 (the dual-fisheye tool's ``--interpolation cubic``).
"""

from __future__ import annotations

import torch


def cubic_weights(t: torch.Tensor, kernel: str):
    """The four tap weights at fractional offset ``t`` in [0, 1)."""
    t2 = t * t
    t3 = t2 * t
    if kernel == "bicubic":
        return (-t / 3 + t2 / 2 - t3 / 6, 1 - t / 2 - t2 + t3 / 2,
                t + t2 / 2 - t3 / 2, -t / 6 + t3 / 6)
    if kernel == "catmull-rom":
        return (-0.5 * t3 + t2 - 0.5 * t, 1.5 * t3 - 2.5 * t2 + 1,
                -1.5 * t3 + 2 * t2 + 0.5 * t, 0.5 * t3 - 0.5 * t2)
    raise ValueError(f"unknown cubic kernel {kernel!r}")


def sample_cubic(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                 kernel: str, equirect: bool) -> torch.Tensor:
    """(H, W, C) ``src`` at (u, v) of any shape → (*u.shape, C), in
    ``src``'s dtype: 16 taps, a row of four weighted along x, the rows
    weighted along y."""
    h, w, c = src.shape
    flat = src.reshape(h * w, c)
    x0f, y0f = torch.floor(u), torch.floor(v)
    wx = cubic_weights(u - x0f, kernel)
    wy = cubic_weights(v - y0f, kernel)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    out = None
    for dy in range(4):
        yy = y0 + (dy - 1)
        if equirect:
            over = (yy < 0) | (yy >= h)
            yy = torch.where(yy < 0, -1 - yy,
                             torch.where(yy >= h, 2 * h - 1 - yy, yy))
            shift = torch.where(over, w // 2, 0)
        yy = yy.clamp(0, h - 1)
        row = None
        for dx in range(4):
            xx = x0 + (dx - 1)
            xx = torch.remainder(xx + shift, w) if equirect \
                else xx.clamp(0, w - 1)
            tap = flat[(yy * w + xx).reshape(-1)].reshape(*u.shape, c) \
                * wx[dx][..., None]
            row = tap if row is None else row + tap
        term = row * wy[dy][..., None]
        out = term if out is None else out + term
    return out


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """Float [0, 1] → u8: ``rint(clamp(x, 0, 1) · 255)``, half to even."""
    return torch.round(x.clamp(0, 1) * 255).to(torch.uint8)
