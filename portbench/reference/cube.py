"""The ``.cube`` 3D LUT decode of D-Log M footage, the plain way: parse the
file (``LUT_3D_SIZE``, ``DOMAIN_MIN``/``DOMAIN_MAX``, rows with red
varying fastest), look each pixel up trilinearly, then take the Rec.709
result to sRGB (the dual-fisheye tool's default
``--lut-output-color-space srgb``): the Rec.709 OETF inverted
(0.081 / 4.5 / 0.099 / 1.099 / 0.45), the sRGB OETF (0.0031308 / 12.92 /
1.055 / 2.4), clipped to [0, 1].
"""

from __future__ import annotations

import pathlib

import torch


def read_cube(path: pathlib.Path):
    """(table indexed [r, g, b, channel] as float64, domain min, max)."""
    size, lo, hi, rows = None, [0.0] * 3, [1.0] * 3, []
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#") or parts[0] == "TITLE":
            continue
        if parts[0] == "LUT_3D_SIZE":
            size = int(parts[1])
        elif parts[0] == "DOMAIN_MIN":
            lo = [float(p) for p in parts[1:4]]
        elif parts[0] == "DOMAIN_MAX":
            hi = [float(p) for p in parts[1:4]]
        else:
            rows.append([float(p) for p in parts[:3]])
    table = torch.tensor(rows, dtype=torch.float64).reshape(size, size, size,
                                                            3)
    return table.permute(2, 1, 0, 3).contiguous(), lo, hi


def apply_lut(rgb: torch.Tensor, lut) -> torch.Tensor:
    """Trilinear lookup of (..., 3) floats, in ``rgb``'s dtype."""
    table, lo, hi = lut
    n = table.shape[0]
    table = table.to(device=rgb.device, dtype=rgb.dtype)
    idx, frac = [], []
    for c in range(3):
        t = ((rgb[..., c] - lo[c]) / (hi[c] - lo[c])).clamp(0, 1) * (n - 1)
        i0 = torch.floor(t).clamp(0, n - 2)
        idx.append(i0.to(torch.int64))
        frac.append((t - i0)[..., None])
    flat = table.reshape(-1, 3)
    out = 0
    for dr in (0, 1):
        wr = frac[0] if dr else 1 - frac[0]
        for dg in (0, 1):
            wg = frac[1] if dg else 1 - frac[1]
            for db in (0, 1):
                wb = frac[2] if db else 1 - frac[2]
                at = ((idx[0] + dr) * n + idx[1] + dg) * n + idx[2] + db
                out = out + flat[at] * (wr * wg * wb)
    return out


def rec709_to_srgb(v: torch.Tensor) -> torch.Tensor:
    v = v.clamp(0, 1)
    lin = torch.where(v < 0.081, v / 4.5, ((v + 0.099) / 1.099) ** (1 / 0.45))
    lin = lin.clamp(0, 1)
    out = torch.where(lin <= 0.0031308, 12.92 * lin,
                      1.055 * lin ** (1 / 2.4) - 0.055)
    return out.clamp(0, 1)
