"""Colour science (port of :mod:`gs360x.core.color`): transfer curves,
matrix moves, and the ``.cube`` 3D LUT.

Transfer-curve constants match the JAX package: Rec.709 OETF with the
0.081 / 4.5 / 1.099 / 0.45 spec values and the standard sRGB pair. Every
matrix move is written as explicit multiply-adds per output channel in the
JAX package's order, so no matrix product (and no TF32) is involved on the
card.

The ``.cube`` loader is host-side (tiny text files). The trilinear apply
runs on the tensor's device: the table lives there as one flat (N³·3) f32
tensor (:func:`lut_table`) and the eight taps are index gathers into it.
:func:`apply_cube_lut` takes (..., 3) tensors like the JAX function,
:func:`apply_cube_lut_planar` takes the (3, H, W) planes the card paths
carry.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# Transfer curves (electro-optical), all on [0, 1] float
# --------------------------------------------------------------------------


def rec709_to_linear(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    return torch.where(v < 0.081, v / 4.5,
                       ((v + 0.099) / 1.099) ** (1.0 / 0.45))


def linear_to_rec709(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    return torch.where(v < 0.018, v * 4.5, 1.099 * v ** 0.45 - 0.099)


def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    return torch.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    return torch.clamp(torch.where(v <= 0.0031308, 12.92 * v,
                                   1.055 * v ** (1.0 / 2.4) - 0.055),
                       0.0, 1.0)


def rec709_to_srgb(v: torch.Tensor) -> torch.Tensor:
    """The default video colour move's transfer half, and the dual-fisheye
    tool's ``--lut-output-color-space srgb``."""
    return linear_to_srgb(rec709_to_linear(v))


# D-Log M (DJI log curve), the published DJI constants
_DLOG_A, _DLOG_B, _DLOG_C, _DLOG_D = 0.9892, 0.0108, 0.256663, 0.584555


def dlog_m_to_linear(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    lin = (10.0 ** ((v - _DLOG_D) / _DLOG_C) - _DLOG_B) / _DLOG_A
    low = v * 0.9 / 14.0  # linear toe below cut
    return torch.where(v <= 0.14, low, torch.clamp(lin, min=0.0))


# --------------------------------------------------------------------------
# Matrix moves: RGB <-> YCbCr and primaries conversion
# --------------------------------------------------------------------------

_BT709 = (0.2126, 0.7152, 0.0722)
_BT601 = (0.299, 0.587, 0.114)


def _rgb_to_ycbcr_mat(coef: Tuple[float, float, float]) -> np.ndarray:
    kr, kg, kb = coef
    return np.array([
        [kr, kg, kb],
        [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
        [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
    ])


RGB_TO_YCBCR_BT709 = _rgb_to_ycbcr_mat(_BT709)
RGB_TO_YCBCR_BT601 = _rgb_to_ycbcr_mat(_BT601)
YCBCR_TO_RGB_BT709 = np.linalg.inv(RGB_TO_YCBCR_BT709)
YCBCR_TO_RGB_BT601 = np.linalg.inv(RGB_TO_YCBCR_BT601)


def luma_bt601(rgb: torch.Tensor) -> torch.Tensor:
    """Y of full-range BT.601 — what ffmpeg ``signalstats`` YAVG averages."""
    kr, kg, kb = _BT601
    return kr * rgb[..., 0] + kg * rgb[..., 1] + kb * rgb[..., 2]


def luma_bt709(rgb: torch.Tensor) -> torch.Tensor:
    kr, kg, kb = _BT709
    return kr * rgb[..., 0] + kg * rgb[..., 1] + kb * rgb[..., 2]


# Primaries: linear-RGB conversion BT.709 -> SMPTE-170M via XYZ (D65),
# the same standard matrices as gs360x.core.color.
_BT709_TO_XYZ = np.array([
    [0.4123908, 0.3575843, 0.1804808],
    [0.2126390, 0.7151687, 0.0721923],
    [0.0193308, 0.1191948, 0.9505322],
])
_SMPTE170M_TO_XYZ = np.array([
    [0.3935209, 0.3652581, 0.1916769],
    [0.2123764, 0.7010599, 0.0865638],
    [0.0187391, 0.1119339, 0.9583847],
])
BT709_TO_SMPTE170M = np.linalg.inv(_SMPTE170M_TO_XYZ) @ _BT709_TO_XYZ
SMPTE170M_TO_BT709 = np.linalg.inv(BT709_TO_SMPTE170M)


def _matrix_move(chans: Sequence[torch.Tensor], mat: np.ndarray,
                 dim: int) -> torch.Tensor:
    """``out[d] = Σ_c chans[c] · mat[d, c]`` (mat rounded to f32 as the
    JAX package casts it), three multiply-adds per output channel,
    stacked along ``dim``."""
    m = np.asarray(mat, np.float32)
    return torch.stack(
        [chans[0] * float(m[d, 0]) + chans[1] * float(m[d, 1])
         + chans[2] * float(m[d, 2]) for d in range(3)], dim=dim)


def apply_rgb_matrix(rgb: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """(..., 3) RGB through a 3×3 matrix: ``out[..., d] = Σ_c rgb[..., c]
    · mat[d, c]``."""
    return _matrix_move([rgb[..., c] for c in range(3)], mat, dim=-1)


def video_color_move_planar(rgb: torch.Tensor, *,
                            keep_rec709: bool = False) -> torch.Tensor:
    """The video colour chain on channel-first (..., 3, H, W) tensors:
    linearize Rec.709, convert primaries BT.709→SMPTE-170M, re-encode with
    sRGB (default) or the same Rec.709 curve (ffmpeg
    ``colorspace=iall=bt709:all=smpte170m[:trc=iec61966-2-1]``)."""
    lin = rec709_to_linear(rgb)
    moved = _matrix_move([lin[..., c, :, :] for c in range(3)],
                         BT709_TO_SMPTE170M, dim=-3)
    moved = torch.clamp(moved, 0.0, 1.0)
    return linear_to_rec709(moved) if keep_rec709 else linear_to_srgb(moved)


def video_color_move(rgb: torch.Tensor, *,
                     keep_rec709: bool = False) -> torch.Tensor:
    """:func:`video_color_move_planar` for channel-last (..., 3) tensors."""
    lin = rec709_to_linear(rgb)
    lin = torch.clamp(apply_rgb_matrix(lin, BT709_TO_SMPTE170M), 0.0, 1.0)
    return linear_to_rec709(lin) if keep_rec709 else linear_to_srgb(lin)


# --------------------------------------------------------------------------
# 3D LUT (.cube)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class CubeLUT:
    """A 3D colour LUT. ``table[r, g, b] -> rgb``; red is the fastest axis
    in the .cube file, and the table is stored indexed ``[r, g, b]``."""

    size: int
    table: np.ndarray          # (N, N, N, 3) float32, indexed [r, g, b]
    domain_min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    domain_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)


def load_cube_lut(path: str | pathlib.Path) -> CubeLUT:
    """Parse a .cube file (Adobe/Resolve format, LUT_3D_SIZE + rows):
    rows are ``r g b`` floats with the **red index varying fastest**."""
    size = None
    domain_min = (0.0, 0.0, 0.0)
    domain_max = (1.0, 1.0, 1.0)
    rows = []
    for raw in pathlib.Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == "TITLE":
            continue
        if key == "LUT_3D_SIZE":
            size = int(parts[1])
            continue
        if key == "DOMAIN_MIN":
            domain_min = tuple(float(x) for x in parts[1:4])
            continue
        if key == "DOMAIN_MAX":
            domain_max = tuple(float(x) for x in parts[1:4])
            continue
        if key == "LUT_1D_SIZE":
            raise ValueError("1D LUTs are not supported; expected LUT_3D_SIZE")
        try:
            rows.append([float(parts[0]), float(parts[1]), float(parts[2])])
        except (ValueError, IndexError):
            continue
    if size is None:
        raise ValueError(f"{path}: missing LUT_3D_SIZE")
    if len(rows) != size ** 3:
        raise ValueError(f"{path}: expected {size ** 3} rows, got {len(rows)}")
    # file order: r fastest, then g, then b -> reshape (b, g, r, 3), transpose
    table = np.asarray(rows, dtype=np.float32).reshape(size, size, size, 3)
    table = np.transpose(table, (2, 1, 0, 3)).copy()
    return CubeLUT(size=size, table=table, domain_min=domain_min,
                   domain_max=domain_max)


def lut_table(lut: CubeLUT, device: torch.device) -> torch.Tensor:
    """The LUT's table on ``device`` as one flat (N³·3) f32 tensor, entry
    ((r·N + g)·N + b)·3 + c. Build it once and pass it to the apply for
    every image of a run."""
    return torch.from_numpy(
        np.ascontiguousarray(lut.table, np.float32).reshape(-1)).to(device)


def _trilinear(chans: Sequence[torch.Tensor], lut: CubeLUT,
               table: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup of three same-shape channel tensors: (..., 3).
    The arithmetic of :func:`gs360x.core.color.apply_cube_lut`, in its
    order, one channel at a time."""
    n = lut.size
    dmin = np.asarray(lut.domain_min, np.float32)
    span = np.asarray(lut.domain_max, np.float32) - dmin
    i0s, fs = [], []
    for c in range(3):
        t = torch.clamp((chans[c] - float(dmin[c])) / float(span[c]),
                        0.0, 1.0) * float(n - 1)
        i0 = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
        fs.append((t - i0.to(t.dtype))[..., None])
        i0s.append(i0)
    r0, g0, b0 = i0s
    fr, fg, fb = fs
    table3 = table.view(-1, 3)

    def tap(dr: int, dg: int, db: int) -> torch.Tensor:
        return table3[((r0 + dr) * n + (g0 + dg)) * n + (b0 + db)]

    c00 = tap(0, 0, 0) * (1 - fr) + tap(1, 0, 0) * fr
    c10 = tap(0, 1, 0) * (1 - fr) + tap(1, 1, 0) * fr
    c01 = tap(0, 0, 1) * (1 - fr) + tap(1, 0, 1) * fr
    c11 = tap(0, 1, 1) * (1 - fr) + tap(1, 1, 1) * fr
    c0 = c00 * (1 - fg) + c10 * fg
    c1 = c01 * (1 - fg) + c11 * fg
    return c0 * (1 - fb) + c1 * fb


def apply_cube_lut(rgb: torch.Tensor, lut: CubeLUT,
                   table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trilinear 3D-LUT application: float (..., 3) in [0, 1] → (..., 3).
    ``table`` is :func:`lut_table` on ``rgb``'s device (built here when
    not given)."""
    if table is None:
        table = lut_table(lut, rgb.device)
    return _trilinear([rgb[..., c] for c in range(3)], lut, table)


def apply_cube_lut_planar(planes: torch.Tensor, lut: CubeLUT,
                          table: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """:func:`apply_cube_lut` on (3, H, W) f32 planes → (3, H, W)."""
    if planes.dim() != 3 or planes.shape[0] != 3:
        raise ValueError(f"apply_cube_lut_planar: expected (3, H, W) planes, "
                         f"got {tuple(planes.shape)}")
    if table is None:
        table = lut_table(lut, planes.device)
    out = _trilinear([planes[0], planes[1], planes[2]], lut, table)
    return out.permute(2, 0, 1).contiguous()
