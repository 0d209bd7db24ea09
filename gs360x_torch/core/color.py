"""Video colour move (port of the part of :mod:`gs360x.core.color` that
the perspcut video path runs).

Transfer-curve constants match the JAX package: Rec.709 OETF with the
0.081 / 4.5 / 1.099 / 0.45 spec values and the standard sRGB pair. The
primaries matrix is applied as three explicit multiply-adds per output
channel, so no matrix product (and no TF32) is involved on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def rec709_to_linear(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    return torch.where(v < 0.081, v / 4.5,
                       ((v + 0.099) / 1.099) ** (1.0 / 0.45))


def linear_to_rec709(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    return torch.where(v < 0.018, v * 4.5, 1.099 * v ** 0.45 - 0.099)


def linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, 0.0, 1.0)
    return torch.clamp(torch.where(v <= 0.0031308, 12.92 * v,
                                   1.055 * v ** (1.0 / 2.4) - 0.055),
                       0.0, 1.0)


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


def video_color_move_planar(rgb: torch.Tensor, *,
                            keep_rec709: bool = False) -> torch.Tensor:
    """The video colour chain on channel-first (..., 3, H, W) tensors:
    linearize Rec.709, convert primaries BT.709→SMPTE-170M, re-encode with
    sRGB (default) or the same Rec.709 curve (ffmpeg
    ``colorspace=iall=bt709:all=smpte170m[:trc=iec61966-2-1]``)."""
    lin = rec709_to_linear(rgb)
    mat = BT709_TO_SMPTE170M.astype(np.float32)
    chans = [lin[..., c, :, :] for c in range(3)]
    moved = torch.stack(
        [chans[0] * float(mat[d, 0]) + chans[1] * float(mat[d, 1])
         + chans[2] * float(mat[d, 2]) for d in range(3)], dim=-3)
    moved = torch.clamp(moved, 0.0, 1.0)
    return linear_to_rec709(moved) if keep_rec709 else linear_to_srgb(moved)
