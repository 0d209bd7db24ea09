"""Lens masks co-warped into the SFM10 views, the plain way
(gs360_DualFisheyeDistortionCalibration.py's ``process_pair_task``, the
mask co-warping of each pair): each view's mask is its lens's mask
sampled nearest through the view's own map, 0 where the map is not valid.

A view pixel takes the lens texel ``(clamp(round(map_y)), clamp(round(
map_x)))``, ``round`` half to even (``torch.round``, as the kernel's
``rintf``), each index clamped to the lens as ``csrc/remap.cu`` clamps it.
The maps and ``valid`` are :func:`portbench.reference.fisheye.view_maps`',
computed in float64 unless asked otherwise; the values are the mask's own
bytes, so the precision is that of the coordinates alone.

Departures from the tool (``gs360x_torch.tools.dualfisheye``):

- the mask is read with Pillow's ``convert("L")``; the tool takes the
  first channel of its RGB read (``read_image(...)[..., 0]``). The two
  agree on an 8-bit gray mask, which MaskSeg writes, and differ on a
  coloured one;
- the maps are this package's float64 equisolid maps; the tool builds its
  own in float32 on the host, so a pixel whose coordinate lies within that
  rounding of a half-integer may take the neighbouring texel;
- the fill is 0, the tool's for masks with ``--mask-outside-model`` at its
  default (``--mask-value`` sets the views' fill, not the masks').
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch
from PIL import Image


def read_mask(path: pathlib.Path) -> torch.Tensor:
    """A lens mask as (H, W) u8, decoded by Pillow as 8-bit gray."""
    with Image.open(path) as im:
        return torch.from_numpy(np.array(im.convert("L")))


def cowarp(mask: torch.Tensor, maps: tuple, rounding=torch.round
           ) -> torch.Tensor:
    """One (size, size) u8 view mask of an (H, W) u8 lens ``mask`` through
    ``maps`` = (map_x, map_y, valid), on the maps' device: each pixel the
    lens texel at its coordinates rounded by ``rounding`` (``torch.round``,
    the function's, or another rule for a control) and clamped to the
    lens."""
    mx, my, valid = maps
    src = mask.to(valid.device)
    h, w = src.shape
    col = rounding(mx.double()).clamp(0, w - 1).to(torch.int64)
    row = rounding(my.double()).clamp(0, h - 1).to(torch.int64)
    out = src[row, col]
    return torch.where(valid, out, torch.zeros_like(out))


def near_tie(maps: tuple, tol: float) -> torch.Tensor:
    """(size, size) bool: the valid pixels whose x or y coordinate lies
    within ``tol`` of a half-integer, where a map built in another
    precision may round to the neighbouring texel."""
    mx, my, valid = maps
    near = [((c.double() - 0.5) - torch.round(c.double() - 0.5)).abs() < tol
            for c in (mx, my)]
    return valid & (near[0] | near[1])
