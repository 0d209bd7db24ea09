"""The comparison that decides ``correct``: written views against the
reference's.

The tools write JPEG, so a written view is its reference view plus the
encoder's error (q98 or q95, 4:4:4: about a LSB on average, a few LSB at
hard edges) plus the kernels' own rounding (a LSB on a few pixels). The
numbers compared, each over the sample of views, are

- ``missing``: outputs the run reported written but not on disk, or empty;
- ``mae_lsb``: the largest mean absolute difference of a view, in LSB of
  its 8 bits, over every pixel and channel;
- ``far_pct``: the largest share of a view's values more than ``FAR_LSB``
  apart, in %: a misplaced or wrongly filled patch that the mean hides.
"""

from __future__ import annotations

import io
import pathlib
from typing import Iterable, Tuple

import numpy as np
import torch
from PIL import Image

FAR_LSB = 24


def read_u8(path: pathlib.Path) -> np.ndarray:
    """A written (or input) image as (H, W, 3) u8, decoded by Pillow."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """``img`` through the encoder settings the tools write with (4:4:4,
    optimized tables) and back: how the control's views reach the
    comparison in the program's place."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=int(quality),
                              subsampling=0, optimize=True)
    return read_u8(buf)


def view_numbers(written: np.ndarray, reference: torch.Tensor
                 ) -> Tuple[float, float]:
    """(mean absolute difference in LSB, % of values more than FAR_LSB
    apart) of one view."""
    ref = reference.cpu().numpy()
    if written.shape != ref.shape:
        return 255.0, 100.0
    diff = np.abs(written.astype(np.int16) - ref.astype(np.int16))
    return float(diff.mean()), float(100.0 * (diff > FAR_LSB).mean())


def numbers(pairs: Iterable[Tuple[np.ndarray, torch.Tensor]],
            missing: int) -> dict:
    """The compared numbers over (written, reference) views."""
    mae, far = 0.0, 0.0
    for written, reference in pairs:
        m, f = view_numbers(written, reference)
        mae, far = max(mae, m), max(far, f)
    return {"missing": missing, "mae_lsb": mae, "far_pct": far}


def verdict(found: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(found[k] <= limits[k] for k in limits)
