"""Interactive point-cloud edit operations (the viewer's edit toolbox).

Rebuilds the reference GUI's in-viewer cloud edits
(``gs360_GUI.py``): remove points by RGB color distance
(the "delete sky points" feature, ``:13132-13237``), add bounding-box fill
points with palette sampling (``:12852-13075``), and add a sky dome
(``:12392-12462`` — via
:func:`gs360x_torch.kernels.voxel.generate_sky_points`).
Pure array functions so the GUI buttons and tests share one implementation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def remove_points_by_color(xyz: np.ndarray, rgb: np.ndarray,
                           color, tolerance: float
                           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Drop points whose RGB is within euclidean ``tolerance`` of ``color``.

    Returns (xyz, rgb, removed_count)."""
    target = np.asarray(color, np.float32)
    dist = np.linalg.norm(rgb.astype(np.float32) - target, axis=1)
    keep = dist > float(tolerance)
    return xyz[keep], rgb[keep], int((~keep).sum())


def add_bbox_fill_points(xyz: np.ndarray, rgb: np.ndarray,
                         bbox_min, bbox_max, count: int, *,
                         palette: Optional[np.ndarray] = None,
                         color=None, seed: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Fill an axis-aligned box with uniformly random points.

    Colors come from ``color`` (flat), from ``palette`` rows sampled
    uniformly, or — default — from random existing cloud points (the
    reference's palette-sampling behavior)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(bbox_min, np.float32)
    hi = np.asarray(bbox_max, np.float32)
    pts = rng.uniform(lo, hi, size=(int(count), 3)).astype(np.float32)
    if color is not None:
        cols = np.tile(np.asarray(color, np.uint8), (count, 1))
    else:
        source = palette if palette is not None and len(palette) else rgb
        if source is None or len(source) == 0:
            cols = np.full((count, 3), 200, np.uint8)
        else:
            cols = np.asarray(source, np.uint8)[
                rng.integers(0, len(source), count)]
    return (np.concatenate([xyz, pts]) if len(xyz) else pts,
            np.concatenate([rgb, cols]) if len(rgb) else cols)


def add_sky_dome(xyz: np.ndarray, rgb: np.ndarray, *, axis=(0, 0, 1),
                 scale: float = 100.0, count: int = 4000,
                 color=(135, 206, 250), sky_percent: float = 50.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    from gs360x_torch.kernels.voxel import generate_sky_points

    center = xyz.mean(axis=0) if len(xyz) else np.zeros(3)
    sky_xyz, sky_rgb = generate_sky_points(center, np.asarray(axis, float),
                                           scale, count,
                                           np.asarray(color, np.uint8),
                                           sky_percent=sky_percent)
    return (np.concatenate([xyz, sky_xyz]) if len(xyz) else sky_xyz,
            np.concatenate([rgb, sky_rgb]) if len(rgb) else sky_rgb)
