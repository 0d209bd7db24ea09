"""Pose helpers (port of :mod:`gs360x.core.pose`).

Only the angle wrap the presets need lives here so far; the rest of the
pose algebra is queued in ROADMAP.md.
"""

from __future__ import annotations


def normalize_angle_deg(a: float) -> float:
    """Wrap to (-180, 180], with -180 mapped to +180."""
    a = ((a + 180.0) % 360.0) - 180.0
    return 180.0 if abs(a + 180.0) < 1e-6 else a
