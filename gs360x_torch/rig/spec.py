"""Declarative view/render plan datatypes (port of
:mod:`gs360x.rig.spec`, field for field).

A :class:`RenderPlan` is the full, executable description of a multi-view
export (the analogue of 360PerspCut's ffmpeg job list). It is pure data:
building one performs no IO, which keeps ``--dry-run`` and tests cheap, and
lets the runtime batch all views of a frame into one device launch.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple


@dataclass(frozen=True)
class ViewSpec:
    """One virtual camera view cut out of a panorama."""

    view_id: str                  # e.g. "A", "B_U", "X"
    yaw_deg: float
    pitch_deg: float
    hfov_deg: float
    vfov_deg: float
    width: int
    height: int
    projection: str = "perspective"   # "perspective" | "fisheye_v360" | "equisolid"
    roll_deg: float = 0.0

    @property
    def dfov_deg(self) -> float:
        """Diagonal FOV used by fisheye projections (hfov carries it)."""
        return self.hfov_deg


@dataclass(frozen=True)
class PlanJob:
    """One (source, view) → output-file unit of work."""

    source: pathlib.Path
    output_name: str              # file name (image mode) or %07d pattern (video)
    view: ViewSpec


@dataclass
class RenderPlan:
    """Everything needed to run an export, plus the user-facing info lines."""

    jobs: List[PlanJob] = field(default_factory=list)
    view_specs: List[ViewSpec] = field(default_factory=list)
    out_dir: Optional[pathlib.Path] = None
    video_mode: bool = False
    fps: Optional[float] = None
    # video mode: export only these extracted-frame indices (FrameSelector
    # CSV replay — the GUI's "apply selection to video export" path); the
    # output numbering keeps the original indices
    selected_frames: Optional[Set[int]] = None
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    keep_rec709: bool = False
    ext: str = ".jpg"
    jpeg_quality_95: bool = False
    bit_depth: int = 8
    interpolation: str = "bicubic"
    # metadata echoed to users (parity with BuildResult info lines,
    # gs360_360PerspCut.py:49-63)
    focal_used_mm: float = 0.0
    focal_35mm_equiv: Optional[float] = None
    hfov_deg: float = 0.0
    vfov_deg: float = 0.0
    preview_views_line: str = ""
    sensor_line: str = ""
    realityscan_line: str = ""
    metashape_line: str = ""

    @property
    def total(self) -> int:
        return len(self.jobs)

    def unique_views(self) -> List[ViewSpec]:
        """Distinct views of the first source — the per-frame view batch."""
        seen = {}
        for job in self.jobs:
            if job.view.view_id not in seen:
                seen[job.view.view_id] = job.view
        return list(seen.values())

    def views_for_source(self, source: pathlib.Path) -> List[Tuple[str, ViewSpec]]:
        return [(j.output_name, j.view) for j in self.jobs if j.source == source]
