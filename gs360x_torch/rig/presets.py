"""View-rig presets and the addcam/delcam/setcam camera grammar (port of
:mod:`gs360x.rig.presets`, kept line for line).

Behaviour-parity with 360PerspCut's plan builder: identical view ids,
yaw/pitch values, output naming, preset focal/size defaults and
deletion/addition tables. Instead of one ffmpeg argv per view it emits a
:class:`~gs360x_torch.rig.spec.RenderPlan` the executor consumes in one
batched launch per frame.

Presets (``gs360_360PerspCut.py:443-454``):

========  =====================================================
default   8 views around the horizon (focal 12 mm)
fisheyelike  10 slots, del C,D,H,I, add A,F ±30° (focal 17 mm)
full360coverage  8 slots, del B,D,F,H, add B,D,F,H ±30° (14 mm)
2views    front/back only (focal 6 mm, 3600 px)
evenMinus30 / evenPlus30  even slots pitched ∓/± 30°
fisheyeXY two 180° fisheye hemispheres X (front) / Y (back)
========  =====================================================
"""

from __future__ import annotations

import pathlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from gs360x_torch.core import camera as cam
from gs360x_torch.core.pose import normalize_angle_deg
from gs360x_torch.rig.spec import PlanJob, RenderPlan, ViewSpec

PRESET_CHOICES = [
    "default", "fisheyelike", "full360coverage", "2views",
    "evenMinus30", "evenPlus30", "fisheyeXY",
]

IMAGE_EXTS = {".tif", ".tiff", ".jpg", ".jpeg", ".png"}


# --------------------------------------------------------------------------
# Letter/camera-key grammar
# --------------------------------------------------------------------------


def letter_tag(idx: int) -> str:
    """0-based slot index → view tag: A..Z then two-digit numbers."""
    return chr(ord("A") + idx) if idx < 26 else f"{idx + 1:02d}"


def letter_to_index1(s: str) -> int:
    """Camera key (letter or 1-based number) → 1-based slot index."""
    s = s.strip()
    if not s:
        raise ValueError("empty camera key")
    if s.isdigit():
        return int(s)
    ch = s.upper()[0]
    if "A" <= ch <= "Z":
        return ord(ch) - ord("A") + 1
    raise ValueError(f"invalid camera key: {s}")


def extra_suffix(delta_pitch: float, default_deg: float = 30.0) -> str:
    """Suffix for an added view: '_U'/'_D' at the default magnitude,
    '_U15'/'_D22.5' otherwise."""
    sign = "_U" if delta_pitch > 0 else "_D"
    mag = abs(delta_pitch)
    if abs(mag - default_deg) < 1e-6:
        return sign
    if float(mag).is_integer():
        return f"{sign}{int(round(mag))}"
    return f"{sign}{mag:g}"


def parse_addcam_spec(spec: str, default_deg: float) -> Dict[int, List[float]]:
    """'B' → ±default; 'B:U', 'D:D20', 'F=U15' → single signed offsets."""
    out: Dict[int, List[float]] = {}
    if not spec:
        return out
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if ":" in token or "=" in token:
            key, val = re.split(r"[:=]", token, maxsplit=1)
            idx1 = letter_to_index1(key)
            val = val.strip().upper()
            m = re.match(r"^([UD])\s*([+-]?\d+(?:\.\d+)?)?$", val)
            if not m:
                raise ValueError(f"invalid --addcam token: {token}")
            deg = float(m.group(2)) if m.group(2) else default_deg
            out.setdefault(idx1, []).append(deg if m.group(1) == "U" else -deg)
        else:
            idx1 = letter_to_index1(token)
            out.setdefault(idx1, []).extend([default_deg, -default_deg])
    return out


def parse_delcam_spec(spec: str) -> Set[int]:
    out: Set[int] = set()
    if not spec:
        return out
    for token in spec.split(","):
        token = token.strip()
        if token:
            out.add(letter_to_index1(token))
    return out


def parse_setcam_spec(spec: str, default_deg: float):
    """Parse --setcam into (abs, delta, extra_abs, extra_delta) maps.

    Absolute: 'A=30', 'A=U', 'A=D20'. Relative: 'A:+10', 'B:-5'. Keys with a
    '_U'/'_D…' suffix target the added views (e.g. 'A_U=5').
    """
    abs_map: Dict[int, float] = {}
    delta_map: Dict[int, float] = {}
    extra_abs: Dict[Tuple[int, str], float] = {}
    extra_delta: Dict[Tuple[int, str], float] = {}
    if not spec:
        return abs_map, delta_map, extra_abs, extra_delta

    def split_key(raw: str) -> Tuple[int, Optional[str]]:
        raw = raw.strip()
        if "_" in raw:
            base, suffix_part = raw.split("_", 1)
            return letter_to_index1(base), "_" + suffix_part.strip()
        return letter_to_index1(raw), None

    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if ":" not in token and "=" not in token:
            raise ValueError(f"invalid --setcam token: {token}")
        key, val = re.split(r"[:=]", token, maxsplit=1)
        idx1, suffix = split_key(key)
        t_abs = extra_abs if suffix else abs_map
        t_delta = extra_delta if suffix else delta_map
        mkey = (idx1, suffix) if suffix else idx1
        v = val.strip()
        if re.match(r"^[+|-]\s*\d+(?:\.\d+)?$", v):
            t_delta[mkey] = float(v.replace(" ", ""))
            continue
        up = re.match(r"^[Uu]\s*(\d+(?:\.\d+)?)?$", v)
        dn = re.match(r"^[Dd]\s*(\d+(?:\.\d+)?)?$", v)
        if up:
            t_abs[mkey] = float(up.group(1)) if up.group(1) else default_deg
        elif dn:
            t_abs[mkey] = -(float(dn.group(1)) if dn.group(1) else default_deg)
        else:
            try:
                t_abs[mkey] = float(v.replace(" ", ""))
            except ValueError as exc:
                raise ValueError(f"invalid --setcam token: {token}") from exc
    return abs_map, delta_map, extra_abs, extra_delta


def parse_sensor_dimensions(s: str) -> Tuple[float, ...]:
    """'36 24', '36x24', '36×24', '36,24' → numeric components."""
    s_norm = s.lower().replace("×", "x").replace(",", " ").strip()
    tokens = ([t.strip() for t in s_norm.split("x") if t.strip()]
              if "x" in s_norm else s_norm.split())
    dims: List[float] = []
    for token in tokens:
        try:
            dims.append(float(token))
        except ValueError:
            continue
    return tuple(dims)


def clamp(v: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, v))


# --------------------------------------------------------------------------
# Plan configuration (mirrors the reference CLI surface)
# --------------------------------------------------------------------------


@dataclass
class PerspCutConfig:
    """Flag-for-flag mirror of the reference arg surface
    (``gs360_360PerspCut.py:417-531``). ``*_explicit`` mark user-set values
    so presets only override defaults (the StoreWithFlag behavior)."""

    preset: str = "default"
    count: int = 8
    addcam: str = ""
    addcam_deg: float = 30.0
    delcam: str = ""
    setcam: str = ""
    add_top: bool = False
    add_bottom: bool = False
    size: int = 1600
    ext: str = "jpg"
    jpeg_quality_95: bool = False
    fps: Optional[float] = None
    start: Optional[float] = None
    end: Optional[float] = None
    keep_rec709: bool = False
    hfov: Optional[float] = None
    focal_mm: float = 12.0
    sensor_mm: str = "36 36"
    interpolation: str = "bicubic"
    # explicit-set markers
    size_explicit: bool = False
    hfov_explicit: bool = False
    focal_mm_explicit: bool = False
    addcam_explicit: bool = False
    delcam_explicit: bool = False
    # execution context
    input_is_video: bool = False
    video_bit_depth: int = 8


# --------------------------------------------------------------------------
# Plan builder
# --------------------------------------------------------------------------


def build_view_plan(cfg: PerspCutConfig, files: Sequence[pathlib.Path],
                    out_dir: pathlib.Path) -> RenderPlan:
    """Enumerate views for every source file per the preset + grammar.

    Output naming: ``<stem>_<view_id><ext>`` for images,
    ``<stem>_%07d_<view_id><ext>`` for video frames — byte-identical to the
    reference so downstream tools interoperate."""

    preset = cfg.preset
    fisheye_xy = preset == "fisheyeXY"
    two_views = preset == "2views"
    fisheyelike = preset == "fisheyelike"
    full360 = preset == "full360coverage"

    count = cfg.count
    even_pitch_all: Optional[float] = None
    if fisheyelike:
        count = 10
    elif full360 or fisheye_xy:
        count = 8
    elif preset == "evenMinus30":
        even_pitch_all = -30.0
    elif preset == "evenPlus30":
        even_pitch_all = 30.0

    size = cfg.size
    focal_mm = cfg.focal_mm
    if two_views and not cfg.size_explicit:
        size = 3600
    if not cfg.hfov_explicit and not cfg.focal_mm_explicit:
        if two_views:
            focal_mm = 6.0
        elif fisheyelike:
            focal_mm = 17.0
        elif full360:
            focal_mm = 14.0

    add_map = parse_addcam_spec(cfg.addcam, cfg.addcam_deg)
    del_set = parse_delcam_spec(cfg.delcam)
    user_add = bool(cfg.addcam.strip()) or cfg.addcam_explicit
    user_del = bool(cfg.delcam.strip()) or cfg.delcam_explicit

    def _preset_add(letters: Sequence[str]) -> None:
        for ch in letters:
            slot = add_map.setdefault(letter_to_index1(ch), [])
            for signed in (cfg.addcam_deg, -cfg.addcam_deg):
                if not any(abs(v - signed) < 1e-6 for v in slot):
                    slot.append(signed)

    if fisheyelike:
        if not user_del:
            del_set.update(letter_to_index1(c) for c in "CDHI")
        if not user_add:
            _preset_add(["A", "F"])
    if full360:
        if not user_del:
            del_set.update(letter_to_index1(c) for c in "BDFH")
        if not user_add:
            _preset_add(["B", "D", "F", "H"])
    if two_views:
        del_set.update(letter_to_index1(c) for c in "BCDFGH")

    set_abs, set_delta, set_extra_abs, set_extra_delta = parse_setcam_spec(
        cfg.setcam, cfg.addcam_deg)

    dims = parse_sensor_dimensions(cfg.sensor_mm)
    sensor_w_mm = dims[0] if dims else 36.0
    sensor_long_mm = max(dims) if dims else sensor_w_mm
    sensor_h_mm = float(dims[1]) if len(dims) >= 2 else sensor_w_mm
    if sensor_h_mm <= 0:
        sensor_h_mm = None

    if cfg.hfov is not None:
        hfov_deg = float(cfg.hfov)
        f_used_mm = cam.focal_mm_from_hfov(hfov_deg, sensor_w_mm)
    else:
        f_used_mm = float(focal_mm)
        hfov_deg = cam.hfov_from_focal_mm(f_used_mm, sensor_w_mm)

    focal_35 = None
    if sensor_long_mm > 0 and abs(sensor_long_mm - 36.0) > 1e-6:
        focal_35 = cam.focal_35mm_equivalent(f_used_mm, sensor_long_mm)

    w = h = int(size)
    if sensor_h_mm and f_used_mm > 1e-6:
        vfov_deg = clamp(cam.vfov_from_sensor(f_used_mm, sensor_h_mm), 1.0, 179.9)
    else:
        vfov_deg = cam.vfov_from_hfov(hfov_deg, w, h)

    if fisheye_xy:
        fisheye_size = size if cfg.size_explicit else 3600
        fisheye_fov = hfov_deg if cfg.hfov_explicit else 180.0
    else:
        fisheye_size = size
        fisheye_fov = hfov_deg

    if count <= 0:
        raise ValueError("--count must be >= 1")
    yaw_step = 360.0 / count
    ext_dot = "." + cfg.ext.lower().lstrip(".")
    fisheye_letter_map = {1: "X", 5: "Y"} if fisheye_xy else {}

    plan = RenderPlan(
        out_dir=out_dir,
        video_mode=cfg.input_is_video,
        fps=cfg.fps,
        start_time=cfg.start,
        end_time=cfg.end,
        keep_rec709=cfg.keep_rec709,
        ext=ext_dot,
        jpeg_quality_95=cfg.jpeg_quality_95,
        bit_depth=cfg.video_bit_depth,
        interpolation=cfg.interpolation,
        focal_used_mm=f_used_mm,
        focal_35mm_equiv=focal_35,
        hfov_deg=hfov_deg,
        vfov_deg=vfov_deg,
    )
    existing: Set[str] = set()

    def apply_setcam(idx1: int, base_pitch: float, suffix: Optional[str] = None) -> float:
        p = base_pitch
        if suffix:
            key = (idx1, suffix)
            if key in set_extra_abs:
                p = set_extra_abs[key]
            elif idx1 in set_abs:
                p = set_abs[idx1]
            if key in set_extra_delta:
                p += set_extra_delta[key]
            elif idx1 in set_delta:
                p += set_delta[idx1]
        else:
            if idx1 in set_abs:
                p = set_abs[idx1]
            if idx1 in set_delta:
                p += set_delta[idx1]
        return p

    for img in files:
        stem = img.stem

        def out_name(view_id: str) -> str:
            if cfg.input_is_video:
                return f"{stem}_%07d_{view_id}{ext_dot}"
            return f"{stem}_{view_id}{ext_dot}"

        def emit(view_id: str, yaw: float, pitch: float, width: int, height: int,
                 hfov: float, vfov: float, projection: str = "perspective") -> None:
            name = out_name(view_id)
            if name in existing:
                return
            view = ViewSpec(view_id=view_id, yaw_deg=yaw, pitch_deg=pitch,
                            hfov_deg=hfov, vfov_deg=vfov, width=width,
                            height=height, projection=projection)
            plan.jobs.append(PlanJob(source=img, output_name=name, view=view))
            plan.view_specs.append(view)
            existing.add(name)

        xy_views: List[Tuple[str, float, float]] = []
        for yi in range(count):
            idx1 = yi + 1
            tag = letter_tag(yi)
            skip_base = (idx1 in del_set) or fisheye_xy
            yaw = normalize_angle_deg(yi * yaw_step)
            pitch = 0.0
            if (idx1 % 2) == 0 and not fisheye_xy and even_pitch_all is not None:
                pitch += even_pitch_all
            pitch = clamp(apply_setcam(idx1, pitch), -90.0, 90.0)

            if fisheye_xy and idx1 in fisheye_letter_map:
                xy_views.append((fisheye_letter_map[idx1], yaw, pitch))

            if not skip_base:
                emit(tag, yaw, pitch, w, h, hfov_deg, vfov_deg)

            if not fisheye_xy and idx1 in add_map:
                for d in add_map[idx1]:
                    p = clamp(pitch + d, -90.0, 90.0)
                    suf = extra_suffix(d, cfg.addcam_deg)
                    p = apply_setcam(idx1, p, suffix=suf)
                    emit(f"{tag}{suf}", yaw, p, w, h, hfov_deg, vfov_deg)

        for xy_tag, yaw_xy, pitch_xy in xy_views:
            emit(xy_tag, yaw_xy, pitch_xy, fisheye_size, fisheye_size,
                 fisheye_fov, fisheye_fov, projection="fisheye_v360")

        extra_pitches = ([90.0] if cfg.add_top else []) + ([-90.0] if cfg.add_bottom else [])
        td_index = count
        for td_pitch in extra_pitches:
            td_tag = letter_tag(td_index)
            td_index += 1
            p = clamp(td_pitch, -90.0, 90.0)
            p = apply_setcam(letter_to_index1(td_tag), p)
            emit(td_tag, 0.0, p, w, h, hfov_deg, vfov_deg)

    _fill_info_lines(plan, cfg, files, fisheye_xy, fisheye_fov, fisheye_size,
                     sensor_w_mm, w, h, f_used_mm, focal_35)
    return plan


def _fill_info_lines(plan: RenderPlan, cfg: PerspCutConfig,
                     files: Sequence[pathlib.Path], fisheye_xy: bool,
                     fisheye_fov: float, fisheye_size: int,
                     sensor_w_mm: float, w: int, h: int,
                     f_used_mm: float, focal_35: Optional[float]) -> None:
    """User-facing summary lines (RealityScan / Metashape focal hints),
    format-identical to ``gs360_360PerspCut.py:912-967``."""
    if not plan.jobs:
        return
    first_src = plan.jobs[0].source
    seen: List[str] = []
    for job in plan.jobs:
        if job.source != first_src:
            break
        if job.view.view_id and job.view.view_id not in seen:
            seen.append(job.view.view_id)
    if not seen:
        return
    n = len(seen)
    plan.preview_views_line = (
        f"[INFO] View summary ({first_src.name}): {n} view"
        + ("s" if n != 1 else "") + " - " + ", ".join(seen))
    if fisheye_xy:
        plan.preview_views_line += (
            f" | fisheye_fov={fisheye_fov:.1f}deg | size={fisheye_size}x{fisheye_size}")
        return
    plan.sensor_line = f"[INFO] Sensor={cfg.sensor_mm} mm | size={w}x{h}"
    focal_segment = f"focal length=  {f_used_mm:.3f} mm"
    if focal_35 is not None:
        focal_segment += f" (35mm eq=  {focal_35:.3f} mm)"
    plan.realityscan_line = f"[INFO] For RealityScan: {focal_segment}"
    if w > 0:
        pixel_size_mm = sensor_w_mm / float(w)
        if pixel_size_mm > 0:
            plan.metashape_line = (
                "[INFO] For Metashape: Precalibrated f=  {:.5f}  | pixel_size=  {:.4f} mm"
                .format(f_used_mm / pixel_size_mm, pixel_size_mm))
