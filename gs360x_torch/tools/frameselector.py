"""gs360x-torch-frameselector — sharpness-based frame selection on an
NVIDIA GPU.

Port of :mod:`gs360x.tools.frameselector` (which imports
``gs360x.kernels.sharpness`` and so JAX): the same flags (``--score_backend
{ffmpeg,opencv,jax}`` kept for the GUI's argv: ``ffmpeg`` scores
sobel-YAVG, the other two the device metrics), CSV schema, replay
(``--apply_csv`` / ``--reselect_csv``), messages and exit codes, plus
``--device {cuda,cpu}`` (default ``cuda``; ``cuda`` without a card raises)
and ``--stats``. The selection code is the JAX tool's host Python, copied.

Scoring, per image on the device: the decoded u8/u16 RGB is uploaded once,
``planarize.cu`` turns it into f32 planes (scale 1, or 255/65535 for
16-bit), the gray ``0.299R + 0.587G + 0.114B`` clipped to [0, 255] (bitwise
the JAX tool's host ``_load_gray``) is cropped on the device and scored by
:func:`gs360x_torch.kernels.sharpness.score_frame`; one fetch returns the
five features. A pool of up to 8 threads scores images concurrently; a
failed device call raises in the main thread. Optical flow keeps the JAX
route: host gray, host downscale to ≤320 px, crop, then the small grays go
to the device for :mod:`gs360x_torch.kernels.flow`. ``--device cpu`` runs
the plain versions.

Hybrid normalization is dataset-global min-max, so scoring is two-pass:
features first, blend after.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import pathlib
import shutil
import sys
import threading
import time
from bisect import bisect_left, insort
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from gs360x_torch.io.image import read_image
from gs360x_torch.runtime.profiling import StageTimers
from gs360x_torch.device import DEVICE_CHOICES, resolve_device
from gs360x_torch.kernels import flow as flowk
from gs360x_torch.kernels import sharpness as sharp
from gs360x_torch.kernels import _build, warp_cuda
from gs360x_torch.runtime.executor import upload_rows

# constants of the JAX tool
FLOW_DOWNSCALE = 320
FLOW_HIGH_MOTION_THRESHOLD = 0.5
FLOW_HIGH_MOTION_RATIO = 0.4
FLOW_LOW_MOTION_PERCENTILE = 10.0
FLOW_MISSING_HIGH_VALUE = 9999.0
FLOW_CROP_RATIO = 0.6
FAST_SPACING_WINDOW = 64
BRIGHTNESS_SHARPNESS_KEEP_RATIO = 0.2   # gs360_FrameSelector.py:339
BRIGHTNESS_SHARPNESS_MIN_KEEP = 0       # gs360_FrameSelector.py:340
SEGMENT_BOUNDARY_REOPT_TOP_K = 3
SEGMENT_BOUNDARY_REOPT_MAX_PASSES = 3
GROUP_BRIGHTNESS_POWER = 1.5
DEFAULT_CROP_RATIO = 0.8
MIN_DIFF_FRAMES_RATIO = 0.2
MAX_SPACING_RATIO = 0.8
PAIR_X_SUFFIX = "_X"
PAIR_Y_SUFFIX = "_Y"
EXT_CHOICES = {"all": {".tif", ".tiff", ".jpg", ".jpeg", ".png"},
               "tif": {".tif", ".tiff"}, "jpg": {".jpg", ".jpeg"},
               "png": {".png"}}

CSV_HEADER = ["index", "input_mode", "filename", "pair_base", "x_filename",
              "y_filename", "score", "brightness_mean", "group_score",
              "flow_motion", "selected(1=keep)"]


# --------------------------------------------------------------------------
# records
# --------------------------------------------------------------------------


@dataclass
class Record:
    index: int
    input_mode: str               # "single" | "pair"
    file_paths: List[pathlib.Path]
    pair_base: str = ""
    x_path: Optional[pathlib.Path] = None
    y_path: Optional[pathlib.Path] = None

    @property
    def display_name(self) -> str:
        if self.input_mode == "pair":
            return self.pair_base
        return self.file_paths[0].name

    def exists(self) -> bool:
        return all(p.exists() for p in self.file_paths)


def split_stem_suffix(stem: str) -> Tuple[str, Optional[str]]:
    if stem.endswith(PAIR_X_SUFFIX):
        return stem[: -len(PAIR_X_SUFFIX)], "X"
    if stem.endswith(PAIR_Y_SUFFIX):
        return stem[: -len(PAIR_Y_SUFFIX)], "Y"
    return stem, None


def _sort_key(path: pathlib.Path, mode: str):
    import re

    stem = path.stem
    nums = re.findall(r"\d+", stem)
    if mode == "lastnum":
        return (int(nums[-1]) if nums else 0, stem)
    if mode == "firstnum":
        return (int(nums[0]) if nums else 0, stem)
    if mode == "mtime":
        return (path.stat().st_mtime if path.exists() else 0.0, stem)
    return (stem,)


def gather_records(in_dir: pathlib.Path, ext: str, sort: str,
                   input_mode: str) -> Tuple[List[Record], str]:
    exts = EXT_CHOICES[ext]
    files = sorted((p for p in in_dir.iterdir()
                    if p.is_file() and p.suffix.lower() in exts),
                   key=lambda p: _sort_key(p, sort))
    if input_mode == "auto":
        suffixed = sum(1 for p in files if split_stem_suffix(p.stem)[1])
        input_mode = "pair" if files and suffixed >= max(2, len(files) // 2) \
            else "single"
    records: List[Record] = []
    if input_mode == "pair":
        pairs: Dict[str, Dict[str, pathlib.Path]] = {}
        order: List[str] = []
        for p in files:
            base, lens = split_stem_suffix(p.stem)
            if lens is None:
                continue
            if base not in pairs:
                pairs[base] = {}
                order.append(base)
            pairs[base][lens] = p
        for i, base in enumerate(order):
            entry = pairs[base]
            paths = [entry[k] for k in ("X", "Y") if k in entry]
            records.append(Record(index=i, input_mode="pair",
                                  file_paths=paths, pair_base=base,
                                  x_path=entry.get("X"), y_path=entry.get("Y")))
    else:
        for i, p in enumerate(files):
            records.append(Record(index=i, input_mode="single",
                                  file_paths=[p]))
    return records, input_mode


# --------------------------------------------------------------------------
# scoring
# --------------------------------------------------------------------------


@dataclass
class FrameMetrics:
    score: Optional[float] = None
    lap: Optional[float] = None
    ten: Optional[float] = None
    fft: Optional[float] = None
    brightness: float = 0.0
    brightness_weight: float = 1.0
    motion_factor: float = 1.0
    group_score: float = 0.0
    flow: float = 0.0


def _load_gray(path: pathlib.Path) -> Optional[np.ndarray]:
    """Host gray float32 in [0, 255], dtype-aware scaling (the flow route's
    decode; the JAX tool's function)."""
    try:
        img = read_image(path)
    except Exception:
        return None
    if img.dtype == np.uint16:
        img = img.astype(np.float32) * (255.0 / 65535.0)
    else:
        img = img.astype(np.float32)
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.clip(gray, 0.0, 255.0)


def device_gray(img: np.ndarray, device: torch.device) -> torch.Tensor:
    """Decoded (H, W, 3) u8/u16 RGB → (H, W) f32 gray in [0, 255] on
    ``device``: one upload, ``planarize.cu`` to f32 planes (×1 or
    ×255/65535), then ``0.299R + 0.587G + 0.114B`` clipped — bitwise
    :func:`_load_gray`'s arithmetic."""
    if img.ndim != 3 or img.shape[2] != 3 \
            or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"expected an (H, W, 3) u8/u16 image, got "
                         f"{img.shape} {img.dtype}")
    scale = 255.0 / 65535.0 if img.dtype == np.uint16 else 1.0
    planes = warp_cuda.planarize_rows(upload_rows(img, device), scale,
                                      torch.float32)
    gray = 0.299 * planes[0] + 0.587 * planes[1] + 0.114 * planes[2]
    return torch.clamp(gray, 0.0, 255.0)


def score_record(record: Record, metric: str, crop_ratio: float,
                 ignore_highlights: bool, augment_motion: bool, *,
                 device: torch.device,
                 timers: Optional[StageTimers] = None) -> FrameMetrics:
    """Score one record on ``device`` (averaging over pair lenses)."""
    timers = timers or StageTimers()
    feats = []
    for path in record.file_paths:
        with timers.stage("decode"):
            try:
                img = read_image(path)
            except Exception:
                return FrameMetrics()
        with timers.stage("score"):
            gray = device_gray(img, device)
            ys, xs = sharp.crop_by_ratio(tuple(gray.shape), crop_ratio)
            gray = gray[ys, xs].contiguous()
            mask = torch.ones(gray.shape, dtype=torch.bool,
                              device=device)
            if record.input_mode == "pair":
                mask &= sharp.circle_mask(*gray.shape, device=device)
            if ignore_highlights:
                hl = gray >= 0.95 * 255.0
                if 0 < int(hl.sum()) < hl.numel():
                    mask &= ~hl
            use_mask = not bool(mask.all())
            lap, ten, fft, bright, _ = sharp.score_frame(
                gray, mask, metric=metric, use_mask=use_mask)
            # one fetch for the four features
            feats.append(torch.stack([lap, ten, fft, bright]).tolist())
    lap = float(np.mean([f[0] for f in feats]))
    ten = float(np.mean([f[1] for f in feats]))
    fft = float(np.mean([f[2] for f in feats]))
    bright = float(np.mean([f[3] for f in feats]))

    m = FrameMetrics(lap=lap, ten=ten, fft=fft, brightness=bright)
    m.brightness_weight = sharp.brightness_weight(bright)
    if metric == "hybrid":
        m.motion_factor = (sharp.motion_factor_from_tenengrad(ten)
                           if augment_motion else 1.0)
        m.score = (sharp.HYBRID_LAPVAR_WEIGHT * lap
                   + sharp.HYBRID_TENENGRAD_WEIGHT * ten
                   + sharp.HYBRID_FFT_WEIGHT * fft) * m.motion_factor
    elif metric == "lapvar":
        m.score = math.sqrt(lap) if lap is not None else None  # lap = lv^2
    elif metric == "tenengrad":
        m.score = ten
    elif metric == "fft":
        m.score = fft
    elif metric == "sobel-yavg":
        m.score = ten  # score_frame routes sobel_yavg through the ten slot
    return m


def hybrid_normalize(metrics: List[FrameMetrics]) -> None:
    """Dataset-global min-max blend (gs360_FrameSelector.py:2363-2392)."""
    def norm(vals, v):
        if not vals or v is None:
            return 0.0
        vmin, vmax = min(vals), max(vals)
        if math.isclose(vmax, vmin):
            return 0.0
        return (v - vmin) / (vmax - vmin)

    laps = [m.lap for m in metrics if m.lap is not None]
    tens = [m.ten for m in metrics if m.ten is not None]
    ffts = [m.fft for m in metrics if m.fft is not None]
    for m in metrics:
        if m.lap is None:
            continue
        m.score = sharp.hybrid_combine(
            norm(laps, m.lap), norm(tens, m.ten), norm(ffts, m.fft),
            m.motion_factor)


def compute_flows(records: List[Record], metrics: List[FrameMetrics],
                  crop_ratio: float = FLOW_CROP_RATIO,
                  method: str = "lucas_kanade", *,
                  device: torch.device) -> None:
    """Mean flow magnitude between consecutive existing records; each
    record keeps the max of its adjacent-pair magnitudes. ``method``:
    sparse LK (default) or dense Farneback. Grays are made and downscaled
    on the host, as in JAX; the ≤320-long crops run on ``device``."""
    flow_fn = (flowk.mean_flow_magnitude_farneback
               if method == "farneback" else flowk.mean_flow_magnitude)

    def load(rec: Record):
        grays = []
        for p in rec.file_paths:
            g = _load_gray(p)
            if g is None:
                return None
            g = sharp.downscale_max_long(g, FLOW_DOWNSCALE)
            ys, xs = sharp.crop_by_ratio(g.shape, crop_ratio)
            grays.append(torch.from_numpy(
                np.ascontiguousarray(g[ys, xs])).to(device))
        return grays

    prev_idx = None
    prev_grays = None
    for idx, rec in enumerate(records):
        if not rec.exists():
            prev_idx, prev_grays = None, None
            continue
        grays = load(rec)
        if grays is None:
            prev_idx, prev_grays = None, None
            continue
        if prev_grays is not None and all(
                a.shape == b.shape for a, b in zip(prev_grays, grays)):
            mags = []
            for a, b in zip(prev_grays, grays):
                mag = flow_fn(a, b)
                if math.isfinite(mag):
                    mags.append(mag)
            mean_mag = (sum(mags) / len(mags)) if mags \
                else FLOW_MISSING_HIGH_VALUE
            metrics[idx].flow = max(metrics[idx].flow, mean_mag)
            metrics[prev_idx].flow = max(metrics[prev_idx].flow, mean_mag)
        prev_idx, prev_grays = idx, grays


# --------------------------------------------------------------------------
# selection
# --------------------------------------------------------------------------


def round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


@dataclass
class GroupInfo:
    start: int
    end: int
    valid_idx: List[int] = field(default_factory=list)
    group_sum: float = 0.0


def build_groups(records, metrics, segment_size) -> List[GroupInfo]:
    groups = []
    total = len(records)
    for start in range(0, total, segment_size):
        end = min(total, start + segment_size)
        info = GroupInfo(start=start, end=end)
        for i in range(start, end):
            s = metrics[i].score
            if s is None:
                continue
            info.valid_idx.append(i)
            if s > 0.0:
                bf = metrics[i].brightness_weight * (
                    max(metrics[i].brightness, 1e-6) ** GROUP_BRIGHTNESS_POWER)
                info.group_sum += s * bf
        for i in range(start, end):
            metrics[i].group_score = info.group_sum
        groups.append(info)
    return groups


def initial_segment_selection(records, metrics, groups) -> Set[int]:
    selected: Set[int] = set()
    for info in groups:
        rng = range(info.start, info.end)
        existing = [i for i in rng if records[i].exists()]
        valid = [i for i in existing if metrics[i].score is not None]
        chosen = None
        if valid:
            chosen = max(valid, key=lambda i: (metrics[i].score, -i))
        elif existing:
            chosen = existing[0]
        if chosen is not None:
            selected.add(chosen)
    return selected


def _group_center(info) -> float:
    """Segment center index (gs360_FrameSelector.py:1735-1740)."""
    if info.end <= info.start:
        return float(info.start)
    return (float(info.start) + float(info.end - 1)) * 0.5


def _boundary_edge_penalty(left_idx, right_idx, left_info, right_info,
                           min_diff):
    """(hard_violation, soft_shortfall) for one boundary edge
    (gs360_FrameSelector.py:1743-1755)."""
    if left_idx is None or right_idx is None:
        return 0, 0.0
    dist = abs(int(right_idx) - int(left_idx))
    hard = 1 if (min_diff > 1 and dist < min_diff) else 0
    target = max(1.0, abs(_group_center(right_info) - _group_center(left_info)))
    shortfall = max(0.0, target - float(dist)) / target
    return hard, shortfall


def _score_or_neg_inf(metrics, i) -> float:
    s = metrics[i].score
    return float(s) if (s is not None and math.isfinite(s)) else float("-inf")


def _boundary_pair_objective(left_idx, right_idx, left_g, right_g,
                             prev_idx, prev_g, next_idx, next_g,
                             metrics, min_diff, initial_set,
                             current_left, current_right):
    """Lexicographic boundary objective (gs360_FrameSelector.py:1758-1800):
    (fewest hard spacing violations, least center-distance shortfall,
    highest score sum, prefer initial picks, prefer staying put)."""
    hard_total = 0
    shortfall_total = 0.0
    h, sf = _boundary_edge_penalty(left_idx, right_idx, left_g, right_g,
                                   min_diff)
    hard_total += h
    shortfall_total += sf
    if prev_g is not None:
        h, sf = _boundary_edge_penalty(prev_idx, left_idx, prev_g, left_g,
                                       min_diff)
        hard_total += h
        shortfall_total += sf
    if next_g is not None:
        h, sf = _boundary_edge_penalty(right_idx, next_idx, right_g, next_g,
                                       min_diff)
        hard_total += h
        shortfall_total += sf
    score_sum = (_score_or_neg_inf(metrics, left_idx)
                 + _score_or_neg_inf(metrics, right_idx))
    initial_pref = (int(left_idx in initial_set)
                    + int(right_idx in initial_set))
    stay_pref = -((0 if left_idx == current_left else 1)
                  + (0 if right_idx == current_right else 1))
    return (-hard_total, -shortfall_total, score_sum, initial_pref,
            stay_pref)


def boundary_reopt(records, metrics, groups, selected: Set[int],
                   min_diff: int) -> Set[int]:
    """Local boundary re-optimization: for each adjacent segment pair,
    choose the top-K candidate combination that reduces boundary crowding
    while preserving sharpness — full port of the reference's
    refine_segment_selection_boundary_local
    (gs360_FrameSelector.py:1803-1912)."""
    if not groups:
        return set(selected)
    initial_set = set(selected)

    group_candidates: List[List[int]] = []
    selected_by_group: List = []
    for info in groups:
        existing = [i for i in range(info.start, info.end)
                    if records[i].exists()]
        valid = [i for i in existing
                 if metrics[i].score is not None
                 and math.isfinite(metrics[i].score)]
        valid_sorted = sorted(valid,
                              key=lambda i: (-float(metrics[i].score), i))
        candidates = valid_sorted[:SEGMENT_BOUNDARY_REOPT_TOP_K]
        current = None
        for i in range(info.start, info.end):
            if i in initial_set:
                current = i
                break
        if current is None:
            if valid_sorted:
                current = valid_sorted[0]
            elif existing:
                current = existing[0]
        if current is not None and current not in candidates:
            candidates.append(current)
        if not candidates and current is not None:
            candidates = [current]
        group_candidates.append(candidates)
        selected_by_group.append(current)

    if len(groups) < 2:
        return {i for i in selected_by_group if i is not None}

    for _ in range(SEGMENT_BOUNDARY_REOPT_MAX_PASSES):
        changed = False
        for g in range(len(groups) - 1):
            left_c = group_candidates[g]
            right_c = group_candidates[g + 1]
            if not left_c or not right_c:
                continue
            cur_l = selected_by_group[g]
            cur_r = selected_by_group[g + 1]
            prev_idx = selected_by_group[g - 1] if g > 0 else None
            next_idx = (selected_by_group[g + 2]
                        if (g + 2) < len(groups) else None)
            prev_g = groups[g - 1] if g > 0 else None
            next_g = groups[g + 2] if (g + 2) < len(groups) else None
            best_pair = (cur_l, cur_r)
            best_key = None
            for li in left_c:
                for ri in right_c:
                    key = _boundary_pair_objective(
                        li, ri, groups[g], groups[g + 1], prev_idx, prev_g,
                        next_idx, next_g, metrics, min_diff, initial_set,
                        cur_l, cur_r)
                    if best_key is None or key > best_key:
                        best_key = key
                        best_pair = (li, ri)
            if best_pair != (cur_l, cur_r):
                selected_by_group[g], selected_by_group[g + 1] = best_pair
                changed = True
        if not changed:
            break
    return {i for i in selected_by_group if i is not None}


def _pick_best_between(existing, metrics, used, pos_left, pos_right,
                       target_pos, min_diff, window=FAST_SPACING_WINDOW):
    lo = max(pos_left + 1, target_pos - window)
    hi = min(pos_right, target_pos + window)
    best, best_key = None, None
    for pos in range(lo, hi):
        idx = existing[pos]
        if idx in used or metrics[idx].score is None:
            continue
        if pos - pos_left <= min_diff or pos_right - pos <= min_diff:
            continue
        key = (metrics[idx].score, -abs(pos - target_pos))
        if best_key is None or key > best_key:
            best, best_key = idx, key
    return best


def augment_spacing(selected: Set[int], existing: List[int], metrics,
                    max_spacing: int, min_diff: int,
                    mode: str = "single") -> Set[int]:
    """Backfill frames into over-wide gaps (gs360_FrameSelector.py:1184-1242)."""
    if not max_spacing or max_spacing <= 0:
        return set(selected)
    position = {idx: pos for pos, idx in enumerate(existing)}
    augmented = set(selected)
    used = set(selected)
    order = sorted(augmented)
    changed = True
    while changed:
        changed = False
        for i in range(len(order) - 1):
            left, right = order[i], order[i + 1]
            pl, pr = position.get(left), position.get(right)
            if pl is None or pr is None or pr - pl <= max_spacing:
                continue
            target = int(round((pl + pr) / 2.0))
            cand = _pick_best_between(existing, metrics, used, pl, pr,
                                      target, min_diff)
            if cand is None:
                continue
            augmented.add(cand)
            used.add(cand)
            insort(order, cand)
            changed = True
            if mode == "single":
                continue
            break
        if mode == "single":
            break
    return augmented


def prune_low_motion(selected: Set[int], metrics) -> Set[int]:
    """Drop the lowest-motion selected frames (bottom percentile), keeping
    span endpoints."""
    cands = [(i, metrics[i].flow) for i in selected
             if metrics[i].flow and math.isfinite(metrics[i].flow)]
    if not cands:
        return selected
    threshold = float(np.percentile([m for _, m in cands],
                                    FLOW_LOW_MOTION_PERCENTILE))
    order = sorted(selected)
    keep = set(selected)
    for i, mag in cands:
        if mag <= threshold and i not in (order[0], order[-1]):
            keep.discard(i)
    return keep


def _flow_value(m):
    """Finite flow magnitude or None (missing flows carry a sentinel)."""
    f = m.flow
    if f is None or not math.isfinite(f) or f >= FLOW_MISSING_HIGH_VALUE:
        return None
    return float(f)


def augment_motion_segments(selected: Set[int], groups, existing: List[int],
                            metrics, min_diff: int) -> Set[int]:
    """Add extra frames to high-motion SEGMENTS after gap augmentation —
    full port of the reference's augment_motion_segments
    (gs360_FrameSelector.py:1537-1607): threshold = max(0.5, P80 of
    positive flows); per-segment budget = ceil(span/min_diff) minus picks
    already in the segment, capped at round(span * 0.4); candidates ranked
    by (flow, score, -index) descending with min_diff spacing."""
    motion_values = []
    for i in existing:
        f = _flow_value(metrics[i])
        if f is not None and f > 0.0:
            motion_values.append(f)
    if not motion_values:
        return set(selected)

    threshold = max(FLOW_HIGH_MOTION_THRESHOLD,
                    float(np.percentile(motion_values, 80.0)))
    augmented = set(selected)
    existing_set = set(existing)
    ratio_limit = max(0.0, min(1.0, FLOW_HIGH_MOTION_RATIO))
    spacing = max(1, min_diff)

    for info in groups:
        seg = [i for i in range(info.start, info.end)
               if i in existing_set and metrics[i].score is not None
               and _flow_value(metrics[i]) is not None]
        if not seg:
            continue
        seg_motion = max(_flow_value(metrics[i]) for i in seg)
        if seg_motion < threshold:
            continue
        current_in_seg = [i for i in augmented
                          if info.start <= i < info.end]
        span = max(1, info.end - info.start)
        budget = max(0, math.ceil(span / spacing) - len(current_in_seg))
        if budget <= 0:
            continue
        if ratio_limit > 0.0:
            ratio_cap = max(1, int(math.floor(span * ratio_limit + 0.5)))
            budget = min(budget, ratio_cap)
            if budget <= 0:
                continue
        candidates = [i for i in seg if i not in augmented]
        if not candidates:
            continue
        candidates.sort(key=lambda i: (_flow_value(metrics[i]),
                                       _score_or_neg_inf(metrics, i), -i),
                        reverse=True)
        added = 0
        for i in candidates:
            if added >= budget:
                break
            if min_diff > 1 and any(abs(i - sel) < min_diff
                                    for sel in augmented):
                continue
            augmented.add(i)
            added += 1
    return augmented


def _spacing_respects(sorted_selected, candidate, min_diff) -> bool:
    """min_diff spacing check against a sorted selection
    (gs360_FrameSelector.py:1067-1078)."""
    if min_diff <= 1 or not sorted_selected:
        return True
    pos = bisect_left(sorted_selected, candidate)
    if pos > 0 and candidate - sorted_selected[pos - 1] < min_diff:
        return False
    if pos < len(sorted_selected) and sorted_selected[pos] - candidate < min_diff:
        return False
    return True


def augment_lowlight_groups(selected: Set[int], records, metrics,
                            groups, min_diff: int,
                            keep_ratio: float = BRIGHTNESS_SHARPNESS_KEEP_RATIO,
                            min_keep: int = BRIGHTNESS_SHARPNESS_MIN_KEEP
                            ) -> Set[int]:
    """Brightness-weighted per-segment augmentation — full port of the
    reference's augment_lowlight_segments (gs360_FrameSelector.py:1665-1732):
    per-segment budget = max(round(span*keep_ratio), min_keep); candidates
    ranked by score * brightness^GROUP_BRIGHTNESS_POWER (low-light frames
    favored), then raw score, then earlier index; min_diff spacing kept."""
    if keep_ratio <= 0.0 and min_keep <= 0:
        return set(selected)
    augmented = set(selected)
    for info in groups:
        span = max(1, info.end - info.start)
        budget = max(int(round(span * max(0.0, min(1.0, keep_ratio)))),
                     int(min_keep))
        if budget <= 0:
            continue
        candidates = [
            i for i in range(info.start, info.end)
            if records[i].exists() and metrics[i].score is not None
            and i not in augmented]
        if not candidates:
            continue

        def lowlight_score(i):
            b = max(1e-6, float(metrics[i].brightness))
            return float(metrics[i].score) * (b ** GROUP_BRIGHTNESS_POWER)

        candidates.sort(key=lambda i: (lowlight_score(i),
                                       _score_or_neg_inf(metrics, i), -i),
                        reverse=True)
        added = 0
        sorted_selected = sorted(augmented)
        for i in candidates:
            if added >= budget:
                break
            if min_diff > 1 and not _spacing_respects(sorted_selected, i,
                                                      min_diff):
                continue
            augmented.add(i)
            insort(sorted_selected, i)
            added += 1
    return augmented


# --------------------------------------------------------------------------
# CSV
# --------------------------------------------------------------------------


def write_csv(path, records, metrics, selected: Set[int], input_mode: str):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for i, rec in enumerate(records):
            m = metrics[i]
            exists = rec.exists()
            score = m.score if (exists and m.score is not None) else -1.0
            bright = m.brightness if exists and m.score is not None else 0.0
            flag = 1 if (i in selected and exists and m.score is not None) else 0
            w.writerow([
                i, rec.input_mode, rec.display_name, rec.pair_base,
                rec.x_path.name if rec.x_path else "",
                rec.y_path.name if rec.y_path else "",
                score, bright, m.group_score, m.flow, flag,
            ])


def load_csv(path, records, metrics) -> List[int]:
    """Load scores/metrics + selection flags keyed by filename."""
    flags = [0] * len(records)
    by_name = {rec.display_name: i for i, rec in enumerate(records)}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "filename" not in reader.fieldnames:
            raise ValueError("CSV missing header/filename column")
        for row in reader:
            name = row.get("filename", "")
            i = by_name.get(name)
            if i is None:
                continue
            try:
                score = float(row.get("score", "-1"))
            except ValueError:
                score = -1.0
            metrics[i].score = score if score >= 0 else None
            try:
                metrics[i].brightness = float(row.get("brightness_mean", "0"))
            except ValueError:
                pass
            try:
                metrics[i].group_score = float(row.get("group_score", "0"))
            except ValueError:
                pass
            try:
                metrics[i].flow = float(row.get("flow_motion", "0"))
            except ValueError:
                pass
            flags[i] = 1 if row.get("selected(1=keep)", "0").strip() == "1" else 0
    return flags


def safe_move(src: pathlib.Path, dst: pathlib.Path) -> Optional[pathlib.Path]:
    try:
        shutil.move(str(src), str(dst))
        return dst
    except Exception:
        try:
            shutil.copy2(str(src), str(dst))
            os.remove(str(src))
            return dst
        except Exception:
            return None


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def create_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=("Score frames, keep the sharp ones, and move the rest "
                     "into in_dir/blur."))
    ap.add_argument("-i", "--in_dir", required=True,
                    help="Input directory containing frames (non-recursive).")
    ap.add_argument("-n", "--segment_size", type=int, default=10,
                    help="Frames per segment (0/1 = per-frame blur mode).")
    ap.add_argument("-d", "--dry_run", action="store_true",
                    help="Score and select without moving files.")
    ap.add_argument("-c", "--csv", help="Write a selection CSV.")
    ap.add_argument("-r", "--reselect_csv",
                    help="Reuse scores from an existing CSV; recompute selection.")
    ap.add_argument("-a", "--apply_csv",
                    help="Apply selections from an existing CSV.")
    ap.add_argument("-m", "--metric",
                    choices=["hybrid", "lapvar", "tenengrad", "fft"],
                    default="hybrid", help="Sharpness metric.")
    ap.add_argument("--score_backend", choices=["ffmpeg", "opencv", "jax"],
                    default="jax",
                    help=("'jax' (device hybrid metrics, default); 'ffmpeg' "
                          "maps to the sobel-YAVG equivalent; 'opencv' is an "
                          "alias of 'jax' for drop-in compatibility."))
    ap.add_argument("-e", "--ext", choices=list(EXT_CHOICES), default="all")
    ap.add_argument("-s", "--sort",
                    choices=["lastnum", "firstnum", "name", "mtime"],
                    default="lastnum")
    ap.add_argument("--input_mode", choices=["auto", "single", "pair"],
                    default="auto")
    ap.add_argument("-w", "--workers", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--score_crop_ratio", type=float,
                    default=DEFAULT_CROP_RATIO)
    ap.add_argument("--min_spacing_frames", type=int, default=None)
    ap.add_argument("--augment_gaps", dest="augment_gaps",
                    action="store_true", default=True)
    ap.add_argument("--no_augment_gaps", dest="augment_gaps",
                    action="store_false")
    ap.add_argument("--augment_gap_mode", choices=["single", "strict"],
                    default="single")
    ap.add_argument("--augment_lowlight", action="store_true")
    ap.add_argument("--flow_method",
                    choices=["lucas_kanade", "farneback"],
                    default="lucas_kanade",
                    help="Optical-flow estimator (reference FLOW_METHOD)")
    ap.add_argument("--compute_optical_flow", action="store_true")
    ap.add_argument("--augment_motion", action="store_true")
    ap.add_argument("--segment-boundary-reopt", dest="segment_boundary_reopt",
                    action="store_true", default=True)
    ap.add_argument("--no-segment-boundary-reopt",
                    dest="segment_boundary_reopt", action="store_false")
    ap.add_argument("--blur-percent", type=float, default=1.0)
    ap.add_argument("--prune_motion", action="store_true")
    ap.add_argument("--ignore-highlights", dest="ignore_highlights",
                    action="store_true", default=True)
    ap.add_argument("--no-ignore-highlights", dest="ignore_highlights",
                    action="store_false")
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "present; cpu runs the plain torch versions")
    ap.add_argument("--stats", action="store_true",
                    help="Print per-stage timers (decode/score/flow) and "
                         "the wall clock after the run.")
    return ap


def main(argv=None) -> int:
    try:
        return _main(argv)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv=None) -> int:
    args = create_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    timers = StageTimers()
    in_dir = pathlib.Path(args.in_dir).expanduser().resolve()
    if not in_dir.is_dir():
        print(f"[ERR] Input directory not found: {in_dir}", file=sys.stderr)
        return 1

    records, input_mode = gather_records(in_dir, args.ext, args.sort,
                                         args.input_mode)
    total = len(records)
    if total == 0:
        print("[WARN] No frames found.", file=sys.stderr)
        return 0
    print(f"[INFO] {total} record(s), input_mode={input_mode}")

    # cooperative cancellation: SIGINT (KeyboardInterrupt) or a lone 'q'
    # on stdin (reference gs360_FrameSelector.py:202-222)
    cancel = threading.Event()
    from gs360x_torch.runtime.cancel import start_cancel_listener
    start_cancel_listener(cancel)

    metrics = [FrameMetrics() for _ in range(total)]
    metric = args.metric
    if args.score_backend == "ffmpeg":
        metric = "sobel-yavg"

    min_diff = (args.min_spacing_frames if args.min_spacing_frames is not None
                else round_half_up(args.segment_size * MIN_DIFF_FRAMES_RATIO))

    need_flow = (args.compute_optical_flow or args.prune_motion
                 or args.augment_motion)

    if args.apply_csv:
        csv_path = pathlib.Path(args.apply_csv)
        if not csv_path.is_absolute():
            csv_path = in_dir / csv_path
        if not csv_path.is_file():
            print(f"Selection CSV not found: {csv_path}", file=sys.stderr)
            return 1
        flags = load_csv(csv_path, records, metrics)
        final = {i for i, f in enumerate(flags)
                 if f == 1 and records[i].exists()}
        groups = []
    elif args.reselect_csv:
        csv_path = pathlib.Path(args.reselect_csv)
        if not csv_path.is_absolute():
            csv_path = in_dir / csv_path
        if not csv_path.is_file():
            print(f"Metrics CSV not found: {csv_path}", file=sys.stderr)
            return 1
        load_csv(csv_path, records, metrics)
        final, groups = _select(args, records, metrics, min_diff)
    else:
        import concurrent.futures as cf

        from gs360x_torch.runtime.throttle import AdaptiveLimiter, MemoryMonitor

        if device.type == "cuda":
            # build the kernels once, before the scoring threads start
            _build.load()

        workers = args.workers or min(8, os.cpu_count() or 1)
        limiter = AdaptiveLimiter(workers)
        done = 0
        lock = threading.Lock()

        def score_one(rec):
            with limiter:
                return rec.index, score_record(
                    rec, metric, args.score_crop_ratio,
                    args.ignore_highlights, args.augment_motion,
                    device=device, timers=timers)

        with MemoryMonitor(limiter), \
                cf.ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(score_one, rec) for rec in records
                       if rec.exists()]
            skipped = total - len(futures)
            done = skipped
            for fut in cf.as_completed(futures):
                if cancel.is_set():
                    pool.shutdown(wait=False, cancel_futures=True)
                    print("[STOPPED] cancelled during scoring",
                          file=sys.stderr)
                    return 130
                idx, m = fut.result()
                with lock:
                    metrics[idx] = m
                    done += 1
                if done % max(1, total // 20) == 0:
                    sys.stdout.write(
                        f"Scoring... {done * 100 // total:3d}% "
                        f"({done}/{total})\r")
                    sys.stdout.flush()
        sys.stdout.write("\n")
        if metric == "hybrid":
            hybrid_normalize(metrics)
        if need_flow:
            print("[INFO] computing optical flow...")
            with timers.stage("flow"):
                compute_flows(records, metrics, method=args.flow_method,
                              device=device)
        final, groups = _select(args, records, metrics, min_diff)

    # augmentation passes (not in apply mode)
    if not args.apply_csv and args.segment_size > 1:
        existing = [i for i in range(total) if records[i].exists()]
        max_spacing = int(args.segment_size * (1 + MAX_SPACING_RATIO))
        if args.prune_motion:
            final = prune_low_motion(final, metrics)
        if args.augment_gaps:
            final = augment_spacing(final, existing, metrics, max_spacing,
                                    min_diff, args.augment_gap_mode)
        if args.augment_lowlight and groups:
            final = augment_lowlight_groups(final, records, metrics, groups,
                                            min_diff)
        if args.augment_motion and groups:
            final = augment_motion_segments(final, groups, existing, metrics,
                                            min_diff)

    # commit: CSV + move losers to blur/
    csv_out = None
    if args.csv:
        csv_out = pathlib.Path(args.csv)
        if not csv_out.is_absolute():
            csv_out = in_dir / csv_out
    elif args.reselect_csv:
        csv_out = pathlib.Path(args.reselect_csv)
        if not csv_out.is_absolute():
            csv_out = in_dir / csv_out
    if csv_out:
        write_csv(csv_out, records, metrics, final, input_mode)
        print(f"[INFO] CSV written: {csv_out}")

    blur_dir = in_dir / "blur"
    kept = moved = skipped = 0
    for i, rec in enumerate(records):
        if not rec.exists():
            skipped += 1
            continue
        if i in final:
            kept += 1
            continue
        if args.dry_run:
            moved += 1
            continue
        blur_dir.mkdir(exist_ok=True)
        ok = True
        for src in rec.file_paths:
            if safe_move(src, blur_dir / src.name) is None:
                ok = False
                skipped += 1
        if ok:
            moved += 1

    if args.stats:
        print(f"[STATS] {timers.report()} | wall "
              f"{time.perf_counter() - t_start:.2f}s")
    mode_txt = "dry-run, no files moved" if args.dry_run else "moved to blur/"
    print(f"[OK] kept={kept}, rejected={moved} ({mode_txt}), "
          f"skipped={skipped}, total={total}")
    return 0


def _select(args, records, metrics, min_diff) -> Tuple[Set[int], list]:
    total = len(records)
    if args.segment_size <= 1:
        blur_fraction = max(0.0, min(args.blur_percent, 100.0)) / 100.0
        valid = [i for i in range(total)
                 if records[i].exists() and metrics[i].score is not None
                 and math.isfinite(metrics[i].score)]
        order = sorted(valid, key=lambda i: (metrics[i].score, i))
        blur_count = round_half_up(len(order) * blur_fraction) \
            if blur_fraction > 0 else 0
        blur_count = max(0, min(len(order), blur_count))
        return set(order[blur_count:]), []

    groups = build_groups(records, metrics, args.segment_size)
    selected = initial_segment_selection(records, metrics, groups)
    if args.segment_boundary_reopt and len(groups) >= 2:
        selected = boundary_reopt(records, metrics, groups, selected, min_diff)
    return selected, groups


if __name__ == "__main__":
    sys.exit(main())
