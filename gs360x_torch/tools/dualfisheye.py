"""gs360x-torch-dualfisheye — dual-fisheye pipeline (DJI Osmo 360 style) on
an NVIDIA GPU through the port's CUDA kernels.

Port of :mod:`gs360x.tools.dualfisheye` (which imports ``gs360x.core`` and
so JAX): the same host-side numpy code under the same names (Metashape
calibration parse, undistort maps with auto-zoom, the SFM10 10-view
layout with per-view lens choice, pairing), the same flags, messages,
outputs and exit codes, plus ``--device {cuda,cpu}`` (default ``cuda``)
and ``--stats``.

Pixels: each decoded lens image goes to the device once per pair and takes
one source pass (``planarize.cu``: RGBX texels of a u8 image); the
undistort remap of each lens and the SFM10 views of each lens group run
through ``remap.cu`` (:mod:`gs360x_torch.kernels.remap_cuda`), one launch
each, over maps uploaded once and kept resident; masks co-warp through the
same maps with ``nearest``; the kernel's store quantizes the outputs
(``rint(clip·255)`` u8), which are fetched once per launch.
``--device cpu`` runs the plain versions.

Decode: ``--workers`` W threads each take the next pair (W + 1 pairs taken
and not yet passed to the device loop); each decodes lens X, and its
mask, while a helper thread of its own decodes lens Y and Y's mask
(:func:`lens_overlap` counts the pairs whose two lens decodes overlapped).

``--mask-input-dir``: a lens image's mask is the file of its own name
there, else ``<stem>.png``, the name MaskSeg's ``--mode mask`` writes (the
JAX tool looks for the first only). A lens without either is written
without masks, counted, and named in one ``[WARN]`` line at the end of
the run.

``--input-lut`` (or ``--input-color-profile osmo360-dlogm`` with
``--dlogm-lut``) decodes each lens image on the device before the remaps:
planarize to f32 planes (×1/255, or ×1/65535 for 16-bit), the trilinear
``.cube`` apply (:func:`gs360x_torch.core.color.apply_cube_lut_planar`,
the table resident on the device), then the Rec.709 → sRGB curve when
``--lut-output-color-space srgb``.

``--camera-extrinsics-xml`` writes the perspective Metashape XML and a
COLMAP text model (``sparse/0``) from the rig's poses and the SFM10 layout
beside the pixels; ``--metadata-only`` writes only those. Both are host
code (:mod:`gs360x_torch.core.pose`, :mod:`gs360x_torch.io.formats`) and
launch nothing.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import pathlib
import sys
import threading
import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from operator import add
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gs360x_torch.core import color as colorlib
from gs360x_torch.core import pose as posemath
from gs360x_torch.core.pose import CV_TO_GL
from gs360x_torch.device import DEVICE_CHOICES, resolve_device
from gs360x_torch.io import ply as plyio
from gs360x_torch.io.formats import colmap_text
from gs360x_torch.io.formats import metashape as msxml
from gs360x_torch.io.formats.model import ColmapModel, Image, Point3
from gs360x_torch.io.image import (AsyncImageWriter, from_float01, read_image,
                                   texel_decode_counts, to_float01)
from gs360x_torch.kernels import _build, remap_cuda, warp_cuda
from gs360x_torch.rig.presets import parse_sensor_dimensions
from gs360x_torch.runtime.executor import _quantize_device, upload_rows
from gs360x_torch.runtime.prefetch import Prefetcher
from gs360x_torch.runtime.profiling import (StageTimers, WindowCounter,
                                             maybe_trace, span)
from gs360x_torch.runtime.throttle import AdaptiveLimiter, MemoryMonitor
from gs360x_torch.templates import default_osmo360_calibration_path


# The reference accepts exactly {"equisolid_fisheye"} (its shipped Osmo 360
# template and every real Metashape fisheye export use that type;
# gs360_DualFisheyeDistortionCalibration.py:49). "fisheye" is kept as an
# alias for starter calibrations generated by earlier gs360x versions —
# the projection math applied is the same equisolid model either way.
SUPPORTED_MODELS = {"equisolid_fisheye", "fisheye"}


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------


@dataclass
class SensorCalibration:
    sensor_id: str
    model_type: str
    width: int
    height: int
    f: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    b1: float = 0.0
    b2: float = 0.0

    @property
    def center(self) -> Tuple[float, float]:
        return self.width * 0.5 + self.cx, self.height * 0.5 + self.cy


def _parse_float(node: ET.Element, tag: str, default: float) -> float:
    child = node.find(tag)
    if child is None or not (child.text or "").strip():
        return default
    try:
        return float(child.text)
    except ValueError:
        return default


def load_metashape_calibration(xml_path) -> Tuple[Dict[str, SensorCalibration],
                                                  Dict[str, str]]:
    """Sensor calibrations (adjusted-class preferred) + camera→sensor map."""
    root = ET.parse(str(xml_path)).getroot()
    sensor_map: Dict[str, SensorCalibration] = {}
    camera_to_sensor: Dict[str, str] = {}
    for sensor in root.findall(".//sensors/sensor"):
        sid = (sensor.attrib.get("id") or "").strip()
        if not sid:
            continue
        calibs = sensor.findall("calibration")
        calib = None
        for cls in ("adjusted", "initial"):
            for c in calibs:
                if (c.attrib.get("class") or "").strip().lower() == cls:
                    calib = c
                    break
            if calib is not None:
                break
        if calib is None and calibs:
            calib = calibs[0]
        if calib is None:
            continue
        model = ((calib.attrib.get("type") or sensor.attrib.get("type")
                  or "")).strip().lower()
        res = calib.find("resolution")
        if res is None:
            res = sensor.find("resolution")
        if res is None:
            continue
        w = int(res.attrib.get("width", "0"))
        h = int(res.attrib.get("height", "0"))
        if w <= 0 or h <= 0:
            continue
        cal = SensorCalibration(
            sensor_id=sid, model_type=model, width=w, height=h,
            f=_parse_float(calib, "f", 0.0),
            cx=_parse_float(calib, "cx", 0.0),
            cy=_parse_float(calib, "cy", 0.0),
            k1=_parse_float(calib, "k1", 0.0),
            k2=_parse_float(calib, "k2", 0.0),
            k3=_parse_float(calib, "k3", 0.0),
            k4=_parse_float(calib, "k4", 0.0),
            p1=_parse_float(calib, "p1", 0.0),
            p2=_parse_float(calib, "p2", 0.0),
            b1=_parse_float(calib, "b1", 0.0),
            b2=_parse_float(calib, "b2", 0.0))
        if cal.f > 0:
            sensor_map[sid] = cal
    for cam in root.findall(".//cameras/camera"):
        label = (cam.attrib.get("label") or "").strip()
        sid = (cam.attrib.get("sensor_id") or "").strip()
        if label and sid:
            camera_to_sensor[label] = sid
    return sensor_map, camera_to_sensor


# --------------------------------------------------------------------------
# remap math (host numpy maps, applied on the device)
# --------------------------------------------------------------------------


def _brown(x, y, c: SensorCalibration):
    r2 = x * x + y * y
    radial = 1.0 + r2 * (c.k1 + r2 * (c.k2 + r2 * (c.k3 + r2 * c.k4)))
    xd = x * radial
    yd = y * radial
    if c.p1 != 0.0 or c.p2 != 0.0:
        xy = x * y
        xd = xd + c.p1 * (r2 + 2.0 * x * x) + 2.0 * c.p2 * xy
        yd = yd + c.p2 * (r2 + 2.0 * y * y) + 2.0 * c.p1 * xy
    return xd, yd, r2


def remap_for_zoom(calib: SensorCalibration, dst_x, dst_y, zoom: float,
                   lens_fov_deg: float):
    """Undistort map: output pixel → distorted source pixel
    (reference ``:1008-1051``). Returns (src_x, src_y, valid, valid_model)."""
    cx0, cy0 = calib.center
    y0 = (dst_y - cy0) / calib.f
    x0 = (dst_x - cx0 - y0 * calib.b2) / (calib.f + calib.b1)
    x = x0 / zoom
    y = y0 / zoom
    xd, yd, r2 = _brown(x, y, calib)
    src_x = cx0 + xd * calib.f + xd * calib.b1 + yd * calib.b2
    src_y = cy0 + yd * calib.f
    r = np.sqrt(np.maximum(r2, 0.0))
    theta = 2.0 * np.arcsin(np.clip(r * 0.5, 0.0, 1.0))
    theta_max = math.radians(max(1.0, min(360.0, lens_fov_deg)) * 0.5)
    valid_model = theta <= theta_max
    valid = (valid_model & (src_x >= 0) & (src_x <= calib.width - 1)
             & (src_y >= 0) & (src_y <= calib.height - 1))
    return src_x, src_y, valid, valid_model


def estimate_auto_undistort_zoom(calib: SensorCalibration,
                                 sample_count: int = 192,
                                 lens_fov_deg: float = 190.0) -> float:
    """Smallest zoom with no out-of-bounds samples (bisection,
    reference ``:1054-1117``)."""
    steps = max(32, sample_count)
    gx = np.linspace(0.0, calib.width - 1.0, steps, dtype=np.float32)
    gy = np.linspace(0.0, calib.height - 1.0, steps, dtype=np.float32)
    dx, dy = np.meshgrid(gx, gy)

    def overflow(zoom):
        sx, sy, _v, vm = remap_for_zoom(calib, dx, dy, zoom, lens_fov_deg)
        if not vm.any():
            return 0.0
        sx, sy = sx[vm], sy[vm]
        return float(max(np.maximum(0, -sx).max(),
                         np.maximum(0, sx - (calib.width - 1)).max(),
                         np.maximum(0, -sy).max(),
                         np.maximum(0, sy - (calib.height - 1)).max()))

    if overflow(1.0) <= 0.0:
        return 1.0
    low, high = 1.0, 1.0
    for _ in range(20):
        high *= 1.2
        if overflow(high) <= 0.0:
            break
    if overflow(high) > 0.0:
        return high
    for _ in range(20):
        mid = 0.5 * (low + high)
        if overflow(mid) <= 0.0:
            high = mid
        else:
            low = mid
    return high


@dataclass
class RemapCache:
    map_x: np.ndarray
    map_y: np.ndarray
    valid: np.ndarray
    undistort_zoom: float


def build_remap_cache(calib: SensorCalibration,
                      undistort_zoom: Optional[float],
                      lens_fov_deg: float) -> RemapCache:
    if calib.model_type not in SUPPORTED_MODELS:
        raise ValueError(f"Unsupported sensor model '{calib.model_type}' "
                         f"(supported: {', '.join(sorted(SUPPORTED_MODELS))})")
    gx = np.arange(calib.width, dtype=np.float32)
    gy = np.arange(calib.height, dtype=np.float32)
    dx, dy = np.meshgrid(gx, gy)
    zoom = (float(undistort_zoom) if undistort_zoom is not None
            else estimate_auto_undistort_zoom(calib,
                                              lens_fov_deg=lens_fov_deg))
    zoom = max(1e-6, zoom)
    sx, sy, valid, _vm = remap_for_zoom(calib, dx, dy, zoom, lens_fov_deg)
    return RemapCache(sx.astype(np.float32), sy.astype(np.float32), valid,
                      zoom)


def rotate_view_vectors(vectors: np.ndarray, yaw_deg: float,
                        pitch_deg: float) -> np.ndarray:
    """Pitch-then-yaw rotation in the tool's y-up frame
    (reference ``:1310-1339``)."""
    pitch, yaw = math.radians(pitch_deg), math.radians(yaw_deg)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    y1 = cp * y + sp * z
    z1 = -sp * y + cp * z
    x2 = cy * x + sy * z1
    z2 = -sy * x + cy * z1
    return np.stack([x2, y1, z2], axis=-1)


def wrap_angle_deg(a: float) -> float:
    return ((float(a) + 180.0) % 360.0) - 180.0


def compute_view_fov_deg(focal_mm: float, sensor_mm: str):
    dims = parse_sensor_dimensions(sensor_mm)
    w_mm = dims[0] if dims else 36.0
    h_mm = dims[1] if len(dims) > 1 else w_mm
    hfov = math.degrees(2.0 * math.atan(w_mm / (2.0 * focal_mm)))
    vfov = math.degrees(2.0 * math.atan(h_mm / (2.0 * focal_mm)))
    return hfov, vfov


def build_sfm10_specs(output_size: int, focal_mm: float, sensor_mm: str,
                      yaw_delta_deg: float, pitch_delta_deg: float
                      ) -> List[dict]:
    """10-view layout around the front/back lens axes (reference
    ``:1258-1307``)."""
    if output_size <= 0:
        raise ValueError("--perspective-size must be > 0")
    if not 0.0 < yaw_delta_deg < 180.0:
        raise ValueError("--perspective-yaw-delta-deg must be in (0, 180)")
    if not 0.0 < pitch_delta_deg < 89.9:
        raise ValueError("--perspective-pitch-delta-deg must be in (0, 89.9)")
    hfov, vfov = compute_view_fov_deg(focal_mm, sensor_mm)
    layout = [
        ("A", 0.0, 0.0), ("A_U", 0.0, pitch_delta_deg),
        ("A_D", 0.0, -pitch_delta_deg), ("B", yaw_delta_deg, 0.0),
        ("E", 180.0 - yaw_delta_deg, 0.0), ("F", 180.0, 0.0),
        ("F_U", 180.0, pitch_delta_deg), ("F_D", 180.0, -pitch_delta_deg),
        ("G", 180.0 + yaw_delta_deg, 0.0),
        ("J", 360.0 - yaw_delta_deg, 0.0),
    ]
    return [dict(view_id=v, yaw_deg=y, pitch_deg=p, hfov_deg=hfov,
                 vfov_deg=vfov, width=output_size, height=output_size)
            for v, y, p in layout]


def build_direct_perspective_map(calib: SensorCalibration, yaw_deg: float,
                                 pitch_deg: float, hfov_deg: float,
                                 vfov_deg: float, out_w: int, out_h: int,
                                 lens_fov_deg: float):
    """Equisolid fisheye lens → perspective map (reference ``:1759-1823``)."""
    xs = ((np.arange(out_w, dtype=np.float32) + 0.5) / out_w) * 2.0 - 1.0
    ys = ((np.arange(out_h, dtype=np.float32) + 0.5) / out_h) * 2.0 - 1.0
    uu, vv = np.meshgrid(xs, ys)
    rays = np.stack([
        math.tan(math.radians(min(179.9, max(1e-3, hfov_deg))) / 2) * uu,
        math.tan(math.radians(min(179.9, max(1e-3, vfov_deg))) / 2) * (-vv),
        np.ones_like(uu)], axis=-1)
    rays /= np.maximum(np.linalg.norm(rays, axis=2, keepdims=True), 1e-12)
    rays = rotate_view_vectors(rays, yaw_deg, pitch_deg)
    rx, ry, rz = rays[..., 0], rays[..., 1], rays[..., 2]
    theta = np.arccos(np.clip(rz, -1.0, 1.0))
    theta_max = math.radians(max(1.0, min(360.0, lens_fov_deg)) * 0.5)
    rho = np.sqrt(rx * rx + ry * ry)
    scale = np.zeros_like(rho)
    nz = rho > 1e-12
    scale[nz] = 2.0 * np.sin(theta[nz] * 0.5) / rho[nz]
    x_n = rx * scale
    y_n = -ry * scale  # image Y grows downward
    xd, yd, _ = _brown(x_n, y_n, calib)
    cx0, cy0 = calib.center
    map_x = cx0 + xd * calib.f + xd * calib.b1 + yd * calib.b2
    map_y = cy0 + yd * calib.f
    valid = ((theta <= theta_max) & (map_x >= 0)
             & (map_x <= calib.width - 1) & (map_y >= 0)
             & (map_y <= calib.height - 1))
    return map_x.astype(np.float32), map_y.astype(np.float32), valid


def build_perspective_spec_maps(sensor_map, sensor_id_x, sensor_id_y, specs,
                                lens_x_yaw_deg, lens_y_yaw_deg, lens_fov_deg):
    """Per view: try both lenses, keep the one with the best valid ratio."""
    out = {}
    for spec in specs:
        candidates = []
        for lens_key, lens_yaw, sid in (("X", lens_x_yaw_deg, sensor_id_x),
                                        ("Y", lens_y_yaw_deg, sensor_id_y)):
            yaw_rel = wrap_angle_deg(spec["yaw_deg"] - lens_yaw)
            mx, my, valid = build_direct_perspective_map(
                sensor_map[sid], yaw_rel, spec["pitch_deg"],
                spec["hfov_deg"], spec["vfov_deg"], spec["width"],
                spec["height"], lens_fov_deg)
            candidates.append((float(valid.mean()), -abs(yaw_rel), lens_key,
                               mx, my, valid))
        best = max(candidates, key=lambda c: (c[0], c[1]))
        out[spec["view_id"]] = {"lens_key": best[2], "map_x": best[3],
                                "map_y": best[4], "valid": best[5]}
    return out


# --------------------------------------------------------------------------
# pairing
# --------------------------------------------------------------------------


def split_stem_suffix(stem, x_suffix, y_suffix):
    if stem.endswith(x_suffix):
        return stem[: -len(x_suffix)], "X"
    if stem.endswith(y_suffix):
        return stem[: -len(y_suffix)], "Y"
    return stem, ""


def build_pair_records(paths, x_suffix, y_suffix):
    table: Dict[str, Dict[str, pathlib.Path]] = {}
    for p in paths:
        base, key = split_stem_suffix(p.stem, x_suffix, y_suffix)
        if key in ("X", "Y"):
            table.setdefault(base, {})[key] = p
    return [(base, t["X"], t["Y"]) for base, t in sorted(table.items())
            if "X" in t and "Y" in t]


def resolve_sensor_ids(camera_to_sensor, sensor_map, base, x_path, y_path,
                       x_suffix, y_suffix, default_x, default_y):
    sid_x = camera_to_sensor.get(x_path.stem, default_x)
    sid_y = camera_to_sensor.get(y_path.stem, default_y)
    if sid_x not in sensor_map or sid_y not in sensor_map:
        ids = sorted(sensor_map)
        if len(ids) >= 2:
            sid_x = sid_x if sid_x in sensor_map else ids[0]
            sid_y = sid_y if sid_y in sensor_map else ids[1]
        elif ids:
            sid_x = sid_y = ids[0]
    return sid_x, sid_y


def default_calibration_path() -> pathlib.Path:
    """The generated DJI Osmo 360 starter calibration
    (``gs360x_torch.templates``, cached under ``~/.gs360x``), used when no
    ``--camera-xml`` is given."""
    return default_osmo360_calibration_path()


# --------------------------------------------------------------------------
# device resampling
# --------------------------------------------------------------------------


# value = (map_x, map_y, valid, prepared): keeping the map arrays in the
# value pins them alive, so a recycled id() can never alias a stale entry
_PREPARED_REMAPS: Dict[tuple, tuple] = {}


def prepared_remap(map_x, map_y, valid, src_h: int, src_w: int,
                   device: torch.device):
    """The :class:`~gs360x_torch.kernels.remap_cuda.PreparedRemap` of one
    map for one source size, cached: the maps go to the device once per
    run."""
    key = (id(map_x), id(map_y), id(valid), src_h, src_w, str(device))
    hit = _PREPARED_REMAPS.get(key)
    if hit is not None and hit[0] is map_x and hit[1] is map_y \
            and hit[2] is valid:
        return hit[3]
    prep = remap_cuda.PreparedRemap(map_x, map_y, valid, src_w=src_w,
                                    src_h=src_h, device=device)
    _PREPARED_REMAPS[key] = (map_x, map_y, valid, prep)
    return prep


def device_remap(image: np.ndarray, map_x, map_y, valid, *, interp: str,
                 fill: float, quantize: bool = False,
                 device: torch.device) -> np.ndarray:
    """Remap one host image on ``device`` (``remap.cu`` on a CUDA device);
    (H, W, C) in, (h, w, C) out, or 2-D in and out. ``quantize=True``
    has the kernel store u8, so the fetch is a quarter of the f32 one."""
    h, w = image.shape[:2]
    out = prepared_remap(map_x, map_y, valid, h, w, device)(
        remap_cuda.remap_source(image, h, w, device), interp=interp,
        fill=fill, out_dtype=torch.uint8 if quantize else None)
    out = out.permute(1, 2, 0).cpu().numpy()
    return out[..., 0] if image.ndim == 2 else out


def prepare_input_planes(img: np.ndarray, input_lut, lut_output_color_space:
                         str, *, device: torch.device,
                         table: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One decoded lens image → the source of the remaps on ``device``:
    the port of :func:`gs360x.tools.dualfisheye.prepare_input_image`,
    which returns the same values as (H, W, 3) floats on the host.

    Without a LUT: :func:`remap_cuda.remap_source` (a u8 image becomes RGBX
    texels of its bytes, an RGBX decode goes as it is; a u16 one f32
    planes).
    With one: (3, H, W) f32 planes scaled to [0, 1] by ``planarize.cu``,
    the trilinear LUT (``table``: :func:`colorlib.lut_table` on
    ``device``), then Rec.709 → sRGB when ``lut_output_color_space`` is
    ``srgb``."""
    if input_lut is None:
        return remap_cuda.remap_source(img, img.shape[0], img.shape[1],
                                       device)
    if img.ndim != 3 or img.shape[2] != 3 \
            or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"LUT decode: expected an (H, W, 3) u8/u16 image, "
                         f"got {img.shape} {img.dtype}")
    scale = 1.0 / 255.0 if img.dtype == np.uint8 else 1.0 / 65535.0
    planes = warp_cuda.planarize_rows(upload_rows(img, device), scale,
                                      torch.float32)
    planes = colorlib.apply_cube_lut_planar(planes, input_lut, table)
    if lut_output_color_space == "srgb":
        planes = colorlib.rec709_to_srgb(planes)
    return planes


class _LensViews:
    """The SFM10 views one lens serves, as one resident
    :class:`~gs360x_torch.kernels.remap_cuda.PreparedRemapBatch` per source
    size and interp (masks share the image batch's maps)."""

    def __init__(self, view_ids, maps, device):
        self.view_ids = list(view_ids)
        self._maps = maps          # [(map_x, map_y, valid), ...]
        self._device = device
        self._batches: Dict[tuple, object] = {}

    def batch(self, src_h: int, src_w: int, interp: str):
        key = (src_h, src_w)
        base = self._batches.get(key)
        if base is None:
            base = remap_cuda.PreparedRemapBatch(
                self._maps, src_w=src_w, src_h=src_h, interp=interp,
                device=self._device)
            self._batches[key] = base
        return base if base.interp == interp else base.with_interp(interp)

    def render(self, source: torch.Tensor, size: Tuple[int, int],
               interp: str, fill: float) -> np.ndarray:
        """(V, C, h, w) u8 on the host from one lens source (texels or
        planes of a ``size`` = (height, width) image): one launch, whose
        store quantizes, and one fetch."""
        batch = self.batch(size[0], size[1], interp)
        return batch(source, fill=fill, out_dtype=torch.uint8).cpu().numpy()


# --------------------------------------------------------------------------
# masks
# --------------------------------------------------------------------------


# each lens image's mask lookup: (start on time.perf_counter, 1, found)
_MASKS = WindowCounter(looked_up=add, found=add)


def mask_counts(start: Optional[float] = None,
                end: Optional[float] = None) -> dict:
    """``{"looked_up", "found"}``: the lens images of this process whose
    mask was looked for under ``--mask-input-dir``, and those that had one;
    given ``start`` and ``end`` (``time.perf_counter``), only the lookups
    of the newest 65536 that started in [start, end)."""
    return _MASKS.read(start, end)


def find_mask(mask_dir: pathlib.Path, image: pathlib.Path
              ) -> Optional[pathlib.Path]:
    """The mask of lens image ``image`` under ``mask_dir``: the file of
    its own name, else ``<stem>.png`` (MaskSeg's name), else None; each
    call counted by :func:`mask_counts`."""
    t0 = time.perf_counter()
    found = next((p for p in (mask_dir / image.name,
                              mask_dir / f"{image.stem}.png")
                  if p.exists()), None)
    _MASKS.add(t0, looked_up=1, found=found is not None)
    return found


# each pair's decode: (the earlier lens's start on time.perf_counter, 1,
# whether the two lens decodes overlapped in time)
_LENS_OVERLAP = WindowCounter(pairs=add, overlapped=add)


def lens_overlap(start: Optional[float] = None,
                 end: Optional[float] = None) -> dict:
    """``{"pairs", "overlapped"}``: the lens pairs this process decoded,
    and those whose two lens decodes (each lens image with its mask) ran
    at the same time for a while; given ``start`` and ``end``
    (``time.perf_counter``), only the pairs of the newest 65536 whose
    decode started in [start, end)."""
    return _LENS_OVERLAP.read(start, end)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def create_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=("Dual-fisheye pipeline: Metashape calibration XML -> "
                     "undistortion and direct perspective export, on an "
                     "NVIDIA GPU (PyTorch + CUDA kernels)."))
    ap.add_argument("-i", "--input-dir", default=None,
                    help="Folder of _X/_Y fisheye pairs")
    ap.add_argument("--metadata-only", action="store_true",
                    help="Export metadata without processing pixels")
    ap.add_argument("-x", "--camera-xml", default=None,
                    help="Metashape calibration XML (fisheye sensors); "
                         "defaults to the generated Osmo 360 starter "
                         "calibration")
    ap.add_argument("-o", "--output-dir", default=None)
    ap.add_argument("--suffixes", default="_X,_Y")
    ap.add_argument("--ext", default="jpg,jpeg,png,tif,tiff")
    ap.add_argument("--input-lut", default=None,
                    help=".cube 3D LUT applied on load (D-Log M decode)")
    ap.add_argument("--lut-output-color-space",
                    choices=("srgb", "rec709", "passthrough"),
                    default="srgb")
    ap.add_argument("--input-color-profile",
                    choices=("native", "osmo360-dlogm"), default="native",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dlogm-lut", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sensor-id-x", default="0")
    ap.add_argument("--sensor-id-y", default="1")
    ap.add_argument("--interpolation", choices=("nearest", "linear", "cubic"),
                    default="cubic")
    ap.add_argument("--undistort-zoom", default="auto",
                    help="'auto' or a fixed zoom factor")
    ap.add_argument("--mask-outside-model", dest="mask_outside_model",
                    action="store_true", default=True)
    ap.add_argument("--no-mask-outside-model", dest="mask_outside_model",
                    action="store_false")
    ap.add_argument("--mask-value", type=int, default=0)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--workers", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--memory-throttle-percent", type=float, default=80.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--report-json", default=None)
    ap.add_argument("--no-perspective", action="store_true")
    ap.add_argument("--save-fisheye-output", dest="fisheye_output",
                    action="store_true", default=False)
    ap.add_argument("--no-fisheye-output", dest="fisheye_output",
                    action="store_false")
    ap.add_argument("--fisheye-output-dir", default=None)
    ap.add_argument("--save-color-corrected-output", action="store_true")
    ap.add_argument("--color-corrected-output-dir", default=None)
    ap.add_argument("--perspective-output-dir", default=None)
    ap.add_argument("--perspective-ext", default=".jpg")
    ap.add_argument("--perspective-mask-ext", default=".png")
    ap.add_argument("--perspective-size", type=int, default=1750)
    ap.add_argument("--perspective-focal-mm", type=float, default=14.0)
    ap.add_argument("--perspective-sensor-mm", default="36 36")
    ap.add_argument("--perspective-yaw-delta-deg", type=float, default=40.0)
    ap.add_argument("--perspective-pitch-delta-deg", type=float, default=40.0)
    ap.add_argument("--perspective-jpeg-quality", type=int, default=95)
    ap.add_argument("--lens-fov-deg", type=float, default=190.0)
    ap.add_argument("--lens-x-yaw-deg", type=float, default=0.0)
    ap.add_argument("--lens-y-yaw-deg", type=float, default=180.0)
    ap.add_argument("--camera-extrinsics-xml", default=None,
                    help="Metashape alignment XML for metadata export")
    ap.add_argument("--pointcloud-ply", default=None)
    ap.add_argument("--mask-input-dir", default=None)
    ap.add_argument("--perspective-metashape-xml-name",
                    default="perspective_cams.xml")
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "present; cpu runs the plain torch versions")
    ap.add_argument("--stats", action="store_true",
                    help="Print per-stage pipeline timers after the run")
    return ap


def export_perspective_camera_metadata(args, specs, out_dir) -> None:
    """Rig extrinsics XML + SFM10 layout → perspective Metashape XML +
    COLMAP text under ``sparse/0`` (host numpy f64; no device work)."""
    xml_path = pathlib.Path(args.camera_extrinsics_xml).expanduser().resolve()
    if not xml_path.is_file():
        raise ValueError(f"Camera extrinsics XML not found: {xml_path}")
    cameras = msxml.read_spherical_cameras(xml_path)

    hfov = specs[0]["hfov_deg"]
    size = int(specs[0]["width"])
    f_px = (args.perspective_focal_mm
            / (compute_sensor_w_mm(args.perspective_sensor_mm) / size))
    model = ColmapModel()
    cam_id = model.add_camera("PINHOLE", size, size,
                              [f_px, f_px, size * 0.5, size * 0.5])
    suffixes = args.suffixes.split(",")
    x_suffix = suffixes[0] if suffixes else "_X"
    y_suffix = suffixes[1] if len(suffixes) > 1 else "_Y"
    ext = args.perspective_ext.lstrip(".")
    seen_bases = set()
    idx = 1
    for _cid, label, mat in cameras:
        base, key = split_stem_suffix(label, x_suffix, y_suffix)
        if key != "X" or base in seen_bases:
            continue  # the X lens pose anchors the rig
        seen_bases.add(base)
        base_gl = np.asarray(mat, np.float64) @ CV_TO_GL
        for spec in specs:
            r_rel = posemath.mat4_from_rt(posemath.yaw_pitch_to_rot_gl(
                spec["yaw_deg"], spec["pitch_deg"]))
            c2w_gl = base_gl @ r_rel
            name = f"{base}_{spec['view_id']}.{ext}"
            model.images.append(Image.from_c2w_gl(idx, c2w_gl, cam_id, name))
            idx += 1
    if not model.images:
        raise ValueError("no X-lens camera poses found in extrinsics XML")

    if args.pointcloud_ply:
        xyz, rgb = plyio.load_ply_xyz_rgb(args.pointcloud_ply)
        model.points = [Point3(i + 1, float(p[0]), float(p[1]), float(p[2]),
                               int(c[0]), int(c[1]), int(c[2]))
                        for i, (p, c) in enumerate(zip(xyz, rgb))]

    out_xml = out_dir / args.perspective_metashape_xml_name
    msxml.write_perspective_xml(out_xml, model)
    print(f"[OK] perspective Metashape XML: {out_xml}")
    colmap_dir = out_dir / "sparse" / "0"
    colmap_text.write_model(colmap_dir, model)
    print(f"[OK] perspective COLMAP: {colmap_dir}")


def compute_sensor_w_mm(sensor_mm: str) -> float:
    dims = parse_sensor_dimensions(sensor_mm)
    return dims[0] if dims else 36.0


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
    interp = {"nearest": "nearest", "linear": "bilinear",
              "cubic": "catmull-rom"}[args.interpolation]

    # legacy profile -> LUT mapping, as the JAX tool does it
    if args.input_color_profile == "osmo360-dlogm" and not args.input_lut:
        if not args.dlogm_lut:
            print("[ERR] --input-color-profile osmo360-dlogm requires "
                  "--dlogm-lut (the D-Log M .cube is user-supplied)",
                  file=sys.stderr)
            return 2
        args.input_lut = args.dlogm_lut

    if args.camera_xml:
        xml_path = pathlib.Path(args.camera_xml).expanduser().resolve()
    else:
        xml_path = default_calibration_path()
        print(f"[INFO] using generated Osmo 360 starter calibration: "
              f"{xml_path}")
    if not xml_path.is_file():
        print(f"[ERR] calibration XML not found: {xml_path}", file=sys.stderr)
        return 1
    sensor_map, camera_to_sensor = load_metashape_calibration(xml_path)
    if not sensor_map:
        print("[ERR] no usable sensor calibrations in XML", file=sys.stderr)
        return 1
    print(f"[INFO] calibration sensors: {sorted(sensor_map)}")

    try:
        specs = build_sfm10_specs(
            args.perspective_size, args.perspective_focal_mm,
            args.perspective_sensor_mm, args.perspective_yaw_delta_deg,
            args.perspective_pitch_delta_deg)
    except ValueError as exc:
        print(f"[ERR] {exc}", file=sys.stderr)
        return 1

    out_dir = pathlib.Path(args.output_dir).expanduser().resolve() \
        if args.output_dir else (
            pathlib.Path(args.input_dir).expanduser().resolve() / "undistorted"
            if args.input_dir else xml_path.parent / "dualfisheye_out")
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.metadata_only:
        if not args.camera_extrinsics_xml:
            print("[ERR] --metadata-only requires --camera-extrinsics-xml",
                  file=sys.stderr)
            return 1
        try:
            export_perspective_camera_metadata(args, specs, out_dir)
        except ValueError as exc:
            print(f"[ERR] {exc}", file=sys.stderr)
            return 1
        return 0

    if not args.input_dir:
        print("[ERR] --input-dir is required unless --metadata-only",
              file=sys.stderr)
        return 1
    in_dir = pathlib.Path(args.input_dir).expanduser().resolve()
    if not in_dir.is_dir():
        print(f"[ERR] input dir not found: {in_dir}", file=sys.stderr)
        return 1
    exts = {"." + e.strip().lstrip(".").lower()
            for e in args.ext.split(",") if e.strip()}
    files = sorted(p for p in in_dir.iterdir()
                   if p.is_file() and p.suffix.lower() in exts)
    suffixes = args.suffixes.split(",")
    x_suffix = suffixes[0] if suffixes else "_X"
    y_suffix = suffixes[1] if len(suffixes) > 1 else "_Y"
    pairs = build_pair_records(files, x_suffix, y_suffix)
    if args.limit > 0:
        pairs = pairs[: args.limit]
    if not pairs:
        print("[WARN] no X/Y pairs found", file=sys.stderr)
        return 0
    print(f"[INFO] {len(pairs)} pair(s)")

    input_lut = None
    if args.input_lut:
        try:
            input_lut = colorlib.load_cube_lut(args.input_lut)
            print(f"[INFO] LUT loaded: {args.input_lut} "
                  f"(size {input_lut.size})")
        except (OSError, ValueError) as exc:
            print(f"[ERR] failed to load LUT: {exc}", file=sys.stderr)
            return 1

    zoom = None if str(args.undistort_zoom).lower() == "auto" \
        else float(args.undistort_zoom)

    # resolve sensors + caches
    resolved = []
    for base, xp, yp in pairs:
        sid_x, sid_y = resolve_sensor_ids(
            camera_to_sensor, sensor_map, base, xp, yp, x_suffix, y_suffix,
            args.sensor_id_x, args.sensor_id_y)
        resolved.append((base, xp, yp, sid_x, sid_y))

    remap_cache: Dict[str, RemapCache] = {}
    if args.fisheye_output:
        for sid in sorted({r[3] for r in resolved} | {r[4] for r in resolved}):
            try:
                remap_cache[sid] = build_remap_cache(
                    sensor_map[sid], zoom, args.lens_fov_deg)
            except ValueError as exc:
                print(f"[ERR] {exc}", file=sys.stderr)
                return 1
            print(f"[INFO] sensor {sid}: undistort zoom="
                  f"{remap_cache[sid].undistort_zoom:.4f}")

    timers = StageTimers()
    map_cache: Dict[Tuple[str, str], dict] = {}
    if not args.no_perspective:
        for key in sorted({(r[3], r[4]) for r in resolved}):
            with timers.stage("map_build"):
                map_cache[key] = build_perspective_spec_maps(
                    sensor_map, key[0], key[1], specs, args.lens_x_yaw_deg,
                    args.lens_y_yaw_deg, args.lens_fov_deg)
            chosen = {v: m["lens_key"] for v, m in map_cache[key].items()}
            print(f"[INFO] lens choice {key}: {chosen}")

    if args.dry_run:
        print(f"[DRY] would process {len(pairs)} pair(s) x "
              f"{len(specs) if not args.no_perspective else 0} views")
        return 0

    if device.type == "cuda":
        # a kernel that fails to build raises here, not as a failed pair
        _build.load()

    mask_dir = pathlib.Path(args.mask_input_dir).resolve() \
        if args.mask_input_dir else None
    persp_dir = pathlib.Path(args.perspective_output_dir).resolve() \
        if args.perspective_output_dir else out_dir / "perspective"
    color_dir = pathlib.Path(args.color_corrected_output_dir).resolve() \
        if args.color_corrected_output_dir else out_dir / "color_corrected"
    images_dir = persp_dir / "images"
    masks_dir = persp_dir / "masks"

    fill = args.mask_value / 255.0
    report = {"pairs": [], "processed": 0, "failed": 0}
    # the LUT's table goes to the device once per run
    lut_table = (colorlib.lut_table(input_lut, device)
                 if input_lut is not None else None)

    # the model mask (or all-valid) of every map, fixed for the run, so
    # the device caches key on stable arrays
    def run_valid(valid):
        return valid if args.mask_outside_model else np.ones_like(valid)

    undistort = {sid: (c.map_x, c.map_y, run_valid(c.valid))
                 for sid, c in remap_cache.items()}
    lens_views: Dict[Tuple[str, str], Dict[str, _LensViews]] = {}
    for key, maps in map_cache.items():
        lens_views[key] = {}
        for lens in ("X", "Y"):
            ids = [s["view_id"] for s in specs
                   if maps[s["view_id"]]["lens_key"] == lens]
            if ids:
                lens_views[key][lens] = _LensViews(
                    ids, [(maps[v]["map_x"], maps[v]["map_y"],
                           run_valid(maps[v]["valid"])) for v in ids],
                    device)

    # memory-adaptive prefetch of pair decodes (reference's throttled
    # worker loop): n_workers decode threads, n_workers + 1 pairs taken and
    # not yet passed by the device loop, fewer pairs decoded at once under
    # memory pressure. Each decode thread has a helper for the pair's Y
    # lens (lens_pool).
    n_workers = args.workers or min(4, os.cpu_count() or 1)
    limiter = AdaptiveLimiter(n_workers)
    if args.memory_throttle_percent:
        high = max(0.05, min(1.0, args.memory_throttle_percent / 100.0))
    else:
        high = 1.01  # throttling disabled

    # Pillow's own RGBX goes to the card as texels, unless the host reads
    # the lens image or the LUT path takes it
    want_texels = input_lut is None and not args.save_color_corrected_output

    def read_mask(lens_path):
        path = find_mask(mask_dir, lens_path) if mask_dir else None
        if path is None:
            return None
        with timers.stage("mask_decode"):
            return read_image(path)[..., 0]

    def decode_lens(path):
        """Lens image ``path`` and then its mask, each as read or as the
        exception its read raised (no mask read after a failed image), and
        the decode's start and end on ``time.perf_counter``."""
        t0 = time.perf_counter()
        try:
            img = read_image(path, texels=want_texels)
        except Exception as exc:
            return (exc, None), (t0, time.perf_counter())
        try:
            mask = read_mask(path)
        except Exception as exc:
            mask = exc
        return (img, mask), (t0, time.perf_counter())

    def decode_lens_y(path):
        """The helper's lens: a ``decode`` span in the ring only, so that
        ``[STATS]`` keeps one ``decode`` a pair."""
        with span("decode"):
            return decode_lens(path)

    def decode_pair(item):
        """The pair and its lens images and masks, or the first exception
        of X's image, Y's image, X's mask, Y's mask: that pair's own
        failure. Lens Y decodes on a helper while this thread decodes X."""
        xp, yp = item[1:3]
        try:
            with limiter, timers.stage("decode"):
                lens_y = lens_pool.submit(decode_lens_y, yp)
                (img_x, mask_x), (x0, x1) = decode_lens(xp)
                (img_y, mask_y), (y0, y1) = lens_y.result()
        except Exception as exc:
            return item, exc
        _LENS_OVERLAP.add(min(x0, y0), pairs=1,
                          overlapped=max(x0, y0) < min(x1, y1))
        parts = (img_x, img_y, mask_x, mask_y)
        return item, next((p for p in parts if isinstance(p, Exception)),
                          parts)

    masks_before, overlap_before = mask_counts(), lens_overlap()

    with maybe_trace("dualfisheye"), \
            AsyncImageWriter(workers=8, timers=timers) as writer, \
            MemoryMonitor(limiter, high=high,
                          low=max(0.0, high - 0.10)), \
            concurrent.futures.ThreadPoolExecutor(n_workers) as lens_pool:
        decoded = Prefetcher(resolved, threading.Event(), depth=1,
                             timers=timers, decode=decode_pair,
                             width=n_workers)
        for pi, ((base, xp, yp, sid_x, sid_y), images) in enumerate(
                decoded, 1):
            try:
                if isinstance(images, Exception):
                    raise images
                img_x, img_y, mask_x, mask_y = images

                outputs = []
                # each lens image goes to the device, planar, once (and
                # through the LUT decode there, when one is given)
                with timers.stage("upload"):
                    planes = {
                        lens: prepare_input_planes(
                            img, input_lut, args.lut_output_color_space,
                            device=device, table=lut_table)
                        for lens, img in (("X", img_x), ("Y", img_y))}

                if args.save_color_corrected_output:
                    color_dir.mkdir(parents=True, exist_ok=True)
                    for lens, path, img in (("X", xp, img_x),
                                            ("Y", yp, img_y)):
                        if input_lut is None:
                            writer.submit(color_dir / path.name,
                                          from_float01(to_float01(img)))
                        else:
                            writer.submit(color_dir / path.name,
                                          _quantize_device(planes[lens], 8)
                                          .cpu().numpy(), planar=True)

                if args.fisheye_output:
                    for lens, path, sid, img in (("X", xp, sid_x, img_x),
                                                 ("Y", yp, sid_y, img_y)):
                        with timers.stage("remap"):
                            und = prepared_remap(
                                *undistort[sid], *img.shape[:2], device)(
                                planes[lens], interp=interp, fill=fill,
                                out_dtype=torch.uint8)
                        with timers.stage("fetch"):
                            und = und.cpu().numpy()
                        writer.submit(out_dir / path.name, und, planar=True)
                        outputs.append(path.name)

                if not args.no_perspective:
                    images_dir.mkdir(parents=True, exist_ok=True)
                    rendered: Dict[str, np.ndarray] = {}
                    masks: Dict[str, np.ndarray] = {}
                    for lens, group in lens_views[(sid_x, sid_y)].items():
                        img = img_x if lens == "X" else img_y
                        with timers.stage("remap+fetch"):
                            out = group.render(planes[lens], img.shape[:2],
                                               interp, fill)
                        rendered.update(zip(group.view_ids, out))
                        src_mask = mask_x if lens == "X" else mask_y
                        if src_mask is not None:
                            with timers.stage("mask_remap+fetch"):
                                mplanes = remap_cuda.source_planes(
                                    src_mask, src_mask.shape[0],
                                    src_mask.shape[1], device)
                                mout = group.render(
                                    mplanes, src_mask.shape[:2], "nearest",
                                    0.0)
                            masks.update(zip(group.view_ids, mout[:, 0]))
                    for spec in specs:
                        vid = spec["view_id"]
                        name = f"{base}_{vid}{args.perspective_ext}"
                        writer.submit(
                            images_dir / name, rendered[vid], planar=True,
                            jpeg_quality=args.perspective_jpeg_quality)
                        outputs.append(name)
                        if vid in masks:
                            masks_dir.mkdir(parents=True, exist_ok=True)
                            writer.submit(
                                masks_dir / f"{base}_{vid}"
                                            f"{args.perspective_mask_ext}",
                                masks[vid], stage="mask_encode")
                report["pairs"].append({"base": base, "outputs": outputs})
                report["processed"] += 1
            except Exception as exc:
                print(f"[WARN] pair {base} failed: {exc}", file=sys.stderr)
                report["failed"] += 1
            print(f"[{pi}/{len(resolved)}] {base}", flush=True)

    if args.camera_extrinsics_xml:
        try:
            export_perspective_camera_metadata(args, specs, persp_dir)
        except ValueError as exc:
            print(f"[ERR] {exc}", file=sys.stderr)
            return 1

    if args.report_json:
        pathlib.Path(args.report_json).write_text(json.dumps(report,
                                                             indent=2))
    masks_run = {k: v - masks_before[k] for k, v in mask_counts().items()}
    overlap_run = {k: v - overlap_before[k]
                   for k, v in lens_overlap().items()}
    if masks_run["found"] < masks_run["looked_up"]:
        print(f"[WARN] {masks_run['looked_up'] - masks_run['found']} of "
              f"{masks_run['looked_up']} lens image(s) had no mask in "
              f"{mask_dir} (neither their own name nor <stem>.png); their "
              "views were written without one", file=sys.stderr)
    if args.stats:
        texels = texel_decode_counts()
        print(f"[STATS] {timers.report()} | texel decodes "
              f"{texels['served']} of {texels['requested']} | masks "
              f"{masks_run['found']} of {masks_run['looked_up']} | lens "
              f"overlap {overlap_run['overlapped']} of {overlap_run['pairs']}")
    print(f"[OK] processed={report['processed']} failed={report['failed']}")
    return 0 if report["failed"] == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
