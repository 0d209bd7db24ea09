"""RealityScan formats: camera CSV, per-image XMP files, axis conventions.

RealityScan's world is Z-up with the camera axis remap ``REALITYSCAN_AXIS``
(x, z, -y); poses travel as heading/pitch/roll angles in the CSV and as a
9-value world→camera rotation in XMP — conventions mirrored from
``gs360_CameraFormatConverter.py:553-695, 1122-1185``.
"""

from __future__ import annotations

import csv
import math
import pathlib
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from gs360x_torch.core import pose as posemath
from gs360x_torch.core.pose import REALITYSCAN_AXIS, normalize_angle_deg
from gs360x_torch.io.formats.model import (
    ColmapModel, Image, focal_mm_to_pixels,
)

CSV_HEADER = ["#name", "x", "y", "alt", "heading", "pitch", "roll", "f",
              "px", "py", "k1", "k2", "k3", "k4", "t1", "t2"]


# --------------------------------------------------------------------------
# axis / angle conventions
# --------------------------------------------------------------------------


def colmap_world_to_rs_world(v) -> np.ndarray:
    return REALITYSCAN_AXIS.T @ np.asarray(v, dtype=np.float64)


def rs_world_to_colmap_world(v) -> np.ndarray:
    return REALITYSCAN_AXIS @ np.asarray(v, dtype=np.float64)


def colmap_rot_to_rs_rot(r_wc: np.ndarray) -> np.ndarray:
    return r_wc @ REALITYSCAN_AXIS


def rs_rot_to_colmap_rot(r_xmp: np.ndarray) -> np.ndarray:
    return r_xmp @ REALITYSCAN_AXIS.T


def rs_rotation_to_hpr(r_xmp: np.ndarray) -> Tuple[float, float, float]:
    """World→camera RS rotation → (heading, pitch, roll) degrees.

    Convention sampled from RealityScan's Align CSV export: heading is the
    azimuth of the camera forward axis (+180° offset), pitch the elevation,
    roll measured against the horizon-aligned up vector (180° − signed)."""
    r_cw = np.asarray(r_xmp).T
    fwd = r_cw[:, 1] / np.linalg.norm(r_cw[:, 1])
    up = r_cw[:, 2] / np.linalg.norm(r_cw[:, 2])
    heading = normalize_angle_deg(
        math.degrees(math.atan2(fwd[0], fwd[1])) - 180.0)
    pitch = -math.degrees(math.atan2(fwd[2], math.hypot(fwd[0], fwd[1])))
    world_up = np.array([0.0, 0.0, 1.0])
    right0 = np.cross(world_up, fwd)
    if np.linalg.norm(right0) < 1e-9:
        right0 = np.array([1.0, 0.0, 0.0])
    right0 /= np.linalg.norm(right0)
    up0 = np.cross(fwd, right0)
    up0 /= np.linalg.norm(up0)
    s = float(fwd @ np.cross(up0, up))
    c = float(up0 @ up)
    roll = normalize_angle_deg(180.0 - math.degrees(math.atan2(s, c)))
    return heading, pitch, roll


def hpr_to_rs_rotation(heading: float, pitch: float, roll: float) -> np.ndarray:
    az = math.radians(normalize_angle_deg(float(heading) + 180.0))
    elev = math.radians(-float(pitch))
    cos_e = math.cos(elev)
    fwd = np.array([math.sin(az) * cos_e, math.cos(az) * cos_e,
                    math.sin(elev)])
    fwd /= np.linalg.norm(fwd)
    world_up = np.array([0.0, 0.0, 1.0])
    right0 = np.cross(world_up, fwd)
    if np.linalg.norm(right0) < 1e-9:
        right0 = np.array([1.0, 0.0, 0.0])
    right0 /= np.linalg.norm(right0)
    up0 = np.cross(fwd, right0)
    up0 /= np.linalg.norm(up0)
    roll_signed = normalize_angle_deg(180.0 - float(roll))
    up = posemath.axis_angle_mat3(fwd, roll_signed) @ up0
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    up /= np.linalg.norm(up)
    r_cw = np.stack([right, fwd, up], axis=1)
    return r_cw.T


# --------------------------------------------------------------------------
# CSV
# --------------------------------------------------------------------------


def read_csv_rows(path) -> List[dict]:
    rows = []
    with pathlib.Path(path).open("r", encoding="utf-8") as f:
        rd = csv.DictReader(f)
        for raw in rd:
            name_key = "#name" if "#name" in raw else "name"
            if not raw.get(name_key):
                continue
            rows.append({
                "name": raw[name_key],
                "x": float(raw["x"]), "y": float(raw["y"]),
                "alt": float(raw["alt"]),
                "heading": float(raw["heading"]),
                "pitch": float(raw["pitch"]), "roll": float(raw["roll"]),
                "f": float(raw["f"]),
            })
    return rows


def write_csv_rows(path, rows: List[dict]) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w", encoding="utf-8", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(CSV_HEADER)
        for row in rows:
            wr.writerow([
                row["name"],
                *(f"{row[k]:.15g}" for k in ("x", "y", "alt", "heading",
                                             "pitch", "roll", "f")),
                "0", "0", "0", "0", "0", "0", "0", "0",
            ])


def make_csv_row(name, x, y, alt, heading, pitch, roll, focal_mm) -> dict:
    return {"name": name, "x": float(x), "y": float(y), "alt": float(alt),
            "heading": float(heading), "pitch": float(pitch),
            "roll": float(roll), "f": float(focal_mm)}


# --------------------------------------------------------------------------
# XMP
# --------------------------------------------------------------------------


def _xmp_value(text: str, key: str) -> str:
    m = re.search(rf"<xcr:{re.escape(key)}>([^<]+)</xcr:{re.escape(key)}>",
                  text)
    if m:
        return m.group(1).strip()
    m = re.search(rf'xcr:{re.escape(key)}="([^"]+)"', text)
    if m:
        return m.group(1).strip()
    raise ValueError(f"xmp missing xcr:{key}")


def read_xmp_dir(xmp_dir, image_ext: str = "jpg") -> List[dict]:
    d = pathlib.Path(xmp_dir)
    if not d.exists():
        raise ValueError(f"xmp dir not found: {d}")
    files = sorted(d.glob("*.xmp"))
    if not files:
        raise ValueError(f"no .xmp files found in {d}")
    ext = str(image_ext or "").lstrip(".")
    rows = []
    for path in files:
        text = path.read_text(encoding="utf-8")
        rot = [float(x) for x in _xmp_value(text, "Rotation").split()]
        pos = [float(x) for x in _xmp_value(text, "Position").split()]
        if len(rot) != 9:
            raise ValueError(f"invalid xcr:Rotation count in {path}")
        if len(pos) != 3:
            raise ValueError(f"invalid xcr:Position count in {path}")
        focal = float(_xmp_value(text, "FocalLength35mm"))
        name = path.stem + (f".{ext}" if ext else "")
        rows.append({"name": name,
                     "r_xmp": np.array(rot).reshape(3, 3),
                     "pos_rs": np.array(pos),
                     "focal_mm": focal})
    return rows


def write_xmp_dir(out_dir, records: List[dict]) -> None:
    d = pathlib.Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    for rec in records:
        stem = pathlib.Path(rec["name"]).stem
        rot_text = " ".join(f"{v:.15g}"
                            for v in np.asarray(rec["r_xmp"]).reshape(-1))
        pos = rec["pos_rs"]
        pos_text = " ".join(f"{float(v):.15g}" for v in pos)
        focal_text = f"{float(rec['focal_mm']):g}"
        lines = [
            '<x:xmpmeta xmlns:x="adobe:ns:meta/">',
            '  <rdf:RDF xmlns:rdf="http://www.w3.org/1999/'
            '02/22-rdf-syntax-ns#">',
            '    <rdf:Description xcr:Version="3" xcr:PosePrior="initial" '
            'xcr:Coordinates="absolute"',
            '       xcr:DistortionModel="perspective" '
            'xcr:DistortionCoeficients="0 0 0 0 0 0"',
            f'       xcr:FocalLength35mm="{focal_text}" xcr:Skew="0" '
            'xcr:AspectRatio="1" xcr:PrincipalPointU="0"',
            '       xcr:PrincipalPointV="0" xcr:CalibrationPrior="initial" '
            'xcr:CalibrationGroup="0"',
            '       xcr:DistortionGroup="0" xcr:InTexturing="1" '
            'xcr:InMeshing="1" '
            'xmlns:xcr="http://www.capturingreality.com/ns/xcr/1.1#">',
            f"      <xcr:Rotation>{rot_text}</xcr:Rotation>",
            f"      <xcr:Position>{pos_text}</xcr:Position>",
            "    </rdf:Description>",
            "  </rdf:RDF>",
            "</x:xmpmeta>",
        ]
        (d / f"{stem}.xmp").write_text("\n".join(lines) + "\n",
                                       encoding="utf-8")


# --------------------------------------------------------------------------
# canonical model builders
# --------------------------------------------------------------------------


def model_from_csv_rows(rows: List[dict], w: int, h: int, *,
                        sensor_w_mm: float, sensor_h_mm: float,
                        single_camera: bool = False,
                        image_name_map: Optional[Dict[str, str]] = None
                        ) -> ColmapModel:
    model = ColmapModel()
    image_name_map = image_name_map or {}
    for idx, row in enumerate(rows, start=1):
        r_xmp = hpr_to_rs_rotation(row["heading"], row["pitch"], row["roll"])
        r_wc = rs_rot_to_colmap_rot(r_xmp)
        center = rs_world_to_colmap_world([row["x"], row["y"], row["alt"]])
        t_wc = r_wc @ (-center)
        fx, fy = focal_mm_to_pixels(row["f"], w, h, sensor_w_mm, sensor_h_mm)
        cam_id = model.add_camera("PINHOLE", int(w), int(h),
                                  [fx, fy, w * 0.5, h * 0.5],
                                  single=single_camera)
        name = image_name_map.get(pathlib.Path(row["name"]).stem, row["name"])
        model.images.append(Image.from_pose(idx, r_wc, t_wc, cam_id, name))
    return model


def model_from_xmp_rows(rows: List[dict], w: int, h: int, *,
                        sensor_w_mm: float, sensor_h_mm: float,
                        single_camera: bool = False,
                        image_name_map: Optional[Dict[str, str]] = None
                        ) -> ColmapModel:
    model = ColmapModel()
    image_name_map = image_name_map or {}
    for idx, row in enumerate(rows, start=1):
        r_wc = rs_rot_to_colmap_rot(np.asarray(row["r_xmp"]))
        center = rs_world_to_colmap_world(row["pos_rs"])
        t_wc = r_wc @ (-center)
        fx, fy = focal_mm_to_pixels(row["focal_mm"], w, h, sensor_w_mm,
                                    sensor_h_mm)
        cam_id = model.add_camera("PINHOLE", int(w), int(h),
                                  [fx, fy, w * 0.5, h * 0.5],
                                  single=single_camera)
        name = image_name_map.get(pathlib.Path(row["name"]).stem, row["name"])
        model.images.append(Image.from_pose(idx, r_wc, t_wc, cam_id, name))
    return model


# ---- point axis conversions -------------------------------------------------


def points_to_rs_vertices(points):
    """COLMAP points → RealityScan PLY axis (canonical export order)."""
    xyz = np.array([[p.x, p.y, p.z] for p in points])
    rgb = np.array([[p.r, p.g, p.b] for p in points], dtype=np.uint8)
    if len(xyz):
        xyz = (REALITYSCAN_AXIS.T @ xyz.T).T
    return xyz.astype(np.float32), rgb


def rs_vertices_to_points(xyz, rgb, point_id_start: int = 0):
    from gs360x_torch.io.formats.model import Point3

    out = []
    for i, (v, c) in enumerate(zip(np.asarray(xyz), np.asarray(rgb))):
        w = REALITYSCAN_AXIS @ np.asarray(v, dtype=np.float64)
        out.append(Point3(id=point_id_start + i, x=float(w[0]), y=float(w[1]),
                          z=float(w[2]), r=int(c[0]), g=int(c[1]),
                          b=int(c[2])))
    return out


def points_to_transforms_ply_vertices(points):
    """COLMAP points → companion-PLY axis for transforms.json (x, -y, -z)."""
    xyz = np.array([[p.x, -p.y, -p.z] for p in points], dtype=np.float32)
    rgb = np.array([[p.r, p.g, p.b] for p in points], dtype=np.uint8)
    return xyz, rgb


def transforms_ply_vertices_to_points(xyz, rgb, point_id_start: int = 0):
    from gs360x_torch.io.formats.model import Point3

    return [Point3(id=point_id_start + i, x=float(v[0]), y=-float(v[1]),
                   z=-float(v[2]), r=int(c[0]), g=int(c[1]), b=int(c[2]))
            for i, (v, c) in enumerate(zip(np.asarray(xyz), np.asarray(rgb)))]
