"""gs360x-torch-ms360xml — Metashape spherical XML → virtual perspective
cameras (port of :mod:`gs360x.tools.ms360xml`: the same flags, messages and
exit codes, plus ``--device {cuda,cpu}``, which ``--persp-cut`` hands on to
the port's perspective cut; the conversion itself is host numpy f64).

Rebuild of ``gs360_MS360xmlToPersCams``
(``cli_tools/gs360_MS360xmlToPersCams.py``): loads a
Metashape *spherical* alignment XML (chunk/component similarity transforms
applied), expands each 360° camera into the preset's virtual perspective
views (camera rig algebra in the GL frame, reference ``:1800-1875``), and
exports transforms.json (+270° world-X fix), a COLMAP text model, Metashape
perspective XML, a Metashape Multi-Camera-System rig XML, and RealityScan
XMP files; rotates/scales a companion PLY; optionally runs the perspective
cut in-process.

The MCS rig XML is generated structurally from the view set (master sensor
+ per-view slave sensors with rig-relative rotations) rather than from the
reference's bundled 1,689-line template — functionally equivalent rig
metadata without copying the template file.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

from gs360x_torch.core import camera as cam
from gs360x_torch.core import pose as posemath
from gs360x_torch.device import DEVICE_CHOICES
from gs360x_torch.core.pose import (
    COLMAP_X_BASE_DEG, CV_TO_GL, POINTCLOUD_PLY_X_DEG, TRANSFORMS_X_FIX_DEG,
)
from gs360x_torch.io.formats import metashape as msxml
from gs360x_torch.io.formats import realityscan as rsfmt
from gs360x_torch.io.formats import transforms_json as tfjson
from gs360x_torch.io.formats.model import Camera, ColmapModel, Image, Point3
from gs360x_torch.rig.presets import extra_suffix, letter_tag

SENSOR_W_MM = 36.0
SENSOR_H_MM = 36.0
DEFAULT_SIZE = 1600
ADD_CAM_DEG = 30.0
CUBE_FOV_DEG = 105.0
PRESET_CHOICES = ["default", "fisheyelike", "full360coverage", "2views",
                  "evenMinus30", "evenPlus30", "cube105"]
FORMAT_METASHAPE_MULTI = "metashape-multi-camera-system"


def preset_config(name: str) -> dict:
    """Preset table (reference ``gs360_MS360xmlToPersCams.py:592-678``)."""
    table = {
        "default": dict(count=8, focal_mm=12.0, size=DEFAULT_SIZE,
                        dels=[], adds=[], even=None),
        "fisheyelike": dict(count=10, focal_mm=17.0, size=DEFAULT_SIZE,
                            dels=list("CDHI"), adds=list("AF"), even=None),
        "full360coverage": dict(count=8, focal_mm=14.0, size=DEFAULT_SIZE,
                                dels=list("BDFH"), adds=list("BDFH"),
                                even=None),
        "2views": dict(count=8, focal_mm=6.0, size=3600,
                       dels=list("BCDFGH"), adds=[], even=None),
        "evenMinus30": dict(count=8, focal_mm=12.0, size=DEFAULT_SIZE,
                            dels=[], adds=[], even=-30.0),
        "evenPlus30": dict(count=8, focal_mm=12.0, size=DEFAULT_SIZE,
                           dels=[], adds=[], even=30.0),
    }
    if name in table:
        cfg = dict(table[name])
        cfg["explicit"] = None
        return cfg
    if name == "cube105":
        return dict(count=6, focal_mm=cam.focal_mm_from_hfov(CUBE_FOV_DEG,
                                                             SENSOR_W_MM),
                    size=DEFAULT_SIZE, dels=[], adds=[], even=None,
                    explicit=[("A", 0.0, 0.0), ("B", 90.0, 0.0),
                              ("C", 180.0, 0.0), ("D", -90.0, 0.0),
                              ("E", 0.0, 90.0), ("F", 0.0, -90.0)])
    raise ValueError(f"unknown preset: {name}")


def build_views(preset: str) -> List[Tuple[str, float, float]]:
    cfg = preset_config(preset)
    if cfg["explicit"]:
        return list(cfg["explicit"])
    views = []
    yaw_step = 360.0 / cfg["count"]
    dels = set(cfg["dels"])
    adds = set(cfg["adds"])
    for idx in range(cfg["count"]):
        tag = letter_tag(idx)
        yaw = posemath.normalize_angle_deg(idx * yaw_step)
        pitch = 0.0
        if cfg["even"] is not None and ((idx + 1) % 2) == 0:
            pitch = cfg["even"]
        if tag not in dels:
            views.append((tag, yaw, pitch))
        if tag in adds:
            for delta in (ADD_CAM_DEG, -ADD_CAM_DEG):
                p2 = max(-90.0, min(90.0, pitch + delta))
                views.append((f"{tag}{extra_suffix(delta, ADD_CAM_DEG)}",
                              yaw, p2))
    return views


def compute_intrinsics(focal_mm: float, width: int, height: int):
    fl_x = focal_mm / (SENSOR_W_MM / width)
    fl_y = focal_mm / (SENSOR_H_MM / height)
    return fl_x, fl_y, width * 0.5, height * 0.5


def strip_view_suffix(name: str, view_ids) -> str:
    upper = str(name).upper()
    for vid in sorted({str(v).upper() for v in view_ids}, key=len,
                      reverse=True):
        if upper.endswith("_" + vid):
            return name[: -len(vid) - 1]
    return name


def safe_name(name: str) -> str:
    return name.replace("\\", "_").replace("/", "_").strip()


def build_frames(cameras, preset: str, ext: str, scale: float,
                 world_rot: np.ndarray):
    """(rig cam × view) → frames with GL c2w matrices + intrinsics."""
    views = build_views(preset)
    cfg = preset_config(preset)
    width = height = int(cfg["size"])
    fl_x, fl_y, cx, cy = compute_intrinsics(cfg["focal_mm"], width, height)
    intrinsics = (fl_x, fl_y, cx, cy, width, height)
    world4 = posemath.mat4_from_rt(world_rot)

    view_ids = [v for v, _, _ in views]
    frames = []
    for _cam_id, label, mat in cameras:
        base = safe_name(strip_view_suffix(label, view_ids))
        mat_scaled = posemath.apply_unit_scale(np.asarray(mat, np.float64),
                                               scale)
        mat_world = world4 @ mat_scaled
        base_gl = mat_world @ CV_TO_GL
        for view_id, yaw, pitch in views:
            r_rel = posemath.mat4_from_rt(
                posemath.yaw_pitch_to_rot_gl(yaw, pitch))
            c2w_gl = base_gl @ r_rel
            frames.append({
                "file_path": f"{base}_{view_id}.{ext}",
                "c2w_gl": c2w_gl,
                "source_name": base,
                "view_id": view_id,
                "yaw": yaw,
                "pitch": pitch,
            })
    return frames, intrinsics, views


def model_from_frames(frames, intrinsics, x_fix_deg: float) -> ColmapModel:
    fl_x, fl_y, cx, cy, w, h = intrinsics
    model = ColmapModel()
    cam_id = model.add_camera("PINHOLE", int(w), int(h),
                              [fl_x, fl_y, cx, cy])
    for i, fr in enumerate(frames, start=1):
        model.images.append(Image.from_c2w_gl(
            i, fr["c2w_gl"], cam_id, fr["file_path"], x_fix_deg=x_fix_deg))
    return model


def build_points_outputs(ply_path, out_dir, world_rot, pc_rotate_x_deg,
                         scale, *, write_transforms_ply=True):
    """Rotate/scale companion PLY; returns COLMAP-space points
    (reference ``gs360_MS360xmlToPersCams.py:922-984``)."""
    from gs360x_torch.io import ply as plyio

    xyz, rgb = plyio.load_ply_xyz_rgb(ply_path)
    rotated = (world_rot @ xyz.T).T * scale
    out_xyz = rotated
    if abs(pc_rotate_x_deg) > 1e-6:
        out_xyz = (posemath.rot_x_deg(pc_rotate_x_deg) @ rotated.T).T
    points = [Point3(id=i + 1, x=float(p[0]), y=float(p[1]), z=float(p[2]),
                     r=int(c[0]), g=int(c[1]), b=int(c[2]))
              for i, (p, c) in enumerate(zip(rotated, rgb))]
    if write_transforms_ply:
        out_ply = pathlib.Path(out_dir) / "pointcloud_for_transforms.ply"
        plyio.save_ply_xyz_rgb(out_ply, out_xyz.astype(np.float32), rgb)
        print(f"[OK] Rotated pointcloud: {out_ply}")
    return points


# --------------------------------------------------------------------------
# Metashape Multi-Camera-System rig export
# --------------------------------------------------------------------------


# fisheyelike MCS slave offsets: calibrated Reference/Adjusted rotation
# constants from the reference\'s Metashape-accepted rig template
# (gs360_MS360xmlToPersCams.py:81-228 /
# templates/perspective_cams_Multi-Camera-System.xml). Rotations are
# omega/phi/kappa degrees; locations are meters (None = omit the node).
MCS_ROTATION_ACCURACY = "0.10000000000000001"
MCS_FISHEYELIKE_SLAVE_OFFSETS = {
    "A_D": {"location": None,
            "reference_rotation":
                "-30 -1.0000000000000001e-09 1.0000000000000001e-09",
            "adjusted_rotation":
                "1 1.7453292519943295e-11 1.7453292519943295e-11 "
                "-2.3841685560428086e-11 0.86602191310483012 "
                "0.50000604598569609 -6.3881819957709397e-12 "
                "-0.50000604598569609 0.86602191310483012"},
    "A_U": {"location": None,
            "reference_rotation":
                "30 1.0000000000000001e-09 -1.0000000000000001e-09",
            "adjusted_rotation":
                "1 -1.7453292519943295e-11 -1.7453292519943295e-11 "
                "6.3880987725495763e-12 0.86602016774919766 "
                "-0.50000906896940533 2.3841707859244642e-11 "
                "0.50000906896940533 0.86602016774919766"},
    "B": {"location": None,
          "reference_rotation":
              "-1.0000000000000001e-09 -36 -1.0000000000000001e-09",
          "adjusted_rotation":
              "0.80901699437494745 -1.4120010256431277e-11 "
              "0.58778525229247314 7.1945045727740908e-12 1 "
              "1.4120010256431277e-11 -0.58778525229247314 "
              "-7.1945045727740908e-12 0.80901699437494745"},
    "E": {"location": "0.0016815735845178558 -0.002587362402607621 "
                      "-0.0091133641591967102",
          "reference_rotation": "179.999 -36 179.999",
          "adjusted_rotation":
              "-0.80901699425172713 1.4120010255956319e-05 "
              "0.58778525229247314 7.1945045714363033e-06 "
              "0.99999999987443222 -1.4120010255956319e-05 "
              "-0.58778525241804092 -7.1945045714363033e-06 "
              "-0.80901699425172713"},
    "F": {"location": "0.0015400348723170199 -0.0024766844652872205 "
                      "-0.008990779308733465",
          "reference_rotation": "179.999 1.0000000000000001e-09 179.999",
          "adjusted_rotation":
              "-0.99999999984769128 1.7453292519356215e-05 "
              "-1.7453292519943295e-11 1.7453292517002544e-05 "
              "0.99999999969538256 -1.7453292519356215e-05 "
              "-2.8716412725158887e-10 -1.7453292517002544e-05 "
              "-0.99999999984769128"},
    "F_D": {"location": "0.0015154558601237569 -0.0025037968632555573 "
                        "-0.0088901677022376925",
            "reference_rotation": "-150 1.0000000000000001e-09 179.999",
            "adjusted_rotation":
                "-0.99999999984769128 1.7453292519356215e-05 "
                "-1.7453292519943295e-11 1.5114985974797131e-05 "
                "0.86602540365253555 0.49999999999999994 "
                "8.7266613746728056e-06 0.49999999992384531 "
                "-0.86602540378443871"},
    "F_U": {"location": "0.0015425475773918887 -0.002487764150421878 "
                        "-0.0091081939841455399",
            "reference_rotation": "150 1.0000000000000001e-09 -179.999",
            "adjusted_rotation":
                "-0.99999999984769128 -1.7453292519356215e-05 "
                "-1.7453292519943295e-11 -1.5114985974797131e-05 "
                "0.86602540365253555 -0.49999999999999994 "
                "8.7266613746728056e-06 -0.49999999992384531 "
                "-0.86602540378443871"},
    "G": {"location": "0.0015096652640664463 -0.0025136977484785479 "
                      "-0.00912520386006389",
          "reference_rotation": "-179.999 36 179.999",
          "adjusted_rotation":
              "-0.80901699425172713 1.4120010255956319e-05 "
              "-0.58778525229247314 7.1945045714363033e-06 "
              "0.99999999987443222 1.4120010255956319e-05 "
              "0.58778525241804092 7.1945045714363033e-06 "
              "-0.80901699425172713"},
    "J": {"location": None,
          "reference_rotation":
              "-1.0000000000000001e-09 36 1.0000000000000001e-09",
          "adjusted_rotation":
              "0.80901699437494745 1.4120010256431277e-11 "
              "-0.58778525229247314 -7.1945045727740908e-12 1 "
              "1.4120010256431277e-11 0.58778525229247314 "
              "-7.1945045727740908e-12 0.80901699437494745"},
}


def _mat3_to_opk_deg(rot):
    """Rotation matrix -> Metashape Omega/Phi/Kappa degrees (Rz*Ry*Rx,
    gs360_MS360xmlToPersCams.py:1529-1540)."""
    r31 = max(-1.0, min(1.0, float(rot[2][0])))
    phi = math.asin(-r31)
    omega = math.atan2(float(rot[2][1]), float(rot[2][2]))
    kappa = math.atan2(float(rot[1][0]), float(rot[0][0]))
    return math.degrees(omega), math.degrees(phi), math.degrees(kappa)


def export_metashape_multi_camera_xml(out_path, frames, intrinsics, views,
                                      preset: str = "fisheyelike"):
    """Generate the Metashape Multi-Camera-System rig document.

    Mirrors the document shape Metashape 2.3 itself writes (reference
    template ``templates/perspective_cams_Multi-Camera-System.xml`` and
    the rewrite logic at ``gs360_MS360xmlToPersCams.py:1609-1797``):
    sensor 0 is the rig master; each slave sensor carries the
    rig-relative ``<rotation>`` (master^T @ view, CV frame), a zeroed or
    preset-calibrated ``<location>``, and a ``<reference rotation="o p k"
    sabc=... enabled="true"/>`` attribute node; cameras are FLAT under
    ``<cameras>`` with slaves linked by ``master_id`` to their source
    frame\'s master camera; one component owns every camera. For the
    fisheyelike preset the reference\'s calibrated slave-offset constants
    override the derived Reference/Adjusted values.
    """
    fl_x, fl_y, cx, cy, w, h = intrinsics
    f = 0.5 * (fl_x + fl_y)
    view_list = list(views)
    view_ids = [v for v, _, _ in view_list]

    doc = ET.Element("document", {"version": "2.3.0"})
    chunk = ET.SubElement(doc, "chunk",
                          {"label": "unknown", "enabled": "true"})
    sensors_node = ET.SubElement(chunk, "sensors",
                                 {"next_id": str(len(view_list))})
    offsets = (MCS_FISHEYELIKE_SLAVE_OFFSETS
               if preset == "fisheyelike" else {})
    for sid, (vid, yaw, pitch) in enumerate(view_list):
        attrs = {"id": str(sid), "label": "unknown", "type": "frame"}
        if sid != 0:
            attrs["master_id"] = "0"
        sensor = ET.SubElement(sensors_node, "sensor", attrs)
        ET.SubElement(sensor, "resolution",
                      {"width": str(int(w)), "height": str(int(h))})
        ET.SubElement(sensor, "property",
                      {"name": "fixed", "value": "true"})
        ET.SubElement(sensor, "property",
                      {"name": "layer_index", "value": "0"})
        bands = ET.SubElement(sensor, "bands")
        for band in ("Red", "Green", "Blue"):
            ET.SubElement(bands, "band", {"label": band})
        ET.SubElement(sensor, "data_type").text = "uint8"
        calib = ET.SubElement(sensor, "calibration",
                              {"type": "frame", "class": "initial"})
        ET.SubElement(calib, "resolution",
                      {"width": str(int(w)), "height": str(int(h))})
        ET.SubElement(calib, "f").text = f"{f:.15g}"
        if sid != 0:
            # rig-relative rotation: master view -> this view (CV frame)
            r_master = posemath.yaw_pitch_to_rot_gl(view_list[0][1],
                                                    view_list[0][2])
            r_view = posemath.yaw_pitch_to_rot_gl(yaw, pitch)
            r_rel_gl = r_master.T @ r_view
            flip = np.diag([1.0, -1.0, -1.0])
            r_rel_cv = flip @ r_rel_gl @ flip
            cfg = offsets.get(vid, {})
            rot_text = cfg.get("adjusted_rotation") or " ".join(
                f"{v:.15g}" for v in np.asarray(r_rel_cv).reshape(-1))
            ET.SubElement(sensor, "rotation").text = rot_text
            ref_attrs = {"sabc": MCS_ROTATION_ACCURACY, "enabled": "true"}
            ref_rot = cfg.get("reference_rotation")
            if ref_rot is None:
                o, ph, k = _mat3_to_opk_deg(r_rel_cv)
                ref_rot = f"{o:.15g} {ph:.15g} {k:.15g}"
            ref_attrs["rotation"] = ref_rot
            ET.SubElement(sensor, "reference", ref_attrs)
            loc = cfg.get("location") if vid in offsets else "0 0 0"
            if loc is not None:
                ET.SubElement(sensor, "location").text = loc
        ET.SubElement(sensor, "black_level").text = "0 0 0"
        ET.SubElement(sensor, "sensitivity").text = "1 1 1"

    components = ET.SubElement(chunk, "components",
                               {"next_id": "1", "active_id": "0"})
    component = ET.SubElement(components, "component",
                              {"id": "0", "label": "Component 1"})

    # cameras: flat, grouped by source frame via master_id chains
    by_source = {}
    order = []
    for fr in frames:
        if fr["source_name"] not in by_source:
            by_source[fr["source_name"]] = {}
            order.append(fr["source_name"])
        by_source[fr["source_name"]][fr["view_id"]] = fr

    cameras_node = ET.SubElement(chunk, "cameras", {
        "next_id": str(len(order) * len(view_ids)),
        "next_group_id": "0"})
    master_cam_ids = []
    cam_id = 0
    for source in order:
        entries = by_source[source]
        master = entries.get(view_ids[0])
        master_cam_id = cam_id
        master_cam_ids.append(master_cam_id)
        for sid, vid in enumerate(view_ids):
            fr = entries.get(vid)
            if fr is None:
                continue
            attrs = {"id": str(cam_id), "sensor_id": str(sid),
                     "component_id": "0",
                     "label": pathlib.Path(fr["file_path"]).stem}
            if sid != 0:
                attrs["master_id"] = str(master_cam_id)
            cam_node = ET.SubElement(cameras_node, "camera", attrs)
            if sid == 0 and master is not None:
                c2w_cv = np.asarray(master["c2w_gl"]) @ CV_TO_GL
                ET.SubElement(cam_node, "transform").text = " ".join(
                    f"{v:.15g}" for v in np.asarray(c2w_cv).reshape(-1))
            cam_id += 1
    partition = ET.SubElement(component, "partition")
    ET.SubElement(partition, "camera_ids").text = " ".join(
        str(i) for i in master_cam_ids)

    settings = ET.SubElement(chunk, "settings")
    for name, value in (("accuracy_tiepoints", "1"),
                        ("accuracy_cameras", "10"),
                        ("accuracy_cameras_ypr", "10"),
                        ("accuracy_markers", "0.0050000000000000001"),
                        ("accuracy_scalebars", "0.001"),
                        ("accuracy_projections", "0.5")):
        ET.SubElement(settings, "property", {"name": name, "value": value})

    msxml._indent(doc)
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with out_path.open("wb") as fo:
        fo.write(b"<?xml version='1.0' encoding='UTF-8'?>\n")
        fo.write(ET.tostring(doc, encoding="utf-8"))


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def parse_axis(text: str):
    vals = [float(x) for x in str(text).replace(",", " ").split()]
    if len(vals) != 3:
        raise ValueError("axis must have 3 components")
    return vals


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Convert Metashape 360 XML to virtual camera transforms.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("xml", help="Metashape cameras_XML.xml path")
    ap.add_argument("--preset", choices=PRESET_CHOICES,
                    default="full360coverage")
    ap.add_argument("-o", "--out", default=None,
                    help="Output directory (default: <xml_dir>/perspective_cams)")
    ap.add_argument("--format",
                    choices=["transforms", "colmap", "metashape",
                             FORMAT_METASHAPE_MULTI, "realityscan", "all"],
                    default="metashape")
    ap.add_argument("--ext", default="jpg")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="Uniform world scale applied to cameras and points")
    ap.add_argument("--world-rot-axis", default="0 1 0")
    ap.add_argument("--world-rot-deg", type=float, default=0.0)
    ap.add_argument("--persp-cut", "--cut", dest="cut", action="store_true",
                    help="Run the perspective cut after conversion")
    ap.add_argument("--cut-input", default=None)
    ap.add_argument("--cut-out", default=None)
    ap.add_argument("--points-ply", default=None)
    ap.add_argument("--pc-rotate-x-plus180", dest="pc_rotate_x_deg",
                    action="store_const", const=180.0, default=0.0,
                    help="Rotate output pointcloud PLY around X by +180 deg")
    ap.add_argument("--pc-rotate-x-plus90", dest="pc_rotate_x_deg",
                    action="store_const", const=90.0, help=argparse.SUPPRESS)
    ap.add_argument("--pc-rotate-x-minus90", dest="pc_rotate_x_deg",
                    action="store_const", const=-90.0, help=argparse.SUPPRESS)
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device of the perspective cut (--persp-cut): "
                         "cuda raises when no card is available; cpu runs "
                         "the plain torch versions")
    return ap


def run_cut(preset: str, cut_in: pathlib.Path,
            cut_out: Optional[pathlib.Path], device: str = "cuda") -> int:
    from gs360x_torch.tools import perspcut

    argv = ["-i", str(cut_in), "--preset",
            preset if preset != "cube105" else "default"]
    if cut_out:
        argv += ["-o", str(cut_out)]
    print(f"[INFO] running perspective cut: {' '.join(argv)}")
    return perspcut.main(argv + ["--device", device])


def main(argv=None) -> int:
    try:
        return _main(argv)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.format == FORMAT_METASHAPE_MULTI and args.preset != "fisheyelike":
        print("[ERR] --format metashape-multi-camera-system requires "
              "--preset fisheyelike", file=sys.stderr)
        return 1
    xml_path = pathlib.Path(args.xml).expanduser().resolve()
    if not xml_path.exists():
        print(f"[ERR] XML not found: {xml_path}", file=sys.stderr)
        return 1
    out_dir = (pathlib.Path(args.out).expanduser().resolve() if args.out
               else xml_path.parent / "perspective_cams")
    out_dir.mkdir(parents=True, exist_ok=True)

    try:
        axis = parse_axis(args.world_rot_axis)
    except ValueError as exc:
        print(f"[ERR] --world-rot-axis: {exc}", file=sys.stderr)
        return 1
    world_rot = posemath.axis_angle_mat3(axis, args.world_rot_deg)

    try:
        cameras = msxml.read_spherical_cameras(xml_path)
    except ValueError as exc:
        print(f"[ERR] {exc}", file=sys.stderr)
        return 1

    ext = args.ext.lstrip(".")
    frames, intrinsics, views = build_frames(cameras, args.preset, ext,
                                             args.scale, world_rot)
    cfg = preset_config(args.preset)
    fl_x = intrinsics[0]
    print(f"[INFO] preset={args.preset} views={len(views)} "
          f"focal_mm={cfg['focal_mm']:g}")
    print(f"[INFO] intrinsics: size={intrinsics[4]}x{intrinsics[5]} "
          f"f_px={fl_x:.5f}")
    print(f"[INFO] transforms X fix: +{TRANSFORMS_X_FIX_DEG:.1f} deg | "
          f"pointcloud ply X: +{POINTCLOUD_PLY_X_DEG:.1f} deg")

    if args.format in ("transforms", "all"):
        tf_frames = [{
            "file_path": fr["file_path"],
            "transform_matrix": posemath.apply_x_fix_gl(
                fr["c2w_gl"], TRANSFORMS_X_FIX_DEG),
        } for fr in frames]
        out_json = out_dir / "transforms.json"
        tfjson.write_transforms(out_json, tf_frames, intrinsics)
        print(f"[OK] transforms.json: {out_json}")

    points: List[Point3] = []
    needs_colmap = args.format in ("colmap", "all")
    allow_points = args.format in ("transforms", "colmap", "all")
    if needs_colmap and not args.points_ply:
        print("[ERR] --points-ply is required when --format includes colmap",
              file=sys.stderr)
        return 1
    if args.points_ply and allow_points:
        ply_path = pathlib.Path(args.points_ply).expanduser().resolve()
        if not ply_path.exists():
            print(f"[ERR] points PLY not found: {ply_path}", file=sys.stderr)
            return 1
        points = build_points_outputs(
            ply_path, out_dir, world_rot, args.pc_rotate_x_deg, args.scale,
            write_transforms_ply=args.format in ("transforms", "all"))

    model = model_from_frames(frames, intrinsics, COLMAP_X_BASE_DEG)
    model.points = points

    if needs_colmap:
        from gs360x_torch.io.formats import colmap_text

        colmap_dir = out_dir / "sparse" / "0"
        colmap_text.write_model(colmap_dir, model)
        print(f"[OK] COLMAP text: {colmap_dir}")

    if args.format in ("realityscan", "all"):
        rs_dir = out_dir / "cameras_RealityScan"
        records = []
        for img in model.images:
            r_xmp = rsfmt.colmap_rot_to_rs_rot(img.r_wc)
            center_rs = rsfmt.colmap_world_to_rs_world(img.center)
            focal_mm = cfg["focal_mm"] * (36.0 / SENSOR_W_MM)
            records.append({"name": img.name, "r_xmp": r_xmp,
                            "pos_rs": center_rs, "focal_mm": focal_mm})
        rsfmt.write_xmp_dir(rs_dir, records)
        print(f"[OK] RealityScan XMP: {rs_dir}")

    if args.format == FORMAT_METASHAPE_MULTI:
        out_multi = out_dir / "perspective_cams_Multi-Camera-System.xml"
        export_metashape_multi_camera_xml(out_multi, frames, intrinsics,
                                          views, preset=args.preset)
        print(f"[OK] Metashape Multi-Camera XML: {out_multi}")

    if args.format in ("metashape", "all"):
        out_xml = out_dir / "perspective_cams.xml"
        msxml.write_perspective_xml(out_xml, model)
        print(f"[OK] Metashape cameras XML: {out_xml}")

    if args.cut:
        cut_in = (pathlib.Path(args.cut_input).expanduser().resolve()
                  if args.cut_input else xml_path.parent / "360imgs")
        if not cut_in.exists():
            print(f"[ERR] cut input not found: {cut_in}", file=sys.stderr)
            return 1
        cut_out = (pathlib.Path(args.cut_out).expanduser().resolve()
                   if args.cut_out else None)
        rc = run_cut(args.preset, cut_in, cut_out, args.device)
        if rc != 0:
            return rc

    print("[INFO] If you still need to cut images, run gs360x-perspcut "
          "separately.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
