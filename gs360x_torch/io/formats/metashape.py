"""Metashape (Agisoft) camera XML IO.

Perspective chunks: sensors (frame type, resolution, calibration ``f``) and
cameras with 4×4 ``<transform>`` = OpenCV c2w in chunk space
(``gs360_CameraFormatConverter.py:815-1042``). Spherical chunks (the 360°
alignment export consumed by ms360xml) additionally carry chunk/component
similarity transforms (rotation, translation, scale) that map chunk space
to world space (``gs360_MS360xmlToPersCams.py:476-585``).
"""

from __future__ import annotations

import pathlib
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from gs360x_torch.io.formats.model import Camera, ColmapModel, Image


def _indent(elem, level=0):
    newline = "\n" + ("  " * level)
    if len(elem):
        if not elem.text or not elem.text.strip():
            elem.text = newline + "  "
        for child in elem:
            _indent(child, level + 1)
        if not elem[-1].tail or not elem[-1].tail.strip():
            elem[-1].tail = newline
    if level and (not elem.tail or not elem.tail.strip()):
        elem.tail = newline


def _parse_transform_text(text, src="<transform>") -> np.ndarray:
    vals = [float(x) for x in str(text or "").split()]
    if len(vals) == 16:
        return np.array(vals, dtype=np.float64).reshape(4, 4)
    if len(vals) == 12:
        m = np.eye(4)
        m[:3, :] = np.array(vals, dtype=np.float64).reshape(3, 4)
        return m
    raise ValueError(f"invalid Metashape {src}: expected 12/16 floats, "
                     f"got {len(vals)}")


def _sensor_resolution(sensor) -> Tuple[Optional[int], Optional[int]]:
    for node in (sensor.find("calibration/resolution"),
                 sensor.find("resolution")):
        if node is not None:
            try:
                return int(node.attrib["width"]), int(node.attrib["height"])
            except (KeyError, ValueError):
                continue
    return None, None


def _sensor_focal_px(sensor) -> Optional[float]:
    node = sensor.find("calibration/f")
    if node is not None and (node.text or "").strip():
        return float(node.text)
    fx = sensor.find("calibration/fx")
    fy = sensor.find("calibration/fy")
    if fx is not None and fy is not None:
        return 0.5 * (float(fx.text) + float(fy.text))
    return None


# --------------------------------------------------------------------------
# perspective XML
# --------------------------------------------------------------------------


def read_perspective_xml(path, *, default_width: Optional[int] = None,
                         default_height: Optional[int] = None,
                         image_ext: str = "jpg",
                         image_name_map: Optional[Dict[str, str]] = None
                         ) -> Tuple[List[dict], int, int]:
    """Perspective XML → list of dicts with c2w_cv, focal_px, name."""
    xml_path = pathlib.Path(path)
    root = ET.parse(str(xml_path)).getroot()
    chunk = root.find("chunk")
    if chunk is None:
        raise ValueError(f"invalid Metashape XML (missing <chunk>): {path}")
    sensors_root = chunk.find("sensors")
    cams_root = chunk.find("cameras")
    if sensors_root is None or cams_root is None:
        raise ValueError("invalid Metashape XML (missing <sensors>/"
                         f"<cameras>): {path}")

    sensors = {}
    for sensor in sensors_root.findall("sensor"):
        if (sensor.attrib.get("master_id") is not None
                or sensor.find("rotation") is not None
                or sensor.find("location") is not None):
            raise ValueError("Multi-Camera-System XML is not supported "
                             f"here: {path}")
        sid = int(sensor.attrib["id"])
        w, h = _sensor_resolution(sensor)
        sensors[sid] = {"w": w, "h": h, "f_px": _sensor_focal_px(sensor)}

    image_name_map = image_name_map or {}
    records = []
    width = height = None
    for cam in cams_root.findall("camera"):
        tr = cam.find("transform")
        if tr is None or not (tr.text or "").strip():
            continue
        label = cam.attrib.get("label")
        if not label:
            continue
        sid = cam.attrib.get("sensor_id")
        if sid is None:
            if len(sensors) != 1:
                raise ValueError("camera missing sensor_id in multi-sensor "
                                 f"XML: {path}")
            info = next(iter(sensors.values()))
        else:
            info = sensors.get(int(sid))
            if info is None:
                raise ValueError(f"unknown sensor_id {sid} in {path}")
        w, h = info["w"], info["h"]
        if (w is None or h is None) and default_width and default_height:
            w, h = int(default_width), int(default_height)
        if w is None or h is None:
            raise ValueError("Metashape XML sensor resolution missing")
        if info["f_px"] is None:
            raise ValueError("Metashape XML sensor focal <f> missing")
        if width is None:
            width, height = int(w), int(h)
        elif int(w) != width or int(h) != height:
            raise ValueError("mixed image resolutions in Metashape XML are "
                             "not supported")
        name = label if "." in label else f"{label}.{image_ext}"
        name = image_name_map.get(pathlib.Path(name).stem, name)
        records.append({
            "name": name,
            "c2w_cv": _parse_transform_text(tr.text, str(xml_path)),
            "f_px": float(info["f_px"]),
        })
    if not records:
        raise ValueError(f"no cameras with <transform> found in {path}")
    return records, width, height


def model_from_perspective_records(records, width, height, *,
                                   single_camera: bool = False) -> ColmapModel:
    model = ColmapModel()
    for idx, rec in enumerate(records, start=1):
        f = rec["f_px"]
        cam_id = model.add_camera(
            "PINHOLE", width, height,
            [f, f, width * 0.5, height * 0.5], single=single_camera)
        c2w_cv = rec["c2w_cv"]
        r_wc = c2w_cv[:3, :3].T
        t_wc = r_wc @ (-c2w_cv[:3, 3])
        model.images.append(Image.from_pose(idx, r_wc, t_wc, cam_id,
                                            rec["name"]))
    return model


def write_perspective_xml(path, model: ColmapModel,
                          sensor_label: str = "virtual_fisheyelike") -> None:
    """Canonical model → Metashape perspective XML (transform = c2w_cv)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    sensor_defs: Dict[tuple, dict] = {}
    sensor_for_cam: Dict[int, int] = {}
    for img in model.images:
        cam = model.camera_for(img)
        fx, fy, _cx, _cy, w, h = cam.pinhole_intrinsics()
        key = (int(w), int(h), round(float(fx), 9), round(float(fy), 9))
        if key not in sensor_defs:
            sensor_defs[key] = {"id": len(sensor_defs), "w": int(w),
                                "h": int(h), "f": 0.5 * (fx + fy)}
        sensor_for_cam[cam.camera_id] = sensor_defs[key]["id"]

    doc = ET.Element("document", {"version": "1.2.0"})
    chunk = ET.SubElement(doc, "chunk", {"label": "unknown",
                                         "enabled": "true"})
    sensors_node = ET.SubElement(chunk, "sensors",
                                 {"next_id": str(len(sensor_defs))})
    for s in sorted(sensor_defs.values(), key=lambda x: x["id"]):
        sensor = ET.SubElement(sensors_node, "sensor",
                               {"id": str(s["id"]), "label": sensor_label,
                                "type": "frame"})
        ET.SubElement(sensor, "resolution",
                      {"width": str(s["w"]), "height": str(s["h"])})
        ET.SubElement(sensor, "property",
                      {"name": "layer_index", "value": "0"})
        ET.SubElement(sensor, "data_type").text = "uint8"
        calib = ET.SubElement(sensor, "calibration",
                              {"type": "frame", "class": "initial"})
        ET.SubElement(calib, "resolution",
                      {"width": str(s["w"]), "height": str(s["h"])})
        ET.SubElement(calib, "f").text = f"{s['f']:.15g}"
        ET.SubElement(sensor, "black_level").text = "0 0 0"
        ET.SubElement(sensor, "sensitivity").text = "1 1 1"

    comps = ET.SubElement(chunk, "components",
                          {"next_id": "1", "active_id": "0"})
    comp = ET.SubElement(comps, "component",
                         {"id": "0", "label": "Component 1"})
    ET.SubElement(comp, "partition")

    cams_node = ET.SubElement(chunk, "cameras",
                              {"next_id": str(len(model.images)),
                               "next_group_id": "0"})
    for idx, img in enumerate(model.images):
        cam = model.camera_for(img)
        r_cw = img.r_wc.T
        center = img.center
        c2w = np.eye(4)
        c2w[:3, :3] = r_cw
        c2w[:3, 3] = center
        cam_node = ET.SubElement(cams_node, "camera", {
            "id": str(idx),
            "sensor_id": str(sensor_for_cam[cam.camera_id]),
            "component_id": "0",
            "label": pathlib.Path(img.name).stem,
        })
        flat = " ".join(f"{float(v):.15g}" for v in c2w.reshape(-1))
        ET.SubElement(cam_node, "transform").text = flat

    _indent(doc)
    with path.open("wb") as f:
        f.write(b"<?xml version='1.0' encoding='UTF-8'?>\n")
        f.write(ET.tostring(doc, encoding="utf-8"))
        f.write(b"\n")


# --------------------------------------------------------------------------
# spherical XML (360 alignment input of ms360xml)
# --------------------------------------------------------------------------


def _parse_similarity(node) -> Optional[dict]:
    """Metashape <transform> similarity node → rotation/translation/scale.

    Two shapes occur in the wild: raw 12/16-float text (scale folded into
    the rotation block), or child <rotation>/<translation>/<scale> nodes."""
    if node is None:
        return None
    raw = (node.text or "").strip()
    if raw:
        m = _parse_transform_text(raw)
        r = m[:3, :3]
        scale = float(np.mean([np.linalg.norm(r[:, i]) for i in range(3)]))
        rotation = r / scale if scale > 0 else r
        return {"rotation": rotation, "translation": m[:3, 3],
                "scale": scale if scale > 0 else 1.0}
    rot_n = node.find("rotation")
    tr_n = node.find("translation")
    sc_n = node.find("scale")
    if rot_n is None and tr_n is None and sc_n is None:
        return None
    rotation = np.eye(3)
    if rot_n is not None and (rot_n.text or "").strip():
        vals = [float(x) for x in rot_n.text.split()]
        if len(vals) == 9:
            rotation = np.array(vals).reshape(3, 3)
    translation = np.zeros(3)
    if tr_n is not None and (tr_n.text or "").strip():
        vals = [float(x) for x in tr_n.text.split()]
        if len(vals) == 3:
            translation = np.array(vals)
    scale = 1.0
    if sc_n is not None and (sc_n.text or "").strip():
        scale = float(sc_n.text.split()[0])
    return {"rotation": rotation, "translation": translation,
            "scale": float(scale)}


def _apply_similarity(sim: dict, c2w: np.ndarray) -> np.ndarray:
    """Similarity → world: center is rotated+scaled+translated; the camera
    ROTATION only rotates (scale must not distort it) — matches
    ``gs360_MS360xmlToPersCams.py:520-541``."""
    rot = np.asarray(sim["rotation"])
    out = np.eye(4)
    out[:3, :3] = rot @ c2w[:3, :3]
    out[:3, 3] = sim["scale"] * (rot @ c2w[:3, 3]) + np.asarray(
        sim["translation"])
    return out


def read_spherical_cameras(path) -> List[Tuple[int, str, np.ndarray]]:
    """Spherical chunk → [(camera_id, label, world c2w 4x4)], sorted by id.

    Chunk-level similarity wins; a component transform applies only when no
    chunk transform exists. Disabled cameras are skipped
    (``gs360_MS360xmlToPersCams.py:543-585``).
    """
    root = ET.parse(str(path)).getroot()
    chunk = root.find("chunk")
    if chunk is None:
        raise ValueError(f"invalid Metashape XML (missing <chunk>): {path}")
    cams_root = chunk.find("cameras")
    if cams_root is None:
        raise ValueError(f"invalid Metashape XML (missing <cameras>): {path}")

    chunk_sim = _parse_similarity(chunk.find("transform"))
    comp_sims: Dict[str, dict] = {}
    comps = chunk.find("components")
    if comps is not None:
        for comp in comps.findall("component"):
            cid = (comp.get("id") or "").strip()
            sim = _parse_similarity(comp.find("transform"))
            if cid and sim is not None:
                comp_sims[cid] = sim

    out = []
    for cam in cams_root.findall("camera"):
        if (cam.get("enabled") or "").lower() == "false":
            continue
        tr = cam.find("transform")
        if tr is None or not (tr.text or "").strip():
            continue
        label = cam.get("label") or f"camera_{cam.get('id', '0')}"
        cam_id = int(cam.get("id", "0"))
        c2w = _parse_transform_text(tr.text, str(path))
        sim = chunk_sim
        if sim is None:
            comp_id = (cam.get("component_id") or "").strip()
            sim = comp_sims.get(comp_id)
        if sim is not None:
            c2w = _apply_similarity(sim, c2w)
        out.append((cam_id, label, c2w))
    if not out:
        raise ValueError(f"no cameras with <transform> found in {path}")
    out.sort(key=lambda x: x[0])
    return out
