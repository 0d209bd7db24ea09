"""Generated data templates.

The reference ships a 1,087-line Metashape calibration XML for the DJI
Osmo 360 (``cli_tools/templates/Osmo360-Fisheye-Distortion.xml``). Rather
than copying that file, this module *generates* an equivalent calibration
document carrying the same physical constants: two cameras sharing one
equisolid-fisheye sensor (3840² px), an ``initial`` class at the nominal
f=1050 px, and the Metashape-``adjusted`` class (f, cx, cy, k1..k3) from
the reference template — calibration coefficients are measured data, not
code, so the default undistortion behavior matches the reference's
default path.
"""

from __future__ import annotations

import pathlib
import xml.etree.ElementTree as ET

# DJI Osmo 360 nominal sensor constants
OSMO360_SENSOR_PX = 3840
OSMO360_NOMINAL_F_PX = 1050.0

# Metashape-adjusted calibration for the Osmo 360 dual-fisheye sensor
# (data constants from the reference's shipped template,
# cli_tools/templates/Osmo360-Fisheye-Distortion.xml:18-27)
OSMO360_ADJUSTED = {
    "f": 1049.9268186384606,
    "cx": -0.053481903280599763,
    "cy": -0.040449115818567277,
    "k1": 0.10190869149858893,
    "k2": 0.00079808296648272998,
    "k3": -0.00031893309097734927,
}

SENSOR_TYPE = "equisolid_fisheye"


def write_osmo360_default_calibration(path) -> pathlib.Path:
    """Write the default DJI Osmo 360 equisolid-fisheye calibration XML.

    One sensor shared by both lens streams (the reference template is
    single-sensor too — its X and Y cameras both reference sensor id 0),
    with ``initial`` (nominal f) and ``adjusted`` (measured f/cx/cy/k1..k3)
    calibration classes. The dual-fisheye tool prefers the adjusted class.
    """
    doc = ET.Element("document", {"version": "1.2.0"})
    chunk = ET.SubElement(doc, "chunk", {"label": "osmo360-default",
                                         "enabled": "true"})
    sensors = ET.SubElement(chunk, "sensors", {"next_id": "1"})
    sensor = ET.SubElement(sensors, "sensor",
                           {"id": "0", "label": "Osmo360 dual fisheye",
                            "type": SENSOR_TYPE})
    ET.SubElement(sensor, "resolution",
                  {"width": str(OSMO360_SENSOR_PX),
                   "height": str(OSMO360_SENSOR_PX)})

    initial = ET.SubElement(sensor, "calibration",
                            {"type": SENSOR_TYPE, "class": "initial"})
    ET.SubElement(initial, "resolution",
                  {"width": str(OSMO360_SENSOR_PX),
                   "height": str(OSMO360_SENSOR_PX)})
    ET.SubElement(initial, "f").text = f"{OSMO360_NOMINAL_F_PX:g}"

    adjusted = ET.SubElement(sensor, "calibration",
                             {"type": SENSOR_TYPE, "class": "adjusted"})
    ET.SubElement(adjusted, "resolution",
                  {"width": str(OSMO360_SENSOR_PX),
                   "height": str(OSMO360_SENSOR_PX)})
    for key, value in OSMO360_ADJUSTED.items():
        ET.SubElement(adjusted, key).text = repr(value)

    cameras = ET.SubElement(chunk, "cameras", {"next_id": "0"})
    del cameras

    out = pathlib.Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    tree = ET.ElementTree(doc)
    ET.indent(tree, space="  ")
    tree.write(out, encoding="utf-8", xml_declaration=True)
    return out


def default_osmo360_calibration_path() -> pathlib.Path:
    """Cached default calibration under the user config dir (regenerated
    when the template version changes)."""
    path = pathlib.Path.home() / ".gs360x" / "osmo360_default_calib_v2.xml"
    if not path.exists():
        write_osmo360_default_calibration(path)
    return path
