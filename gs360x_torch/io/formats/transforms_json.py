"""transforms.json (NeRF/3DGS camera file) IO.

Matches the reference's schema (``gs360_CameraFormatConverter.py:598-611,
744-763``): OPENCV camera model header with fl_x/fl_y/cx/cy/w/h, zeroed
distortion, frames with OpenGL c2w ``transform_matrix``. The gs360 dataset
convention bakes a +270° world-X rotation into the exported c2w
(``TRANSFORMS_X_FIX_DEG``); the importer undoes whatever fix is passed.
"""

from __future__ import annotations

import json
import pathlib
from typing import List, Optional, Tuple

import numpy as np

from gs360x_torch.core import pose as posemath
from gs360x_torch.io.formats.model import Camera, ColmapModel, Image


def read_transforms(path) -> Tuple[list, Tuple[float, float, float, float, int, int]]:
    data = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))
    intr = (float(data["fl_x"]), float(data["fl_y"]),
            float(data["cx"]), float(data["cy"]),
            int(data["w"]), int(data["h"]))
    frames = [{"file_path": fr.get("file_path", ""),
               "transform_matrix": fr["transform_matrix"]}
              for fr in data.get("frames", [])]
    return frames, intr


def write_transforms(path, frames: List[dict],
                     intrinsics: Tuple[float, float, float, float, int, int]
                     ) -> None:
    fx, fy, cx, cy, w, h = intrinsics
    payload = {
        "camera_model": "OPENCV",
        "fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
        "w": int(w), "h": int(h),
        "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
        "frames": [
            {"file_path": fr["file_path"],
             "transform_matrix": _matrix_as_lists(fr["transform_matrix"])}
            for fr in frames
        ],
    }
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=2), encoding="utf-8")


def _matrix_as_lists(m) -> list:
    return [[float(v) for v in row] for row in np.asarray(m)]


def model_from_transforms(path, *, x_fix_deg: float,
                          sensor_w_mm: float = 36.0,
                          sensor_h_mm: float = 36.0) -> ColmapModel:
    """transforms.json → canonical model, undoing the world X fix."""
    frames, intr = read_transforms(path)
    fx, fy, cx, cy, w, h = intr
    model = ColmapModel()
    cam_id = model.add_camera("PINHOLE", w, h, [fx, fy, cx, cy])
    for i, fr in enumerate(frames, start=1):
        c2w_gl = np.asarray(fr["transform_matrix"], dtype=np.float64)
        # exported c2w = R_x(fix) @ c2w_raw  =>  undo with R_x(-fix)
        c2w_gl = posemath.mat4_from_rt(
            posemath.rot_x_deg(-x_fix_deg)) @ c2w_gl
        model.images.append(Image.from_c2w_gl(i, c2w_gl, cam_id,
                                              fr["file_path"]))
    return model


def frames_from_model(model: ColmapModel, *, x_fix_deg: float) -> Tuple[list, tuple]:
    """Canonical model → transforms frames + uniform intrinsics.

    Raises if intrinsics differ across images (the reference refuses
    non-uniform transforms.json exports)."""
    intr_ref: Optional[tuple] = None
    frames = []
    for img in model.images:
        cam = model.camera_for(img)
        intr = cam.pinhole_intrinsics()
        if intr_ref is None:
            intr_ref = intr
        elif any(abs(float(a) - float(b)) > 1e-6
                 for a, b in zip(intr_ref, intr)):
            raise ValueError("transforms.json export requires uniform "
                             "intrinsics")
        c2w_gl = posemath.apply_x_fix_gl(img.c2w_gl(), x_fix_deg)
        frames.append({"file_path": img.name, "transform_matrix": c2w_gl})
    if intr_ref is None:
        raise ValueError("no images to export")
    return frames, intr_ref
