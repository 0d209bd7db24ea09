"""COLMAP text model IO (cameras.txt / images.txt / points3D.txt).

Format-compatible with COLMAP and with the reference converter's writer
(``gs360_CameraFormatConverter.py:397-544``): same headers, ``%.12g``
numeric formatting, preserved POINTS2D lines and track tokens.
"""

from __future__ import annotations

import pathlib
from typing import Optional

from gs360x_torch.io.formats.model import Camera, ColmapModel, Image, Point3


def read_model(colmap_dir) -> ColmapModel:
    d = pathlib.Path(colmap_dir)
    model = ColmapModel()
    model.cameras = _read_cameras(d / "cameras.txt")
    model.images = _read_images(d / "images.txt")
    model.points = _read_points(d / "points3D.txt")
    return model


def _read_cameras(path) -> dict:
    cameras = {}
    for raw in pathlib.Path(path).read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam = Camera(camera_id=int(parts[0]), model=parts[1],
                     width=int(parts[2]), height=int(parts[3]),
                     params=[float(x) for x in parts[4:]])
        cameras[cam.camera_id] = cam
    return cameras


def _read_images(path) -> list:
    images = []
    lines = pathlib.Path(path).read_text(encoding="utf-8").splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 10:
            continue
        img = Image(image_id=int(parts[0]),
                    qw=float(parts[1]), qx=float(parts[2]),
                    qy=float(parts[3]), qz=float(parts[4]),
                    tx=float(parts[5]), ty=float(parts[6]),
                    tz=float(parts[7]), camera_id=int(parts[8]),
                    name=" ".join(parts[9:]),
                    points2d_line=lines[i] if i < len(lines) else "")
        images.append(img)
        i += 1
    return images


def _read_points(path) -> list:
    points = []
    p = pathlib.Path(path)
    if not p.exists():
        return points
    for raw in p.read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 8:
            continue
        points.append(Point3(id=int(parts[0]), x=float(parts[1]),
                             y=float(parts[2]), z=float(parts[3]),
                             r=int(parts[4]), g=int(parts[5]),
                             b=int(parts[6]), err=float(parts[7]),
                             track_tokens=list(parts[8:])))
    return points


def write_model(out_dir, model: ColmapModel) -> None:
    d = pathlib.Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)

    mean_obs = 0.0
    if model.images:
        total = sum(len((img.points2d_line or "").split()) // 3
                    for img in model.images)
        mean_obs = total / float(len(model.images))
    mean_track = 0.0
    if model.points:
        total = sum(len(pt.track_tokens) // 2 for pt in model.points)
        mean_track = total / float(len(model.points))

    with (d / "cameras.txt").open("w", encoding="utf-8") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {len(model.cameras)}\n")
        for cam in sorted(model.cameras.values(), key=lambda c: c.camera_id):
            params = " ".join(f"{v:.12g}" for v in cam.params)
            f.write(f"{cam.camera_id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")

    with (d / "images.txt").open("w", encoding="utf-8") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {len(model.images)}, "
                f"mean observations per image: {mean_obs:.3f}\n")
        for img in sorted(model.images, key=lambda x: x.image_id):
            f.write(f"{img.image_id} {img.qw:.12g} {img.qx:.12g} "
                    f"{img.qy:.12g} {img.qz:.12g} {img.tx:.12g} "
                    f"{img.ty:.12g} {img.tz:.12g} {img.camera_id} "
                    f"{img.name}\n")
            f.write((img.points2d_line or "") + "\n")

    with (d / "points3D.txt").open("w", encoding="utf-8") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as "
                "(IMAGE_ID, POINT2D_IDX)\n")
        f.write(f"# Number of points: {len(model.points)}, "
                f"mean track length: {mean_track:.6f}\n")
        for pt in model.points:
            line = (f"{pt.id} {pt.x:.12g} {pt.y:.12g} {pt.z:.12g} "
                    f"{pt.r} {pt.g} {pt.b} {pt.err:.6g}")
            if pt.track_tokens:
                line += " " + " ".join(str(t) for t in pt.track_tokens)
            f.write(line + "\n")
