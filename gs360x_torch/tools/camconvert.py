"""gs360x-torch-camconvert — camera/point format hub CLI (port of
:mod:`gs360x.tools.camconvert`: the same subcommands, flags, messages and
exit codes). The conversion is host numpy f64; ``--device`` is accepted so
that every tool of the port has one interface, and selects nothing here.

Rebuild of ``gs360_CameraFormatConverter``
(``cli_tools/gs360_CameraFormatConverter.py:1998-2354``):
subcommand = input format; outputs selected by ``--export-*`` flags with the
same default-export policy (COLMAP input → RS CSV+PLY; other inputs → all
camera formats, PLY variants when a point cloud is supplied).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from gs360x_torch.core import pose as posemath
from gs360x_torch.io.formats import colmap_text, metashape, realityscan, transforms_json
from gs360x_torch.io.formats.hub import (
    DEFAULT_SENSOR_H_MM, DEFAULT_SENSOR_W_MM, ExportOptions,
    apply_world_transforms, export_model, infer_image_size_from_dir,
    map_stem_to_image_name,
)


def _add_world_transform_args(p):
    for axis in "xyz":
        p.add_argument(f"--camera-rot-{axis}-deg", type=float, default=0.0,
                       help=f"Rotate camera world around {axis.upper()} "
                            "before export (degrees)")
        p.add_argument(f"--pointcloud-rot-{axis}-deg", type=float,
                       default=0.0,
                       help=f"Rotate pointcloud around {axis.upper()} "
                            "before export (degrees)")
    p.add_argument("--camera-scale", type=float, default=1.0)
    p.add_argument("--pointcloud-scale", type=float, default=1.0)


def _add_common_args(p, *, allow_ply_input=True):
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--sensor-width-mm", type=float,
                   default=DEFAULT_SENSOR_W_MM)
    p.add_argument("--sensor-height-mm", type=float,
                   default=DEFAULT_SENSOR_H_MM)
    p.add_argument("--transforms-x-fix-deg", type=float,
                   default=posemath.TRANSFORMS_X_FIX_DEG)
    p.add_argument("--single-camera", action="store_true",
                   help="Collapse all images onto one COLMAP camera")
    p.add_argument("--image-dir", default=None,
                   help="Folder used to resolve image names/sizes")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="Accepted for the port's common interface; the "
                        "conversion runs on the host and uses no device")
    if allow_ply_input:
        p.add_argument("--realityscan-ply", "--ply", dest="ply", default=None,
                       help="Optional point cloud in RealityScan PLY axis")
    _add_world_transform_args(p)
    _add_export_args(p)


def _add_export_args(p):
    # reference spellings first, short forms kept as aliases
    # (gs360_CameraFormatConverter.py:1883-1996)
    p.add_argument("--export-colmap", action="store_true")
    p.add_argument("--export-realityscan-csv", "--export-csv",
                   dest="export_csv", action="store_true")
    p.add_argument("--export-realityscan-ply", "--export-ply",
                   dest="export_ply", action="store_true")
    p.add_argument("--export-transforms-json", "--export-transforms",
                   dest="export_transforms", action="store_true")
    p.add_argument("--export-transforms-ply", action="store_true")
    p.add_argument("--export-realityscan-xmp", "--export-xmp",
                   dest="export_xmp", action="store_true")
    p.add_argument("--export-metashape-xml", action="store_true")
    p.add_argument("--realityscan-csv-file", "--csv-name", dest="csv_name",
                   default="Align_RS_PerspCams.csv")
    p.add_argument("--realityscan-ply-file", "--ply-name", dest="ply_name",
                   default="Align_RS_PerspCams.ply")
    p.add_argument("--transforms-json-file", "--transforms-name",
                   dest="transforms_name", default="transforms.json")
    p.add_argument("--transforms-ply-file", "--transforms-ply-name",
                   dest="transforms_ply_name",
                   default="pointcloud_for_transforms.ply")
    p.add_argument("--realityscan-xmp-output-dir",
                   "--realityscan-xmp-dir-name", "--xmp-dir-name",
                   dest="xmp_dir_name", default="cameras_RealityScan")
    p.add_argument("--metashape-xml-file", "--metashape-xml-name",
                   dest="metashape_xml_name",
                   default="perspective_cams.xml")
    p.add_argument("--point-id-start", type=int, default=0,
                   help="First POINT3D id for imported cloud vertices "
                        "(reference :1820)")


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=("Camera format converter between COLMAP, RealityScan "
                     "(CSV/PLY/XMP), transforms.json, and Metashape "
                     "perspective XML."),
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = ap.add_subparsers(dest="cmd")
    sub.required = True

    c = sub.add_parser("colmap", aliases=["colmap-to-rs"],
                       help="Input: COLMAP text model directory.")
    c.add_argument("colmap_dir")
    _add_common_args(c, allow_ply_input=False)
    c.set_defaults(source="colmap")

    r = sub.add_parser("realityscan-csv", help="Input: RealityScan CSV.")
    _add_common_args(r)
    r.add_argument("--realityscan-csv", "--csv", dest="csv", required=True)
    r.add_argument("--width", type=int, required=True)
    r.add_argument("--height", type=int, required=True)
    r.set_defaults(source="csv")

    x = sub.add_parser("realityscan-xmp", help="Input: RealityScan XMP dir.")
    _add_common_args(x)
    x.add_argument("--realityscan-xmp-dir", "--xmp-dir", dest="xmp_dir",
                   required=True)
    x.add_argument("--realityscan-xmp-image-ext", "--xmp-image-ext",
                   dest="xmp_image_ext", default="jpg")
    x.add_argument("--width", type=int, default=None)
    x.add_argument("--height", type=int, default=None)
    x.set_defaults(source="xmp")

    t = sub.add_parser("transforms-json", help="Input: transforms.json.")
    _add_common_args(t)
    t.add_argument("--transforms-json", required=True)
    t.add_argument("--transforms-ply", default=None,
                   help="Companion PLY in transforms axis")
    t.add_argument("--width", type=int, default=None)
    t.add_argument("--height", type=int, default=None)
    t.set_defaults(source="metadata-transforms")

    m = sub.add_parser("metashape-xml",
                       help="Input: Metashape perspective XML.")
    _add_common_args(m)
    m.add_argument("--metashape-xml", required=True)
    m.add_argument("--metashape-xml-image-ext", default="jpg")
    m.add_argument("--width", type=int, default=None)
    m.add_argument("--height", type=int, default=None)
    m.set_defaults(source="metashape")

    return ap


def _load_ply_points(args, model):
    """Attach point cloud inputs to the model (RS-axis or transforms-axis)."""
    from gs360x_torch.io import ply as plyio

    pid0 = int(getattr(args, "point_id_start", 0))
    ply_path = getattr(args, "ply", None)
    if ply_path:
        xyz, rgb = plyio.load_ply_xyz_rgb(ply_path)
        model.points = realityscan.rs_vertices_to_points(xyz, rgb, pid0)
    tf_ply = getattr(args, "transforms_ply", None)
    if tf_ply:
        xyz, rgb = plyio.load_ply_xyz_rgb(tf_ply)
        model.points = realityscan.transforms_ply_vertices_to_points(
            xyz, rgb, pid0)


def build_model(args):
    name_map = map_stem_to_image_name(getattr(args, "image_dir", None))
    if args.source == "colmap":
        model = colmap_text.read_model(args.colmap_dir)
        if not model.cameras or not model.images:
            raise ValueError(f"missing COLMAP text files in {args.colmap_dir}")
        return model
    if args.source == "csv":
        rows = realityscan.read_csv_rows(args.csv)
        model = realityscan.model_from_csv_rows(
            rows, args.width, args.height,
            sensor_w_mm=args.sensor_width_mm,
            sensor_h_mm=args.sensor_height_mm,
            single_camera=args.single_camera, image_name_map=name_map)
        _load_ply_points(args, model)
        return model
    if args.source == "xmp":
        if args.width is None or args.height is None:
            if not args.image_dir:
                raise ValueError("--width/--height required for XMP input "
                                 "(or pass --image-dir)")
            w, h = infer_image_size_from_dir(args.image_dir)
        else:
            w, h = args.width, args.height
        rows = realityscan.read_xmp_dir(args.xmp_dir,
                                        image_ext=args.xmp_image_ext)
        model = realityscan.model_from_xmp_rows(
            rows, w, h, sensor_w_mm=args.sensor_width_mm,
            sensor_h_mm=args.sensor_height_mm,
            single_camera=args.single_camera, image_name_map=name_map)
        _load_ply_points(args, model)
        return model
    if args.source == "metadata-transforms":
        model = transforms_json.model_from_transforms(
            args.transforms_json, x_fix_deg=args.transforms_x_fix_deg)
        _load_ply_points(args, model)
        return model
    if args.source == "metashape":
        records, w, h = metashape.read_perspective_xml(
            args.metashape_xml, default_width=args.width,
            default_height=args.height,
            image_ext=args.metashape_xml_image_ext,
            image_name_map=name_map)
        model = metashape.model_from_perspective_records(
            records, w, h, single_camera=args.single_camera)
        _load_ply_points(args, model)
        return model
    raise ValueError(f"unknown source {args.source}")


def options_from_args(args) -> ExportOptions:
    opts = ExportOptions(
        out_dir=pathlib.Path(args.out).expanduser().resolve(),
        sensor_width_mm=args.sensor_width_mm,
        sensor_height_mm=args.sensor_height_mm,
        transforms_x_fix_deg=args.transforms_x_fix_deg,
        export_colmap=args.export_colmap,
        export_csv=args.export_csv,
        export_ply=args.export_ply,
        export_transforms=args.export_transforms,
        export_transforms_ply=args.export_transforms_ply,
        export_xmp=args.export_xmp,
        export_metashape_xml=args.export_metashape_xml,
        csv_name=args.csv_name, ply_name=args.ply_name,
        transforms_name=args.transforms_name,
        transforms_ply_name=args.transforms_ply_name,
        xmp_dir_name=args.xmp_dir_name,
        metashape_xml_name=args.metashape_xml_name,
        camera_rot_deg=(args.camera_rot_x_deg, args.camera_rot_y_deg,
                        args.camera_rot_z_deg),
        pointcloud_rot_deg=(args.pointcloud_rot_x_deg,
                            args.pointcloud_rot_y_deg,
                            args.pointcloud_rot_z_deg),
        camera_scale=args.camera_scale,
        pointcloud_scale=args.pointcloud_scale,
    )
    any_selected = any([opts.export_colmap, opts.export_csv, opts.export_ply,
                        opts.export_transforms, opts.export_transforms_ply,
                        opts.export_xmp, opts.export_metashape_xml])
    if not any_selected:
        if args.source == "colmap":
            opts.export_csv = True
            opts.export_ply = True
        else:
            has_points = bool(getattr(args, "ply", None)
                              or getattr(args, "transforms_ply", None))
            opts.export_colmap = True
            opts.export_csv = True
            opts.export_transforms = True
            opts.export_xmp = True
            opts.export_metashape_xml = True
            opts.export_ply = has_points
            opts.export_transforms_ply = has_points
    return opts


def main(argv=None) -> int:
    try:
        return _main(argv)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        model = build_model(args)
    except (ValueError, OSError) as exc:
        print(f"[ERR] {exc}", file=sys.stderr)
        return 1
    opts = options_from_args(args)
    apply_world_transforms(model, opts)
    try:
        for line in export_model(model, opts):
            print(line)
    except ValueError as exc:
        print(f"[ERR] {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
