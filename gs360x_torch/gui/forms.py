"""Tab definitions: field specs + pure argv builders for every tool tab.

Each tab is data (fields) plus a function ``values → argv`` so the GUI layer
stays declarative and the arg plumbing is unit-testable without a display.
Field tuple: (key, label, kind, default) with kind ∈ {str, path, dir, int,
float, bool, choice:<a|b|c>}.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Field = Tuple[str, str, str, object]


def _opt(argv: List[str], flag: str, value, default=None, *,
         as_flag: bool = False) -> None:
    if as_flag:
        if value:
            argv.append(flag)
        return
    if value is None:
        return
    text = str(value).strip()
    if text == "" or (default is not None and text == str(default)):
        return
    argv.extend([flag, text])


# --- Video2Frames -----------------------------------------------------------

VIDEO2FRAMES_FIELDS: Sequence[Field] = (
    ("video", "Input video", "path", ""),
    ("output", "Output dir", "dir", ""),
    ("fps", "FPS", "float", 2.0),
    ("ext", "Extension", "str", "jpg"),
    ("prefix", "Prefix", "str", "out"),
    ("start", "Start (s)", "str", ""),
    ("end", "End (s)", "str", ""),
    ("keep_rec709", "Keep Rec.709", "bool", False),
    ("overwrite", "Overwrite", "bool", False),
    ("map_stream", "Map stream (0:v:N)", "str", ""),
    ("name_suffix", "Name suffix", "str", ""),
)


def build_video2frames_argv(v: Dict) -> List[str]:
    argv = ["-i", str(v["video"]), "-f", str(v["fps"])]
    _opt(argv, "-o", v.get("output"))
    _opt(argv, "-e", v.get("ext"), "jpg")
    _opt(argv, "--prefix", v.get("prefix"), "out")
    _opt(argv, "--start", v.get("start"))
    _opt(argv, "--end", v.get("end"))
    _opt(argv, "--keep-rec709", v.get("keep_rec709"), as_flag=True)
    _opt(argv, "--overwrite", v.get("overwrite"), as_flag=True)
    _opt(argv, "--map-stream", v.get("map_stream"))
    _opt(argv, "--name-suffix", v.get("name_suffix"))
    return argv


def build_dualfisheye_extract_queue(v: Dict) -> List[List[str]]:
    """Two Video2Frames runs: lens Y then lens X (reference
    ``gs360_GUI.py:9788-9819``)."""
    base = dict(v)
    jobs = []
    for stream, suffix in (("0:v:1", "_Y"), ("0:v:0", "_X")):
        run = dict(base)
        run["map_stream"] = stream
        run["name_suffix"] = suffix
        run["overwrite"] = True
        jobs.append(build_video2frames_argv(run))
    return jobs


# --- FrameSelector -----------------------------------------------------------

FRAMESELECTOR_FIELDS: Sequence[Field] = (
    ("in_dir", "Input dir", "dir", ""),
    ("segment_size", "Segment size", "int", 10),
    ("metric", "Metric", "choice:hybrid|lapvar|tenengrad|fft", "hybrid"),
    ("csv", "Selection CSV", "str", ""),
    ("dry_run", "Dry run", "bool", True),
    ("augment_gaps", "Augment gaps", "bool", True),
    ("prune_motion", "Prune low motion", "bool", False),
    ("augment_motion", "Augment motion", "bool", False),
    ("blur_percent", "Blur % (per-frame mode)", "float", 1.0),
)


def build_frameselector_argv(v: Dict) -> List[str]:
    argv = ["-i", str(v["in_dir"]), "-n", str(v.get("segment_size", 10))]
    _opt(argv, "-m", v.get("metric"), "hybrid")
    _opt(argv, "-c", v.get("csv"))
    _opt(argv, "-d", v.get("dry_run"), as_flag=True)
    if not v.get("augment_gaps", True):
        argv.append("--no_augment_gaps")
    _opt(argv, "--prune_motion", v.get("prune_motion"), as_flag=True)
    _opt(argv, "--augment_motion", v.get("augment_motion"), as_flag=True)
    _opt(argv, "--blur-percent", v.get("blur_percent"), 1.0)
    return argv


# --- 360PerspCut -------------------------------------------------------------

PERSPCUT_FIELDS: Sequence[Field] = (
    ("input_dir", "Input (dir or video)", "path", ""),
    ("out_dir", "Output dir", "dir", ""),
    ("preset", "Preset",
     "choice:default|fisheyelike|full360coverage|2views|evenMinus30|"
     "evenPlus30|fisheyeXY", "default"),
    ("count", "Count", "int", 8),
    ("size", "Size", "int", 1600),
    ("focal_mm", "Focal (mm)", "float", 12.0),
    ("addcam", "Add cams", "str", ""),
    ("delcam", "Del cams", "str", ""),
    ("setcam", "Set cams", "str", ""),
    ("add_top", "Add top", "bool", False),
    ("add_bottom", "Add bottom", "bool", False),
    ("fps", "FPS (video)", "str", ""),
    ("select_csv", "Selection CSV (video)", "path", ""),
    ("ext", "Extension", "str", "jpg"),
    ("backend", "Backend", "choice:auto|pallas|xla", "auto"),
)


def build_perspcut_argv(v: Dict) -> List[str]:
    argv = ["-i", str(v["input_dir"])]
    _opt(argv, "-o", v.get("out_dir"))
    _opt(argv, "--preset", v.get("preset"), "default")
    _opt(argv, "--count", v.get("count"), 8)
    _opt(argv, "--size", v.get("size"), 1600)
    _opt(argv, "--focal-mm", v.get("focal_mm"), 12.0)
    _opt(argv, "--addcam", v.get("addcam"))
    _opt(argv, "--delcam", v.get("delcam"))
    _opt(argv, "--setcam", v.get("setcam"))
    _opt(argv, "--add-top", v.get("add_top"), as_flag=True)
    _opt(argv, "--add-bottom", v.get("add_bottom"), as_flag=True)
    _opt(argv, "-f", v.get("fps"))
    _opt(argv, "--select-csv", v.get("select_csv"))
    _opt(argv, "--ext", v.get("ext"), "jpg")
    _opt(argv, "--backend", v.get("backend"), "auto")
    return argv


# --- SegmentationMaskTool ------------------------------------------------------

MASKSEG_FIELDS: Sequence[Field] = (
    ("input_dir", "Input dir", "dir", ""),
    ("output_dir", "Output dir", "dir", ""),
    ("mode", "Mode",
     "choice:mask|alpha|cutout|keep_person|remove_person|inpaint", "mask"),
    ("target", "Target",
     "choice:person|bicycle|car|motorcycle|bus|truck|animal", "person"),
    ("include_shadow", "Include shadow", "bool", False),
    ("mask_expand_pixels", "Expand (px)", "int", 15),
    ("edge_fuse_pixels", "Edge fuse (px)", "int", 25),
    ("manual_mask_dir", "Manual mask dir", "dir", ""),
    ("checkpoint", "Model checkpoint", "path", ""),
)


def build_maskseg_argv(v: Dict) -> List[str]:
    argv = ["-i", str(v["input_dir"])]
    _opt(argv, "-o", v.get("output_dir"))
    _opt(argv, "--mode", v.get("mode"), "mask")
    _opt(argv, "--target", v.get("target"), None)
    _opt(argv, "--include_shadow", v.get("include_shadow"), as_flag=True)
    _opt(argv, "--mask-expand-pixels", v.get("mask_expand_pixels"), 15)
    _opt(argv, "--edge-fuse-pixels", v.get("edge_fuse_pixels"), 25)
    _opt(argv, "--manual-mask-dir", v.get("manual_mask_dir"))
    _opt(argv, "--checkpoint", v.get("checkpoint"))
    return argv


# --- PointCloudOptimizer ------------------------------------------------------

PLYOPT_FIELDS: Sequence[Field] = (
    ("input", "Input PLY/COLMAP", "path", ""),
    ("output", "Output", "path", ""),
    ("target_points", "Target points", "str", ""),
    ("target_percent", "Target %", "str", ""),
    ("voxel_size", "Voxel size", "str", ""),
    ("method", "Method", "choice:voxel|spatial-hash|adaptive", "voxel"),
    ("keep_strategy", "Representative",
     "choice:centroid|center|first|random", "centroid"),
    ("sky_axis", "Sky axis", "choice:|+X|-X|+Y|-Y|+Z|-Z", ""),
    ("sky_scale", "Sky scale", "float", 100.0),
    ("sky_count", "Sky count", "int", 4000),
    ("sky_color", "Sky color", "str", "#87cefa"),
)


def build_plyopt_argv(v: Dict) -> List[str]:
    argv = ["-i", str(v["input"])]
    _opt(argv, "-o", v.get("output"))
    _opt(argv, "-t", v.get("target_points"))
    _opt(argv, "-r", v.get("target_percent"))
    _opt(argv, "-v", v.get("voxel_size"))
    _opt(argv, "--downsample-method", v.get("method"), "voxel")
    _opt(argv, "-k", v.get("keep_strategy"), "centroid")
    if v.get("sky_axis"):
        _opt(argv, "--sky-axis", v.get("sky_axis"))
        _opt(argv, "--sky-scale", v.get("sky_scale"), 100.0)
        _opt(argv, "--sky-count", v.get("sky_count"), 4000)
        _opt(argv, "--sky-color", v.get("sky_color"), "#87cefa")
    return argv


# --- MS360xmlToPerspCams -------------------------------------------------------

MS360XML_FIELDS: Sequence[Field] = (
    ("xml", "Metashape XML", "path", ""),
    ("out", "Output dir", "dir", ""),
    ("preset", "Preset",
     "choice:default|fisheyelike|full360coverage|2views|evenMinus30|"
     "evenPlus30|cube105", "full360coverage"),
    ("format", "Format",
     "choice:transforms|colmap|metashape|metashape-multi-camera-system|"
     "realityscan|all", "metashape"),
    ("points_ply", "Points PLY", "path", ""),
    ("scale", "Scale", "float", 1.0),
    ("pc_rotate_x_plus180", "PLY rot X+180", "bool", False),
    ("cut", "Run PerspCut", "bool", False),
    ("cut_input", "PerspCut input", "path", ""),
)


def build_ms360xml_argv(v: Dict) -> List[str]:
    argv = [str(v["xml"])]
    _opt(argv, "-o", v.get("out"))
    _opt(argv, "--preset", v.get("preset"), "full360coverage")
    _opt(argv, "--format", v.get("format"), "metashape")
    _opt(argv, "--points-ply", v.get("points_ply"))
    _opt(argv, "--scale", v.get("scale"), 1.0)
    _opt(argv, "--pc-rotate-x-plus180", v.get("pc_rotate_x_plus180"),
         as_flag=True)
    _opt(argv, "--cut", v.get("cut"), as_flag=True)
    _opt(argv, "--cut-input", v.get("cut_input"))
    return argv


# --- DualFisheyePipeline -------------------------------------------------------

DUALFISHEYE_FIELDS: Sequence[Field] = (
    ("input_dir", "Input dir (X/Y pairs)", "dir", ""),
    ("camera_xml", "Calibration XML", "path", ""),
    ("output_dir", "Output dir", "dir", ""),
    ("input_lut", "Input LUT (.cube)", "path", ""),
    ("perspective_size", "Perspective size", "int", 1750),
    ("perspective_focal_mm", "Focal (mm)", "float", 14.0),
    ("save_fisheye_output", "Save undistorted fisheye", "bool", False),
    ("no_perspective", "Skip perspective", "bool", False),
    ("camera_extrinsics_xml", "Extrinsics XML", "path", ""),
    ("metadata_only", "Metadata only", "bool", False),
)


def build_dualfisheye_argv(v: Dict) -> List[str]:
    argv = ["--camera-xml", str(v["camera_xml"])]
    _opt(argv, "--input-dir", v.get("input_dir"))
    _opt(argv, "--output-dir", v.get("output_dir"))
    _opt(argv, "--input-lut", v.get("input_lut"))
    _opt(argv, "--perspective-size", v.get("perspective_size"), 1750)
    _opt(argv, "--perspective-focal-mm", v.get("perspective_focal_mm"), 14.0)
    _opt(argv, "--save-fisheye-output", v.get("save_fisheye_output"),
         as_flag=True)
    _opt(argv, "--no-perspective", v.get("no_perspective"), as_flag=True)
    _opt(argv, "--camera-extrinsics-xml", v.get("camera_extrinsics_xml"))
    _opt(argv, "--metadata-only", v.get("metadata_only"), as_flag=True)
    return argv


# --- CameraOptimization (scene/converter) --------------------------------------

SCENE_FIELDS: Sequence[Field] = (
    ("source", "Scene source", "path", ""),
    ("ply", "Companion PLY", "path", ""),
    ("export_ply", "Export normalized PLY", "path", ""),
)


def build_scene_argv(v: Dict) -> List[str]:
    argv = [str(v["source"])]
    _opt(argv, "--ply", v.get("ply"))
    _opt(argv, "--export-ply", v.get("export_ply"))
    return argv


CAMCONVERT_FIELDS: Sequence[Field] = (
    ("cmd", "Input format",
     "choice:colmap|realityscan-csv|realityscan-xmp|transforms-json|"
     "metashape-xml", "colmap"),
    ("input", "Input path", "path", ""),
    ("out", "Output dir", "dir", ""),
    ("width", "Width", "str", ""),
    ("height", "Height", "str", ""),
    ("camera_rot_x_deg", "Cam rot X", "float", 0.0),
    ("camera_rot_y_deg", "Cam rot Y", "float", 0.0),
    ("camera_rot_z_deg", "Cam rot Z", "float", 0.0),
    ("camera_scale", "Cam scale", "float", 1.0),
    ("pointcloud_scale", "Points scale", "float", 1.0),
)


def build_camconvert_argv(v: Dict) -> List[str]:
    cmd = v.get("cmd", "colmap")
    argv = [cmd]
    input_flag = {
        "colmap": None, "realityscan-csv": "--csv",
        "realityscan-xmp": "--xmp-dir", "transforms-json":
        "--transforms-json", "metashape-xml": "--metashape-xml",
    }[cmd]
    if input_flag is None:
        argv.append(str(v["input"]))
    else:
        argv.extend([input_flag, str(v["input"])])
    argv.extend(["-o", str(v["out"])])
    if cmd == "realityscan-csv":
        _opt(argv, "--width", v.get("width"))
        _opt(argv, "--height", v.get("height"))
    for axis in "xyz":
        _opt(argv, f"--camera-rot-{axis}-deg", v.get(f"camera_rot_{axis}_deg"),
             0.0)
    _opt(argv, "--camera-scale", v.get("camera_scale"), 1.0)
    _opt(argv, "--pointcloud-scale", v.get("pointcloud_scale"), 1.0)
    return argv


TABS = (
    ("Video2Frames", "video2frames", VIDEO2FRAMES_FIELDS,
     build_video2frames_argv),
    ("FrameSelector", "frameselector", FRAMESELECTOR_FIELDS,
     build_frameselector_argv),
    ("360PerspCut", "perspcut", PERSPCUT_FIELDS, build_perspcut_argv),
    ("SegmentationMask", "maskseg", MASKSEG_FIELDS, build_maskseg_argv),
    ("PointCloudOptimizer", "plyopt", PLYOPT_FIELDS, build_plyopt_argv),
    ("MS360xmlToPerspCams", "ms360xml", MS360XML_FIELDS, build_ms360xml_argv),
    ("DualFisheyePipeline", "dualfisheye", DUALFISHEYE_FIELDS,
     build_dualfisheye_argv),
    ("CameraOptimization", "camconvert", CAMCONVERT_FIELDS,
     build_camconvert_argv),
    ("SceneViewer", "scene", SCENE_FIELDS, build_scene_argv),
)
