"""The port's camera-format modules (:mod:`gs360x_torch.io.formats`, host
numpy f64) against :mod:`gs360x.io.formats`: the same seeded model through
every reader, writer, converter and world transform of both packages —
written files byte-equal, returned arrays equal to 1e-12, every public
function named in at least one scenario."""

import dataclasses
import inspect
import pathlib
import types

import numpy as np
import pytest

import gs360x.core.pose as jpose
import gs360x.io.formats.colmap_text as jcolmap
import gs360x.io.formats.hub as jhub
import gs360x.io.formats.metashape as jmeta
import gs360x.io.formats.model as jmodel
import gs360x.io.formats.realityscan as jrs
import gs360x.io.formats.transforms_json as jtf
import gs360x.io.image as jimage
import gs360x.io.ply as jply
import gs360x_torch.core.pose as tpose
import gs360x_torch.io.formats.colmap_text as tcolmap
import gs360x_torch.io.formats.hub as thub
import gs360x_torch.io.formats.metashape as tmeta
import gs360x_torch.io.formats.model as tmodel
import gs360x_torch.io.formats.realityscan as trs
import gs360x_torch.io.formats.transforms_json as ttf
import gs360x_torch.io.image as timage
import gs360x_torch.io.ply as tply

J = types.SimpleNamespace(pose=jpose, colmap=jcolmap, hub=jhub, meta=jmeta,
                          model=jmodel, rs=jrs, tf=jtf, image=jimage,
                          ply=jply)
T = types.SimpleNamespace(pose=tpose, colmap=tcolmap, hub=thub, meta=tmeta,
                          model=tmodel, rs=trs, tf=ttf, image=timage,
                          ply=tply)

SPHERICAL_XML = """<?xml version='1.0'?>
<document version="1.2.0">
 <chunk label="c" enabled="true">
  <sensors next_id="1"><sensor id="0" type="spherical"/></sensors>
  <components next_id="1"><component id="0">
   <transform><rotation>1 0 0 0 0 -1 0 1 0</rotation>
    <translation>1 2 3</translation><scale>3</scale></transform>
  </component></components>
  <cameras next_id="3">
   <camera id="0" label="pano_0001" component_id="0">
    <transform>1 0 0 0 0 1 0 0 0 0 1 2 0 0 0 1</transform>
   </camera>
   <camera id="1" label="pano_0002" enabled="false">
    <transform>1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</transform>
   </camera>
   <camera id="2" label="pano_0003">
    <transform>0 0 1 0.5 0 1 0 -1 -1 0 0 4</transform>
   </camera>
  </cameras>
  <transform>
   <rotation>0 -1 0 1 0 0 0 0 1</rotation>
   <translation>10 0 0</translation>
   <scale>2</scale>
  </transform>
 </chunk>
</document>"""


def sample_model(pkg, n_images=5, n_points=20):
    """tests/test_formats.py::sample_model, built from ``pkg``'s classes,
    with a second camera so that intrinsics differ across images."""
    rng = np.random.default_rng(0)
    model = pkg.model.ColmapModel()
    cam_id = model.add_camera("PINHOLE", 1600, 1600,
                              [533.333, 533.333, 800.0, 800.0])
    for i in range(1, n_images + 1):
        r = pkg.pose.axis_angle_mat3(rng.normal(size=3),
                                     rng.uniform(-90, 90))
        center = rng.normal(size=3) * 3
        model.images.append(pkg.model.Image.from_pose(
            i, r, r @ (-center), cam_id, f"frame_{i:04d}_A.jpg"))
    for j in range(n_points):
        model.points.append(pkg.model.Point3(
            id=j + 1, x=float(rng.normal()), y=float(rng.normal()),
            z=float(rng.normal()), r=int(rng.integers(0, 256)),
            g=int(rng.integers(0, 256)), b=int(rng.integers(0, 256)),
            err=0.5))
    return model


def dump(value):
    """Dataclasses, arrays and containers → plain comparable structures
    (arrays as (dtype, shape, f64 list))."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {"__class__": type(value).__name__,
                **{f.name: dump(getattr(value, f.name))
                   for f in dataclasses.fields(value)}}
    if isinstance(value, np.ndarray):
        return ("ndarray", str(value.dtype), value.shape,
                np.asarray(value, np.float64).ravel().tolist())
    if isinstance(value, dict):
        return {str(k): dump(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [dump(v) for v in value]
    if isinstance(value, pathlib.Path):
        return value.name
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    return value


def assert_dumps_close(got, ref, where="value"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), where
        for key in ref:
            assert_dumps_close(got[key], ref[key], f"{where}.{key}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_dumps_close(g, r, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert isinstance(got, float), where
        assert got == pytest.approx(ref, rel=0, abs=1e-12, nan_ok=True), where
    else:
        assert got == ref, where


def tree_bytes(root: pathlib.Path) -> dict:
    """Every file under ``root``: relative path → bytes."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ---- scenarios: fn(pkg, out_dir) -> values; files land under out_dir -------

def scenario_colmap_text(pkg, out):
    model = sample_model(pkg)
    pkg.colmap.write_model(out / "m", model)
    back = pkg.colmap.read_model(out / "m")
    pkg.colmap.write_model(out / "again", back)
    return {"back": back, "empty": pkg.colmap.read_model(out / "m").points[:0]}


def scenario_transforms_json(pkg, out):
    model = sample_model(pkg)
    frames, intr = pkg.tf.frames_from_model(model, x_fix_deg=270.0)
    pkg.tf.write_transforms(out / "transforms.json", frames, intr)
    read = pkg.tf.read_transforms(out / "transforms.json")
    back = pkg.tf.model_from_transforms(out / "transforms.json",
                                        x_fix_deg=270.0, sensor_w_mm=36.0,
                                        sensor_h_mm=24.0)
    mixed = sample_model(pkg, 2, 0)
    cam2 = mixed.add_camera("PINHOLE", 800, 600, [400.0, 400.0, 400.0, 300.0])
    mixed.images[1].camera_id = cam2
    try:
        pkg.tf.frames_from_model(mixed, x_fix_deg=0.0)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return {"frames": frames, "intr": intr, "read": read, "back": back,
            "refused": refused}


def scenario_realityscan(pkg, out):
    model = sample_model(pkg)
    rows, records, hpr_back = [], [], []
    for img in model.images:
        r_xmp = pkg.rs.colmap_rot_to_rs_rot(img.r_wc)
        center = pkg.rs.colmap_world_to_rs_world(img.center)
        hpr = pkg.rs.rs_rotation_to_hpr(r_xmp)
        hpr_back.append((pkg.rs.hpr_to_rs_rotation(*hpr),
                         pkg.rs.rs_rot_to_colmap_rot(r_xmp),
                         pkg.rs.rs_world_to_colmap_world(center)))
        rows.append(pkg.rs.make_csv_row(img.name, *center, *hpr, 12.0))
        records.append({"name": img.name, "r_xmp": r_xmp, "pos_rs": center,
                        "focal_mm": 12.0})
    pkg.rs.write_csv_rows(out / "cams.csv", rows)
    pkg.rs.write_xmp_dir(out / "xmp", records)
    csv_rows = pkg.rs.read_csv_rows(out / "cams.csv")
    xmp_rows = pkg.rs.read_xmp_dir(out / "xmp", image_ext="png")
    kw = dict(sensor_w_mm=36.0, sensor_h_mm=24.0)
    from_csv = pkg.rs.model_from_csv_rows(
        csv_rows, 1600, 1200, image_name_map={"frame_0002_A": "x.tif"}, **kw)
    from_xmp = pkg.rs.model_from_xmp_rows(xmp_rows, 1600, 1200,
                                          single_camera=True, **kw)
    rs_xyz, rs_rgb = pkg.rs.points_to_rs_vertices(model.points)
    tf_xyz, tf_rgb = pkg.rs.points_to_transforms_ply_vertices(model.points)
    return {"rows": rows, "hpr_back": hpr_back, "csv_rows": csv_rows,
            "xmp_rows": xmp_rows, "from_csv": from_csv, "from_xmp": from_xmp,
            "rs_vertices": (rs_xyz, rs_rgb), "tf_vertices": (tf_xyz, tf_rgb),
            "rs_points": pkg.rs.rs_vertices_to_points(rs_xyz, rs_rgb, 7),
            "tf_points": pkg.rs.transforms_ply_vertices_to_points(
                tf_xyz, tf_rgb, 3),
            "no_points": pkg.rs.points_to_rs_vertices([])}


def scenario_metashape(pkg, out):
    model = sample_model(pkg)
    model.add_camera("PINHOLE", 1600, 1600, [610.0, 610.0, 800.0, 800.0])
    model.images[3].camera_id = 2
    pkg.meta.write_perspective_xml(out / "cams.xml", model)
    pkg.meta.write_perspective_xml(out / "named.xml", model,
                                   sensor_label="rig")
    records, w, h = pkg.meta.read_perspective_xml(
        out / "cams.xml", image_ext="png",
        image_name_map={"frame_0001_A": "frame_0001_A.tif"})
    back = pkg.meta.model_from_perspective_records(records, w, h)
    single = pkg.meta.model_from_perspective_records(records, w, h,
                                                     single_camera=True)
    (out / "sph.xml").write_text(SPHERICAL_XML)
    (out / "bad.xml").write_text("<document><chunk/></document>")
    try:
        pkg.meta.read_spherical_cameras(out / "bad.xml")
        refused = None
    except ValueError as exc:
        refused = str(exc).replace(str(out), "OUT")
    return {"records": records, "size": (w, h), "back": back,
            "single": single,
            "spherical": pkg.meta.read_spherical_cameras(out / "sph.xml"),
            "refused": refused}


def scenario_model(pkg, out):
    model = sample_model(pkg, 3, 6)
    img = model.images[0]
    cam = model.camera_for(img)
    first = {"r_wc": img.r_wc, "t_wc": img.t_wc, "center": img.center,
             "c2w_gl": img.c2w_gl(), "intr": cam.pinhole_intrinsics()}
    rebuilt = pkg.model.Image.from_c2w_gl(9, img.c2w_gl(), 1, "again.jpg")
    same_cam = model.add_camera("PINHOLE", 1600, 1600,
                                [533.3330001, 533.333, 800.0, 800.0])
    new_cam = model.add_camera("SIMPLE_PINHOLE", 640, 480, [500.0, 320, 240])
    forced = model.add_camera("PINHOLE", 1, 1, [1, 1, 1, 1], single=True)
    rot = pkg.model.world_rotation_xyz_deg(10.0, -20.0, 30.0)
    model.rotate_cameras(rot)
    model.scale_cameras(2.5)
    model.rotate_points(rot)
    model.scale_points(0.25)
    return {"first": first, "rebuilt": rebuilt, "rot": rot, "model": model,
            "cams": (same_cam, new_cam, forced),
            "simple_intr": model.cameras[new_cam].pinhole_intrinsics(),
            "to_mm": pkg.model.focal_pixels_to_mm(533.3, 540.0, 1600, 1200,
                                                  36.0, 24.0),
            "to_px": pkg.model.focal_mm_to_pixels(12.0, 1600, 1200, 36.0,
                                                  24.0)}


def scenario_hub(pkg, out):
    model = sample_model(pkg)
    opts = pkg.hub.ExportOptions(
        out_dir=out / "export", export_colmap=True, export_csv=True,
        export_ply=True, export_transforms=True, export_transforms_ply=True,
        export_xmp=True, export_metashape_xml=True,
        camera_rot_deg=(0.0, 90.0, 0.0), pointcloud_rot_deg=(180.0, 0.0, 0.0),
        camera_scale=2.0, pointcloud_scale=0.5, sensor_height_mm=24.0)
    pkg.hub.apply_world_transforms(model, opts)
    logs = pkg.hub.export_model(model, opts)
    bare = sample_model(pkg, 2, 0)
    bare_logs = pkg.hub.export_model(bare, pkg.hub.ExportOptions(
        out_dir=out / "bare", export_ply=True, export_transforms_ply=True,
        export_csv=True, csv_name="only.csv"))
    images = out / "images"
    images.mkdir()
    (images / "notes.txt").write_text("not an image")
    (images / "a_broken.png").write_bytes(b"not a png")
    pkg.image.write_image(images / "b_0001.png",
                          np.zeros((6, 9, 3), np.uint8))
    (images / "c_0002.JPG").write_bytes(b"")
    try:
        pkg.hub.infer_image_size_from_dir(out / "bare")
        refused = None
    except ValueError as exc:
        refused = str(exc).replace(str(out), "OUT")
    return {"logs": [ln.replace(str(out), "OUT") for ln in logs],
            "bare_logs": [ln.replace(str(out), "OUT") for ln in bare_logs],
            "listed": pkg.hub.list_image_files(images),
            "stems": pkg.hub.map_stem_to_image_name(images),
            "no_dir": pkg.hub.map_stem_to_image_name(None),
            "size": pkg.hub.infer_image_size_from_dir(images),
            "refused": refused, "model": model}


SCENARIOS = {fn.__name__[len("scenario_"):]: fn for fn in (
    scenario_colmap_text, scenario_transforms_json, scenario_realityscan,
    scenario_metashape, scenario_model, scenario_hub)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_package(tmp_path, name):
    ref_out, got_out = tmp_path / "jax", tmp_path / "torch"
    ref_out.mkdir()
    got_out.mkdir()
    ref = dump(SCENARIOS[name](J, ref_out))
    got = dump(SCENARIOS[name](T, got_out))
    assert_dumps_close(got, ref, name)
    ref_files, got_files = tree_bytes(ref_out), tree_bytes(got_out)
    assert sorted(got_files) == sorted(ref_files)
    for rel, data in ref_files.items():
        assert got_files[rel] == data, rel


@pytest.mark.parametrize("module", ["colmap", "hub", "meta", "model", "rs",
                                    "tf"])
def test_public_names_match_and_are_exercised(module):
    """The copy has the original's public names, and every public function
    of the original is called by a scenario above."""
    ref_mod, got_mod = getattr(J, module), getattr(T, module)

    def public(mod):
        return sorted(
            name for name, obj in vars(mod).items()
            if not name.startswith("_") and (callable(obj) or name.isupper())
            and getattr(obj, "__module__", mod.__name__) == mod.__name__)

    assert public(got_mod) == public(ref_mod)
    source = pathlib.Path(__file__).read_text()
    for name in public(ref_mod):
        if inspect.isfunction(getattr(ref_mod, name)):
            assert f".{name}(" in source, f"{module}.{name} is not exercised"


def test_package_init_reexports_match():
    import gs360x.io.formats as jformats
    import gs360x_torch.io.formats as tformats

    def names(pkg):
        return sorted(n for n in vars(pkg) if not n.startswith("_"))

    assert names(tformats) == names(jformats)
    assert tformats.ColmapModel is tmodel.ColmapModel
    assert tformats.ColmapModel is not jformats.ColmapModel
