"""The port's dual-fisheye tool (:mod:`gs360x_torch.tools.dualfisheye`)
against the JAX package's (:mod:`gs360x.tools.dualfisheye`) on the CPU:
the host-side numpy code exactly (calibration parse, auto-zoom, undistort
maps, SFM10 layout, per-view lens choice and maps, pairing), the device
remap within 1 LSB, and the whole CLI (``--device cpu``, the plain
versions): the same files, images within 1 LSB, masks equal, the same
report JSON and exit codes; ``--dry-run``, a missing XML, and the pose
export (``--camera-extrinsics-xml``, ``--metadata-only``: the perspective
Metashape XML and ``sparse/0`` byte-equal to the JAX tool's, the same
error exits). The ``.cube`` LUT decode
(``--input-lut`` with each output colour space, ``--input-color-profile
osmo360-dlogm`` with ``--dlogm-lut``) against the JAX CLI: images within 1
LSB, masks equal, the same exit codes and messages."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gs360x.io import image as im
from gs360x.core import color as jcolor
from gs360x.tools import dualfisheye as jdf
from gs360x_torch.core import color as tcolor
from gs360x_torch.io import image as tim
from gs360x_torch.kernels import remap_cuda, warp_cuda
from gs360x_torch.tools import dualfisheye as tdf
from test_dualfisheye import CALIB_XML, make_calib, synth_fisheye
from test_torch_color import _smooth_table, write_cube

torch.set_num_threads(1)

CPU = torch.device("cpu")


def port_calib(calib):
    return tdf.SensorCalibration(**dataclasses.asdict(calib))


@pytest.fixture
def calib_xml(tmp_path):
    p = tmp_path / "calib.xml"
    p.write_text(CALIB_XML)
    return p


# --- host code: exactly the JAX tool's ---------------------------------------

def test_calibration_parse_equals_jax(calib_xml):
    ref_sensors, ref_cams = jdf.load_metashape_calibration(calib_xml)
    got_sensors, got_cams = tdf.load_metashape_calibration(calib_xml)
    assert got_cams == ref_cams
    assert sorted(got_sensors) == sorted(ref_sensors)
    for sid, calib in ref_sensors.items():
        assert dataclasses.asdict(got_sensors[sid]) == \
            dataclasses.asdict(calib)
        assert got_sensors[sid].center == calib.center


@pytest.mark.parametrize("kw,zoom", [(dict(f=140.0, k1=0.15), None),
                                     (dict(f=143.0, k1=0.01, cx=1.5,
                                           cy=-0.8, p1=1e-3, b1=0.5), 1.1)])
def test_remap_cache_equals_jax(kw, zoom):
    calib = make_calib(size=128, **kw)
    ref = jdf.build_remap_cache(calib, zoom, 190.0)
    got = tdf.build_remap_cache(port_calib(calib), zoom, 190.0)
    assert got.undistort_zoom == ref.undistort_zoom
    for name in ("map_x", "map_y", "valid"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name
    assert tdf.estimate_auto_undistort_zoom(port_calib(calib)) == \
        jdf.estimate_auto_undistort_zoom(calib)


def test_sfm10_specs_and_perspective_maps_equal_jax():
    specs = tdf.build_sfm10_specs(48, 14.0, "36x24", 40.0, 35.0)
    assert specs == jdf.build_sfm10_specs(48, 14.0, "36x24", 40.0, 35.0)
    ref_sensors = {"0": make_calib("0", size=256),
                   "1": make_calib("1", size=256, k1=0.02)}
    got_sensors = {k: port_calib(v) for k, v in ref_sensors.items()}
    ref = jdf.build_perspective_spec_maps(ref_sensors, "0", "1", specs,
                                          0.0, 180.0, 190.0)
    got = tdf.build_perspective_spec_maps(got_sensors, "0", "1", specs,
                                          0.0, 180.0, 190.0)
    assert list(got) == list(ref)
    for vid, m in ref.items():
        assert got[vid]["lens_key"] == m["lens_key"]
        for name in ("map_x", "map_y", "valid"):
            assert np.array_equal(got[vid][name], m[name]), (vid, name)
    for bad in ((48, 14.0, "36 36", 190.0, 40.0),
                (48, 14.0, "36 36", 40.0, 95.0), (0, 14.0, "36 36", 40, 40)):
        with pytest.raises(ValueError) as ref_exc:
            jdf.build_sfm10_specs(*bad)
        with pytest.raises(ValueError) as got_exc:
            tdf.build_sfm10_specs(*bad)
        assert str(got_exc.value) == str(ref_exc.value)


def test_pairing_and_sensor_ids_equal_jax(tmp_path):
    for name in ("a_X.jpg", "a_Y.jpg", "b_X.jpg", "c_Y.jpg", "d.jpg",
                 "e_X.png", "e_Y.png"):
        (tmp_path / name).touch()
    files = sorted(tmp_path.iterdir())
    pairs = tdf.build_pair_records(files, "_X", "_Y")
    assert pairs == jdf.build_pair_records(files, "_X", "_Y")
    sensors = {"0": None, "7": None}
    for cams in ({}, {"a_X": "7", "a_Y": "0"}, {"a_X": "9"}):
        args = (cams, sensors, "a", pairs[0][1], pairs[0][2], "_X", "_Y",
                "0", "1")
        assert tdf.resolve_sensor_ids(*args) == jdf.resolve_sensor_ids(*args)


@pytest.mark.parametrize("interp", ["nearest", "bilinear", "catmull-rom"])
def test_device_remap_matches_jax(interp):
    calib = make_calib(size=128, k1=0.05)
    cache = jdf.build_remap_cache(calib, None, 190.0)
    img = synth_fisheye(calib)
    ref = jdf.device_remap(im.to_float01(img), cache.map_x, cache.map_y,
                           cache.valid, interp=interp, fill=0.2,
                           quantize=True)
    got = tdf.device_remap(img, cache.map_x, cache.map_y, cache.valid,
                           interp=interp, fill=0.2, quantize=True,
                           device=CPU)
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape == (128, 128, 3)
    assert int(np.abs(got.astype(int) - ref.astype(int)).max()) <= 1
    mask = img[..., 0]
    ref_m = jdf.device_remap(mask.astype(np.float32) / 255.0, cache.map_x,
                             cache.map_y, cache.valid, interp="nearest",
                             fill=0.0)
    got_m = tdf.device_remap(mask, cache.map_x, cache.map_y, cache.valid,
                             interp="nearest", fill=0.0, quantize=True,
                             device=CPU)
    assert np.array_equal(got_m, im.from_float01(ref_m))


# --- the whole CLI -----------------------------------------------------------

def _pair_dir(tmp_path, calib_xml, masks: bool):
    sensors, _ = jdf.load_metashape_calibration(calib_xml)
    in_dir = tmp_path / "pairs"
    in_dir.mkdir()
    im.write_image(in_dir / "frame_0001_X.png", synth_fisheye(sensors["0"]))
    im.write_image(in_dir / "frame_0001_Y.png", synth_fisheye(sensors["1"]))
    mask_dir = None
    if masks:
        mask_dir = tmp_path / "masks"
        mask_dir.mkdir()
        rng = np.random.default_rng(5)
        for name in ("frame_0001_X.png", "frame_0001_Y.png"):
            m = (rng.random((512, 512)) > 0.5).astype(np.uint8) * 255
            im.write_image(mask_dir / name, np.repeat(m[..., None], 3, -1))
    return in_dir, mask_dir


def test_cli_matches_jax(calib_xml, tmp_path):
    in_dir, mask_dir = _pair_dir(tmp_path, calib_xml, masks=True)
    common = ["--input-dir", str(in_dir), "--camera-xml", str(calib_xml),
              "--perspective-size", "128", "--save-fisheye-output",
              "--perspective-ext", ".png", "--mask-input-dir", str(mask_dir)]
    ref_out, got_out = tmp_path / "jax", tmp_path / "torch"
    assert jdf.main(common + ["--output-dir", str(ref_out), "--report-json",
                              str(tmp_path / "jax.json")]) == 0
    remap_cuda.reset_counters()
    warp_cuda.reset_counters()
    served = tim.texel_decode_counts()["served"]
    assert tdf.main(common + ["--output-dir", str(got_out), "--report-json",
                              str(tmp_path / "torch.json"),
                              "--device", "cpu"]) == 0
    # one remap per lens undistort, per lens view group, per mask group;
    # each lens image decodes to Pillow's RGBX texels, so no planarize
    assert remap_cuda.PLAIN_CALLS["remap"] == 6
    assert warp_cuda.PLAIN_CALLS["planarize"] == 0
    assert tim.texel_decode_counts()["served"] == served + 2
    assert remap_cuda.LAUNCHES["remap"] == 0
    assert json.loads((tmp_path / "torch.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    ref_files = sorted(p.relative_to(ref_out) for p in ref_out.rglob("*.png"))
    got_files = sorted(p.relative_to(got_out) for p in got_out.rglob("*.png"))
    assert got_files == ref_files
    assert len(ref_files) == 2 + 10 + 10
    for rel in ref_files:
        ref = im.read_image(ref_out / rel).astype(np.int32)
        got = im.read_image(got_out / rel).astype(np.int32)
        assert got.shape == ref.shape, rel
        if rel.parts[:2] == ("perspective", "masks"):
            assert np.array_equal(got, ref), rel
        else:
            assert int(np.abs(got - ref).max()) <= 1, rel


def test_dry_run(calib_xml, tmp_path, capsys):
    in_dir = tmp_path / "pairs"
    in_dir.mkdir()
    (in_dir / "p_X.jpg").write_bytes(b"")
    (in_dir / "p_Y.jpg").write_bytes(b"")
    args = ["--input-dir", str(in_dir), "--camera-xml", str(calib_xml),
            "--dry-run", "--perspective-size", "64"]
    assert jdf.main(args) == 0
    ref = capsys.readouterr().out
    assert tdf.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "[DRY]" in got
    assert got == ref


def test_missing_xml_and_input_exit_codes(tmp_path):
    missing = ["--camera-xml", str(tmp_path / "no.xml")]
    assert tdf.main(missing + ["--device", "cpu"]) == jdf.main(missing) == 1
    xml = tmp_path / "c.xml"
    xml.write_text(CALIB_XML)
    no_input = ["--camera-xml", str(xml), "--output-dir",
                str(tmp_path / "o")]
    assert tdf.main(no_input + ["--device", "cpu"]) == \
        jdf.main(no_input) == 1


# --- the pose export (--camera-extrinsics-xml, --metadata-only) --------------

EXTRINSICS_XML = """<?xml version='1.0'?>
<document><chunk>
 <sensors next_id="1"><sensor id="0" type="fisheye"/></sensors>
 <cameras next_id="4">
  <camera id="0" label="frame_0001_X">
   <transform>1 0 0 0.5 0 1 0 -0.25 0 0 1 2 0 0 0 1</transform>
  </camera>
  <camera id="1" label="frame_0001_Y">
   <transform>-1 0 0 0.5 0 1 0 -0.25 0 0 -1 2 0 0 0 1</transform>
  </camera>
  <camera id="2" label="frame_0002_X">
   <transform>0 0 1 3 0 1 0 0 -1 0 0 1 0 0 0 1</transform>
  </camera>
  <camera id="3" label="frame_0002_Y">
   <transform>0 0 -1 3 0 1 0 0 1 0 0 1 0 0 0 1</transform>
  </camera>
 </cameras>
</chunk></document>"""


def _metadata_files(out_dir):
    """The pose export's files under ``out_dir``: relative path → bytes."""
    files = {p.relative_to(out_dir): p.read_bytes()
             for p in sorted(out_dir.rglob("*"))
             if p.is_file() and (p.suffix in (".xml", ".txt"))}
    assert files
    return files


@pytest.mark.parametrize("extra", [
    [],
    ["--perspective-ext", ".png", "--suffixes", "_X,_Y",
     "--perspective-focal-mm", "18", "--perspective-sensor-mm", "36x24",
     "--perspective-metashape-xml-name", "rig.xml"],
    ["--pointcloud-ply", "POINTS"],
])
def test_metadata_only_matches_jax(calib_xml, tmp_path, extra):
    """--metadata-only: the perspective Metashape XML and ``sparse/0`` are
    byte-equal to the JAX tool's; nothing runs on a device."""
    ext_xml = tmp_path / "align.xml"
    ext_xml.write_text(EXTRINSICS_XML)
    if "POINTS" in extra:
        from gs360x.io import ply as jply
        rng = np.random.default_rng(3)
        ply = tmp_path / "points.ply"
        jply.save_ply_xyz_rgb(ply, rng.normal(size=(12, 3)),
                              rng.integers(0, 256, (12, 3), dtype=np.uint8))
        extra = [str(ply) if x == "POINTS" else x for x in extra]
    common = ["--camera-xml", str(calib_xml), "--metadata-only",
              "--camera-extrinsics-xml", str(ext_xml), "--perspective-size",
              "64"] + extra
    ref_out, got_out = tmp_path / "jax", tmp_path / "torch"
    assert jdf.main(common + ["--output-dir", str(ref_out)]) == 0
    remap_cuda.reset_counters()
    warp_cuda.reset_counters()
    assert tdf.main(common + ["--output-dir", str(got_out), "--device",
                              "cpu"]) == 0
    assert not any(remap_cuda.PLAIN_CALLS.values())
    assert not any(warp_cuda.PLAIN_CALLS.values())
    ref, got = _metadata_files(ref_out), _metadata_files(got_out)
    assert sorted(got) == sorted(ref)
    assert len(ref) == 1 + 3          # the XML, cameras/images/points3D.txt
    for rel, data in ref.items():
        assert got[rel] == data, rel


def test_camera_extrinsics_xml_beside_the_pixels_matches_jax(calib_xml,
                                                             tmp_path):
    """--camera-extrinsics-xml on a pixel run: metadata byte-equal to the
    JAX tool's under ``perspective/``, pixels as without the flag."""
    in_dir, _ = _pair_dir(tmp_path, calib_xml, masks=False)
    ext_xml = tmp_path / "align.xml"
    ext_xml.write_text(EXTRINSICS_XML)
    common = ["--input-dir", str(in_dir), "--camera-xml", str(calib_xml),
              "--perspective-size", "64", "--perspective-ext", ".png"]
    flag = ["--camera-extrinsics-xml", str(ext_xml)]
    ref_out, got_out, bare_out = (tmp_path / "jax", tmp_path / "torch",
                                  tmp_path / "bare")
    assert jdf.main(common + flag + ["--output-dir", str(ref_out)]) == 0
    assert tdf.main(common + flag + ["--output-dir", str(got_out),
                                     "--device", "cpu"]) == 0
    assert tdf.main(common + ["--output-dir", str(bare_out), "--device",
                              "cpu"]) == 0
    ref, got = _metadata_files(ref_out), _metadata_files(got_out)
    assert sorted(got) == sorted(ref) and len(ref) == 4
    for rel, data in ref.items():
        assert rel.parts[0] == "perspective"
        assert got[rel] == data, rel
    assert not list(bare_out.rglob("*.xml"))
    images = sorted(p.relative_to(bare_out) for p in bare_out.rglob("*.png"))
    assert len(images) == 10
    for rel in images:
        assert (got_out / rel).read_bytes() == (bare_out / rel).read_bytes()


@pytest.mark.parametrize("case", ["no-extrinsics", "missing-file",
                                  "no-x-lens"])
def test_metadata_errors_match_jax(calib_xml, tmp_path, capsys, case):
    """The pose export's error exits and ``[ERR]`` lines are the JAX
    tool's."""
    args = ["--camera-xml", str(calib_xml), "--metadata-only",
            "--output-dir", str(tmp_path / "o"), "--perspective-size", "64"]
    if case == "missing-file":
        args += ["--camera-extrinsics-xml", str(tmp_path / "none.xml")]
    elif case == "no-x-lens":
        ext_xml = tmp_path / "align.xml"
        ext_xml.write_text(EXTRINSICS_XML.replace("_X", "_Q"))
        args += ["--camera-extrinsics-xml", str(ext_xml)]
    ref_rc = jdf.main(args)
    ref_err = capsys.readouterr().err
    got_rc = tdf.main(args + ["--device", "cpu"])
    got_err = capsys.readouterr().err
    assert got_rc == ref_rc == 1
    assert got_err == ref_err and got_err.startswith("[ERR]")


# --- the .cube LUT decode ----------------------------------------------------

@pytest.fixture
def cube(tmp_path):
    return write_cube(tmp_path / "dlogm.cube", _smooth_table(9, 4))


def _assert_outputs_match(ref_out, got_out):
    ref_files = sorted(p.relative_to(ref_out) for p in ref_out.rglob("*.png"))
    got_files = sorted(p.relative_to(got_out) for p in got_out.rglob("*.png"))
    assert got_files == ref_files and ref_files
    for rel in ref_files:
        ref = im.read_image(ref_out / rel).astype(np.int32)
        got = im.read_image(got_out / rel).astype(np.int32)
        assert got.shape == ref.shape, rel
        if rel.parts[:2] == ("perspective", "masks"):
            assert np.array_equal(got, ref), rel
        else:
            assert int(np.abs(got - ref).max()) <= 1, rel
    return ref_files


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("space", ["srgb", "rec709", "passthrough"])
def test_prepare_input_planes_match_jax(tmp_path, cube, dtype, space):
    rng = np.random.default_rng(3)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (24, 20, 3), dtype=dtype)
    path = tmp_path / "lens.png"
    im.write_image(path, img)
    ref = jdf.prepare_input_image(path, jcolor.load_cube_lut(cube), space)
    warp_cuda.reset_counters()
    got = tdf.prepare_input_planes(im.read_image(path),
                                   tcolor.load_cube_lut(cube), space,
                                   device=CPU)
    assert warp_cuda.PLAIN_CALLS["planarize"] == 1
    assert got.dtype == torch.float32 and got.shape == (3, 24, 20)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), ref, rtol=0,
                               atol=1e-6)
    # without a LUT: the source of the remaps, RGBX texels of a u8 image's
    # bytes (X = 0), scaled f32 planes of a u16 one
    plain = tdf.prepare_input_planes(im.read_image(path), None, space,
                                     device=CPU)
    if dtype == np.uint8:
        assert plain.shape == (24, 20, 4) and not plain[..., 3].any()
        hwc = plain[..., :3]
    else:
        hwc = plain.permute(1, 2, 0)
    np.testing.assert_allclose(
        im.to_float01(hwc.numpy()),
        jdf.prepare_input_image(path, None, space), rtol=0, atol=1e-6)


@pytest.mark.parametrize("flags", [
    ["--lut-output-color-space", "srgb"],
    ["--lut-output-color-space", "passthrough",
     "--save-color-corrected-output"],
    ["--input-color-profile", "osmo360-dlogm", "--dlogm-lut", "{cube}"]])
def test_lut_cli_matches_jax(calib_xml, tmp_path, cube, flags):
    in_dir, mask_dir = _pair_dir(tmp_path, calib_xml, masks=True)
    flags = [f.replace("{cube}", str(cube)) for f in flags]
    if "--dlogm-lut" not in flags:
        flags = ["--input-lut", str(cube)] + flags
    common = ["--input-dir", str(in_dir), "--camera-xml", str(calib_xml),
              "--perspective-size", "64", "--save-fisheye-output",
              "--perspective-ext", ".png", "--mask-input-dir",
              str(mask_dir)] + flags
    ref_out, got_out = tmp_path / "jax", tmp_path / "torch"
    assert jdf.main(common + ["--output-dir", str(ref_out)]) == 0
    remap_cuda.reset_counters()
    warp_cuda.reset_counters()
    assert tdf.main(common + ["--output-dir", str(got_out),
                              "--device", "cpu"]) == 0
    # one planarize per lens image, into the LUT; the remaps as without one
    assert warp_cuda.PLAIN_CALLS["planarize"] == 2
    assert remap_cuda.PLAIN_CALLS["remap"] == 6
    files = _assert_outputs_match(ref_out, got_out)
    n_color = 2 if "--save-color-corrected-output" in flags else 0
    assert len(files) == 2 + 10 + 10 + n_color


@pytest.mark.parametrize("lut", [False, True])
def test_cli_writes_what_the_packed_decode_writes(calib_xml, tmp_path,
                                                  monkeypatch, cube, lut):
    """JPEG lens pairs with masks and the undistorted fisheyes: the files
    of the texel decode byte-equal to those with the packed decode forced;
    with ``--dlogm-lut`` no texels are asked for."""
    sensors, _ = jdf.load_metashape_calibration(calib_xml)
    in_dir, mask_dir = _pair_dir(tmp_path, calib_xml, masks=True)
    for lens, sid in (("X", "0"), ("Y", "1")):
        (in_dir / f"frame_0001_{lens}.png").unlink()
        tim.write_image(in_dir / f"frame_0001_{lens}.jpg",
                        synth_fisheye(sensors[sid]), jpeg_quality=95)
        mask = mask_dir / f"frame_0001_{lens}.png"
        tim.write_image(mask.with_suffix(".jpg"), tim.read_image(mask))
    flags = (["--input-color-profile", "osmo360-dlogm", "--dlogm-lut",
              str(cube)] if lut else [])
    common = ["--input-dir", str(in_dir), "--camera-xml", str(calib_xml),
              "--perspective-size", "64", "--save-fisheye-output",
              "--perspective-ext", ".png", "--mask-input-dir", str(mask_dir),
              "--device", "cpu"] + flags
    inner = tdf.read_image
    outs = {}
    for route in ("texels", "packed"):
        if route == "packed":
            monkeypatch.setattr(tdf, "read_image",
                                lambda path, texels=False: inner(path))
        before = tim.texel_decode_counts()
        assert tdf.main(common + ["--output-dir",
                                  str(tmp_path / route)]) == 0
        after = tim.texel_decode_counts()
        asked = after["requested"] - before["requested"]
        served = after["served"] - before["served"]
        assert (asked, served) == ((2, 2) if route == "texels" and not lut
                                   else (0, 0))
        outs[route] = {p.relative_to(tmp_path / route): p.read_bytes()
                       for p in (tmp_path / route).rglob("*.*")}
    assert len(outs["texels"]) == 2 + 10 + 10
    assert outs["texels"] == outs["packed"]


def test_lut_errors_match_jax(calib_xml, tmp_path, capsys):
    base = ["--camera-xml", str(calib_xml), "--input-dir", str(tmp_path),
            "--input-color-profile", "osmo360-dlogm"]
    assert jdf.main(base) == 2
    ref_err = capsys.readouterr().err
    assert tdf.main(base + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == ref_err
    assert "requires --dlogm-lut" in ref_err
    in_dir, _ = _pair_dir(tmp_path, calib_xml, masks=False)
    bad = tmp_path / "bad.cube"
    bad.write_text("LUT_3D_SIZE 2\n0 0 0\n")
    args = ["--camera-xml", str(calib_xml), "--input-dir", str(in_dir),
            "--input-lut", str(bad), "--output-dir", str(tmp_path / "o")]
    assert jdf.main(args) == 1
    ref_err = capsys.readouterr().err
    assert tdf.main(args + ["--device", "cpu"]) == 1
    assert capsys.readouterr().err == ref_err
    assert ref_err.startswith("[ERR] failed to load LUT")
