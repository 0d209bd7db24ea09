"""The port's ``camconvert`` CLI (:mod:`gs360x_torch.tools.camconvert`)
against the JAX package's on the fixtures of ``tests/test_formats.py``:
every subcommand and export flag, every output file byte-equal, exit codes,
``[OK]``/``[WARN]`` lines and ``[ERR]`` lines equal. The tool is host code;
``--device`` is accepted and changes nothing."""

import numpy as np
import pytest

from gs360x.io import image as jim
from gs360x.io import ply as jply
from gs360x.io.formats import colmap_text as jcolmap
from gs360x.tools import camconvert as jcc
from gs360x_torch.tools import camconvert as tcc
from test_formats import sample_model
from test_torch_formats import tree_bytes

ALL_EXPORTS = ["--export-colmap", "--export-csv", "--export-transforms",
               "--export-xmp", "--export-metashape-xml", "--export-ply",
               "--export-transforms-ply"]


@pytest.fixture
def sources(tmp_path):
    """One model in every input format, written by the JAX tool, plus a
    point cloud and an image folder."""
    src = tmp_path / "src"
    jcolmap.write_model(src / "colmap", sample_model())
    assert jcc.main(["colmap", str(src / "colmap"), "-o", str(src / "all")]
                    + ALL_EXPORTS) == 0
    rng = np.random.default_rng(2)
    jply.save_ply_xyz_rgb(src / "cloud.ply",
                          rng.normal(size=(9, 3)).astype(np.float32),
                          rng.integers(0, 256, (9, 3), dtype=np.uint8))
    images = src / "images"
    images.mkdir()
    for i in range(1, 6):
        jim.write_image(images / f"frame_{i:04d}_A.png",
                        np.zeros((12, 20, 3), np.uint8))
    return src


def run_both(make_args, tmp_path, capsys):
    results = []
    for name, mod, extra in (("jax", jcc, []),
                             ("torch", tcc, ["--device", "cpu"])):
        out = tmp_path / f"out_{name}"
        rc = mod.main(make_args(out) + extra)
        cap = capsys.readouterr()
        results.append((rc, cap.out.replace(str(out), "OUT"),
                        cap.err.replace(str(out), "OUT"),
                        tree_bytes(out) if out.exists() else {}))
    return results


def assert_same(ref, got, rc=0):
    assert got[0] == ref[0] == rc
    assert got[1] == ref[1] and got[2] == ref[2]
    assert sorted(got[3]) == sorted(ref[3])
    for rel, data in ref[3].items():
        assert got[3][rel] == data, rel


CASES = {
    "colmap-all": lambda s, o: ["colmap", str(s / "colmap"), "-o", str(o)]
    + ALL_EXPORTS,
    "colmap-default-policy": lambda s, o: ["colmap", str(s / "colmap"), "-o",
                                           str(o)],
    "colmap-world-transforms": lambda s, o: [
        "colmap", str(s / "colmap"), "-o", str(o), "--export-colmap",
        "--export-ply", "--camera-rot-z-deg", "90", "--camera-scale", "2",
        "--pointcloud-rot-x-deg", "180", "--pointcloud-scale", "0.5"],
    "colmap-names": lambda s, o: [
        "colmap", str(s / "colmap"), "-o", str(o),
        "--export-realityscan-csv", "--export-transforms-json",
        "--export-realityscan-xmp", "--realityscan-csv-file", "MyCams.csv",
        "--transforms-json-file", "tf.json", "--realityscan-xmp-output-dir",
        "xmps", "--single-camera", "--transforms-x-fix-deg", "90"],
    "csv-default-exports-all": lambda s, o: [
        "realityscan-csv", "--csv", str(s / "all" / "Align_RS_PerspCams.csv"),
        "--width", "1600", "--height", "1600", "-o", str(o)],
    "csv-with-ply-and-ids": lambda s, o: [
        "realityscan-csv", "--csv", str(s / "all" / "Align_RS_PerspCams.csv"),
        "--width", "1600", "--height", "1600", "-o", str(o),
        "--realityscan-ply", str(s / "cloud.ply"), "--export-colmap",
        "--export-transforms-ply", "--point-id-start", "500",
        "--sensor-width-mm", "36", "--sensor-height-mm", "24"],
    "xmp-with-image-dir": lambda s, o: [
        "realityscan-xmp", "--xmp-dir", str(s / "all" / "cameras_RealityScan"),
        "--image-dir", str(s / "images"), "-o", str(o)],
    "xmp-with-size": lambda s, o: [
        "realityscan-xmp", "--xmp-dir", str(s / "all" / "cameras_RealityScan"),
        "--xmp-image-ext", "png", "--width", "800", "--height", "600", "-o",
        str(o), "--export-colmap"],
    "transforms-back-to-colmap": lambda s, o: [
        "transforms-json", "--transforms-json",
        str(s / "all" / "transforms.json"), "--transforms-ply",
        str(s / "all" / "pointcloud_for_transforms.ply"), "-o", str(o),
        "--export-colmap", "--export-ply"],
    "metashape-xml": lambda s, o: [
        "metashape-xml", "--metashape-xml",
        str(s / "all" / "perspective_cams.xml"), "--metashape-xml-image-ext",
        "png", "-o", str(o), "--ply", str(s / "cloud.ply")],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_outputs_match_jax(sources, tmp_path, capsys, case):
    capsys.readouterr()
    ref, got = run_both(lambda out: CASES[case](sources, out), tmp_path,
                        capsys)
    assert_same(ref, got)
    assert ref[3], "the case wrote no file"


ERRORS = {
    "missing-colmap-dir": lambda s, o: ["colmap", str(s / "nope"), "-o",
                                        str(o)],
    "missing-csv": lambda s, o: ["realityscan-csv", "--csv",
                                 str(s / "no.csv"), "--width", "10",
                                 "--height", "10", "-o", str(o)],
    "xmp-without-size": lambda s, o: [
        "realityscan-xmp", "--xmp-dir", str(s / "all" / "cameras_RealityScan"),
        "-o", str(o)],
    "empty-xmp-dir": lambda s, o: ["realityscan-xmp", "--xmp-dir",
                                   str(s / "images"), "--width", "10",
                                   "--height", "10", "-o", str(o)],
    "missing-transforms": lambda s, o: ["transforms-json",
                                        "--transforms-json",
                                        str(s / "no.json"), "-o", str(o)],
    "missing-ply": lambda s, o: [
        "realityscan-csv", "--csv", str(s / "all" / "Align_RS_PerspCams.csv"),
        "--width", "1600", "--height", "1600", "-o", str(o), "--ply",
        str(s / "no.ply")],
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_exits_match_jax(sources, tmp_path, capsys, case):
    capsys.readouterr()
    ref, got = run_both(lambda out: ERRORS[case](sources, out), tmp_path,
                        capsys)
    assert got[0] == ref[0] != 0
    assert got[2] == ref[2]
    assert sorted(got[3]) == sorted(ref[3])


def test_device_flag_changes_nothing(sources, tmp_path, capsys):
    """--device cuda is accepted without a card: the tool uses no device."""
    outs = {}
    for device in ("cpu", "cuda"):
        out = tmp_path / device
        assert tcc.main(["colmap", str(sources / "colmap"), "-o", str(out),
                         "--export-transforms", "--device", device]) == 0
        outs[device] = tree_bytes(out)
    capsys.readouterr()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]


def test_usage_error_exit_matches_jax(capsys):
    for mod in (jcc, tcc):
        with pytest.raises(SystemExit) as exc:
            mod.main(["colmap"])
        assert exc.value.code == 2
    capsys.readouterr()
