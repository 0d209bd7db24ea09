"""The port's ``ms360xml`` CLI (:mod:`gs360x_torch.tools.ms360xml`) against
the JAX package's on the fixtures of ``tests/test_ms360xml.py``: every
output file byte-equal, exit codes and ``[ERR]`` lines equal, the helper
functions equal, and ``--persp-cut`` handing ``--device`` on to the port's
perspective cut, whose images are within 1 LSB (on at most 0.1% of pixels;
1 LSB anywhere for presets with pole-grazing views) of the JAX tool's
cut."""

import numpy as np
import pytest
import torch

from gs360x.io import image as im
from gs360x.io import ply as jply
from gs360x.tools import ms360xml as jms
from gs360x.tools import perspcut as jax_perspcut
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.tools import ms360xml as tms
from gs360x_torch.tools import perspcut as torch_perspcut
from test_ms360xml import SPHERICAL_XML
from test_torch_formats import tree_bytes
from test_torch_perspcut import _assert_same_outputs, lonlat_pano

torch.set_num_threads(1)


@pytest.fixture
def xml_file(tmp_path):
    p = tmp_path / "spherical.xml"
    p.write_text(SPHERICAL_XML)
    return p


@pytest.fixture
def points_ply(tmp_path):
    rng = np.random.default_rng(0)
    p = tmp_path / "pts.ply"
    jply.save_ply_xyz_rgb(p, rng.random((50, 3)).astype(np.float32),
                          rng.integers(0, 255, (50, 3), dtype=np.uint8))
    return p


def run_both(args, tmp_path, capsys):
    """Both CLIs on ``args`` + ``-o``: (rc, stdout, stderr, files) each,
    with the output directory's name taken out of the messages."""
    results = []
    for name, mod, extra in (("jax", jms, []),
                             ("torch", tms, ["--device", "cpu"])):
        out = tmp_path / name
        rc = mod.main(list(args) + ["-o", str(out)] + extra)
        cap = capsys.readouterr()
        results.append((rc, cap.out.replace(str(out), "OUT"),
                        cap.err.replace(str(out), "OUT"),
                        tree_bytes(out) if out.exists() else {}))
    return results


CLI_CASES = {
    "transforms-default": ["--preset", "default", "--format", "transforms"],
    "metashape-2views-scaled": ["--preset", "2views", "--format", "metashape",
                                "--scale", "2.0"],
    "metashape-full360": ["--format", "metashape"],
    "realityscan": ["--preset", "default", "--format", "realityscan"],
    "mcs-fisheyelike": ["--preset", "fisheyelike", "--format",
                        jms.FORMAT_METASHAPE_MULTI],
    "cube105-world-rot": ["--preset", "cube105", "--format", "transforms",
                          "--world-rot-axis", "0,0,1", "--world-rot-deg",
                          "33", "--ext", ".png"],
    "even-presets": ["--preset", "evenMinus30", "--format", "realityscan"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_outputs_match_jax(xml_file, tmp_path, capsys, case):
    ref, got = run_both([str(xml_file)] + CLI_CASES[case], tmp_path, capsys)
    assert got[0] == ref[0] == 0
    assert got[1] == ref[1] and got[2] == ref[2]
    assert sorted(got[3]) == sorted(ref[3]) and ref[3]
    for rel, data in ref[3].items():
        assert got[3][rel] == data, rel


@pytest.mark.parametrize("fmt,flags", [
    ("colmap", []), ("all", []), ("transforms", ["--pc-rotate-x-plus180"]),
    ("all", ["--pc-rotate-x-plus90", "--scale", "0.5"]),
    ("metashape", [])])
def test_cli_with_points_matches_jax(xml_file, points_ply, tmp_path, capsys,
                                     fmt, flags):
    args = [str(xml_file), "--preset", "default", "--format", fmt,
            "--points-ply", str(points_ply)] + flags
    ref, got = run_both(args, tmp_path, capsys)
    assert got[0] == ref[0] == 0
    assert got[1] == ref[1]
    assert sorted(got[3]) == sorted(ref[3]) and ref[3]
    for rel, data in ref[3].items():
        assert got[3][rel] == data, rel
    if fmt == "all":
        assert {"transforms.json", "perspective_cams.xml",
                "sparse/0/images.txt", "pointcloud_for_transforms.ply"} \
            <= set(got[3])
        assert any(rel.startswith("cameras_RealityScan/") for rel in got[3])


@pytest.mark.parametrize("case", ["colmap-needs-points", "mcs-needs-preset",
                                  "missing-xml", "bad-axis", "missing-ply",
                                  "not-spherical", "missing-cut-input"])
def test_error_exits_match_jax(xml_file, tmp_path, capsys, case):
    args = {
        "colmap-needs-points": [str(xml_file), "--format", "colmap"],
        "mcs-needs-preset": [str(xml_file), "--format",
                             jms.FORMAT_METASHAPE_MULTI],
        "missing-xml": [str(tmp_path / "no.xml")],
        "bad-axis": [str(xml_file), "--world-rot-axis", "1 0"],
        "missing-ply": [str(xml_file), "--format", "colmap", "--points-ply",
                        str(tmp_path / "none.ply")],
        "not-spherical": [str(tmp_path / "flat.xml")],
        "missing-cut-input": [str(xml_file), "--persp-cut", "--cut-input",
                              str(tmp_path / "nowhere")],
    }[case]
    (tmp_path / "flat.xml").write_text("<document><chunk/></document>")
    ref, got = run_both(args, tmp_path, capsys)
    assert got[0] == ref[0] == 1
    assert got[2] == ref[2] and got[2].startswith("[ERR]")


@pytest.mark.parametrize("preset", jms.PRESET_CHOICES)
def test_views_and_frames_match_jax(xml_file, preset):
    assert tms.PRESET_CHOICES == jms.PRESET_CHOICES
    assert tms.preset_config(preset) == jms.preset_config(preset)
    ref_views, got_views = jms.build_views(preset), tms.build_views(preset)
    assert got_views == ref_views
    from gs360x.io.formats import metashape as jmeta
    cameras = jmeta.read_spherical_cameras(xml_file)
    world_rot = np.eye(3)
    ref_frames, ref_intr, _ = jms.build_frames(cameras, preset, "jpg", 2.0,
                                               world_rot)
    got_frames, got_intr, _ = tms.build_frames(cameras, preset, "jpg", 2.0,
                                               world_rot)
    assert got_intr == ref_intr
    assert [f["file_path"] for f in got_frames] == \
        [f["file_path"] for f in ref_frames]
    for g, r in zip(got_frames, ref_frames):
        np.testing.assert_allclose(g["c2w_gl"], r["c2w_gl"], rtol=0,
                                   atol=1e-12)


def test_helpers_match_jax():
    view_ids = [v[0] for v in jms.build_views("full360coverage")]
    for label in ("pano_0001_A", "pano_0001_B_U", "x", "frame_0007_F_D20",
                  "a b/c"):
        assert tms.strip_view_suffix(label, view_ids) == \
            jms.strip_view_suffix(label, view_ids)
        assert tms.safe_name(label) == jms.safe_name(label)
    assert tms.compute_intrinsics(14.0, 1600, 1600) == \
        jms.compute_intrinsics(14.0, 1600, 1600)
    for text in ("0 1 0", "1,2,3", "0.5, 0 -1"):
        assert tms.parse_axis(text) == jms.parse_axis(text)
    assert (tms.SENSOR_W_MM, tms.DEFAULT_SIZE, tms.CUBE_FOV_DEG) == \
        (jms.SENSOR_W_MM, jms.DEFAULT_SIZE, jms.CUBE_FOV_DEG)


@pytest.mark.parametrize("preset,share", [("default", 0.001),
                                          ("full360coverage", 1.0),
                                          ("cube105", 0.001)])
def test_persp_cut_matches_jax(xml_file, tmp_path, capsys, monkeypatch,
                               preset, share):
    """--persp-cut runs each package's own perspective cut. The cut takes
    the tool's defaults (1600 px JPEGs), too large for a CPU test and
    lossy, so both cuts are narrowed to 64 px PNGs on the way in; the
    argv each tool hands over is checked as it is."""
    panos = tmp_path / "360imgs"          # the tool's default cut input
    panos.mkdir()
    im.write_image(panos / "pano_0001.png", lonlat_pano(256, 128))
    im.write_image(panos / "pano_0002.png", lonlat_pano(256, 128, shift=0.7))
    handed = {}

    def narrowed(name, real_main):
        def main(argv):
            handed[name] = list(argv)
            return real_main(list(argv) + ["--size", "64", "--ext", "png"])
        return main

    monkeypatch.setattr(jax_perspcut, "main",
                        narrowed("jax", jax_perspcut.main))
    monkeypatch.setattr(torch_perspcut, "main",
                        narrowed("torch", torch_perspcut.main))
    ref_cut, got_cut = tmp_path / "cut_jax", tmp_path / "cut_torch"
    common = [str(xml_file), "--preset", preset, "--persp-cut"]
    assert jms.main(common + ["-o", str(tmp_path / "jax"), "--cut-out",
                              str(ref_cut)]) == 0
    ref_out = capsys.readouterr().out
    warp_cuda.reset_counters()
    assert tms.main(common + ["-o", str(tmp_path / "torch"), "--cut-out",
                              str(got_cut), "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    cut_preset = "default" if preset == "cube105" else preset
    assert handed["jax"] == ["-i", str(panos), "--preset", cut_preset, "-o",
                             str(ref_cut)]
    assert handed["torch"] == ["-i", str(panos), "--preset", cut_preset,
                               "-o", str(got_cut), "--device", "cpu"]
    assert warp_cuda.PLAIN_CALLS["warp"] >= 2
    assert warp_cuda.LAUNCHES == {"planarize": 0, "warp": 0}
    assert "[INFO] running perspective cut:" in got_out
    assert "failed=0" in got_out and "failed=0" in ref_out
    _assert_same_outputs(ref_cut, got_cut, share=share)
    n_views = len(jms.build_views(cut_preset))
    assert len(list(got_cut.iterdir())) == 2 * n_views
    assert (tmp_path / "torch" / "perspective_cams.xml").read_bytes() == \
        (tmp_path / "jax" / "perspective_cams.xml").read_bytes()


def test_persp_cut_on_cuda_without_a_card_raises(xml_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    panos = tmp_path / "360imgs"
    panos.mkdir()
    im.write_image(panos / "pano_0001.png", lonlat_pano(64, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tms.main([str(xml_file), "--persp-cut", "-o", str(tmp_path / "o"),
                  "--cut-out", str(tmp_path / "cut")])
    assert not (tmp_path / "cut").exists()
