"""The port's scene loader and CLI (:mod:`gs360x_torch.io.scene`,
:mod:`gs360x_torch.tools.scene`) against the JAX package's.

Both are host numpy, so the port's files are the JAX package's copied:
byte-equal once their imports name the same package (the loader's
docstring names the reference by its path in the reference tree, the
CLI's docstring says which package it belongs to). On the fixtures of
``tests/test_scene.py`` — a 4-camera COLMAP model with 30 points exported
to every format — both loaders give the same cameras, points and
normalization log, and both CLIs the same summary, the same exit codes
and byte-equal PLY exports.
"""

import io
import pathlib
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

from gs360x.core import pose as posemath
from gs360x.io import scene as jscene
from gs360x.io.formats import colmap_text
from gs360x.io.formats.hub import ExportOptions, export_model
from gs360x.io.formats.model import ColmapModel, Image, Point3
from gs360x.tools import scene as jcli
from gs360x_torch.io import scene as tscene
from gs360x_torch.tools import scene as tcli

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _body(path: pathlib.Path) -> str:
    """The source after its docstring, imports named as in the JAX
    package."""
    text = path.read_text().replace("gs360x_torch", "gs360x")
    return text[text.index('"""', 3) + 3:]


@pytest.mark.parametrize("module", ["io/scene.py", "tools/scene.py"])
def test_copies_are_byte_equal_apart_from_their_imports(module):
    port = ROOT / "gs360x_torch" / module
    ref = ROOT / "gs360x" / module
    assert _body(port) == _body(ref)
    if module == "io/scene.py":
        doc = port.read_text().split('"""')[1]
        # the port names the reference file by its path in that tree
        assert doc == re.sub(r"``/[\w/]+/cli_tools/", "``cli_tools/",
                             ref.read_text().split('"""')[1])


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    rng = np.random.default_rng(0)
    model = ColmapModel()
    cid = model.add_camera("PINHOLE", 1600, 1600,
                           [533.333, 533.333, 800, 800])
    for i in range(1, 5):
        r = posemath.axis_angle_mat3(rng.normal(size=3), rng.uniform(-80, 80))
        c = rng.normal(size=3) * 2
        model.images.append(Image.from_pose(i, r, r @ (-c), cid,
                                            f"img_{i:03d}_A.jpg"))
    for j in range(30):
        model.points.append(Point3(j + 1, *rng.normal(size=3), 100, 150, 200))
    d = tmp_path_factory.mktemp("scene_exports")
    colmap_text.write_model(d / "colmap", model)
    export_model(model, ExportOptions(
        out_dir=d, export_csv=True, export_transforms=True,
        export_transforms_ply=True, export_xmp=True,
        export_metashape_xml=True, export_ply=True))
    return d


SOURCES = {
    "colmap": ("colmap", None),
    "transforms": ("transforms.json", "pointcloud_for_transforms.ply"),
    "transforms without ply": ("transforms.json", None),
    "realityscan csv": ("Align_RS_PerspCams.csv", "Align_RS_PerspCams.ply"),
    "realityscan xmp": ("cameras_RealityScan", None),
    "metashape xml": ("perspective_cams.xml", None),
}


@pytest.mark.parametrize("source", list(SOURCES))
def test_loader_and_cli_match_jax(source, exported, tmp_path):
    path, ply = SOURCES[source]
    kw = {"ply_path": exported / ply} if ply else {}
    got = tscene.load_scene(exported / path, **kw)
    ref = jscene.load_scene(exported / path, **kw)
    assert (got.source_kind, got.info_text, got.normalization_log) == \
        (ref.source_kind, ref.info_text, ref.normalization_log)
    np.testing.assert_array_equal(got.points_xyz, ref.points_xyz)
    np.testing.assert_array_equal(got.points_rgb, ref.points_rgb)
    assert len(got.cameras) == len(ref.cameras) == 4
    for a, b in zip(got.cameras, ref.cameras):
        assert a.name == b.name
        np.testing.assert_array_equal(a.center, b.center)
        np.testing.assert_array_equal(a.rotation_cw, b.rotation_cw)
        assert (a.frustum_half_w, a.frustum_half_h) == \
            (b.frustum_half_w, b.frustum_half_h)
    np.testing.assert_array_equal(
        tscene.frustum_segments(got.cameras[0], scale=0.5),
        jscene.frustum_segments(ref.cameras[0], scale=0.5))

    outs = {}
    for tag, cli in (("jax", jcli), ("torch", tcli)):
        out = tmp_path / f"{tag}.ply"
        args = [str(exported / path), "--export-ply", str(out),
                "--camera-marker-color", "1,2,3"]
        if ply:
            args += ["--ply", str(exported / ply)]
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(args) == 0
        outs[tag] = (buf.getvalue().replace(str(out), "OUT"),
                     out.read_bytes())
    assert outs["torch"] == outs["jax"]


def test_error_exits_match_jax(tmp_path, capsys):
    for source in (tmp_path / "none", tmp_path / "nope.xyz"):
        assert jcli.main([str(source)]) == 1
        ref = capsys.readouterr()
        assert tcli.main([str(source)]) == 1
        assert capsys.readouterr() == ref
        assert ref.err.startswith("[ERR] ")
