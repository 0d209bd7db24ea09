"""The port's PLY codec (:mod:`gs360x_torch.io.ply`) against
:mod:`gs360x.io.ply` on the fixtures of ``tests/test_io.py``: written files
byte-equal, decoded arrays equal, the same errors."""

import dataclasses

import numpy as np
import pytest

from gs360x.io import ply as jply
from gs360x_torch.io import ply as tply


def random_cloud(n=100, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(n, 3), dtype=np.uint8)
    return xyz, rgb


def columns(kind: str):
    """The vertex columns of each tests/test_io.py PLY fixture."""
    xyz, rgb = random_cloud(20, seed=1)
    cols = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    if kind == "rgb":
        cols.update(red=rgb[:, 0], green=rgb[:, 1], blue=rgb[:, 2])
    elif kind == "float01":
        col = np.linspace(0, 1, 60, dtype=np.float32).reshape(20, 3)
        cols.update(red=col[:, 0], green=col[:, 1], blue=col[:, 2])
    elif kind == "float255":
        col = np.linspace(-5, 300, 60, dtype=np.float32).reshape(20, 3)
        cols.update(r=col[:, 0], g=col[:, 1], b=col[:, 2])
    elif kind == "dc":
        dc = np.random.default_rng(2).normal(size=(20, 3)).astype(np.float32)
        cols.update(f_dc_0=dc[:, 0], f_dc_1=dc[:, 1], f_dc_2=dc[:, 2])
    elif kind == "mixed":
        cols.update(diffuse_red=rgb[:, 0], diffuse_green=rgb[:, 1],
                    diffuse_blue=rgb[:, 2],
                    id=np.arange(20, dtype=np.int32),
                    w=np.linspace(0, 1, 20, dtype=np.float64),
                    s=np.arange(20, dtype=np.int16),
                    u=np.arange(20, dtype=np.uint16))
    return cols


def assert_ply_files_equal(got, ref):
    assert got.comments == ref.comments
    assert len(got.elements) == len(ref.elements)
    for g, r in zip(got.elements, ref.elements):
        assert dataclasses.asdict(dataclasses.replace(g, data=None)) == \
            dataclasses.asdict(dataclasses.replace(r, data=None))
        assert (g.data is None) == (r.data is None)
        if r.data is not None:
            assert g.data.dtype == r.data.dtype
            assert g.data.tobytes() == r.data.tobytes()


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("kind", ["plain", "rgb", "float01", "float255", "dc",
                                  "mixed"])
def test_write_read_load_match_jax_package(tmp_path, kind, binary):
    cols = columns(kind)
    ref_path, got_path = tmp_path / "jax.ply", tmp_path / "torch.ply"
    kw = dict(binary=binary, comments=["made by a test", kind])
    jply.write_ply(ref_path, cols, **kw)
    tply.write_ply(got_path, cols, **kw)
    assert got_path.read_bytes() == ref_path.read_bytes()
    assert_ply_files_equal(tply.read_ply(ref_path), jply.read_ply(ref_path))
    ref_xyz, ref_rgb = jply.load_ply_xyz_rgb(ref_path)
    got_xyz, got_rgb = tply.load_ply_xyz_rgb(ref_path)
    assert got_xyz.dtype == ref_xyz.dtype == np.float32
    assert got_rgb.dtype == ref_rgb.dtype == np.uint8
    np.testing.assert_array_equal(got_xyz, ref_xyz)
    np.testing.assert_array_equal(got_rgb, ref_rgb)


def test_save_ply_xyz_rgb_matches_jax_package(tmp_path):
    xyz, rgb = random_cloud()
    jply.save_ply_xyz_rgb(tmp_path / "jax.ply", xyz, rgb)
    tply.save_ply_xyz_rgb(tmp_path / "torch.ply", xyz.astype(np.float64),
                          rgb.astype(np.int64))
    assert (tmp_path / "torch.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()
    got_xyz, got_rgb = tply.load_ply_xyz_rgb(tmp_path / "torch.ply")
    np.testing.assert_array_equal(got_xyz, xyz)
    np.testing.assert_array_equal(got_rgb, rgb)


def test_custom_element_and_big_endian_match_jax_package(tmp_path):
    """An element not called ``vertex``, and a big-endian body."""
    cols = columns("rgb")
    p = tmp_path / "pts.ply"
    tply.write_ply(p, cols, element="points")
    for a, b in zip(tply.load_ply_xyz_rgb(p), jply.load_ply_xyz_rgb(p)):
        np.testing.assert_array_equal(a, b)
    verts = np.array([(0, 0, 0), (1, 0.5, 0), (0, 1, -2)],
                     dtype=[("x", ">f4"), ("y", ">f4"), ("z", ">f4")])
    big = tmp_path / "big.ply"
    big.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement vertex 3\n"
                    b"property float x\nproperty float y\nproperty float z\n"
                    b"end_header\n" + verts.tobytes())
    assert_ply_files_equal(tply.read_ply(big), jply.read_ply(big))
    np.testing.assert_array_equal(tply.load_ply_xyz_rgb(big)[0],
                                  jply.load_ply_xyz_rgb(big)[0])


def test_list_properties_are_skipped_as_in_jax_package(tmp_path):
    p = tmp_path / "faces.ply"
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex 3\nproperty float x\nproperty float y\n"
              b"property float z\nelement face 1\n"
              b"property list uchar int vertex_indices\nend_header\n")
    verts = np.array([(0, 0, 0), (1, 0, 0), (0, 1, 0)],
                     dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
    face = bytes([3]) + np.array([0, 1, 2], "<i4").tobytes()
    p.write_bytes(header + verts.tobytes() + face)
    assert_ply_files_equal(tply.read_ply(p), jply.read_ply(p))
    got_xyz, got_rgb = tply.load_ply_xyz_rgb(p)
    ref_xyz, ref_rgb = jply.load_ply_xyz_rgb(p)
    np.testing.assert_array_equal(got_xyz, ref_xyz)
    np.testing.assert_array_equal(got_rgb, ref_rgb)
    assert tply.read_ply(p).element("face").list_properties == \
        jply.read_ply(p).element("face").list_properties
    assert tply.read_ply(p).element("edge") is None


def test_colour_helpers_match_jax_package():
    dc = np.random.default_rng(4).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(tply.dc_sh_to_rgb8(dc),
                                  jply.dc_sh_to_rgb8(dc))
    assert tply.SH_C0 == jply.SH_C0


@pytest.mark.parametrize("case", ["ragged-columns", "rows-differ",
                                  "no-vertex", "not-a-ply"])
def test_errors_match_jax_package(tmp_path, case):
    def run(mod, path):
        if case == "ragged-columns":
            mod.write_ply(path, {"x": np.zeros(3, np.float32),
                                 "y": np.zeros(2, np.float32)})
        elif case == "rows-differ":
            mod.save_ply_xyz_rgb(path, np.zeros((3, 3)), np.zeros((2, 3)))
        elif case == "no-vertex":
            mod.write_ply(path, {"a": np.zeros(3, np.float32)},
                          element="other")
            mod.load_ply_xyz_rgb(path)
        else:
            path.write_bytes(b"solid stl\n")
            mod.read_ply(path)

    with pytest.raises(ValueError) as ref:
        run(jply, tmp_path / "a.ply")
    with pytest.raises(ValueError) as got:
        run(tply, tmp_path / "a.ply")
    assert str(got.value) == str(ref.value)
