"""The port's voxel path (:mod:`gs360x_torch.kernels.voxel`, torch ops on
the CPU) and PlyOptimizer CLI (:mod:`gs360x_torch.tools.plyopt`, ``--device
cpu``) against the JAX package's on the CPU.

Clouds of a few thousand points, made from a seed: uniform, thin (one axis
1e-7 wide: the target search's first voxel is tiny, and its keys pass
2**21, where the sort takes three stable passes), on a grid (every voxel
full of ties) and clustered. The voxel keys, the stable lexicographic
order, the occupied-voxel count, the segment picks of every representative
and the downsamples, target searches (with their log lines), spatial hash,
adaptive octree and sky dome equal the JAX module's exactly: the port's
centroid score is the f32 ``fma(d2, d2, fma(d1, d1, d0 * d0))`` that XLA
computes on the CPU, and its
segment sums add in the sorted order as XLA's scatter-add does. The
fixtures of ``tests/test_voxel_plyopt.py`` through both CLIs give the same
stdout and byte-equal PLY and COLMAP files.
"""

import io
import pathlib
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs360x.io import ply as jply
from gs360x.io.formats import colmap_text as jcolmap
from gs360x.io.formats.model import ColmapModel, Image, Point3
from gs360x.kernels import voxel as jv
from gs360x.tools import plyopt as jpo
from gs360x_torch.kernels import voxel as tv
from gs360x_torch.tools import plyopt as tpo

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPS = ("centroid", "center", "first", "random")


def make_cloud(kind: str, n: int = 3000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return (rng.random((n, 3)) * 10).astype(np.float32)
    if kind == "thin":
        xyz = rng.random((n, 3)).astype(np.float32)
        xyz[:, 0] *= 1e3
        xyz[:, 2] *= 1e-7
        return xyz
    if kind == "grid":
        return np.floor(rng.random((n, 3)) * 4).astype(np.float32) * 0.5
    return (rng.normal(size=(n, 3)) * np.array([5.0, 1.0, 0.01])
            ).astype(np.float32)


CLOUDS = ["uniform", "thin", "grid", "clustered"]
VOXELS = [0.05, 0.3, 1.0, 1e-6]


@pytest.mark.parametrize("kind", CLOUDS)
def test_keys_order_and_count_equal_jax(kind):
    xyz = make_cloud(kind)
    lo = xyz.min(0)
    packed = []
    for v in VOXELS:
        ref = np.asarray(jv.grid_keys(jnp.asarray(xyz), v, jnp.asarray(lo)))
        keys = tv.grid_keys(torch.from_numpy(xyz), v, torch.from_numpy(lo))
        np.testing.assert_array_equal(keys.numpy(), ref)
        np.testing.assert_array_equal(
            tv._lexsort_order(keys).numpy(),
            np.asarray(jv._lexsort_order(jnp.asarray(ref))))
        packed.append(int(ref.max()) < 1 << tv.PACK_BITS)
        assert tv.unique_voxel_count(xyz, v, device=CPU) == \
            jv.unique_voxel_count(xyz, v)
        assert tv.unique_voxel_count(torch.from_numpy(xyz), v,
                                     torch.from_numpy(lo)) == \
            jv.unique_voxel_count(xyz, v, lo)
    # at 1e-6 the keys pass 2**21 (three stable passes) except on the grid
    assert packed == [True, True, True, kind == "grid"]


@pytest.mark.parametrize("kind", CLOUDS)
@pytest.mark.parametrize("rep", ["first", "random", "centroid"])
def test_segment_picks_equal_jax(kind, rep):
    xyz = make_cloud(kind)
    rand = np.random.default_rng(0).random(len(xyz)).astype(np.float32)
    for v in VOXELS:
        keys = np.array(jv.grid_keys(jnp.asarray(xyz), v,
                                     jnp.asarray(xyz.min(0))))
        pick, valid = jv._voxel_reduce_impl(
            jnp.asarray(xyz), jnp.asarray(keys), jnp.asarray(rand),
            representative=rep)
        ref = np.asarray(pick)[np.asarray(valid)]
        assert np.asarray(valid)[:len(ref)].all()
        got = tv._voxel_reduce_impl(torch.from_numpy(xyz),
                                    torch.from_numpy(keys),
                                    torch.from_numpy(rand),
                                    representative=rep)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", ["equal", "near tie", "far"])
def test_centroid_pick_differences(case):
    """The count the card checks use: voxel (0, 0, 0) holds two points
    equidistant from its centroid, voxel (1, 0, 0) a point on its centroid
    and two 0.05 away. Picking the other of the two is a near-tie; picking
    a point 0.05 away instead of the one on the centroid is not."""
    from gs360x_torch import checks

    xyz = np.array([[0.2, 0.5, 0.5], [0.8, 0.5, 0.5], [1.5, 0.5, 0.5],
                    [1.45, 0.5, 0.5], [1.55, 0.5, 0.5]], np.float32)
    keys = np.floor(xyz).astype(np.int32)
    ref = np.array([0, 2])
    got = {"equal": [0, 2], "near tie": [1, 2], "far": [0, 3]}[case]
    want = {"equal": (0, 0), "near tie": (1, 0), "far": (1, 1)}[case]
    assert checks.centroid_pick_differences(xyz, keys, np.array(got),
                                            ref) == want


@pytest.mark.parametrize("rep", REPS)
def test_downsample_by_size_equals_jax(rep):
    for kind in CLOUDS:
        xyz = make_cloud(kind, seed=1)
        rgb = np.random.default_rng(2).integers(0, 256, xyz.shape,
                                                dtype=np.uint8)
        for v in VOXELS[:3]:
            ref = jv.voxel_downsample_by_size(xyz, rgb, v,
                                              representative=rep, seed=3)
            got = tv.voxel_downsample_by_size(xyz, rgb, v,
                                              representative=rep, seed=3,
                                              device=CPU)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _logged(fn, *args, **kw):
    lines = []
    out = fn(*args, log=lines.append, **kw)
    return out, lines


@pytest.mark.parametrize("kind", CLOUDS)
def test_searches_equal_jax(kind):
    xyz = make_cloud(kind, n=4000)
    rgb = np.zeros_like(xyz, dtype=np.uint8)
    for target in (150, 800):
        ref = _logged(jv.voxel_downsample_to_target, xyz, rgb, target)
        got = _logged(tv.voxel_downsample_to_target, xyz, rgb, target,
                      device=CPU)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0][2], ref[0][2])
        ref = _logged(jv.spatial_hash_downsample, xyz, rgb,
                      target_points=target, representative="first")
        got = _logged(tv.spatial_hash_downsample, xyz, rgb,
                      target_points=target, representative="first",
                      device=CPU)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0][2], ref[0][2])
    for rep in REPS:
        np.testing.assert_array_equal(
            tv.adaptive_voxel_downsample(xyz, rgb, 300, representative=rep,
                                         weight_power=0.5)[2],
            jv.adaptive_voxel_downsample(xyz, rgb, 300, representative=rep,
                                         weight_power=0.5)[2])


def test_sky_dome_equals_jax():
    for axis in sorted(tv.SKY_AXES):
        for pct in (30.0, 50.0, 100.0):
            got = tv.generate_sky_points([1, 2, 3], tv.SKY_AXES[axis], 7.0,
                                         333, [1, 2, 3], sky_percent=pct)
            ref = jv.generate_sky_points([1, 2, 3], jv.SKY_AXES[axis], 7.0,
                                         333, [1, 2, 3], sky_percent=pct)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)


# --- the CLI -----------------------------------------------------------------

def cloud(n=2000, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    xyz = (rng.random((n, 3)) * spread).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return xyz, rgb


def _colmap_model(root: pathlib.Path) -> pathlib.Path:
    model = ColmapModel()
    cid = model.add_camera("PINHOLE", 100, 100, [50, 50, 50, 50])
    model.images.append(Image(1, 1, 0, 0, 0, 0, 0, 0, cid, "a.jpg",
                              points2d_line="1.0 2.0 1 3.0 4.0 2 5.0 6.0 -1"))
    rng = np.random.default_rng(0)
    for j in range(1, 41):
        x, y, z = rng.random(3) * 10
        model.points.append(Point3(j, x, y, z, 10, 20, 30))
    jcolmap.write_model(root / "cm", model)
    return root / "cm"


def _inputs(root: pathlib.Path) -> dict:
    files = {}
    for name, n, seed in (("c100", 100, 0), ("c3000", 3000, 0),
                          ("c4000", 4000, 0), ("c500", 500, 0),
                          ("extra", 50, 9), ("c10", 10, 0)):
        files[name] = root / f"{name}.ply"
        jply.save_ply_xyz_rgb(files[name], *cloud(n, seed))
    files["cm"] = _colmap_model(root)
    return files


# (name, input, output suffix, flags): the fixtures of
# tests/test_voxel_plyopt.py, then every method and representative
CASES = {
    "stats only": ("c100", None, []),
    "voxel size": ("c3000", ".ply", ["-v", "2.0"]),
    "target percent": ("c4000", ".ply", ["-r", "10"]),
    "sky and append": ("c500", ".ply", ["--append-ply", "extra.ply",
                                        "--sky-axis", "+Z", "--sky-count",
                                        "100", "--sky-color", "255,0,0"]),
    "colmap round trip": ("cm", "", ["-v", "5.0"]),
    "target first": ("c4000", ".ply", ["-t", "700", "-k", "first"]),
    "voxel center": ("c3000", ".ply", ["-v", "0.7", "-k", "center"]),
    "voxel random": ("c3000", ".ply", ["-v", "0.7", "-k", "random"]),
    "spatial hash": ("c4000", ".ply", ["--downsample-method",
                                       "spatial-hash", "-t", "600"]),
    "adaptive": ("c4000", ".ply", ["--adaptive", "-t", "300"]),
    "adaptive without target": ("c500", ".ply", ["--adaptive"]),
}


def _run(module, args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = module.main(args)
    return rc, buf.getvalue()


def _files(root: pathlib.Path) -> dict:
    if root.is_file():
        return {"": root.read_bytes()}
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(case, tmp_path):
    files = _inputs(tmp_path)
    name, suffix, flags = CASES[case]
    outs = {}
    for tag, module, extra in (("jax", jpo, []),
                               ("torch", tpo, ["--device", "cpu"])):
        args = ["-i", str(files[name])] + flags + extra
        out = None
        if suffix is not None:
            out = tmp_path / f"out_{tag}{suffix}"
            args += ["-o", str(out)]
        rc, text = _run(module, args)
        assert rc == 0, text
        outs[tag] = (text.replace(str(out), "OUT") if out else text,
                     _files(out) if out else {})
    assert outs["torch"] == outs["jax"]
    if suffix is not None:
        assert outs["jax"][1]


def test_error_exits_match_jax(tmp_path, capsys):
    files = _inputs(tmp_path)
    for args in (["-i", str(tmp_path / "none.ply")],
                 ["-i", str(files["c10"]), "-o", str(tmp_path / "o.ply"),
                  "--sky-axis", "+Z", "--sky-color", "banana"],
                 ["-i", str(files["c10"]), "-o", str(tmp_path / "o.ply"),
                  "--sky-axis", "+Z", "--sky-color", "#12"]):
        assert jpo.main(args) == 1
        ref = capsys.readouterr()
        assert tpo.main(args + ["--device", "cpu"]) == 1
        assert capsys.readouterr() == ref


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    files = _inputs(tmp_path)
    with pytest.raises(RuntimeError, match="--device cuda"):
        tpo.main(["-i", str(files["c10"])])
