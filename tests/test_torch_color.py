"""The port's colour module (:mod:`gs360x_torch.core.color`) against the
JAX package's (:mod:`gs360x.core.color`) on the CPU: every curve, luma
and matrix move (atol 1e-6), the HWC video colour move against the planar
form (1e-6), the ``.cube`` parser on files written here (tables equal,
the same errors), and the trilinear apply, HWC and planar, at N = 2, 17
and 33 (atol 1e-6; an identity LUT returns its input)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs360x.core import color as jcolor
from gs360x_torch.core import color as tcolor

torch.set_num_threads(1)

ATOL = 1e-6


def _rgb(shape=(13, 17, 3), seed=0, lo=-0.1, hi=1.1):
    """Values past both ends of [0, 1], so every clip is exercised."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _close(got: torch.Tensor, ref, atol=ATOL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("name", [
    "rec709_to_linear", "linear_to_rec709", "srgb_to_linear",
    "linear_to_srgb", "rec709_to_srgb", "dlog_m_to_linear"])
def test_curves_match_jax(name):
    x = _rgb(seed=1)
    _close(getattr(tcolor, name)(torch.from_numpy(x)),
           getattr(jcolor, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["luma_bt601", "luma_bt709"])
def test_luma_matches_jax(name):
    x = _rgb(seed=2, lo=0.0, hi=1.0)
    _close(getattr(tcolor, name)(torch.from_numpy(x)),
           getattr(jcolor, name)(jnp.asarray(x)))


@pytest.mark.parametrize("mat", [
    "RGB_TO_YCBCR_BT709", "RGB_TO_YCBCR_BT601", "YCBCR_TO_RGB_BT709",
    "YCBCR_TO_RGB_BT601", "BT709_TO_SMPTE170M", "SMPTE170M_TO_BT709"])
def test_matrix_moves_match_jax(mat):
    assert np.array_equal(getattr(tcolor, mat), getattr(jcolor, mat))
    x = _rgb(seed=3)
    _close(tcolor.apply_rgb_matrix(torch.from_numpy(x), getattr(tcolor, mat)),
           jcolor.apply_rgb_matrix(jnp.asarray(x), getattr(jcolor, mat)))


@pytest.mark.parametrize("keep_rec709", [False, True])
def test_video_color_move_hwc_planar_and_jax(keep_rec709):
    x = _rgb(seed=4)
    hwc = tcolor.video_color_move(torch.from_numpy(x),
                                  keep_rec709=keep_rec709)
    _close(hwc, jcolor.video_color_move(jnp.asarray(x),
                                        keep_rec709=keep_rec709))
    planar = tcolor.video_color_move_planar(
        torch.from_numpy(x).permute(2, 0, 1), keep_rec709=keep_rec709)
    _close(planar.permute(1, 2, 0).contiguous(), hwc.numpy())
    _close(planar, jcolor.video_color_move_planar(
        jnp.asarray(np.moveaxis(x, -1, 0)), keep_rec709=keep_rec709))


# --- .cube files ---------------------------------------------------------


def _smooth_table(n: int, seed: int) -> np.ndarray:
    """(N, N, N, 3) indexed [r, g, b]: a smooth, non-separable colour
    function plus a little noise."""
    g = np.linspace(0.0, 1.0, n)
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")
    rng = np.random.default_rng(seed)
    out = np.stack([0.1 + 0.8 * r ** 1.3 + 0.05 * np.sin(3 * gg * b),
                    0.9 * gg * (0.8 + 0.2 * r),
                    0.5 * b + 0.3 * r * gg], -1)
    return (out + 0.01 * rng.random(out.shape)).astype(np.float32)


def write_cube(path, table: np.ndarray, *, title=True, comments=True,
               domain=None):
    """A .cube file of ``table`` (indexed [r, g, b]): red fastest."""
    n = table.shape[0]
    lines = []
    if comments:
        lines += ["# written by the test", ""]
    if title:
        lines.append('TITLE "test lut"')
    lines.append(f"LUT_3D_SIZE {n}")
    if domain is not None:
        lines.append("DOMAIN_MIN " + " ".join(f"{v:g}" for v in domain[0]))
        lines.append("DOMAIN_MAX " + " ".join(f"{v:g}" for v in domain[1]))
    for b in range(n):
        for g in range(n):
            for r in range(n):
                lines.append(" ".join(f"{v:.7f}" for v in table[r, g, b]))
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("kw", [
    dict(), dict(title=False, comments=False),
    dict(domain=((-0.1, 0.0, 0.05), (1.2, 1.0, 0.9)))])
def test_load_cube_lut_equals_jax(tmp_path, kw):
    path = write_cube(tmp_path / "a.cube", _smooth_table(5, 0), **kw)
    ref = jcolor.load_cube_lut(path)
    got = tcolor.load_cube_lut(path)
    assert got.size == ref.size == 5
    assert got.table.dtype == np.float32
    assert np.array_equal(got.table, ref.table)
    assert got.domain_min == ref.domain_min
    assert got.domain_max == ref.domain_max


@pytest.mark.parametrize("text", [
    "LUT_1D_SIZE 4\n0 0 0\n",
    "0 0 0\n1 1 1\n",
    "LUT_3D_SIZE 2\n0 0 0\n1 1 1\n"])
def test_load_cube_lut_errors_equal_jax(tmp_path, text):
    path = tmp_path / "bad.cube"
    path.write_text(text)
    with pytest.raises(ValueError) as ref:
        jcolor.load_cube_lut(path)
    with pytest.raises(ValueError) as got:
        tcolor.load_cube_lut(path)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("n", [2, 17, 33])
def test_apply_cube_lut_matches_jax(tmp_path, n):
    domain = ((-0.05, 0.0, 0.02), (1.1, 1.0, 0.97)) if n == 17 else None
    path = write_cube(tmp_path / "l.cube", _smooth_table(n, n), domain=domain)
    ref_lut, lut = jcolor.load_cube_lut(path), tcolor.load_cube_lut(path)
    x = _rgb(seed=n)
    # a few samples exactly on grid nodes and on the domain's edges
    x[0, :4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.75],
                [1.0, 0.0, 1.0]]
    ref = np.asarray(jcolor.apply_cube_lut(jnp.asarray(x), ref_lut))
    hwc = tcolor.apply_cube_lut(torch.from_numpy(x), lut)
    _close(hwc, ref)
    table = tcolor.lut_table(lut, torch.device("cpu"))
    assert table.shape == (n ** 3 * 3,) and table.dtype == torch.float32
    planar = tcolor.apply_cube_lut_planar(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 0))), lut,
        table)
    assert planar.is_contiguous()
    _close(planar, np.moveaxis(ref, -1, 0))


@pytest.mark.parametrize("n", [2, 17, 33])
def test_identity_lut_returns_its_input(tmp_path, n):
    g = np.linspace(0.0, 1.0, n, dtype=np.float32)
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")
    path = write_cube(tmp_path / "id.cube", np.stack([r, gg, b], -1))
    lut = tcolor.load_cube_lut(path)
    x = _rgb(seed=7, lo=0.0, hi=1.0)
    _close(tcolor.apply_cube_lut(torch.from_numpy(x), lut), x)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 0)))
    _close(tcolor.apply_cube_lut_planar(planes, lut), planes.numpy())


def test_planar_apply_rejects_hwc():
    lut = tcolor.CubeLUT(size=2, table=np.zeros((2, 2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="planes"):
        tcolor.apply_cube_lut_planar(torch.zeros(4, 4, 3), lut)
