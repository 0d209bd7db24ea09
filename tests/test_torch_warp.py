"""The port's warp twin and CUDA-path wrapper (plain version on CPU
tensors) against the JAX package: the XLA twin, the Pallas yaw-ring path
in interpret mode, the independent v360 oracle, and the kernels' view
table. Sizes follow ``tests/test_warp_pallas.py`` (512x256 source,
256x128 views). The CUDA kernel itself is held to the plain version on the
card by ``chip_smoke.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs360x.kernels import v360_oracle as vo
from gs360x.kernels import warp as jax_warp
from gs360x.kernels import warp_pallas
from gs360x_torch.kernels import warp as twin
from gs360x_torch.kernels import warp_cuda

torch.set_num_threads(1)

KW = dict(width=256, height=128, hfov_deg=100.0, vfov_deg=60.0)
RING = np.array([0.0, 90.0, 180.0, 270.0])     # includes the 180° seam


def lonlat_pano(w=512, h=256):
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    return np.stack([
        0.5 + 0.5 * np.sin(lon),
        0.5 + 0.5 * np.sin(lat),
        0.5 + 0.5 * np.cos(3 * lon),
    ], -1).astype(np.float32)


SRC = lonlat_pano()
SRC_U8 = np.clip(np.rint(SRC * 255.0), 0, 255).astype(np.uint8)


# --- the twin against the JAX XLA twin ---------------------------------------

@pytest.mark.parametrize("interp", ["bicubic", "bilinear", "nearest"])
def test_twin_matches_jax_xla_twin(interp):
    # the yaw ring with the seam, one pitched and one pitched+rolled view
    yaws = np.array([0.0, 90.0, 180.0, 270.0, 45.0, 10.0], np.float32)
    pitches = np.array([0.0, 0.0, 0.0, 0.0, 10.0, -20.0], np.float32)
    rolls = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 15.0], np.float32)
    ref = np.asarray(jax_warp.warp_equirect_to_views(
        SRC, yaws, pitches, rolls, interp=interp, backend="xla", **KW))
    got = twin.warp_equirect_to_views(
        torch.from_numpy(SRC), yaws, pitches, rolls, interp=interp,
        **KW).numpy()
    assert got.shape == ref.shape == (6, 128, 256, 3)
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_twin_fisheye_output_matches_jax_xla_twin():
    args = (np.array([0.0, 180.0], np.float32), np.zeros(2, np.float32),
            np.zeros(2, np.float32))
    kw = dict(width=96, height=96, hfov_deg=150.0, vfov_deg=150.0,
              projection="fisheye_v360", interp="bilinear")
    ref = np.asarray(jax_warp.warp_equirect_to_views(SRC, *args,
                                                     backend="xla", **kw))
    got = twin.warp_equirect_to_views(torch.from_numpy(SRC), *args,
                                      **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_view_rotation_matches_jax():
    angles = [(0.0, 0.0, 0.0), (37.0, 12.5, -8.0), (180.0, -60.0, 90.0)]
    for yaw, pitch, roll in angles:
        ref = np.asarray(jax_warp.view_rotation(
            jnp.float32(yaw), jnp.float32(pitch), jnp.float32(roll)))
        got = twin.view_rotation(torch.tensor(yaw), torch.tensor(pitch),
                                 torch.tensor(roll)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_interpolation_weights_match_jax():
    t = np.linspace(0.0, 0.999, 37, dtype=np.float32)
    for jfn, tfn in ((jax_warp.lagrange_cubic_weights,
                      twin.lagrange_cubic_weights),
                     (jax_warp.catmull_rom_weights,
                      twin.catmull_rom_weights)):
        ref = np.stack([np.asarray(w) for w in jfn(jnp.asarray(t))])
        got = np.stack([w.numpy() for w in tfn(torch.from_numpy(t))])
        np.testing.assert_allclose(got, ref, atol=1e-7)


# --- the CUDA-path wrapper (plain version on CPU) against Pallas -------------

@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
@pytest.mark.parametrize("src_dtype", ["u8", "f32"])
def test_wrapper_matches_pallas_yaw_ring(interp, src_dtype):
    src = SRC_U8 if src_dtype == "u8" else SRC
    zeros = np.zeros(4)
    ref = np.asarray(warp_pallas.warp_equirect_to_views_pallas(
        src, RING, zeros, zeros, interp=interp, interpret=True,
        planar=True, **KW))
    rows = torch.from_numpy(np.ascontiguousarray(src).reshape(256, 512 * 3))
    warp_cuda.reset_counters()
    got = warp_cuda.warp_equirect_to_views_cuda(
        rows, RING, zeros, zeros, interp=interp, planar=True, **KW).numpy()
    assert warp_cuda.PLAIN_CALLS["warp"] == 1
    assert warp_cuda.LAUNCHES["warp"] == 0
    assert got.shape == ref.shape == (4, 3, 128, 256)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_wrapper_hwc_layout_and_nearest_maps_to_bilinear():
    rows = torch.from_numpy(SRC_U8.reshape(256, 512 * 3))
    zeros = np.zeros(2)
    near = warp_cuda.warp_equirect_to_views_cuda(
        rows, RING[:2], zeros, zeros, interp="nearest", **KW)
    bil = warp_cuda.warp_equirect_to_views_cuda(
        rows, RING[:2], zeros, zeros, interp="bilinear", planar=True, **KW)
    assert near.shape == (2, 128, 256, 3)
    assert torch.equal(near, bil.permute(0, 2, 3, 1))


def test_kernel_gate():
    assert warp_cuda.kernel_supports("perspective", [0.0, 0.0], [360.0, 0.0])
    assert not warp_cuda.kernel_supports("perspective", [0.0, 10.0],
                                         [0.0, 0.0])
    assert not warp_cuda.kernel_supports("perspective", [0.0], [5.0])
    assert not warp_cuda.kernel_supports("fisheye_v360", [0.0], [0.0])


# --- the view table against the one the Pallas entry builds ------------------

def test_view_table_equals_pallas(monkeypatch):
    seen = []
    real = warp_pallas._warp_call_yaw2

    def spy(src_rows, view_f32, *args, **kwargs):
        seen.append(np.asarray(view_f32))
        return real(src_rows, view_f32, *args, **kwargs)

    monkeypatch.setattr(warp_pallas, "_warp_call_yaw2", spy)
    yaws = np.array([10.0, 100.0, 180.0, 250.0])
    zeros = np.zeros(4)
    warp_pallas.warp_equirect_to_views_pallas(
        SRC, yaws, zeros, zeros, interp="bilinear", interpret=True, **KW)
    assert len(seen) == 1
    got = warp_cuda.view_table(yaws, zeros, zeros, KW["hfov_deg"],
                               KW["vfov_deg"])
    assert np.array_equal(got, seen[0][:len(yaws)])


@pytest.mark.parametrize("yaw,pitch,roll", [(45.0, 10.0, 0.0),
                                            (10.0, -20.0, 15.0)])
def test_view_table_rotation_of_tilted_views_equals_pallas(yaw, pitch, roll):
    # the Pallas entry fills rot[0:9] from its planner's budget
    budget = warp_pallas.plan_view(256, 128, 100.0, 60.0, yaw, pitch, roll,
                                   512, 256, true_w=256, true_h=128)
    assert budget is not None
    got = warp_cuda.view_table([yaw], [pitch], [roll], 100.0, 60.0)
    assert np.array_equal(got[0, 0:9], budget.rot.reshape(-1))


# --- the twin against the independent v360 oracle ---------------------------

ORACLE_OUT = 128
ORACLE_CASES = [
    # (hfov, yaw) of the yaw and seam cases of tests/test_v360_oracle.py
    (104.25, 37.0),
    (104.25, 180.0),     # seam crossing
]


@pytest.fixture(scope="module")
def oracle_pano():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:256, 0:512]
    img = np.stack([
        (xx * 255.0 / 512 + 15.0 * np.sin(yy * 0.13)) % 256.0,
        (yy * 255.0 / 256 + 15.0 * np.sin(xx * 0.09)) % 256.0,
        ((xx // 8 + yy // 8) % 2) * 140.0 + 50.0,
    ], axis=-1)
    img += rng.normal(0.0, 10.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
@pytest.mark.parametrize("hfov,yaw", ORACLE_CASES)
def test_twin_meets_oracle_gate(oracle_pano, hfov, yaw, interp):
    oracle, valid = vo.warp_equirect_oracle(
        oracle_pano, yaw, 0.0, 0.0, width=ORACLE_OUT, height=ORACLE_OUT,
        hfov_deg=hfov, vfov_deg=hfov, interp=interp)
    out = twin.warp_equirect_to_views(
        torch.from_numpy(oracle_pano.astype(np.float32) / 255.0),
        [yaw], [0.0], [0.0], width=ORACLE_OUT, height=ORACLE_OUT,
        hfov_deg=hfov, vfov_deg=hfov, interp=interp)
    got = np.clip(np.rint(out[0].numpy() * 255.0), 0, 255).astype(np.uint8)
    # the gate of tests/test_v360_oracle.py::_assert_parity: float taps
    # against v360's Q14 fixed-point taps
    diff = np.abs(got.astype(np.int32) - oracle.astype(np.int32))[valid]
    assert int(diff.max()) <= 2, f"max diff {diff.max()} u8 LSB vs oracle"
    assert float((diff > 1).mean()) <= 0.01
