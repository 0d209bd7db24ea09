"""The port's warp twin and CUDA-path wrapper (plain version on CPU
tensors) against the JAX package: the XLA twin (yaw ring, and the tilted,
pole and fisheye geometry of ``tests/test_warp_pallas.py``), the Pallas
yaw-ring path in interpret mode, the independent v360 oracle on every
parity case, the kernels' view table (perspective and fisheye), the
quantizing store (``out_dtype``) against the plain quantize and the JAX
executor's, and the kernel's column-wrap rule against ``%``. Sizes
follow ``tests/test_warp_pallas.py`` (512x256 source, 256x128 views). The
CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs360x.kernels import v360_oracle as vo
from gs360x.kernels import warp as jax_warp
from gs360x.kernels import warp_pallas
from gs360x.runtime import executor as jax_executor
from gs360x_torch.kernels import warp as twin
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.runtime import executor as torch_executor

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


@pytest.mark.parametrize("projection,interp", [("cylindrical", "bicubic"),
                                               ("perspective", "lanczos")])
def test_unsupported_projection_or_interp_raises(projection, interp):
    # the JAX entry's PallasFallback cases: no view is refused otherwise
    rows = torch.from_numpy(SRC_U8.reshape(256, 512 * 3))
    warp_cuda.reset_counters()
    with pytest.raises(ValueError, match=projection if interp == "bicubic"
                       else interp):
        warp_cuda.warp_equirect_to_views_cuda(
            rows, [0.0], [10.0], [0.0], projection=projection,
            interp=interp, **KW)
    assert warp_cuda.PLAIN_CALLS == {"planarize": 0, "warp": 0}


# --- tilted, pole and fisheye views against the JAX XLA twin -----------------

def _lonlat(w, h):
    return lonlat_pano(w, h) if (w, h) != (512, 256) else SRC


FKW = dict(width=128, height=128, hfov_deg=180.0, vfov_deg=180.0)
# (id, source (w, h), view kwargs, yaws, pitches, rolls, projection, interp,
#  pole): the geometry of the tests/test_warp_pallas.py cases at the lines
#  named; `pole` marks views whose image holds a pole, where u is
#  ill-conditioned (ROADMAP C) and the oracle's LSB gate applies
GEOMETRY = [
    ("seam_straddle_45", (512, 256), KW, [180.0], [0.0], [0.0],
     "perspective", "bicubic", False),
    ("pole_up_167", (512, 256), KW, [0.0], [90.0], [0.0],
     "perspective", "bilinear", True),
    ("pole_down_167", (512, 256), KW, [0.0], [-90.0], [0.0],
     "perspective", "bicubic", True),
    ("near_pole_up_167", (512, 256), KW, [0.0], [75.0], [0.0],
     "perspective", "bicubic", True),
    ("near_pole_down_167", (512, 256), KW, [0.0], [-75.0], [0.0],
     "perspective", "bilinear", True),
    ("pole_with_seam_174", (512, 256), KW, [180.0], [88.0], [30.0],
     "perspective", "bicubic", True),
    ("extreme_slope_181", (512, 256),
     dict(width=256, height=128, hfov_deg=150.0, vfov_deg=70.0),
     [45.0], [0.0], [0.0], "perspective", "bicubic", False),
    ("fisheye_front_back_261", (512, 256), FKW, [0.0, 180.0], [0.0, 0.0],
     [0.0, 0.0], "fisheye_v360", "bilinear", True),
    ("equisolid_front_back_261", (512, 256), FKW, [0.0, 180.0], [0.0, 0.0],
     [0.0, 0.0], "equisolid", "bicubic", True),
    ("grazing_pole_362", (512, 256),
     dict(width=256, height=32, hfov_deg=60.0, vfov_deg=22.0),
     [20.0], [-82.0], [0.0], "perspective", "bicubic", True),
    ("wide_fov_tilt_401", (2048, 1024),
     dict(width=256, height=128, hfov_deg=112.6, vfov_deg=100.0),
     [0.0], [30.0], [0.0], "perspective", "bicubic", False),
    ("deep_shear_510", (1024, 512),
     dict(width=384, height=64, hfov_deg=110.0, vfov_deg=30.0),
     [20.0], [60.0], [0.0], "perspective", "bicubic", False),
    ("fisheye_overflow_619", (768, 384),
     dict(width=128, height=128, hfov_deg=190.0, vfov_deg=190.0),
     [0.0], [0.0], [0.0], "fisheye_v360", "bilinear", True),
]


def _assert_lsb_gate(got, ref):
    """The oracle's gate (tests/test_v360_oracle.py::_assert_parity):
    <= 2 u8 LSB, and <= 1% of samples more than 1 LSB apart."""
    def q(x):
        return np.clip(np.rint(np.asarray(x) * 255.0), 0, 255).astype(
            np.int32)
    diff = np.abs(q(got) - q(ref))
    assert int(diff.max()) <= 2, f"max diff {diff.max()} u8 LSB"
    assert float((diff > 1).mean()) <= 0.01


@pytest.mark.parametrize("path", ["twin", "wrapper"])
@pytest.mark.parametrize(
    "src_wh,kw,yaws,pitches,rolls,projection,interp,pole",
    [pytest.param(*case[1:], id=case[0]) for case in GEOMETRY])
def test_tilted_pole_fisheye_views_match_jax_xla_twin(
        path, src_wh, kw, yaws, pitches, rolls, projection, interp, pole):
    src = _lonlat(*src_wh)
    angles = [np.asarray(a, np.float32) for a in (yaws, pitches, rolls)]
    if path == "twin":
        ref = np.asarray(jax_warp.warp_equirect_to_views(
            src, *angles, projection=projection, interp=interp,
            backend="xla", **kw))
        got = twin.warp_equirect_to_views(
            torch.from_numpy(src), *angles, projection=projection,
            interp=interp, **kw).numpy()
    else:
        # the CUDA-path wrapper on a CPU u8 frame: the plain version
        src_u8 = np.clip(np.rint(src * 255.0), 0, 255).astype(np.uint8)
        ref = np.asarray(jax_warp.warp_equirect_to_views(
            src_u8.astype(np.float32) / 255.0, *angles,
            projection=projection, interp=interp, backend="xla", **kw))
        h, w = src_u8.shape[:2]
        warp_cuda.reset_counters()
        got = warp_cuda.warp_equirect_to_views_cuda(
            torch.from_numpy(src_u8.reshape(h, w * 3)), yaws, pitches,
            rolls, projection=projection, interp=interp, **kw).numpy()
        assert warp_cuda.PLAIN_CALLS["warp"] == 1
        assert warp_cuda.LAUNCHES["warp"] == 0
    assert got.shape == ref.shape == (len(yaws), kw["height"], kw["width"], 3)
    if projection != "perspective":
        # the image circle: bitwise the same mask, 0 outside it
        outside = np.all(ref == 0.0, axis=-1)
        assert np.array_equal(np.all(got == 0.0, axis=-1), outside)
        assert outside[:, 0, 0].all()
    if pole:
        _assert_lsb_gate(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=5e-5)


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


class _Captured(Exception):
    pass


@pytest.mark.parametrize("projection", ["fisheye_v360", "equisolid"])
def test_fisheye_view_table_equals_pallas(monkeypatch, projection):
    # fisheye outputs go to the wide kernels; capture their view table and
    # stop before the interpret-mode kernel runs
    seen = []

    def spy(src_rows, view_f32, *args, **kwargs):
        seen.append(np.asarray(view_f32))
        raise _Captured

    for name in ("_warp_call_wide3", "_warp_call_wide2", "_warp_call_wide"):
        monkeypatch.setattr(warp_pallas, name, spy)
    yaws = np.array([0.0, 180.0])
    pitches = np.array([0.0, 15.0])
    rolls = np.array([0.0, -5.0])
    with pytest.raises(_Captured):
        warp_pallas.warp_equirect_to_views_pallas(
            SRC, yaws, pitches, rolls, width=64, height=64,
            hfov_deg=190.0, vfov_deg=190.0, projection=projection,
            interp="bilinear", interpret=True)
    got = warp_cuda.view_table(yaws, pitches, rolls, 190.0, 190.0,
                               projection)
    assert np.array_equal(got, seen[0][:len(yaws)])


# --- the twin against the independent v360 oracle ---------------------------

ORACLE_OUT = 128
# every parity case of docs/V360_PARITY.md (tools/v360_parity_report.py:
# the 7 CASES of tests/test_v360_oracle.py plus tilt_m30 and pole_graze):
# (id, projection, hfov, vfov, yaw, pitch, roll)
ORACLE_CASES = [
    ("yaw_ring", "perspective", 104.25, 104.25, 37.0, 0.0, 0.0),
    ("seam_cross", "perspective", 104.25, 104.25, 180.0, 0.0, 0.0),
    ("tilt_p30", "perspective", 104.25, 104.25, 45.0, 30.0, 0.0),
    ("tilt_m30", "perspective", 104.25, 104.25, -135.0, -30.0, 0.0),
    ("deep_shear", "perspective", 110.0, 110.0, 20.0, 60.0, 0.0),
    ("pole_graze", "perspective", 112.6, 112.6, 0.0, 62.0, 0.0),
    ("roll_20", "perspective", 104.25, 104.25, 10.0, 15.0, 20.0),
    ("fisheye_d190", "fisheye_v360", 190.0, 190.0, 0.0, 0.0, 0.0),
    ("pole_up", "perspective", 104.25, 104.25, 0.0, 90.0, 0.0),
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
@pytest.mark.parametrize("projection,hfov,vfov,yaw,pitch,roll",
                         [pytest.param(*c[1:], id=c[0]) for c in ORACLE_CASES])
def test_twin_meets_oracle_gate(oracle_pano, projection, hfov, vfov, yaw,
                                pitch, roll, interp):
    oracle, valid = vo.warp_equirect_oracle(
        oracle_pano, yaw, pitch, roll, width=ORACLE_OUT, height=ORACLE_OUT,
        hfov_deg=hfov, vfov_deg=vfov, projection=projection, interp=interp)
    out = twin.warp_equirect_to_views(
        torch.from_numpy(oracle_pano.astype(np.float32) / 255.0),
        [yaw], [pitch], [roll], width=ORACLE_OUT, height=ORACLE_OUT,
        hfov_deg=hfov, vfov_deg=vfov, projection=projection, interp=interp)
    got = np.clip(np.rint(out[0].numpy() * 255.0), 0, 255).astype(np.uint8)
    # the gate of tests/test_v360_oracle.py::_assert_parity: float taps
    # against v360's Q14 fixed-point taps
    diff = np.abs(got.astype(np.int32) - oracle.astype(np.int32))[valid]
    assert int(diff.max()) <= 2, f"max diff {diff.max()} u8 LSB vs oracle"
    assert float((diff > 1).mean()) <= 0.01


# --- the quantizing store: out_dtype = u8 / u16 ------------------------------

# (id, yaws, pitches, rolls, view kwargs, projection, pole)
STORE_VIEWS = [
    ("yaw_ring_with_seam", RING, [0.0] * 4, [0.0] * 4, KW, "perspective",
     False),
    ("pole_view", [30.0], [90.0], [0.0], KW, "perspective", True),
    ("fisheye_v360", [0.0, 180.0], [0.0, 0.0], [0.0, 0.0], FKW,
     "fisheye_v360", True),
]


@pytest.mark.parametrize("bits,out_dtype", [(8, torch.uint8),
                                            (16, torch.uint16)],
                         ids=["u8", "u16"])
@pytest.mark.parametrize("yaws,pitches,rolls,kw,projection,pole",
                         [pytest.param(*v[1:], id=v[0]) for v in STORE_VIEWS])
def test_wrapper_out_dtype_is_the_quantized_f32_result(
        yaws, pitches, rolls, kw, projection, pole, bits, out_dtype):
    rows = torch.from_numpy(SRC_U8.reshape(256, 512 * 3))
    args = (rows, yaws, pitches, rolls)
    kwargs = dict(projection=projection, interp="bicubic", planar=True, **kw)
    f32 = warp_cuda.warp_equirect_to_views_cuda(*args, **kwargs)
    got = warp_cuda.warp_equirect_to_views_cuda(*args, out_dtype=out_dtype,
                                                **kwargs)
    assert f32.dtype == torch.float32 and got.dtype == out_dtype
    # on a CPU tensor: the executor's four-pass quantize of the f32 result
    assert torch.equal(got, torch_executor._quantize_device(f32, bits))
    assert torch.equal(got, warp_cuda.quantize_plain(f32, out_dtype))
    # and the JAX path: its executor's quantize of the XLA twin's views
    ref = np.asarray(jax_executor._quantize_device(
        jax_warp.warp_equirect_to_views(
            SRC_U8.astype(np.float32) / 255.0, np.asarray(yaws, np.float32),
            np.asarray(pitches, np.float32), np.asarray(rolls, np.float32),
            projection=projection, interp="bicubic", backend="xla", **kw),
        bit_depth=bits)).transpose(0, 3, 1, 2)
    assert ref.dtype == got.numpy().dtype
    lsb = (1 if bits == 8 else 257)      # one u8 LSB in the store's units
    diff = np.abs(got.numpy().astype(np.int64) - ref.astype(np.int64))
    if pole:
        # u is ill-conditioned where a pole is in view: the oracle's gate
        assert int(diff.max()) <= 2 * lsb
        assert float((diff > lsb).mean()) <= 0.01
    elif bits == 8:
        assert int(diff.max()) <= 1
        assert float((diff > 0).mean()) <= 0.001
    else:
        # the twins' f32 gate (5e-5) in u16 steps, plus one for the rounding
        assert int(diff.max()) <= 4


def test_wrapper_rejects_unknown_out_dtype():
    rows = torch.from_numpy(SRC_U8.reshape(256, 512 * 3))
    with pytest.raises(ValueError, match="out_dtype"):
        warp_cuda.warp_equirect_to_views_cuda(
            rows, [0.0], [0.0], [0.0], out_dtype=torch.int16, **KW)
    with pytest.raises(ValueError, match="out_dtype"):
        warp_cuda.quantize_plain(torch.zeros(3), torch.int32)
    assert warp_cuda.quantize_plain(torch.tensor([0.5, -1.0, 2.0, 0.5 / 255]),
                                    torch.uint8).tolist() == [128, 0, 255, 0]


@pytest.mark.parametrize("w", [7680, 37, 4])
def test_kernel_column_wrap_rule_equals_modulo(w):
    # every tap column the kernel can form: [-2, w + 1] unshifted, up to
    # 1.5 w + 1 with the pole shift of w // 2 applied to a wrapped column
    x = np.arange(-2, w + w // 2 + 2)
    assert np.array_equal(warp_cuda.wrap_tap_column(x, w), x % w)
    cols = warp_cuda.wrap_tap_column(np.arange(-2, w + 2), w)
    assert cols.min() == 0 and cols.max() == w - 1
    shifted = warp_cuda.wrap_tap_column(cols + w // 2, w)
    assert np.array_equal(shifted, (np.arange(-2, w + 2) + w // 2) % w)
    # phi = +-pi gives u = w - 0.5 exactly: x0 = w - 1, last tap x0 + 2
    assert warp_cuda.wrap_tap_column(np.int64(w - 1 + 2 + w // 2), w) \
        == (w + 1 + w // 2) % w
