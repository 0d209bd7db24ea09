"""The plain reference against itself and against closed forms on tiny
inputs, and its control: the same reference in bfloat16 must fail the
cells' limits."""

import numpy as np
import pytest
import torch

from portbench import harness, scenes
from portbench.reference import compare, cube, equirect, fisheye, resample

SEED = 2 ** 33 + 5


@pytest.mark.parametrize("kernel", ["bicubic", "catmull-rom"])
def test_cubic_weights_partition_unity(kernel):
    t = torch.linspace(0, 0.999, 17, dtype=torch.float64)
    w = resample.cubic_weights(t, kernel)
    assert torch.allclose(sum(w), torch.ones_like(t))
    at0 = resample.cubic_weights(torch.zeros(1, dtype=torch.float64), kernel)
    assert [float(x) for x in at0] == [0.0, 1.0, 0.0, 0.0]


def test_sample_at_integers_is_the_source():
    src = torch.rand(6, 9, 3, dtype=torch.float64)
    v, u = torch.meshgrid(torch.arange(6.0, dtype=torch.float64),
                          torch.arange(9.0, dtype=torch.float64),
                          indexing="ij")
    for equirect_src in (True, False):
        out = resample.sample_cubic(src, u, v, kernel="bicubic",
                                    equirect=equirect_src)
        assert torch.allclose(out, src)


def test_equirect_wrap_and_pole():
    """A tap past the right edge wraps to column 0; a row past the top
    reflects onto the opposite meridian."""
    src = torch.arange(4 * 8, dtype=torch.float64).reshape(4, 8, 1)
    u, v = torch.tensor([8.0]), torch.tensor([0.0])
    out = resample.sample_cubic(src, u, v, kernel="bicubic", equirect=True)
    assert float(out) == float(src[0, 0, 0])
    u, v = torch.tensor([1.0]), torch.tensor([-1.0])
    out = resample.sample_cubic(src, u, v, kernel="bicubic", equirect=True)
    assert float(out) == float(src[0, 5, 0])


def _lonlat(h, w):
    """An equirect frame whose red codes longitude and green latitude."""
    lon = (np.arange(w) + 0.5) / w
    lat = (np.arange(h) + 0.5) / h
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.round(lon[None, :] * 255)
    img[..., 1] = np.round(lat[:, None] * 255)
    return torch.from_numpy(img)


@pytest.mark.parametrize("yaw", [0.0, 45.0, -90.0])
def test_view_looks_where_it_points(yaw):
    frame = _lonlat(256, 512)
    views = {"size": 32, "focal_mm": 12.0, "sensor_mm": [36.0, 36.0],
             "interp": "bicubic"}
    out = equirect.cut_view(frame, {"id": "A", "yaw": yaw, "pitch": 0.0},
                            views)
    centre = out[15:17, 15:17].double().mean((0, 1))
    assert abs(float(centre[0]) - 255 * (yaw / 360 + 0.5)) <= 2
    assert abs(float(centre[1]) - 127.5) <= 2


def test_fisheye_axis_hits_the_centre():
    """The view along a lens's axis maps its centre pixel to the lens
    centre; the lens choice takes X for yaw 0 and Y for yaw 180."""
    calib = {"width": 101, "height": 101, "f": 27.6, "cx": 0.0, "cy": 0.0,
             "k1": 0.1}
    mx, my, valid = fisheye.lens_map(calib, 0.0, 0.0, 90.0, 90.0, 33, 190.0)
    assert float(mx[16, 16]) == pytest.approx(50.5)
    assert float(my[16, 16]) == pytest.approx(50.5)
    assert bool(valid[16, 16])
    cfg = {"calibration": calib, "lens_yaw_deg": [0.0, 180.0],
           "lens_fov_deg": 190.0,
           "views": {"size": 9, "focal_mm": 14.0, "sensor_mm": [36.0, 36.0],
                     "layout": [{"id": "A", "yaw": 0.0, "pitch": 0.0},
                                {"id": "F", "yaw": 180.0, "pitch": 0.0}]}}
    maps = fisheye.view_maps(cfg)
    assert maps["A"][0] == "X" and maps["F"][0] == "Y"


def test_identity_cube_and_transfer():
    n = 5
    g = torch.linspace(0, 1, n, dtype=torch.float64)
    r, gg, b = torch.meshgrid(g, g, g, indexing="ij")
    table = (torch.stack([r, gg, b], -1), [0.0] * 3, [1.0] * 3)
    rgb = torch.rand(10, 3, dtype=torch.float64)
    assert torch.allclose(cube.apply_lut(rgb, table), rgb)
    v = torch.tensor([0.0, 0.05, 0.5, 1.0], dtype=torch.float64)
    lin = torch.where(v < 0.081, v / 4.5, ((v + 0.099) / 1.099) ** (1 / 0.45))
    srgb = cube.rec709_to_srgb(v)
    back = torch.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4)
    assert torch.allclose(back, lin)


def test_float32_within_a_lsb_of_float64():
    """The precision the kernels compute in agrees with the reference to
    a LSB on a few pixels."""
    frame = torch.from_numpy(scenes.scene(SEED, 0, 128, 256, {
        "octaves": 4, "shapes": 20, "grain_lsb": 2}))
    views = {"size": 48, "focal_mm": 12.0, "sensor_mm": [36.0, 36.0],
             "interp": "bicubic"}
    view = {"id": "A", "yaw": 30.0, "pitch": 10.0}
    a = equirect.cut_view(frame, view, views, torch.float64).int()
    b = equirect.cut_view(frame, view, views, torch.float32).int()
    diff = (a - b).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).double().mean()) < 0.01


def test_numbers_and_verdict():
    ref = torch.full((4, 4, 3), 100, dtype=torch.uint8)
    same = compare.numbers([(ref.numpy(), ref)], 0)
    assert same == {"missing": 0, "mae_lsb": 0.0, "far_pct": 0.0}
    off = ref.numpy().copy()
    off[0, 0] = 200
    found = compare.numbers([(ref.numpy(), ref), (off, ref)], 1)
    assert found["far_pct"] == pytest.approx(100 / 16)
    limits = {"missing": 0, "mae_lsb": 3.5, "far_pct": 0.5}
    assert compare.verdict(same, limits)
    assert not compare.verdict(found, limits)
    wrong_shape = compare.numbers([(ref.numpy()[:2], ref)], 0)
    assert wrong_shape["mae_lsb"] == 255.0


@pytest.mark.parametrize("cell", [w["name"] for w in harness.Spec.load()
                                  .data["workloads"]])
def test_control_fails(cell, tiny_spec, tmp_path):
    """The control (the reference in bfloat16, in the program's place)
    comes out as not correct, at a size a test run holds; the readings
    on the card at the cells' own sizes are in PERF.md."""
    from portbench import control
    out = control.readings(tiny_spec, cell, SEED, torch.device("cpu"),
                           tmp_path / "control")
    assert out["correct"] is False
    assert out["check"]["mae_lsb"][0] > out["check"]["mae_lsb"][1]
