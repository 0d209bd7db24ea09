"""The work counts behind the rooflines, against shapes counted by hand."""

import math

import pytest
import torch

from portbench import work


def test_constants_frozen():
    """The copies of chip_smoke.py's constants (a later change to the
    program does not move the yardstick)."""
    assert work.HBM_TBS == 3.35 and work.FP32_ISSUE_T == 33.5
    assert work.TAP_INSNS_PER_PX == {"bicubic": 84, "catmull-rom": 84,
                                     "bilinear": 20, "nearest": 3}
    assert work.WARP_RAY_INSNS_PER_PX == 54


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::warp_equirect_kernel<gs360x::Texels, "
     "unsigned char, true, 0>(...)", "warp"),
    ("(anonymous namespace)::texelize_regs(unsigned char const*, uint4*, "
     "long)", "planarize"),
    ("void (anonymous namespace)::remap_kernel<gs360x::Texels, unsigned "
     "char, 3>(...)", "remap"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
])
def test_family(name, fam):
    assert work.family(name) == fam


def test_least_us():
    assert work.least_us(3.35e6, 0) == {"us": 1.0, "bound_by": "bytes"}
    assert work.least_us(0, 67e6) == {"us": 2.0, "bound_by": "operations"}


def test_mark_texels_wrap_and_clamp():
    seen = torch.zeros(8 * 16, dtype=torch.bool)
    # one pixel at the left edge of an equirect source: columns wrap
    work.mark_texels(seen, torch.tensor([0.2]), torch.tensor([3.5]), None,
                     8, 16, True)
    cols = sorted({int(i) % 16 for i in seen.nonzero()})
    assert cols == [0, 1, 2, 15] and int(seen.sum()) == 16
    lens = torch.zeros(8 * 16, dtype=torch.bool)
    work.mark_texels(lens, torch.tensor([0.2]), torch.tensor([3.5]), None,
                     8, 16, False)
    assert int(lens.sum()) == 12   # column -1 clamps onto column 0


def _perspcut(size=16, h=32, w=64):
    views = {"size": size, "focal_mm": 12.0, "sensor_mm": [36.0, 36.0],
             "interp": "bicubic",
             "layout": [{"id": "A", "yaw": 0.0, "pitch": 0.0},
                        {"id": "B", "yaw": 90.0, "pitch": 0.0}]}
    return {"frame": {"width": w, "height": h}, "views": views}


def test_warp_launch_counts():
    cfg = _perspcut()
    out = work.warp_launch(cfg)
    pixels = 2 * 16 * 16
    ops_us = pixels * (84 + 54) / 33.5e6
    texels = out["source_share"] * 32 * 64
    bytes_us = (texels * 3 + pixels * 3) / 3.35e6
    assert out["us"] == pytest.approx(max(ops_us, bytes_us))
    assert out["bound_by"] == ("operations" if ops_us > bytes_us
                               else "bytes")
    assert 0 < out["source_share"] < 1


def _fisheye(size=16, lens=64):
    s = lens / 3840
    return {"calibration": {"width": lens, "height": lens,
                            "f": 1049.9268186384606 * s, "cx": 0.0,
                            "cy": 0.0, "k1": 0.1019},
            "lens_yaw_deg": [0.0, 180.0], "lens_fov_deg": 190.0,
            "interp": "catmull-rom", "fill": 0.0,
            "views": {"size": size, "focal_mm": 14.0,
                      "sensor_mm": [36.0, 36.0],
                      "layout": [{"id": "A", "yaw": 0.0, "pitch": 0.0},
                                 {"id": "F", "yaw": 180.0, "pitch": 0.0},
                                 {"id": "B", "yaw": 40.0, "pitch": 0.0}]}}


def test_remap_launches_counts():
    """Two lens groups (X: A and B, Y: F); a pair's least time is the sum
    of the two launches', each bytes- or operations-bound on its own."""
    from portbench.reference import fisheye
    cfg = _fisheye()
    maps = fisheye.view_maps(cfg, torch.float32)
    assert [maps[v][0] for v in ("A", "F", "B")] == ["X", "Y", "X"]
    total = 0.0
    for lens, ids in (("X", ("A", "B")), ("Y", ("F",))):
        seen = torch.zeros(64 * 64, dtype=torch.bool)
        sampled = 0
        for v in ids:
            _l, mx, my, valid = maps[v]
            sampled += int(valid.sum())
            work.mark_texels(seen, mx, my, valid, 64, 64, False)
        pixels = len(ids) * 16 * 16
        moved = int(seen.sum()) * 3 + sampled * 8 + pixels * 4
        total += max(moved / 3.35e6, sampled * 84 / 33.5e6)
    out = work.remap_launches(cfg, False)
    assert out["pair_us"] == pytest.approx(total)
    assert out["us"] == pytest.approx(total / 2)
    f32 = work.remap_launches(cfg, True)
    assert f32["pair_us"] > out["pair_us"]
    assert math.isfinite(f32["us"])
