"""The CUDA kernels against their plain torch versions on the card, at
small and ragged shapes (``chip_smoke.py`` covers the main path's full
shapes). Marked ``cuda``: each test skips without a card. On a machine
with one, run (the JAX-side conftest is not needed)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from gs360x_torch.kernels import warp_cuda

pytestmark = pytest.mark.cuda

RING = [0.0, 90.0, 180.0, 270.0, 333.0]     # includes the 180° seam


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _rows(dtype, h, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        arr = rng.random((h, 3 * w), dtype=np.float32)
    else:
        arr = rng.integers(0, np.iinfo(dtype).max + 1, (h, 3 * w),
                           dtype=dtype)
    return torch.from_numpy(arr).to(dev)


def _pano(dtype, h, w, dev):
    """Smooth lon/lat panorama as (H, 3*W) rows of ``dtype``."""
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    img = np.stack([0.5 + 0.5 * np.sin(lon), 0.5 + 0.5 * np.sin(lat),
                    0.5 + 0.5 * np.cos(3 * lon)], -1)
    if dtype != np.float32:
        img = np.rint(img * np.iinfo(dtype).max)
    return torch.from_numpy(img.astype(dtype).reshape(h, 3 * w)).to(dev)


@pytest.mark.parametrize("dtype,scale,u8_out", [
    (np.uint8, 1.0, True), (np.uint8, 1.0 / 255.0, False),
    (np.uint16, 1.0 / 65535.0, False), (np.float32, 1.0, False)])
def test_planarize_kernel_bitwise_equals_plain(dev, dtype, scale, u8_out):
    rows = _rows(dtype, 37, 301, dev)
    out_dtype = torch.uint8 if u8_out else torch.float32
    got = warp_cuda.planarize_rows(rows, scale, out_dtype)
    ref = warp_cuda.planarize_rows_plain(rows, scale, out_dtype)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (3, 37, 301)
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("size", [(256, 128), (250, 131)])
def test_warp_kernel_matches_plain(dev, interp, dtype, size):
    rows = _pano(dtype, 256, 512, dev)
    zeros = [0.0] * len(RING)
    kw = dict(width=size[0], height=size[1], hfov_deg=100.0, vfov_deg=60.0,
              interp=interp, planar=True)
    before = dict(warp_cuda.LAUNCHES)
    got = warp_cuda.warp_equirect_to_views_cuda(rows, RING, zeros, zeros,
                                                **kw)
    ref = warp_cuda.warp_equirect_to_views_plain(rows, RING, zeros, zeros,
                                                 **kw)
    torch.cuda.synchronize()
    assert warp_cuda.LAUNCHES["warp"] == before["warp"] + 1
    assert got.shape == ref.shape == (len(RING), 3, size[1], size[0])
    # the tolerance of the Pallas-vs-twin parity tests
    assert float((got - ref).abs().max()) <= 1e-4


def test_warp_kernel_reflects_over_the_poles(dev):
    # views with taps past both poles, through the launcher directly (the
    # wrapper's gate keeps tilted views off the kernel in this slice)
    rows = _pano(np.uint8, 64, 128, dev)
    yaws, pitches, rolls = [20.0, 200.0], [80.0, -85.0], [0.0, 10.0]
    kw = dict(width=96, height=96, hfov_deg=110.0, vfov_deg=110.0)
    planes = warp_cuda.planarize_rows(rows, 1.0, torch.uint8)
    got = warp_cuda.warp_planes(planes, yaws, pitches, rolls,
                                interp="bicubic", **kw)
    ref = warp_cuda.warp_equirect_to_views_plain(
        rows, yaws, pitches, rolls, interp="bicubic", planar=True, **kw)
    torch.cuda.synchronize()
    lsb = (torch.round(got.clamp(0, 1) * 255)
           - torch.round(ref.clamp(0, 1) * 255)).abs()
    # near a pole u is ill-conditioned; gate as the oracle parity does
    assert float(lsb.max()) <= 2
    assert float((lsb > 1).float().mean()) <= 0.01


def test_wrapper_raises_outside_the_gate(dev):
    rows = _rows(np.uint8, 64, 128, dev)
    kw = dict(width=32, height=32, hfov_deg=90.0, vfov_deg=90.0)
    with pytest.raises(NotImplementedError, match="slice 3"):
        warp_cuda.warp_equirect_to_views_cuda(
            rows, [0.0], [0.0], [0.0], projection="fisheye_v360", **kw)
    with pytest.raises(NotImplementedError, match="slice 2"):
        warp_cuda.warp_equirect_to_views_cuda(rows, [0.0], [10.0], [0.0],
                                              **kw)
