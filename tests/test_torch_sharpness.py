"""The port's sharpness metrics (:mod:`gs360x_torch.kernels.sharpness`)
against the JAX package's (:mod:`gs360x.kernels.sharpness`) on the CPU,
on seeded grays: each metric with and without a mask (rtol 1e-5; the FFT
energy 1e-4), ``score_frame`` for each of the five metrics, the circle
mask exactly, the host crop/downscale helpers and weights equal, and the
FrameSelector's device gray (planarize + weighted sum) bitwise equal to
the JAX tool's host ``_load_gray`` for u8 and u16 images."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs360x.io import image as im
from gs360x.kernels import sharpness as jsharp
from gs360x.tools import frameselector as jfs
from gs360x_torch.kernels import sharpness as tsharp
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.tools import frameselector as tfs

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-5
FFT_RTOL = 1e-4


def _gray(seed=0, shape=(37, 53), blur=False):
    rng = np.random.default_rng(seed)
    img = rng.random(shape) * 255.0
    if blur:   # smooth content: small, nonzero gradients
        p = np.pad(img, 2, mode="edge")
        img = sum(p[i:i + shape[0], j:j + shape[1]]
                  for i in range(5) for j in range(5)) / 25.0
    return img.astype(np.float32)


def _mask(shape, seed=1):
    return np.random.default_rng(seed).random(shape) > 0.3


def _cases():
    for name in ("laplacian_variance", "tenengrad", "sobel_yavg",
                 "fft_energy", "brightness_mean", "highlight_ratio"):
        for masked in (False, True):
            yield pytest.param(name, masked,
                               id=f"{name}-{'mask' if masked else 'full'}")


@pytest.mark.parametrize("name,masked", list(_cases()))
@pytest.mark.parametrize("blur", [False, True])
def test_metric_matches_jax(name, masked, blur):
    gray = _gray(seed=3, blur=blur)
    if name == "highlight_ratio":
        gray[::3] = 250.0
    mask = _mask(gray.shape) if masked else None
    ref = float(getattr(jsharp, name)(
        jnp.asarray(gray), None if mask is None else jnp.asarray(mask)))
    got = getattr(tsharp, name)(torch.from_numpy(gray),
                                None if mask is None
                                else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    rtol = FFT_RTOL if name == "fft_energy" else RTOL
    assert float(got) == pytest.approx(ref, rel=rtol, abs=1e-6)


def test_conv3x3_and_sobel_magnitude_match_jax():
    gray = _gray(seed=4)
    for k in (jsharp._LAPLACIAN_K3, jsharp._SOBEL_X, jsharp._SOBEL_Y):
        ref = np.asarray(jsharp._conv3x3(jnp.asarray(gray), k))
        got = tsharp._conv3x3(torch.from_numpy(gray), k).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(
        tsharp.sobel_magnitude(torch.from_numpy(gray)).numpy(),
        np.asarray(jsharp.sobel_magnitude(jnp.asarray(gray))), rtol=RTOL,
        atol=1e-3)


@pytest.mark.parametrize("metric", list(tsharp.METRICS))
@pytest.mark.parametrize("use_mask", [False, True])
def test_score_frame_matches_jax(metric, use_mask):
    gray = _gray(seed=5, shape=(48, 64))
    mask = np.asarray(jsharp.circle_mask(48, 64))
    ref = jsharp.score_frame(jnp.asarray(gray), jnp.asarray(mask),
                             metric=metric, use_mask=use_mask)
    got = tsharp.score_frame(torch.from_numpy(gray), torch.from_numpy(mask),
                             metric=metric, use_mask=use_mask)
    assert len(got) == len(ref) == 5
    for slot, (g, r) in enumerate(zip(got, ref)):
        rtol = FFT_RTOL if slot == 2 else RTOL
        assert float(g) == pytest.approx(float(r), rel=rtol, abs=1e-6), slot


def test_score_frame_rejects_unknown_metric():
    with pytest.raises(ValueError, match="metric"):
        tsharp.score_frame(torch.zeros(4, 4), None, metric="x",
                           use_mask=False)


@pytest.mark.parametrize("shape", [(64, 64), (48, 64), (33, 17), (1, 5)])
def test_circle_mask_equal(shape):
    assert np.array_equal(tsharp.circle_mask(*shape).numpy(),
                          np.asarray(jsharp.circle_mask(*shape)))


def test_host_helpers_equal():
    for shape, ratio in (((100, 200), 0.8), ((37, 53), 0.6), ((3, 3), 0.1)):
        assert tsharp.crop_by_ratio(shape, ratio) == \
            jsharp.crop_by_ratio(shape, ratio)
    img = _gray(seed=6, shape=(333, 517))
    for max_long in (0, 320, 600, 77):
        ref = jsharp.downscale_max_long(img, max_long)
        got = tsharp.downscale_max_long(img, max_long)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for x in (0.0, 12.5, 4999.0, 1e9):
        assert tsharp.motion_factor_from_tenengrad(x) == \
            jsharp.motion_factor_from_tenengrad(x)
    for b in (0.0, 0.1, 0.35, 0.9):
        assert tsharp.brightness_weight(b) == jsharp.brightness_weight(b)
    assert tsharp.hybrid_combine(0.2, 0.5, 0.9, 0.7) == \
        jsharp.hybrid_combine(0.2, 0.5, 0.9, 0.7)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_device_gray_bitwise_equals_load_gray(tmp_path, dtype):
    rng = np.random.default_rng(7)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (29, 41, 3), dtype=dtype)
    img[0, :3] = np.iinfo(dtype).max   # the clip's upper end
    path = tmp_path / "f.png"
    im.write_image(path, img)
    ref = jfs._load_gray(path)
    assert np.array_equal(tfs._load_gray(path), ref)
    warp_cuda.reset_counters()
    got = tfs.device_gray(im.read_image(path), CPU)
    assert warp_cuda.PLAIN_CALLS["planarize"] == 1
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
