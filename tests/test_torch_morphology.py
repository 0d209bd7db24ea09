"""The port's morphology (:mod:`gs360x_torch.kernels.morphology`) against
the JAX package's (:mod:`gs360x.kernels.morphology`) on the CPU.

``dilate``, ``erode``, ``close_mask`` and ``dilate_radius`` are bitwise the
JAX package's k² shifted slices (the port pools a column, then a row);
``gaussian_blur`` within 1e-6; ``diffusion_inpaint`` within 1e-5 in f32 and
1 LSB after the tool's u8 round; ``connected_components`` equal. Inputs
are seeded random masks with blobs, isolated pixels and edge contact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs360x.kernels import morphology as jm
from gs360x_torch.kernels import morphology as tm

torch.set_num_threads(1)

CPU = torch.device("cpu")
BLUR_TOL = 1e-6
INPAINT_TOL = 1e-5


def _mask(shape=(53, 71), seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < 0.03                   # isolated pixels
    m[10:25, 30:45] = True                          # a blob
    m[-6:, :9] = True                               # edge contact
    m[20, 35] = False                               # a hole in the blob
    return m.astype(np.float32)


@pytest.mark.parametrize("k", [1, 4, 5, 31])
@pytest.mark.parametrize("fn", ["dilate", "erode", "close_mask"])
def test_pools_bitwise_jax(fn, k):
    m = _mask(seed=k)
    ref = np.asarray(getattr(jm, fn)(jnp.asarray(m), k))
    got = getattr(tm, fn)(torch.from_numpy(m), k).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_pools_take_bool_masks():
    m = _mask() > 0
    assert torch.equal(tm.dilate(torch.from_numpy(m), 5),
                       tm.dilate(torch.from_numpy(m.astype(np.float32)), 5))


@pytest.mark.parametrize("radius", [0, 2, 15])
def test_dilate_radius_bitwise_jax(radius):
    m = (_mask(seed=radius) * 255).astype(np.uint8)
    ref = jm.dilate_radius(m, radius)
    got = tm.dilate_radius(m, radius, device=CPU)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sigma,radius", [(7.0, 10), (2.0, 5)])
def test_gaussian_blur_matches_jax(sigma, radius):
    img = np.random.default_rng(radius).random((45, 67), dtype=np.float32)
    ref = np.asarray(jm.gaussian_blur(jnp.asarray(img), sigma=sigma,
                                      radius=radius))
    got = tm.gaussian_blur(torch.from_numpy(img), sigma, radius).numpy()
    assert float(np.abs(got - ref).max()) <= BLUR_TOL


@pytest.mark.parametrize("iters", [1, 256])
def test_diffusion_inpaint_matches_jax(iters):
    rng = np.random.default_rng(iters)
    img = rng.random((48, 64, 3), dtype=np.float32)
    mask = _mask((48, 64), seed=iters) > 0
    ref = np.asarray(jm.diffusion_inpaint(jnp.asarray(img),
                                          jnp.asarray(mask), iters))
    got = tm.diffusion_inpaint(torch.from_numpy(img), torch.from_numpy(mask),
                               iters).numpy()
    assert float(np.abs(got - ref).max()) <= INPAINT_TOL
    np.testing.assert_array_equal(got[~mask], img[~mask])

    def u8(x):
        return np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert int(np.abs(u8(got).astype(int) - u8(ref).astype(int)).max()) <= 1


def test_diffusion_inpaint_without_a_hole_keeps_the_image():
    img = np.random.default_rng(1).random((8, 9, 3), dtype=np.float32)
    got = tm.diffusion_inpaint(torch.from_numpy(img),
                               torch.zeros(8, 9, dtype=torch.bool), 4)
    np.testing.assert_array_equal(got.numpy(), img)


def test_connected_components_equal_jax():
    m = _mask() > 0
    ref_labels, ref_count = jm.connected_components(m)
    got_labels, got_count = tm.connected_components(m)
    assert got_count == ref_count > 2
    assert got_labels.dtype == ref_labels.dtype == np.int32
    np.testing.assert_array_equal(got_labels, ref_labels)
