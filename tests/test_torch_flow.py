"""The port's optical flow (:mod:`gs360x_torch.kernels.flow`) against the
JAX package's (:mod:`gs360x.kernels.flow`) on the CPU, on seeded inputs:
Shi–Tomasi corners (points and ``valid`` equal on blurred noise; on the
checkerboard of ``tests/test_sharpness_flow.py``, whose symmetric corners
tie to the last ulp, ``valid`` and the set of corners equal), LK displacements (atol
1e-3 px, ``ok`` equal), Farneback flow (atol 1e-3) and both mean
magnitudes (abs 1e-3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs360x.kernels import flow as jflow
from gs360x_torch.kernels import flow as tflow
from test_sharpness_flow import blur_np

torch.set_num_threads(1)

ATOL = 1e-3


def _noise(shape=(96, 128), seed=0, n=2):
    rng = np.random.default_rng(seed)
    return blur_np(rng.random(shape) * 255, 5, n).astype(np.float32)


def _checkerboard():
    img = np.zeros((64, 64), np.float32)
    img[::16, :] = 255
    img[:, ::16] = 255
    return blur_np(img, 3).astype(np.float32)


def _pattern(shape, ox, oy):
    h, w = shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (0.5 + 0.3 * np.sin(2 * np.pi * (xx + ox) / 24)
            * np.cos(2 * np.pi * (yy + oy) / 20)).astype(np.float32)


@pytest.mark.parametrize("name", ["noise", "checkerboard", "noise_small"])
def test_corners_equal_jax(name):
    img = {"noise": lambda: _noise(),
           "checkerboard": _checkerboard,
           "noise_small": lambda: _noise((40, 56), seed=4, n=1)}[name]()
    ref_pts, ref_valid = jflow.shi_tomasi_corners(jnp.asarray(img))
    pts, valid = tflow.shi_tomasi_corners(torch.from_numpy(img))
    assert pts.shape == (tflow.N_POINTS, 2) and pts.dtype == torch.float32
    assert np.array_equal(valid.numpy(), np.asarray(ref_valid))
    assert int(valid.sum()) > 4
    ref_pts, pts, valid = np.asarray(ref_pts), pts.numpy(), valid.numpy()
    if name == "checkerboard":
        # the symmetric corners' responses are equal up to the last ulp,
        # which XLA's code and torch's round apart: the same corners, in
        # an order that the ulps decide
        assert set(map(tuple, pts[valid])) == set(map(tuple, ref_pts[valid]))
    else:
        assert np.array_equal(pts, ref_pts)


@pytest.mark.parametrize("shift", [(0, 0), (3, 5), (-2, 1)])
def test_lk_track_matches_jax(shift):
    base = _noise((128, 168))
    curr = np.roll(base, shift, (0, 1))
    pts, _ = jflow.shi_tomasi_corners(jnp.asarray(base))
    ref_disp, ref_ok = jflow.lk_track(jnp.asarray(base), jnp.asarray(curr),
                                      pts)
    disp, ok = tflow.lk_track(torch.from_numpy(base), torch.from_numpy(curr),
                              torch.from_numpy(np.asarray(pts)))
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(disp.numpy(), np.asarray(ref_disp), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["translation", "noise"])
def test_farneback_matches_jax(case):
    if case == "translation":
        prev, curr = _pattern((72, 96), 0, 0), _pattern((72, 96), -2, -1)
    else:
        prev = _noise((48, 64), seed=2) / 255.0
        curr = np.roll(prev, (1, 2), (0, 1))
    ref = np.asarray(jflow.farneback_flow(jnp.asarray(prev),
                                          jnp.asarray(curr)))
    got = tflow.farneback_flow(torch.from_numpy(prev),
                               torch.from_numpy(curr)).numpy()
    assert got.shape == ref.shape == prev.shape + (2,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("method", ["lucas_kanade", "farneback"])
@pytest.mark.parametrize("shift", [(0, 0), (3, 5)])
def test_mean_magnitudes_match_jax(method, shift):
    base = _noise((96, 128), seed=1)
    curr = np.roll(base, shift, (0, 1))
    jfn, tfn = ((jflow.mean_flow_magnitude, tflow.mean_flow_magnitude)
                if method == "lucas_kanade" else
                (jflow.mean_flow_magnitude_farneback,
                 tflow.mean_flow_magnitude_farneback))
    ref = jfn(jnp.asarray(base), jnp.asarray(curr))
    got = tfn(torch.from_numpy(base), torch.from_numpy(curr))
    assert isinstance(got, float)
    assert got == pytest.approx(ref, abs=ATOL)


def test_nothing_tracks_gives_nan():
    flat = np.full((40, 48), 10.0, np.float32)
    ref = jflow.mean_flow_magnitude(jnp.asarray(flat), jnp.asarray(flat))
    got = tflow.mean_flow_magnitude(torch.from_numpy(flat),
                                    torch.from_numpy(flat))
    assert np.isnan(ref) == np.isnan(got)
