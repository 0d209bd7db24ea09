"""The port's planarize (plain version) against the JAX package's
``_planarize_rows`` run in interpret mode: bitwise equal, in both Pallas
variants (MXU one-hot for u8 with H % 128 == 0, lane gathers otherwise),
for u8 and scaled-f32 outputs. The CUDA kernel is held to the same plain
version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs360x.kernels import warp_pallas
from gs360x_torch.kernels import warp_cuda

torch.set_num_threads(1)

WP = 384   # planar width: one of the Pallas kernels' 384-column blocks

CASES = [
    # (id, source dtype, H, scale, u8 output)
    ("u8_mxu_u8out", np.uint8, 128, 1.0, True),
    ("u8_mxu_f32out", np.uint8, 128, 1.0 / 255.0, False),
    ("u8_vpu_u8out", np.uint8, 64, 1.0, True),
    ("u8_vpu_f32out", np.uint8, 16, 1.0 / 255.0, False),
    ("u16_f32out", np.uint16, 16, 1.0 / 65535.0, False),
    ("f32_f32out", np.float32, 16, 1.0, False),
]


def _rows(dtype, h, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random((h, 3 * WP), dtype=np.float32)
    hi = np.iinfo(dtype).max
    return rng.integers(0, hi + 1, (h, 3 * WP), dtype=dtype)


@pytest.mark.parametrize("dtype,h,scale,u8_out",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_plain_planarize_bitwise_equals_pallas(dtype, h, scale, u8_out):
    rows = _rows(dtype, h)
    ref = np.asarray(warp_pallas._planarize_rows(
        jnp.asarray(rows), scale=scale, interpret=True,
        out_dtype=jnp.uint8 if u8_out else None))
    got = warp_cuda.planarize_rows_plain(
        torch.from_numpy(rows), scale,
        torch.uint8 if u8_out else torch.float32).numpy()
    assert got.shape == ref.shape == (3, h, WP)
    assert got.dtype == ref.dtype
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_wrapper_runs_plain_version_on_cpu_tensors():
    warp_cuda.reset_counters()
    rows = torch.from_numpy(_rows(np.uint8, 16))
    out = warp_cuda.planarize_rows(rows, 1.0, torch.uint8)
    assert torch.equal(out, warp_cuda.planarize_rows_plain(rows, 1.0,
                                                           torch.uint8))
    assert warp_cuda.PLAIN_CALLS["planarize"] == 1
    assert warp_cuda.LAUNCHES["planarize"] == 0


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        warp_cuda.planarize_rows(torch.zeros(4, 10, dtype=torch.uint8))
    with pytest.raises(ValueError):
        warp_cuda.planarize_rows(torch.zeros(4, 12, dtype=torch.float32),
                                 1.0, torch.uint8)
