"""The port's planarize (plain version) against the JAX package's
``_planarize_rows`` run in interpret mode: bitwise equal, in both Pallas
variants (MXU one-hot for u8 with H % 128 == 0, lane gathers otherwise),
for u8 and scaled-f32 outputs; and against numpy on an offset view and a
single row; the texel mode's plain version (RGBX, X = 0) against numpy.
The CUDA kernel is held to the same plain version on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

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


PAIRS = [
    # (id, source dtype, scale, u8 output)
    ("u8_u8out", np.uint8, 1.0, True),
    ("u8_f32out", np.uint8, 1.0 / 255.0, False),
    ("u16_f32out", np.uint16, 1.0 / 65535.0, False),
    ("f32_f32out", np.float32, 1.0, False),
]


@pytest.mark.parametrize("h,w,offset", [(5, 37, 1), (1, 301, 0)],
                         ids=["offset_view", "one_row"])
@pytest.mark.parametrize("dtype,scale,u8_out", [p[1:] for p in PAIRS],
                         ids=[p[0] for p in PAIRS])
def test_plain_planarize_offset_view_and_one_row_equal_numpy(
        dtype, scale, u8_out, h, w, offset):
    # the contract planarize.cu's scalar path is held to on the card: a
    # view whose base is not 16-byte aligned, and a single row
    flat = _rows(dtype, 3).reshape(-1)[:3 * h * w + offset]
    rows = torch.from_numpy(flat)[offset:].view(h, 3 * w)
    assert rows.storage_offset() == offset
    want = flat[offset:].reshape(h, w, 3).transpose(2, 0, 1)
    if not u8_out:
        want = want.astype(np.float32) * np.float32(scale)
    got = warp_cuda.planarize_rows(
        rows, scale, torch.uint8 if u8_out else torch.float32).numpy()
    assert got.shape == (3, h, w) and got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8),
                          np.ascontiguousarray(want).view(np.uint8))


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
    with pytest.raises(ValueError, match="variant"):
        warp_cuda.planarize_rows(torch.zeros(4, 12, dtype=torch.uint8),
                                 1.0, torch.uint8, variant="fast")


# --- the texel mode: (H, 3W) u8 rows -> (H, W, 4) RGBX texels ---------------

@pytest.mark.parametrize("h,w,offset", [(5, 37, 1), (1, 301, 0), (8, 48, 0)],
                         ids=["offset_view_w_not_16n", "one_row", "aligned"])
def test_plain_texelize_equals_numpy(h, w, offset):
    flat = _rows(np.uint8, 3).reshape(-1)[:3 * h * w + offset]
    rows = torch.from_numpy(flat)[offset:].view(h, 3 * w)
    assert rows.storage_offset() == offset
    want = np.zeros((h, w, 4), np.uint8)
    want[..., :3] = flat[offset:].reshape(h, w, 3)
    for fn in (warp_cuda.texelize_rows_plain, warp_cuda.texelize_rows):
        got = fn(rows)
        assert got.dtype == torch.uint8 and got.is_contiguous()
        assert warp_cuda.is_texels(got)
        assert np.array_equal(got.numpy(), want)
    # the three channels of a texel are the pixel of the u8 planes
    planes = warp_cuda.planarize_rows_plain(rows, 1.0, torch.uint8)
    assert torch.equal(warp_cuda.texelize_rows_plain(rows)[..., :3]
                       .permute(2, 0, 1), planes)


def test_texelize_wrapper_counts_the_plain_version_on_cpu_tensors():
    warp_cuda.reset_counters()
    warp_cuda.texelize_rows(torch.from_numpy(_rows(np.uint8, 4)))
    assert warp_cuda.PLAIN_CALLS["planarize"] == 1
    assert warp_cuda.LAUNCHES["planarize"] == 0


@pytest.mark.parametrize("rows,match", [
    (torch.zeros(4, 12, dtype=torch.float32), "uint8"),
    (torch.zeros(4, 12, dtype=torch.uint16), "uint8"),
    (torch.zeros(4, 10, dtype=torch.uint8), "rows"),
    (torch.zeros(4, 4, 3, dtype=torch.uint8), "rows")],
    ids=["f32", "u16", "width_not_3n", "not_2d"])
def test_texelize_wrapper_rejects_bad_inputs(rows, match):
    with pytest.raises(ValueError, match=match):
        warp_cuda.texelize_rows(rows)
    assert not warp_cuda.is_texels(rows)


def test_texelize_wrapper_rejects_unknown_variant():
    assert "bulk" not in warp_cuda.PLANARIZE_VARIANTS
    for variant in ("bulk", "fast"):
        with pytest.raises(ValueError, match="variant"):
            warp_cuda.texelize_rows(torch.zeros(4, 12, dtype=torch.uint8),
                                    variant=variant)
        with pytest.raises(ValueError, match="variant"):
            warp_cuda.planarize_rows(torch.zeros(4, 12, dtype=torch.uint8),
                                     1.0, torch.uint8, variant=variant)
