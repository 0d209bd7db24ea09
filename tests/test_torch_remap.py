"""The port's remap path (:mod:`gs360x_torch.kernels.remap_cuda`, its plain
version on CPU tensors) against the JAX XLA ``remap`` — the reference the
Pallas remap kernels are held to (``tests/test_remap_pallas.py``) — on the
same barrel maps and sizes, at 1e-5: all four interps, valid/fill, a
non-tile-aligned output, row input, a u8 source, out-of-range taps, the
batch against V single calls and the single-channel mask co-warp; the
texel source of a u8 RGB image against its planes, and the quantizing
store (``out_dtype``) against the plain quantize and the quantized XLA
``remap``, ``valid`` and ``fill`` included. The CUDA kernel is held to this plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs360x.kernels import warp as jax_warp
from gs360x.runtime import executor as jax_executor
from gs360x_torch.kernels import remap_cuda, warp_cuda
from gs360x_torch.runtime import executor as torch_executor

torch.set_num_threads(1)

CPU = torch.device("cpu")
INTERPS = ["nearest", "bilinear", "bicubic", "catmull-rom"]


def barrel_maps(H, W, src_h, src_w, shift=(30.0, 20.0)):
    """The maps of tests/test_remap_pallas.py::barrel_maps."""
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    nx = (xx - W / 2) / W
    ny = (yy - H / 2) / H
    r2 = nx * nx + ny * ny
    map_x = np.clip(xx * (1 + 0.08 * r2) + shift[0], 0, src_w - 1)
    map_y = np.clip(yy * (1 + 0.08 * r2) + shift[1], 0, src_h - 1)
    return map_x.astype(np.float32), map_y.astype(np.float32)


SRC = np.random.default_rng(0).random((256, 384, 3)).astype(np.float32)
SRC_U8 = np.random.default_rng(1).integers(0, 256, (256, 384, 3),
                                           dtype=np.uint8)


def xla_remap(src, map_x, map_y, valid=None, *, interp, fill=0.0):
    return np.asarray(jax_warp.remap(
        jnp.asarray(src), jnp.asarray(map_x), jnp.asarray(map_y),
        interp=interp, valid=None if valid is None else jnp.asarray(valid),
        fill=fill))


@pytest.mark.parametrize("interp", INTERPS)
def test_remap_matches_jax_xla_remap(interp):
    map_x, map_y = barrel_maps(64, 128, 256, 384)
    remap_cuda.reset_counters()
    out = remap_cuda.remap_cuda(SRC, map_x, map_y, None, interp=interp,
                                planar=False)
    assert remap_cuda.PLAIN_CALLS["remap"] == 1
    assert remap_cuda.LAUNCHES["remap"] == 0
    ref = xla_remap(SRC, map_x, map_y, interp=interp)
    assert out.shape == ref.shape == (64, 128, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("interp", INTERPS)
def test_out_of_range_taps_clamp_like_jax(interp):
    # coordinates past every edge: each tap clamps to the source, the
    # bilinear second row is clamp(clamp(y0) + 1), as in the XLA twin
    map_x, map_y = barrel_maps(48, 96, 256, 384)
    map_x = map_x * 6.0 - 700.0
    map_y = map_y * 4.0 - 300.0
    out = remap_cuda.remap_cuda(SRC, map_x, map_y, interp=interp,
                                planar=False)
    np.testing.assert_allclose(out.numpy(),
                               xla_remap(SRC, map_x, map_y, interp=interp),
                               atol=1e-5)


def test_valid_fill():
    map_x, map_y = barrel_maps(64, 128, 256, 384)
    valid = np.zeros((64, 128), bool)
    valid[16:48, 32:96] = True
    out = remap_cuda.remap_cuda(SRC, map_x, map_y, valid, interp="bilinear",
                                fill=0.25, planar=False).numpy()
    np.testing.assert_allclose(out[0, 0], 0.25, atol=1e-6)
    assert (np.abs(out[32, 64] - 0.25) > 1e-3).any()
    np.testing.assert_allclose(
        out, xla_remap(SRC, map_x, map_y, valid, interp="bilinear",
                       fill=0.25), atol=1e-5)


def test_non_tile_aligned_output():
    map_x, map_y = barrel_maps(50, 200, 256, 384)
    out = remap_cuda.remap_cuda(SRC, map_x, map_y, interp="catmull-rom",
                                planar=True)
    assert out.shape == (3, 50, 200)
    ref = xla_remap(SRC, map_x, map_y, interp="catmull-rom")
    np.testing.assert_allclose(out.permute(1, 2, 0).numpy(), ref, atol=1e-5)


def test_rows_and_planes_input():
    map_x, map_y = barrel_maps(32, 128, 256, 384)
    prep = remap_cuda.PreparedRemap(map_x, map_y, None, src_w=384,
                                    src_h=256, device=CPU)
    a = prep(SRC, interp="bicubic")
    b = prep(SRC.reshape(256, 384 * 3), interp="bicubic")
    c = prep(torch.from_numpy(SRC).permute(2, 0, 1), interp="bicubic")
    assert torch.equal(a, b) and torch.equal(a, c)
    # the maps stay resident: a second frame reuses them
    d = prep(SRC * 0.5, interp="bicubic")
    np.testing.assert_allclose(a.numpy() * 0.5, d.numpy(), atol=1e-6)


@pytest.mark.parametrize("interp", ["bilinear", "catmull-rom"])
def test_u8_source_matches_jax_on_float01(interp):
    # the dual-fisheye tool hands the device u8 planes; the reference
    # remaps to_float01(image) = image / 255
    map_x, map_y = barrel_maps(64, 128, 256, 384)
    remap_cuda.reset_counters()
    warp_cuda.reset_counters()
    out = remap_cuda.remap_cuda(SRC_U8, map_x, map_y, interp=interp,
                                planar=False)
    # one planarize (plain on the CPU) and one remap
    assert warp_cuda.PLAIN_CALLS["planarize"] == 1
    assert remap_cuda.PLAIN_CALLS["remap"] == 1
    ref = xla_remap(SRC_U8.astype(np.float32) / 255.0, map_x, map_y,
                    interp=interp)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_batch_equals_single_calls():
    maps = []
    for k, shift in enumerate([(30.0, 20.0), (5.0, 60.0), (200.0, 0.0)]):
        mx, my = barrel_maps(40, 72, 256, 384, shift=shift)
        valid = np.ones((40, 72), bool)
        valid[k * 5:k * 5 + 7] = False
        maps.append((mx, my, valid))
    for interp in INTERPS:
        batch = remap_cuda.PreparedRemapBatch(maps, src_w=384, src_h=256,
                                              interp=interp, device=CPU)
        remap_cuda.reset_counters()
        got = batch(SRC_U8, fill=0.5)
        assert remap_cuda.PLAIN_CALLS["remap"] == 1
        assert got.shape == (3, 3, 40, 72)
        for v, (mx, my, valid) in enumerate(maps):
            single = remap_cuda.PreparedRemap(
                mx, my, valid, src_w=384, src_h=256, device=CPU)(
                    SRC_U8, interp=interp, fill=0.5)
            assert torch.equal(got[v], single)
        hwc = batch(SRC_U8, fill=0.5, planar=False)
        assert torch.equal(hwc, got.permute(0, 2, 3, 1))
    nearest = batch.with_interp("nearest")
    assert nearest.interp == "nearest" and batch.interp == INTERPS[-1]
    assert nearest.map_x is batch.map_x


def test_single_channel_mask_nearest_is_exact():
    # the dual-fisheye mask co-warp: a 2-D u8 mask through nearest
    rng = np.random.default_rng(2)
    mask = (rng.random((256, 384)) > 0.5).astype(np.uint8) * 255
    map_x, map_y = barrel_maps(64, 128, 256, 384)
    valid = np.ones((64, 128), bool)
    valid[:, :10] = False
    out = remap_cuda.PreparedRemap(map_x, map_y, valid, src_w=384,
                                   src_h=256, device=CPU)(
        mask, interp="nearest", fill=0.0)
    assert out.shape == (1, 64, 128)
    ref = xla_remap((mask.astype(np.float32) / 255.0)[..., None], map_x,
                    map_y, valid, interp="nearest")[..., 0]
    np.testing.assert_array_equal(out[0].numpy(), ref)


def test_bad_arguments_raise():
    map_x, map_y = barrel_maps(16, 16, 256, 384)
    with pytest.raises(ValueError, match="interp"):
        remap_cuda.remap_cuda(SRC, map_x, map_y, interp="lanczos")
    with pytest.raises(ValueError, match="does not match"):
        remap_cuda.PreparedRemap(map_x, map_y, src_w=100, src_h=100,
                                 device=CPU)(SRC)
    with pytest.raises(ValueError, match="one output size"):
        remap_cuda.PreparedRemapBatch(
            [(map_x, map_y, None), (map_x[:8], map_y[:8], None)],
            src_w=384, src_h=256, device=CPU)


# --- the texel source and the quantizing store -------------------------------

def test_u8_rgb_source_becomes_texels_and_remaps_like_its_planes():
    map_x, map_y = barrel_maps(40, 72, 256, 384)
    texels = remap_cuda.remap_source(SRC_U8, 256, 384, CPU)
    assert warp_cuda.is_texels(texels) and texels.shape == (256, 384, 4)
    assert np.array_equal(texels[..., :3].numpy(), SRC_U8)
    assert not texels[..., 3].any()
    # rows and ready texels give the same source; floats, u16 and masks
    # stay planes
    assert torch.equal(remap_cuda.remap_source(
        torch.from_numpy(SRC_U8.reshape(256, 384 * 3)), 256, 384), texels)
    assert remap_cuda.remap_source(texels, 256, 384) is texels
    assert remap_cuda.remap_source(SRC, 256, 384).shape == (3, 256, 384)
    assert remap_cuda.remap_source(SRC_U8[..., 0], 256, 384).shape \
        == (1, 256, 384)
    planes = remap_cuda.source_planes(SRC_U8, 256, 384, CPU)
    mx, my = torch.from_numpy(map_x)[None], torch.from_numpy(map_y)[None]
    for interp in INTERPS:
        a = remap_cuda.remap_planes(texels, mx, my, None, interp=interp)
        b = remap_cuda.remap_planes(planes, mx, my, None, interp=interp)
        assert torch.equal(a, b)


@pytest.mark.parametrize("bits,out_dtype", [(8, torch.uint8),
                                            (16, torch.uint16)],
                         ids=["u8", "u16"])
@pytest.mark.parametrize("interp", ["bilinear", "catmull-rom"])
def test_out_dtype_is_the_quantized_f32_result(interp, bits, out_dtype):
    # a batch with invalid bands and a fill that needs the clamp's company
    # (0.3 * 255 = 76.5 rounds to even: 76)
    maps = []
    for k, shift in enumerate([(30.0, 20.0), (200.0, 0.0)]):
        mx, my = barrel_maps(40, 72, 256, 384, shift=shift)
        valid = np.ones((40, 72), bool)
        valid[k * 5:k * 5 + 7] = False
        maps.append((mx, my, valid))
    batch = remap_cuda.PreparedRemapBatch(maps, src_w=384, src_h=256,
                                          interp=interp, device=CPU)
    f32 = batch(SRC_U8, fill=0.3)
    got = batch(SRC_U8, fill=0.3, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == f32.shape
    assert torch.equal(got, torch_executor._quantize_device(f32, bits))
    assert int(got[0, 0, 0, 0]) == (76 if bits == 8 else 19660)
    single = remap_cuda.PreparedRemap(*maps[1], src_w=384, src_h=256,
                                      device=CPU)(
        SRC_U8, interp=interp, fill=0.3, out_dtype=out_dtype)
    assert torch.equal(single, got[1])
    # against the JAX path: its executor's quantize of the XLA remap
    for v, (mx, my, valid) in enumerate(maps):
        ref = np.asarray(jax_executor._quantize_device(
            jnp.asarray(xla_remap(SRC_U8.astype(np.float32) / 255.0, mx, my,
                                  valid, interp=interp, fill=0.3)),
            bit_depth=bits)).transpose(2, 0, 1)
        diff = np.abs(got[v].numpy().astype(np.int64) - ref.astype(np.int64))
        # the f32 gate (1e-5) in the store's steps, plus one for rounding
        assert int(diff.max()) <= (1 if bits == 8 else 2)


def test_mask_nearest_with_u8_store_is_exact():
    rng = np.random.default_rng(2)
    mask = (rng.random((256, 384)) > 0.5).astype(np.uint8) * 255
    map_x, map_y = barrel_maps(64, 128, 256, 384)
    valid = np.ones((64, 128), bool)
    valid[:, :10] = False
    out = remap_cuda.PreparedRemap(map_x, map_y, valid, src_w=384,
                                   src_h=256, device=CPU)(
        mask, interp="nearest", fill=0.0, out_dtype=torch.uint8)
    assert out.shape == (1, 64, 128) and out.dtype == torch.uint8
    ref = xla_remap((mask.astype(np.float32) / 255.0)[..., None], map_x,
                    map_y, valid, interp="nearest")[..., 0]
    np.testing.assert_array_equal(out[0].numpy(),
                                  np.rint(ref * 255).astype(np.uint8))
    assert set(np.unique(out.numpy())) <= {0, 255}


def test_unknown_out_dtype_raises():
    map_x, map_y = barrel_maps(16, 16, 256, 384)
    with pytest.raises(ValueError, match="out_dtype"):
        remap_cuda.PreparedRemap(map_x, map_y, src_w=384, src_h=256,
                                 device=CPU)(SRC, out_dtype=torch.float16)
