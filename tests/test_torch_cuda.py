"""The CUDA kernels against their plain torch versions on the card, at
small and ragged shapes: planarize (every variant and path: aligned,
ragged, offset views, H past 65535; planes and RGBX texels), the warp and
the remap with every source layout (texels, u8 and f32 planes) and every
store (f32, and u8 / u16 bitwise the plain quantize of the f32 store), the
warp on the yaw ring and the tilted,
pole and fisheye geometry of the ``tests/test_warp_pallas.py`` parity
cases of ``_warp_kernel``, ``_warp_kernel_wide3``, ``_warp_kernel_wide2``,
``_warp_kernel_wide`` and ``_warp_kernel_yaw``), and the remap
(``chip_smoke.py`` covers the main paths' full shapes); the batched warp
launch (a frame axis: every source layout, store, projection and interp,
1-4 frames, four 8K frames) bitwise the single-frame launches, and the
batched wrapper bitwise its per-frame calls; and the slice's
new paths on the card against the same code on the CPU (rtol 1e-4): the
fisheye→perspective maps through ``remap.cu``, the planar ``.cube`` apply,
the FrameSelector gray (bitwise) and ``score_frame`` for every metric, and
both optical flows; the 14 ``micro_ops`` kernels against their plain
versions (movers bitwise, arithmetic at 1e-6, the products, three TF32
passes on the tensor cores, at 1e-5 a step and at most 8 steps), the
grid-invariant and repeated blocks of the products, the composite, the
(64,128) gather, concat, the counted loop, the (8,128) mul and where
(these two bitwise at their check depths over grids 1, 11 and 2048), the
SASS instructions ``SASS_CHECKS`` asks for; and MaskSeg's device
steps against the CPU: the U-Net's logits with TF32 off (1e-3), the
morphology bitwise, the blur (1e-6), the inpaint (1e-5) and
``combined_mask``; video mode's host pack of an RGBX block (the kernel
library's loop) bitwise numpy's; the training step by
both conv routes against the CPU and over two replicas on the card
against one; ``maybe_trace`` around a warp, its trace holding the
launched kernels; and the voxel count and picks on a
200,000-point cloud against the CPU and over two card runs; and
dualfisheye's mask co-warp at 3840² with the SFM10 maps against
``portbench/reference/mask.py``. Marked
``cuda``: each test skips without a card. On a machine
with one, run (the JAX-side conftest is not needed)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from gs360x_torch.core import color as colorlib
from gs360x_torch.kernels import flow as flowk
from gs360x_torch.kernels import micro_ops_cuda as mo
from gs360x_torch.kernels import remap_cuda, warp_cuda
from gs360x_torch.kernels import sharpness as sharp
from gs360x_torch.kernels import warp as twin
from gs360x_torch.tools import frameselector, video2frames

CPU = torch.device("cpu")
RTOL = 1e-4

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


# (id, H, W, storage offset in elements, takes the vector path): H·W a
# multiple of the pixels per chunk (16 for a u8 output, 4 for f32) on an
# aligned base goes vector; an odd H·W or an offset view goes scalar.
# W < 4 still goes vector (chunks span rows), and H = 65537 is past the
# 65535 rows a y grid dimension could hold.
PLANARIZE_SHAPES = [
    ("vector_64x768", 64, 768, 0, True),
    ("scalar_37x301", 37, 301, 0, False),
    ("offset_view_64x768", 64, 768, 1, False),
    ("w_lt_p_16x3", 16, 3, 0, True),
    ("h65537_x16", 65537, 16, 0, True),
]


def _planarize_cases():
    for sid, h, w, offset, vector in PLANARIZE_SHAPES:
        variants = ("auto", *warp_cuda.PLANARIZE_VARIANTS) if vector \
            else ("auto", "scalar")
        for variant in variants:
            yield pytest.param(h, w, offset, vector, variant,
                               id=f"{sid}-{variant}")


def _offset_rows(dtype, h, w, offset, dev):
    """(H, 3·W) rows of ``dtype``: a contiguous view ``offset`` elements
    into its storage, so its base is not 16-byte aligned when offset > 0."""
    flat = _rows(dtype, 1, h * w + 1, dev).reshape(-1)
    return flat[offset:offset + 3 * h * w].view(h, 3 * w)


@pytest.mark.parametrize("h,w,offset,vector,variant", _planarize_cases())
@pytest.mark.parametrize("dtype,scale,u8_out", [
    (np.uint8, 1.0, True), (np.uint8, 1.0 / 255.0, False),
    (np.uint16, 1.0 / 65535.0, False), (np.float32, 1.0, False)])
def test_planarize_kernel_bitwise_equals_plain(dev, dtype, scale, u8_out, h,
                                               w, offset, vector, variant):
    rows = _offset_rows(dtype, h, w, offset, dev)
    assert rows.is_contiguous() and rows.storage_offset() == offset
    out_dtype = torch.uint8 if u8_out else torch.float32
    before = warp_cuda.LAUNCHES["planarize"]
    got = warp_cuda.planarize_rows(rows, scale, out_dtype, variant=variant)
    ref = warp_cuda.planarize_rows_plain(rows, scale, out_dtype)
    torch.cuda.synchronize()
    assert warp_cuda.LAUNCHES["planarize"] == before + 1
    assert got.shape == ref.shape == (3, h, w)
    assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    assert (warp_cuda.planarize_variant(rows, got) != "scalar") == vector


def test_planarize_vector_variants_refuse_ragged_input(dev):
    for rows in (_rows(np.uint8, 37, 301, dev),
                 _offset_rows(np.uint8, 64, 768, 1, dev)):
        with pytest.raises(RuntimeError, match="planarize"):
            warp_cuda.planarize_rows(rows, 1.0, torch.uint8, variant="regs")
        with pytest.raises(RuntimeError, match="planarize"):
            warp_cuda.texelize_rows(rows, variant="regs")


@pytest.mark.parametrize("h,w,offset,vector,variant", _planarize_cases())
def test_texelize_kernel_bitwise_equals_plain(dev, h, w, offset, vector,
                                              variant):
    # the texel mode's chunk is 4 pixels: the shapes that go vector for a
    # u8 planar output (H·W a multiple of 16) go vector here too
    rows = _offset_rows(np.uint8, h, w, offset, dev)
    before = warp_cuda.LAUNCHES["planarize"]
    got = warp_cuda.texelize_rows(rows, variant=variant)
    ref = warp_cuda.texelize_rows_plain(rows)
    torch.cuda.synchronize()
    assert warp_cuda.LAUNCHES["planarize"] == before + 1
    assert got.shape == ref.shape == (h, w, 4) and got.dtype == torch.uint8
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got, ref)
    assert (warp_cuda.planarize_variant(rows, got) != "scalar") == vector


QUANT = [torch.uint8, torch.uint16]


def _assert_quantizing_stores(launch, got):
    """``launch(out_dtype)`` with a u8 / u16 store is bitwise the plain
    quantize of the same launch's f32 store ``got``."""
    for out_dtype in QUANT:
        q = launch(out_dtype)
        assert q.dtype == out_dtype and q.shape == got.shape
        assert torch.equal(q, warp_cuda.quantize_plain(got, out_dtype))


def _assert_source_layouts_agree(rows, got, angles, kw):
    """The f32 views of a u8 frame (texels) are bitwise those of its u8
    planes, and a texel view that is not contiguous is copied, not read
    misaligned."""
    planes = warp_cuda.planarize_rows(rows, 1.0, torch.uint8)
    assert torch.equal(warp_cuda.warp_planes(planes, *angles, **kw), got)
    texels = warp_cuda.texelize_rows(rows)
    wide = torch.zeros((texels.shape[0], texels.shape[1] + 1, 4),
                       dtype=torch.uint8, device=rows.device)
    wide[:, 1:] = texels
    assert torch.equal(warp_cuda.warp_texels(wide[:, 1:], *angles, **kw), got)


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
    _assert_quantizing_stores(
        lambda dt: warp_cuda.warp_equirect_to_views_cuda(
            rows, RING, zeros, zeros, out_dtype=dt, **kw), got)
    if dtype == np.uint8:
        kw.pop("planar")
        _assert_source_layouts_agree(rows, got, (RING, zeros, zeros), kw)


def test_warp_kernel_reflects_over_the_poles(dev):
    # views with taps past both poles, through the planar launcher
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


def _lsb(x):
    return torch.round(x.clamp(0, 1) * 255)


# (id, source (w, h), view kwargs, yaws, pitches, rolls, projection,
#  interp, pole): the tests/test_warp_pallas.py parity cases at the lines
#  named (the same list as tests/test_torch_warp.py::GEOMETRY)
_KW = dict(width=256, height=128, hfov_deg=100.0, vfov_deg=60.0)
_FKW = dict(width=128, height=128, hfov_deg=180.0, vfov_deg=180.0)
GEOMETRY = [
    ("seam_straddle_45", (512, 256), _KW, [180.0], [0.0], [0.0],
     "perspective", "bicubic", False),
    ("poles_167", (512, 256), _KW, [0.0, 0.0, 0.0, 0.0],
     [90.0, -90.0, 75.0, -75.0], [0.0] * 4, "perspective", "bicubic", True),
    ("pole_with_seam_174", (512, 256), _KW, [180.0], [88.0], [30.0],
     "perspective", "bicubic", True),
    ("extreme_slope_181", (512, 256),
     dict(width=256, height=128, hfov_deg=150.0, vfov_deg=70.0),
     [45.0], [0.0], [0.0], "perspective", "bicubic", False),
    ("fisheye_front_back_261", (512, 256), _FKW, [0.0, 180.0], [0.0, 0.0],
     [0.0, 0.0], "fisheye_v360", "bilinear", True),
    ("equisolid_front_back_261", (512, 256), _FKW, [0.0, 180.0],
     [0.0, 10.0], [0.0, 5.0], "equisolid", "bicubic", True),
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
    ("yaw_ring_v1_734", (512, 256), dict(width=250, height=131,
                                         hfov_deg=90.0, vfov_deg=60.0),
     [0.0, 45.0, 180.0, 300.0], [0.0] * 4, [0.0] * 4, "perspective",
     "bilinear", False),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize(
    "src_wh,kw,yaws,pitches,rolls,projection,interp,pole",
    [pytest.param(*case[1:], id=case[0]) for case in GEOMETRY])
def test_tilted_pole_fisheye_kernel_matches_plain(
        dev, dtype, src_wh, kw, yaws, pitches, rolls, projection, interp,
        pole):
    rows = _pano(dtype, src_wh[1], src_wh[0], dev)
    before = dict(warp_cuda.LAUNCHES)
    got = warp_cuda.warp_equirect_to_views_cuda(
        rows, yaws, pitches, rolls, projection=projection, interp=interp,
        planar=True, **kw)
    ref = warp_cuda.warp_equirect_to_views_plain(
        rows, yaws, pitches, rolls, projection=projection, interp=interp,
        planar=True, **kw)
    torch.cuda.synchronize()
    assert warp_cuda.LAUNCHES["warp"] == before["warp"] + 1
    assert got.shape == ref.shape == (len(yaws), 3, kw["height"],
                                      kw["width"])
    assert bool(torch.isfinite(got).all())
    if projection != "perspective":
        # the image circle is bitwise the plain version's: 0 outside
        assert torch.equal((got == 0).all(dim=1), (ref == 0).all(dim=1))
    lsb = (_lsb(got) - _lsb(ref)).abs()
    assert float(lsb.max()) <= (2 if pole else 1)
    assert float((lsb > 1).float().mean()) <= 0.01
    if not pole:
        # the tolerance of the Pallas-vs-twin parity tests
        assert float((got - ref).abs().max()) <= 1e-4
    _assert_quantizing_stores(
        lambda dt: warp_cuda.warp_equirect_to_views_cuda(
            rows, yaws, pitches, rolls, projection=projection, interp=interp,
            planar=True, out_dtype=dt, **kw), got)
    if dtype == np.uint8:
        _assert_source_layouts_agree(
            rows, got, (yaws, pitches, rolls),
            dict(projection=projection, interp=interp, **kw))


# the batched launch: (projection, view kwargs, yaws, pitches, rolls) of
# 3 views with a seam view, a pitched and a rolled one
BATCH_VIEWS = {
    "perspective": (dict(width=40, height=24, hfov_deg=100.0,
                         vfov_deg=70.0), [0.0, 180.0, 300.0],
                    [0.0, 30.0, -70.0], [0.0, 10.0, 0.0]),
    "fisheye_v360": (dict(width=32, height=32, hfov_deg=180.0,
                          vfov_deg=180.0), [0.0, 180.0, 90.0],
                     [0.0, 0.0, 45.0], [0.0, 0.0, 5.0]),
    "equisolid": (dict(width=32, height=32, hfov_deg=190.0,
                       vfov_deg=190.0), [0.0, 180.0, 90.0],
                  [0.0, 10.0, -45.0], [0.0, 5.0, 0.0]),
}


def _batch_sources(source, rows):
    """(B, ...) batch and [per-frame sources] of one layout, both from one
    source pass: texels (B, H, W, 4), u8 or f32 planes (B, 3, H, W) with
    plane stride B·H·W (one ``planarize_rows`` over the B·H rows)."""
    n, h, w3 = rows.shape
    flat = rows.reshape(n * h, w3)
    if source == "texels":
        return (warp_cuda.texelize_rows(flat).view(n, h, w3 // 3, 4),
                [warp_cuda.texelize_rows(r) for r in rows], warp_cuda.warp_texels)
    dtype, scale = ((torch.uint8, 1.0) if source == "u8 planes"
                    else (torch.float32, 1.0 / 255.0))
    planes = warp_cuda.planarize_rows(flat, scale, dtype)
    return (planes.view(3, n, h, w3 // 3).transpose(0, 1),
            [warp_cuda.planarize_rows(r, scale, dtype) for r in rows],
            warp_cuda.warp_planes)


@pytest.mark.parametrize("interp", ["bicubic", "bilinear"])
@pytest.mark.parametrize("projection", list(BATCH_VIEWS))
@pytest.mark.parametrize("out_dtype", [None, torch.uint8, torch.uint16])
@pytest.mark.parametrize("source", ["texels", "u8 planes", "f32 planes"])
def test_batched_warp_launch_bitwise_equals_single_frame_launches(
        dev, source, out_dtype, projection, interp):
    rows = torch.stack([_rows(np.uint8, 96, 192, dev, seed=s)
                        for s in range(4)])
    batch, singles, launch = _batch_sources(source, rows)
    view_kw, *angles = BATCH_VIEWS[projection]
    kw = dict(projection=projection, interp=interp, out_dtype=out_dtype,
              **view_kw)
    ref = [launch(single, *angles, **kw) for single in singles]
    for n in (1, 2, 4):
        before = warp_cuda.LAUNCHES["warp"]
        got = launch(batch[:n], *angles, **kw)
        torch.cuda.synchronize()
        assert warp_cuda.LAUNCHES["warp"] == before + 1
        assert got.shape == (n, 3, 3, view_kw["height"], view_kw["width"])
        for f in range(n):
            assert torch.equal(got[f], ref[f]), (source, n, f)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_batched_wrapper_bitwise_equals_per_frame_calls(dev, dtype, planar):
    rows = torch.stack([_rows(dtype, 64, 128, dev, seed=10 + s)
                        for s in range(3)])
    kw = dict(width=48, height=32, hfov_deg=90.0, vfov_deg=70.0,
              interp="bicubic", planar=planar)
    angles = ([0.0, 180.0], [0.0, 20.0], [0.0, 0.0])
    for out_dtype in (None, torch.uint8, torch.uint16):
        before = dict(warp_cuda.LAUNCHES)
        got = warp_cuda.warp_equirect_to_views_cuda(
            rows, *angles, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        # one source pass and one warp for the batch
        assert warp_cuda.LAUNCHES == {"planarize": before["planarize"] + 1,
                                      "warp": before["warp"] + 1}
        for f in range(3):
            assert torch.equal(got[f], warp_cuda.warp_equirect_to_views_cuda(
                rows[f], *angles, out_dtype=out_dtype, **kw))


def test_batched_launch_of_four_8k_frames_past_2gb(dev):
    # four 8K texel frames are 472 MB and four f32 plane sets 1.6 GB: a
    # frame offset held in 32 bits would corrupt frames 2-3
    h, w = 3840, 7680
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randint(0, 256, (4, h, 3 * w), generator=gen,
                         dtype=torch.uint8, device=dev)
    angles = ([10.0, 190.0], [0.0, -30.0], [0.0, 0.0])
    kw = dict(width=64, height=48, hfov_deg=90.0, vfov_deg=70.0,
              interp="bicubic", planar=True)
    for src in (rows, (rows.to(torch.int32) * 257).to(torch.uint16)):
        got = warp_cuda.warp_equirect_to_views_cuda(src, *angles, **kw)
        for f in range(4):
            assert torch.equal(got[f], warp_cuda.warp_equirect_to_views_cuda(
                src[f], *angles, **kw)), f
        del got


def test_batched_launch_refuses_more_than_a_grid_of_frame_views(dev):
    rows = torch.zeros((2, 8, 48), dtype=torch.uint8, device=dev)
    many = [0.0] * 32768
    before = dict(warp_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="65535"):
        warp_cuda.warp_equirect_to_views_cuda(
            rows, many, many, many, width=4, height=4, hfov_deg=90.0,
            vfov_deg=90.0)
    texels = warp_cuda.texelize_rows(rows.reshape(16, 48)).view(2, 8, 16, 4)
    with pytest.raises(ValueError, match="65535"):
        warp_cuda.warp_texels(texels, many, many, many, width=4, height=4,
                              hfov_deg=90.0, vfov_deg=90.0)
    assert warp_cuda.LAUNCHES["warp"] == before["warp"]


def _barrel_maps(h, w, src_h, src_w, shift):
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    nx = (xx - w / 2) / w
    ny = (yy - h / 2) / h
    r2 = nx * nx + ny * ny
    return ((xx * (1 + 0.08 * r2) + shift[0]).astype(np.float32),
            (yy * (1 + 0.08 * r2) + shift[1]).astype(np.float32))


@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bicubic",
                                    "catmull-rom"])
@pytest.mark.parametrize("dtype,channels", [(np.uint8, 3), (np.float32, 3),
                                            (np.uint8, 1)])
def test_remap_kernel_matches_plain(dev, interp, dtype, channels):
    # three ragged maps over one source, with taps past every edge and an
    # invalid band each (fill), in one launch
    src_h, src_w = 97, 203
    maps = []
    for k, shift in enumerate([(-30.0, -20.0), (60.0, 10.0),
                               (150.0, 70.0)]):
        mx, my = _barrel_maps(45, 77, src_h, src_w, shift)
        valid = np.ones(mx.shape, bool)
        valid[k * 9:k * 9 + 5] = False
        maps.append((mx, my, valid))
    rng = np.random.default_rng(3)
    shape = (src_h, src_w) if channels == 1 else (src_h, src_w, 3)
    src = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8
           else rng.random(shape, dtype=np.float32))
    batch = remap_cuda.PreparedRemapBatch(maps, src_w=src_w, src_h=src_h,
                                          interp=interp, device=dev)
    planes = remap_cuda.source_planes(src, src_h, src_w, dev)
    before = remap_cuda.LAUNCHES["remap"]
    got = batch(planes, fill=0.3)
    ref = remap_cuda.remap_planes_plain(planes, batch.map_x, batch.map_y,
                                        batch.valid, interp=interp, fill=0.3)
    torch.cuda.synchronize()
    assert remap_cuda.LAUNCHES["remap"] == before + 1
    assert got.shape == ref.shape == (3, channels, 45, 77)
    assert float((got - ref).abs().max()) <= 1e-5
    assert float((_lsb(got) - _lsb(ref)).abs().max()) <= 1
    # one map through PreparedRemap equals its row of the batch
    single = remap_cuda.PreparedRemap(*maps[1], src_w=src_w, src_h=src_h,
                                      device=dev)(planes, interp=interp,
                                                  fill=0.3)
    assert torch.equal(single, got[1])
    # the quantizing stores (fill included), and for a u8 RGB image the
    # texel source against its planes
    _assert_quantizing_stores(
        lambda dt: batch(planes, fill=0.3, out_dtype=dt), got)
    if dtype == np.uint8 and channels == 3:
        texels = remap_cuda.remap_source(src, src_h, src_w, dev)
        assert texels.shape == (src_h, src_w, 4)
        before = remap_cuda.LAUNCHES["remap"]
        assert torch.equal(batch(texels, fill=0.3), got)
        assert remap_cuda.LAUNCHES["remap"] == before + 1
        _assert_quantizing_stores(
            lambda dt: batch(texels, fill=0.3, out_dtype=dt), got)


@pytest.mark.parametrize("model", ["equidistant", "equisolid"])
def test_fisheye_perspective_remap_matches_plain(dev, model):
    # Video2Frames' --fisheye-perspective: maps built on the card, one
    # remap.cu launch, against the plain version on the CPU over the same
    # maps; the card's maps against the CPU's at 1e-4 px, the rim's
    # validity apart only where |r - 1| < 1e-6
    rng = np.random.default_rng(4)
    src = rng.random((3, 120, 160), dtype=np.float32)
    cut = video2frames.FisheyeCut(96, 100.0, 190.0, model, dev)
    before = remap_cuda.LAUNCHES["remap"]
    got = cut(torch.from_numpy(src).to(dev))
    torch.cuda.synchronize()
    assert remap_cuda.LAUNCHES["remap"] == before + 1
    prep = cut.prepared(120, 160)
    maps = [t[0].cpu() for t in (prep.map_x, prep.map_y, prep.valid)]
    ref = remap_cuda.remap_planes_plain(
        torch.from_numpy(src), *[m[None] for m in maps], interp="bicubic",
        fill=0.0)[0]
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=RTOL,
                               atol=1e-5)
    u, v, valid = twin.fisheye_perspective_maps(96, 100.0, 190.0, model,
                                                160, 120)
    assert float((maps[0] - u).abs().max()) <= 1e-4
    assert float((maps[1] - v).abs().max()) <= 1e-4
    assert int((maps[2] != valid).sum()) <= 8


def test_video2frames_frame_matches_cpu(dev):
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    for keep in (False, True):
        got = video2frames.frame_to_device(frame, device=dev,
                                           keep_rec709=keep, fisheye=None,
                                           bits=8)
        ref = video2frames.frame_to_device(frame, device=CPU,
                                           keep_rec709=keep, fisheye=None,
                                           bits=8)
        diff = (got.cpu().int() - ref.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) <= 0.001


@pytest.mark.parametrize("n", [2, 17, 33])
def test_apply_cube_lut_planar_matches_cpu(dev, n):
    rng = np.random.default_rng(n)
    table = rng.random((n, n, n, 3), dtype=np.float32)
    lut = colorlib.CubeLUT(size=n, table=table)
    planes = rng.uniform(-0.05, 1.05, (3, 57, 91)).astype(np.float32)
    got = colorlib.apply_cube_lut_planar(
        torch.from_numpy(planes).to(dev), lut,
        colorlib.lut_table(lut, dev))
    ref = colorlib.apply_cube_lut_planar(torch.from_numpy(planes), lut)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_frameselector_gray_bitwise_matches_cpu(dev, dtype):
    rng = np.random.default_rng(6)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (75, 131, 3), dtype=dtype)
    got = frameselector.device_gray(img, dev)
    ref = frameselector.device_gray(img, CPU)
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("metric", list(sharp.METRICS))
@pytest.mark.parametrize("use_mask", [False, True])
def test_score_frame_matches_cpu(dev, metric, use_mask):
    rng = np.random.default_rng(7)
    gray = (rng.random((96, 160)) * 255).astype(np.float32)
    mask = sharp.circle_mask(96, 160)
    got = sharp.score_frame(torch.from_numpy(gray).to(dev), mask.to(dev),
                            metric=metric, use_mask=use_mask)
    ref = sharp.score_frame(torch.from_numpy(gray), mask, metric=metric,
                            use_mask=use_mask)
    for g, r in zip(got, ref):
        assert float(g) == pytest.approx(float(r), rel=RTOL, abs=1e-6)


def _flow_pair(shape, shift, seed):
    rng = np.random.default_rng(seed)
    img = rng.random(shape) * 255
    p = np.pad(img, 2, mode="edge")
    img = sum(p[i:i + shape[0], j:j + shape[1]]
              for i in range(5) for j in range(5)) / 25.0
    img = img.astype(np.float32)
    return img, np.roll(img, shift, (0, 1))


@pytest.mark.parametrize("method", ["lucas_kanade", "farneback"])
def test_flows_match_cpu(dev, method):
    prev, curr = _flow_pair((115, 192), (3, 5), 8)
    fn = (flowk.mean_flow_magnitude if method == "lucas_kanade"
          else flowk.mean_flow_magnitude_farneback)
    got = fn(torch.from_numpy(prev).to(dev), torch.from_numpy(curr).to(dev))
    ref = fn(torch.from_numpy(prev), torch.from_numpy(curr))
    assert got == pytest.approx(ref, rel=RTOL, abs=1e-4)
    if method == "farneback":
        f_dev = flowk.farneback_flow(torch.from_numpy(prev).to(dev),
                                     torch.from_numpy(curr).to(dev))
        f_cpu = flowk.farneback_flow(torch.from_numpy(prev),
                                     torch.from_numpy(curr))
        np.testing.assert_allclose(f_dev.cpu().numpy(), f_cpu.numpy(),
                                   rtol=RTOL, atol=1e-3)
    else:
        pts, valid = flowk.shi_tomasi_corners(torch.from_numpy(prev).to(dev))
        ref_pts, ref_valid = flowk.shi_tomasi_corners(torch.from_numpy(prev))
        assert torch.equal(valid.cpu(), ref_valid)
        assert torch.equal(pts.cpu()[valid.cpu()], ref_pts[ref_valid])


# --- micro_ops: every primitive's kernel against its plain version ----------

@pytest.mark.parametrize("loops", [1, 4, 8])
@pytest.mark.parametrize("key", list(mo.OPS))
def test_micro_op_kernel_matches_plain(dev, key, loops):
    op = mo.OPS[key]
    inputs = mo.make_inputs(dev)
    tensors = [inputs[name] for name in op.inputs]
    mo.reset_counters()
    got = mo.micro_op(key, tensors, loops, grid=7)
    torch.cuda.synchronize()
    assert mo.LAUNCHES["micro_ops"] == 1 and mo.PLAIN_CALLS["micro_ops"] == 0
    assert mo.OP_LAUNCHES[key] == 1
    ref = op.plain(*tensors, loops)
    assert got.shape == ref.shape == op.out_shape and got.dtype == ref.dtype
    assert bool(torch.isfinite(got).all())
    tol = mo.rel_tolerance(key, loops)
    if tol == 0.0:
        assert torch.equal(got, ref)
    else:
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("key", ["chunk", "gather_lane64", "matmul64",
                                 "matmul8", "concat", "loop", "where",
                                 "mul8", "gather_lane8"])
def test_micro_op_grid_and_zero_reps(dev, key):
    """Every block stores the same block: the grid does not enter the
    result, and a second launch repeats it bit for bit; zero applications
    return the primitive's start value (``x`` for the products)."""
    op = mo.OPS[key]
    inputs = mo.make_inputs(dev)
    tensors = [inputs[n] for n in op.inputs]
    one = mo.micro_op(key, tensors, 2, grid=1)
    many = mo.micro_op(key, tensors, 2, grid=300)
    again = mo.micro_op(key, tensors, 2, grid=300)
    assert torch.equal(one, many)
    assert torch.equal(many, again)
    assert torch.equal(mo.micro_op(key, tensors, 0, grid=300),
                       op.plain(*tensors, 0))
    assert torch.equal(mo.micro_op("mul8", [inputs["a8"]], 0), inputs["a8"])
    assert torch.equal(mo.micro_op("gather_sub8",
                                   [inputs["a8"], inputs["ridx8"]], 0),
                       torch.zeros_like(inputs["a8"]))


@pytest.mark.parametrize("key", ["where", "mul8", "gather_lane8"])
def test_micro_op_warp_chains_at_the_check_loops(dev, key):
    """where, the (8,128) mul and the (8,128) gather, a warp a chain:
    bitwise their plain
    versions at every depth of ``CHECK_LOOPS``, on grids 1, 11 (a ragged
    block) and 2048, and over two launches."""
    op = mo.OPS[key]
    inputs = mo.make_inputs(dev)
    tensors = [inputs[n] for n in op.inputs]
    for loops in mo.CHECK_LOOPS[key]:
        ref = op.plain(*tensors, loops)
        for grid in (1, 11, mo.GRID, mo.GRID):
            assert torch.equal(mo.micro_op(key, tensors, loops, grid), ref)


def test_micro_op_sass_counts(dev):
    """The built library holds what ``SASS_CHECKS`` asks: the products'
    HGMMA, one FADD (concat, loop, gather_lane8) or FMUL (mul8, where) for
    each element a thread holds, no FSEL in where and no BAR in
    gather_lane8."""
    from gs360x_torch.kernels import _build
    rows = mo.sass_checks(_build.sass_counts(mo.SASS_OPCODES))
    assert {row[0] for row in rows} == set(mo.SASS_CHECKS)
    assert all(row[4] for row in rows), [row[:4] for row in rows]


def test_micro_op_products_run_at_the_benchmark_depth(dev):
    """64 dependent products overflow f32 in the plain version and in the
    kernel alike; the kernel still launches and returns."""
    inputs = mo.make_inputs(dev)
    out = mo.micro_op("matmul8", [inputs["a8"], inputs["a128"]], mo.OP_REPS,
                      grid=4)
    torch.cuda.synchronize()
    assert out.shape == (8, 128) and not bool(torch.isfinite(out).all())


def test_micro_op_refuses_mixed_devices(dev):
    inputs = mo.make_inputs(dev)
    with pytest.raises(ValueError):
        mo.micro_op("where", [inputs["a8"], inputs["ridx8"].cpu()], 2)


# --- the segmentation U-Net, morphology and MaskSeg's predictor -------------

@pytest.fixture(scope="module")
def shipped_state():
    from gs360x_torch.models import synthseg
    return synthseg.load_packaged_weights()


def test_unet_matches_cpu_with_tf32_off(dev, shipped_state):
    """The U-Net's logits on the card within 1e-3 of the CPU's at the
    inference size of a 1920×1080 view, TF32 off inside ``logits`` and the
    process's flag as it was afterwards; the class argmax equal wherever
    the CPU's top two logits lie more than twice that apart."""
    from gs360x_torch.models import segmentation as seg
    x = torch.from_numpy(np.random.default_rng(9).random(
        (1, 3, 576, 1024), dtype=np.float32))
    before = torch.backends.cudnn.allow_tf32
    got = seg.SegmentationPredictor(shipped_state, device=dev).logits(
        x.to(dev)).cpu()
    ref = seg.SegmentationPredictor(shipped_state, device=CPU).logits(x)
    assert torch.backends.cudnn.allow_tf32 == before
    assert float((got - ref).abs().max()) <= 1e-3
    top2 = ref.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2e-3
    assert torch.equal(got.argmax(1)[clear], ref.argmax(1)[clear])


@pytest.mark.parametrize("k", [1, 4, 5, 31, 51])
def test_morphology_bitwise_matches_cpu(dev, k):
    from gs360x_torch.kernels import morphology as morph
    m = torch.from_numpy(np.random.default_rng(k).random((301, 457)) < 0.02)
    for fn in (morph.dilate, morph.erode, morph.close_mask):
        assert torch.equal(fn(m.to(dev), k).cpu(), fn(m, k))


def test_blur_and_inpaint_match_cpu(dev):
    from gs360x_torch.kernels import morphology as morph
    rng = np.random.default_rng(10)
    luma = torch.from_numpy(rng.random((120, 200), dtype=np.float32))
    got = morph.gaussian_blur(luma.to(dev), 7.0, 10).cpu()
    assert float((got - morph.gaussian_blur(luma, 7.0, 10)).abs().max()) \
        <= 1e-6
    img = torch.from_numpy(rng.random((120, 200, 3), dtype=np.float32))
    mask = torch.from_numpy(rng.random((120, 200)) < 0.3)
    got = morph.diffusion_inpaint(img.to(dev), mask.to(dev)).cpu()
    ref = morph.diffusion_inpaint(img, mask)
    assert float((got - ref).abs().max()) <= 1e-5


def test_combined_mask_matches_cpu(dev, shipped_state):
    """``SegmentationPredictor.combined_mask`` on the card against the CPU
    on photo-style scenes: equal, or apart only where the CPU's
    probability lies within 1e-4 of the mask threshold."""
    from gs360x_torch.models import segmentation as seg
    from gs360x_torch.models import synthseg
    card = seg.SegmentationPredictor(shipped_state, device=dev)
    cpu = seg.SegmentationPredictor(shipped_state, device=CPU)
    rng = np.random.default_rng(11)
    found = 0
    for size in (80, 160, 700):
        img, _ = synthseg.generate_scene(rng, size=size, photo_style=True)
        got = card.combined_mask(img, ["person"], score_thresh=0.5)
        ref = cpu.combined_mask(img, ["person"], score_thresh=0.5)
        if ref is None or got is None:
            assert got is None and ref is None
            continue
        found += 1
        p = cpu.probabilities(img, [seg.CLASS_TO_INDEX["person"]])[0]
        band = (p - seg.MASK_THRESH).abs().numpy() < 1e-4
        assert not ((got != ref) & ~band).any()
    assert found


# --- the training step and the voxel path ------------------------------------

def test_train_step_matches_cpu(dev):
    """Three steps at features (8, 16), 32², batch 2, fg_weight 4 by the
    training conv route (cuDNN, TF32 off) from the same weights as three
    steps on the CPU: the losses within 1e-5
    relative of the CPU's, step 1's gradients within 1e-5 of the largest,
    and the parameters within 2e-6 wherever step 1's gradient is above
    1e-4 of the largest (Adam moves rounding noise by ±lr)."""
    from gs360x_torch.models import segmentation as seg
    params = seg.init_params(torch.Generator().manual_seed(0), (8, 16))
    card = seg.create_train_state(None, 1e-3, (8, 16), device=dev,
                                  params=params)
    cpu = seg.create_train_state(None, 1e-3, (8, 16), device=CPU,
                                 params=params)
    rng = np.random.default_rng(12)
    for step in range(3):
        im = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
        lb = torch.from_numpy(rng.integers(0, 10, (2, 32, 32)))
        got = float(seg.train_step(card, im.to(dev), lb.to(dev), 4.0))
        ref = float(seg.train_step(cpu, im, lb, 4.0))
        assert abs(got - ref) <= 1e-5 * ref
        if step == 0:
            grads = {n: p.grad.clone() for n, p in
                     cpu.model.named_parameters()}
            gmax = max(float(g.abs().max()) for g in grads.values())
            for n, p in card.model.named_parameters():
                assert float((p.grad.cpu() - grads[n]).abs().max()) \
                    <= 1e-5 * gmax, n
    got, ref = card.model.state_dict(), cpu.model.state_dict()
    for n, g in grads.items():
        keep = g.abs() >= 1e-4 * gmax
        if keep.any():
            assert float((got[n].cpu() - ref[n]).abs()[keep].max()) \
                <= 2e-6, n


def test_two_replica_step_on_one_card_matches_one_replica(dev,
                                                         monkeypatch):
    """Three steps of features (8, 16), 32², batch 4, fg_weight 4 over a
    mesh of two replicas on the one card against a mesh of one, by the
    im2col route (the same convolutions at either block size): the losses
    within 1e-5 relative, step 1's gradients within 5e-4 of the largest
    (``chip_smoke.py`` ``[segtrain]`` (e)'s gates); the replica holds the
    first's weights bitwise after each step."""
    from gs360x_torch.models import segmentation as seg
    from gs360x_torch.runtime import mesh as meshlib
    monkeypatch.setattr(seg, "train_convs", seg.f32_convs)
    params = seg.init_params(torch.Generator().manual_seed(0), (8, 16))
    one = seg.create_train_state(None, 1e-3, (8, 16), params=params,
                                 mesh=meshlib.data_mesh([dev]))
    two = seg.create_train_state(None, 1e-3, (8, 16), params=params,
                                 mesh=meshlib.data_mesh([dev, dev]))
    assert one.replicas == () and len(two.replicas) == 1
    rng = np.random.default_rng(14)
    for step in range(3):
        im = torch.from_numpy(rng.random((4, 32, 32, 3), dtype=np.float32))
        lb = torch.from_numpy(rng.integers(1, 10, (4, 32, 32)))
        lb[:2, :28] = 0                  # the shards' foreground differs
        got = float(seg.train_step(two, im.to(dev), lb.to(dev), 4.0))
        ref = float(seg.train_step(one, im.to(dev), lb.to(dev), 4.0))
        assert abs(got - ref) <= 1e-5 * ref
        if step == 0:
            grads = {n: p.grad.clone()
                     for n, p in one.model.named_parameters()}
            gmax = max(float(g.abs().max()) for g in grads.values())
            for n, p in two.model.named_parameters():
                assert float((p.grad - grads[n]).abs().max()) \
                    <= 5e-4 * gmax, n
        main = two.model.state_dict()
        assert all(torch.equal(v, main[k])
                   for k, v in two.replicas[0].state_dict().items())


def test_maybe_trace_holds_the_warp_launch(dev, tmp_path, monkeypatch):
    """One warp of a u8 frame (a texel pass and a warp launch) under
    ``maybe_trace``: the written trace holds those two kernels, as the
    launch counters count them, inside its window."""
    import re
    from gs360x_torch.runtime import profiling
    rows = _rows(np.uint8, 64, 128, dev)
    kw = dict(width=48, height=32, hfov_deg=90.0, vfov_deg=70.0,
              planar=True, out_dtype=torch.uint8)
    angles = ([0.0, 180.0], [0.0, 20.0], [0.0, 0.0])
    warp_cuda.warp_equirect_to_views_cuda(rows, *angles, **kw)  # build
    torch.cuda.synchronize()
    monkeypatch.setenv("GS360X_TRACE_DIR", str(tmp_path))
    before = dict(warp_cuda.LAUNCHES)
    with profiling.maybe_trace("warp"):
        warp_cuda.warp_equirect_to_views_cuda(rows, *angles, **kw)
        torch.cuda.synchronize()
    launched = {k: warp_cuda.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"planarize": 1, "warp": 1}
    got = profiling.read_trace(tmp_path, "warp")
    # names may be mangled, in an anonymous namespace: match the function
    names = [k[0] for k in got["kernels"]]
    assert sum("warp_equirect_kernel" in n for n in names) == 1, names
    assert sum(bool(re.search(r"(planarize|texelize)_(regs|scalar)", n))
               for n in names) == 1, names
    assert 0 < got["busy_us"] <= got["window_us"]


def test_pillow_rgbx_decode_is_the_texel_route_bitwise(dev, tmp_path):
    """An 8K frame and a 3840² lens decoded as Pillow's RGBX block (X =
    255, ``read_image(..., texels=True)``) and uploaded as they are:
    perspcut's ``default`` views (``executor._warp_frame_views``, u8
    store) and the 10 SFM10 remaps bitwise those of the packed (H, W, 3)
    decode through ``texelize_rows`` (X = 0), with one texel pass fewer."""
    import pathlib
    from PIL import Image
    from gs360x_torch import templates
    from gs360x_torch.io import image as imagelib
    from gs360x_torch.rig.presets import PerspCutConfig, build_view_plan
    from gs360x_torch.runtime import executor
    from gs360x_torch.tools import dualfisheye as df

    rng = np.random.default_rng(19)
    frame = rng.integers(0, 256, (3840, 7680, 3), dtype=np.uint8)
    Image.fromarray(frame).save(tmp_path / "f.jpg", quality=95,
                                subsampling=0)
    rgbx = imagelib.read_image(tmp_path / "f.jpg", texels=True)
    rgb = imagelib.read_image(tmp_path / "f.jpg")
    assert rgbx.shape == (3840, 7680, 4) and (rgbx[..., 3] == 255).all()
    views = build_view_plan(PerspCutConfig(preset="default"),
                            [pathlib.Path("f.jpg")],
                            pathlib.Path(".")).unique_views()
    runs = []
    for src in (rgbx, rgb):
        before = dict(warp_cuda.LAUNCHES)
        outs = executor._warp_frame_views(
            src, views, interp="bicubic", backend="auto", device=dev,
            quantize_bits=8)
        runs.append([out[j].cpu() for out, j in outs])
        runs[-1].append({k: warp_cuda.LAUNCHES[k] - before[k]
                         for k in before})
    assert runs[0][-1] == {"planarize": 0, "warp": 1}
    assert runs[1][-1] == {"planarize": 1, "warp": 1}
    assert all(torch.equal(a, b) for a, b in zip(runs[0][:-1],
                                                 runs[1][:-1]))

    lens = rng.integers(0, 256, (3840, 3840, 3), dtype=np.uint8)
    Image.fromarray(lens).save(tmp_path / "l.jpg", quality=95,
                               subsampling=0)
    rgbx = imagelib.read_image(tmp_path / "l.jpg", texels=True)
    rgb = imagelib.read_image(tmp_path / "l.jpg")
    assert rgbx.shape == (3840, 3840, 4)
    calib_path = templates.write_osmo360_default_calibration(
        tmp_path / "calib.xml")
    calib = next(iter(df.load_metashape_calibration(calib_path)[0]
                      .values()))
    maps = []
    for spec in df.build_sfm10_specs(256, 14.0, "36 36", 40.0, 40.0):
        mx, my, valid = df.build_direct_perspective_map(
            calib, spec["yaw_deg"], spec["pitch_deg"], spec["hfov_deg"],
            spec["vfov_deg"], 256, 256, 190.0)
        maps.append((mx, my, valid))
    batch = remap_cuda.PreparedRemapBatch(maps, src_w=3840, src_h=3840,
                                          interp="catmull-rom", device=dev)
    got = [batch(remap_cuda.remap_source(src, 3840, 3840, dev),
                 out_dtype=torch.uint8).cpu() for src in (rgbx, rgb)]
    assert got[0].shape == (10, 3, 256, 256)
    assert torch.equal(got[0], got[1])


def test_library_pack_is_the_numpy_pack(dev, tmp_path, monkeypatch):
    """The kernel library's host pack (``csrc/pack_rgb.cu``, video mode's
    route on a host with a card) bitwise numpy's strided copy (the route
    without one) on an 8K frame's RGBX block and on 1-9 pixels (the tail of
    n % 4); ``decode_jpeg_frame`` takes it here and gives Pillow's
    ``convert("RGB")``."""
    from PIL import Image
    from gs360x_torch.io import image as imagelib
    from gs360x_torch.io import video as videolib
    from gs360x_torch.kernels import _build

    rng = np.random.default_rng(24)
    frame = rng.integers(0, 256, (3840, 7680, 3), dtype=np.uint8)
    path = tmp_path / "f.jpg"
    Image.fromarray(frame).save(path, quality=95, subsampling=0)
    with Image.open(path) as im:
        rgbx = imagelib._decode_rgbx(im)
    assert rgbx is not None and rgbx.shape == (3840, 7680, 4)
    blocks = [rgbx] + [rng.integers(0, 256, (1, n, 4), dtype=np.uint8)
                       for n in range(1, 10)]
    for block in blocks:
        monkeypatch.setattr(videolib, "_LIBRARY_PACK",
                            _build.load().gs360x_pack_rgb)
        got = videolib._pack_rgb(block)
        monkeypatch.setattr(videolib, "_LIBRARY_PACK", False)
        assert np.array_equal(got, videolib._pack_rgb(block))
    monkeypatch.setattr(videolib, "_LIBRARY_PACK", None)
    got = videolib.decode_jpeg_frame(path.read_bytes())
    assert videolib._LIBRARY_PACK
    with Image.open(path) as im:
        assert np.array_equal(got, np.asarray(im.convert("RGB")))


@pytest.fixture(scope="module")
def cloud_200k():
    """200,000 points: noisy planes and a sphere with 3% outliers."""
    rng = np.random.default_rng(13)
    n = 200_000
    plane = rng.random((n // 2, 3)) * [20.0, 20.0, 0.0]
    plane[:, 2] = rng.normal(0.0, 0.02, n // 2)
    d = rng.normal(size=(n // 2 - n // 32, 3))
    sphere = d / np.linalg.norm(d, axis=1, keepdims=True) * 4.0 + 10.0
    out = rng.random((n // 32, 3)) * 25.0
    return np.concatenate([plane, sphere, out]).astype(np.float32)


@pytest.mark.parametrize("rep", ["first", "random", "center", "centroid"])
def test_voxel_path_matches_cpu(dev, cloud_200k, rep):
    """``unique_voxel_count`` equal to the CPU's; ``_voxel_reduce_impl``'s
    picks equal to the CPU's (centroid: apart only in near-tie voxels) and
    equal over two card runs."""
    from gs360x_torch import checks
    from gs360x_torch.kernels import voxel as vox
    xyz = torch.from_numpy(cloud_200k)
    lo = xyz.min(dim=0).values
    rand = torch.from_numpy(np.random.default_rng(0).random(
        len(xyz)).astype(np.float32))
    for v in (0.05, 0.2, 1.0):
        assert vox.unique_voxel_count(xyz.to(dev), v, lo.to(dev)) == \
            vox.unique_voxel_count(xyz, v, lo)
        keys = vox.grid_keys(xyz, v, lo)
        assert torch.equal(vox.grid_keys(xyz.to(dev), v, lo.to(dev)).cpu(),
                           keys)
        runs = [vox._voxel_reduce_impl(
            xyz.to(dev), keys.to(dev), rand.to(dev), representative=rep,
            xyz_min=lo.to(dev), voxel=v).sort().values.cpu()
            for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        ref = vox._voxel_reduce_impl(xyz, keys, rand, representative=rep,
                                     xyz_min=lo, voxel=v).sort().values
        if rep != "centroid":
            assert torch.equal(runs[0], ref)
            continue
        _differ, far = checks.centroid_pick_differences(
            cloud_200k, keys.numpy(), runs[0].numpy(), ref.numpy())
        assert far == 0


def test_mask_cowarp_at_full_size_matches_the_plain_reference(dev, tmp_path):
    """dualfisheye's mask co-warp at the benchmark cell's size: a seeded
    3840² MaskSeg-style mask a lens (``portbench``'s masked driver) through
    the SFM10 maps the tool builds, ``nearest`` over one u8 plane with the
    u8 store, one launch a lens (``_LensViews.render`` as the pair loop
    calls it): bitwise ``portbench/reference/mask.py`` over the same
    float32 maps, and equal to it over its float64 maps but where a
    coordinate lies within 0.1 px of a rounding tie (the tool builds its
    maps in float32, up to 0.079 px from float64 at this size)."""
    from gs360x_torch import templates
    from gs360x_torch.tools import dualfisheye as df
    from portbench import harness
    from portbench.reference import fisheye
    from portbench.reference import mask as maskref

    driver = harness.load_module(harness.HERE / "drivers"
                                 / "dualfisheye_masks.py")
    cfg = harness.load_json(harness.HERE / "configs"
                            / "dualfisheye-masks-osmo360-sfm10.json")
    traffic = harness.load_json(
        harness.HERE / "workloads"
        / "dualfisheye-masks.osmo360-sfm10.png-masks.json")
    params = dict(traffic["masks"], circle=traffic["scene"]["circle"])
    sensors, _ = df.load_metashape_calibration(
        templates.write_osmo360_default_calibration(tmp_path / "c.xml"))
    sid = next(iter(sensors))
    specs = df.build_sfm10_specs(1750, 14.0, "36 36", 40.0, 40.0)
    maps = df.build_perspective_spec_maps(sensors, sid, sid, specs, 0.0,
                                          180.0, 190.0)
    ref64 = fisheye.view_maps(cfg, torch.float64, dev)
    seen = set()
    for k, lens in enumerate("XY"):
        mask = driver.mask_image(25, k, 3840, params)
        src = torch.from_numpy(mask)
        ids = [s["view_id"] for s in specs
               if maps[s["view_id"]]["lens_key"] == lens]
        own = {v: tuple(torch.from_numpy(maps[v][key]).to(dev)
                        for key in ("map_x", "map_y", "valid"))
               for v in ids}
        views = df._LensViews(ids, [tuple(maps[v][key] for key in
                                          ("map_x", "map_y", "valid"))
                                    for v in ids], dev)
        before = remap_cuda.LAUNCHES["remap"]
        got = views.render(remap_cuda.source_planes(mask, 3840, 3840, dev),
                           (3840, 3840), "nearest", 0.0)
        assert remap_cuda.LAUNCHES["remap"] == before + 1
        assert got.shape == (len(ids), 1, 1750, 1750)
        for i, v in enumerate(ids):
            out = torch.from_numpy(got[i, 0]).to(dev)
            assert torch.equal(out, maskref.cowarp(src, own[v])), v
            _lens, *view_maps = ref64[v]
            ref = maskref.cowarp(src, tuple(view_maps))
            tie = maskref.near_tie(tuple(view_maps), 0.1)
            assert torch.equal(out[~tie], ref[~tie]), v
            seen |= set(out.unique().tolist())
    assert seen == {0, 255}
