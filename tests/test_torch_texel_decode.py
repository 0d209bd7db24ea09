"""``gs360x_torch.io.image.read_image(path, texels=True)``: an 8-bit RGB
file decodes into one block of Pillow's, handed out as (H, W, 4) RGBX
with no pack to RGB; every other file, and a Pillow without the block
allocator or the Arrow export, falls back to the packed decode. The array
owns the block for as long as it lives. perspcut's ``run_plan`` and
dualfisheye's ``main`` on the CPU write the same bytes as with the packed
decode forced (``tests/test_torch_dualfisheye.py`` holds the
dual-fisheye case; the card's texel route is in
``tests/test_torch_cuda.py``)."""

import gc
import math
import threading
import weakref

import numpy as np
import pytest
import torch
from PIL import Image

from gs360x_torch.io import image as tim
from gs360x_torch.rig.presets import build_view_plan
from gs360x_torch.runtime import executor
from gs360x_torch.tools import perspcut

torch.set_num_threads(1)

CPU = torch.device("cpu")
H, W = 37, 53   # odd: a row is no multiple of any block or SIMD width


def _rgb(seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _write(path, kind, seed=0):
    rgb = _rgb(seed)
    if kind == "jpg444":
        Image.fromarray(rgb).save(path, quality=98, subsampling=0)
    elif kind == "jpg420":
        Image.fromarray(rgb).save(path, quality=90, subsampling=2)
    elif kind == "png":
        Image.fromarray(rgb).save(path)
    elif kind == "tif":
        Image.fromarray(rgb).save(path, compression="tiff_deflate")
    elif kind == "tif-raw":
        Image.fromarray(rgb).save(path)
    elif kind == "L":
        Image.fromarray(rgb[..., 0]).save(path, quality=95)
    elif kind == "P":
        Image.fromarray(rgb).convert("P").save(path)
    elif kind == "RGBA":
        Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1)).save(path)
    elif kind == "CMYK":
        Image.fromarray(rgb).convert("CMYK").save(path, quality=95)
    elif kind == "png16":
        tim.write_image(path, rgb.astype(np.uint16) * 257)
    elif kind == "I;16":
        Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(path)
    else:
        raise KeyError(kind)
    return path


FAST = {"jpg444": ".jpg", "jpg420": ".jpg", "png": ".png", "tif": ".tif",
        "tif-raw": ".tif"}
FALLBACK = {"L": ".jpg", "P": ".png", "RGBA": ".png", "CMYK": ".jpg",
            "png16": ".png", "I;16": ".png"}


@pytest.mark.parametrize("kind", list(FAST))
def test_rgb_files_come_back_as_pillows_rgbx(tmp_path, kind):
    path = _write(tmp_path / f"x{FAST[kind]}", kind)
    with Image.open(path) as im:
        assert im.mode == "RGB"
    before = tim.texel_decode_counts()
    got = tim.read_image(path, texels=True)
    after = tim.texel_decode_counts()
    assert got.shape == (H, W, 4) and got.dtype == np.uint8
    assert got.flags.c_contiguous
    assert isinstance(got.base, tim._PillowBlock)
    assert np.array_equal(got[..., :3], tim.read_image(path))
    assert (got[..., 3] == 255).all()
    assert after["requested"] - before["requested"] == 1
    assert after["served"] - before["served"] == 1


@pytest.mark.parametrize("kind", list(FALLBACK))
def test_other_files_fall_back_to_the_packed_decode(tmp_path, kind):
    path = _write(tmp_path / f"x{FALLBACK[kind]}", kind)
    before = tim.texel_decode_counts()
    got = tim.read_image(path, texels=True)
    after = tim.texel_decode_counts()
    ref = tim.read_image(path)
    assert got.shape == ref.shape == (H, W, 3)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert after["requested"] - before["requested"] == 1
    assert after["served"] == before["served"]


def _no_arrow_export(core):
    raise AttributeError("'ImagingCore' object has no attribute "
                         "'__arrow_c_schema__'")


def _capsule_of_another_name(schema, array, n_pixels):
    raise ValueError("PyCapsule_GetPointer called with incorrect name")


@pytest.mark.parametrize("missing", ["new_block", "arrow export",
                                     "capsule"])
@pytest.mark.parametrize("kind", ["jpg444", "png"])
def test_a_pillow_without_the_api_falls_back(tmp_path, monkeypatch, missing,
                                             kind):
    path = _write(tmp_path / f"x{FAST[kind]}", kind)
    ref = tim.read_image(path)
    if missing == "new_block":
        monkeypatch.delattr(Image.core, "new_block")
    elif missing == "arrow export":
        monkeypatch.setattr(tim, "_arrow_export", _no_arrow_export)
    else:
        monkeypatch.setattr(tim, "_arrow_rgbx_data",
                            _capsule_of_another_name)
    before = tim.texel_decode_counts()
    got = tim.read_image(path, texels=True)
    assert got.shape == (H, W, 3) and np.array_equal(got, ref)
    assert tim.texel_decode_counts()["served"] == before["served"]


def test_an_export_of_another_layout_falls_back(tmp_path, monkeypatch):
    """An export that is not W·H lists of 4 u8 gives no pointer."""
    path = _write(tmp_path / "x.png", "png")
    gray = Image.core.new_block("L", (W, H))
    monkeypatch.setattr(tim, "_arrow_export",
                        lambda core: (gray.__arrow_c_schema__(),
                                      gray.__arrow_c_array__()))
    got = tim.read_image(path, texels=True)
    assert got.shape == (H, W, 3)
    assert np.array_equal(got, tim.read_image(path))


def test_the_array_owns_its_block(tmp_path):
    """20 decodes, all else dropped and collected, memory churned: every
    array (and a channel view outliving its array) keeps its pixels; the
    block goes once the last view of it does."""
    paths = [_write(tmp_path / f"x{k}.png", "png", seed=k) for k in range(5)]
    arrays, views, refs = [], [], []
    for k in range(20):
        arr = tim.read_image(paths[k % 5], texels=True)
        assert arr.shape == (H, W, 4)
        if k % 2:
            views.append(arr[..., :3])   # the array itself is dropped
        else:
            arrays.append(arr)
        refs.append(weakref.ref(arr.base))
        del arr
    gc.collect()
    churn = [np.full((H, W, 4), 7, np.uint8) for _ in range(64)]
    churn += [tim.read_image(paths[0], texels=True) for _ in range(8)]
    for k, arr in enumerate(arrays):
        expect = _rgb(2 * k % 5)
        assert np.array_equal(arr[..., :3], expect)
        assert (arr[..., 3] == 255).all()
    for k, view in enumerate(views):
        assert np.array_equal(view, _rgb((2 * k + 1) % 5))
    assert all(r() is not None for r in refs)
    del arrays, views, churn, arr, view
    gc.collect()
    assert all(r() is None for r in refs)


def test_a_tensor_over_the_block_keeps_it(tmp_path):
    path = _write(tmp_path / "x.jpg", "jpg444")
    ref = tim.read_image(path)
    t = torch.from_numpy(tim.read_image(path, texels=True))
    gc.collect()
    _ = [tim.read_image(path, texels=True) for _ in range(4)]
    assert np.array_equal(t[..., :3].numpy(), ref)


def test_the_counter_counts_every_thread(tmp_path):
    """More threads than cores, switching as often as the interpreter
    lets them: no count is lost."""
    import os
    import sys
    fast = _write(tmp_path / "x.png", "png")
    slow = _write(tmp_path / "y.jpg", "L")
    n_threads = 2 * (os.cpu_count() or 1) + 1
    before = tim.texel_decode_counts()

    def work():
        for _ in range(5):
            tim.read_image(fast, texels=True)
            tim.read_image(slow, texels=True)
    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = tim.texel_decode_counts()
    assert after["requested"] - before["requested"] == 10 * n_threads
    assert after["served"] - before["served"] == 5 * n_threads


def test_no_texels_asked_no_count(tmp_path):
    path = _write(tmp_path / "x.png", "png")
    before = tim.texel_decode_counts()
    assert tim.read_image(path).shape == (H, W, 3)
    assert tim.texel_decode_counts() == before


def test_the_counter_keeps_each_calls_start(tmp_path):
    """Given a window, only the calls that started in it count."""
    import time
    fast = _write(tmp_path / "x.png", "png")
    slow = _write(tmp_path / "y.jpg", "L")
    t0 = time.perf_counter()
    tim.read_image(fast, texels=True)
    tim.read_image(slow, texels=True)
    t1 = time.perf_counter()
    tim.read_image(fast, texels=True)
    assert tim.texel_decode_counts(t0, t1) == {"requested": 2, "served": 1}
    t2 = time.perf_counter()
    assert tim.texel_decode_counts(t1, t2) == {"requested": 1, "served": 1}
    assert tim.texel_decode_counts(t2 + 1.0, t2 + 2.0) == \
        {"requested": 0, "served": 0}


# --- who takes a texel decode: the upload, the warp, the remap source --------

def test_only_a_texel_decode_is_taken_for_texels(tmp_path):
    """A decode's block goes up as (H, W, 4) texels; any other 4-channel
    host array (RGBA, say) is refused, never read as RGBX."""
    from gs360x_torch.kernels import remap_cuda
    path = _write(tmp_path / "x.png", "png")
    rgbx = tim.read_image(path, texels=True)
    rgba = np.ascontiguousarray(rgbx.copy())
    assert tim.is_texel_decode(rgbx)
    assert not tim.is_texel_decode(rgba)
    assert not tim.is_texel_decode(rgbx[..., :3])
    assert not tim.is_texel_decode(tim.read_image(path))
    up = executor.upload_rows(rgbx, CPU)
    assert up.shape == (H, W, 4) and torch.equal(up, torch.from_numpy(rgbx))
    src = remap_cuda.remap_source(rgbx, H, W, CPU)
    assert src.shape == (H, W, 4) and torch.equal(src, up)
    with pytest.raises(ValueError):
        executor.upload_rows(rgba, CPU)
    with pytest.raises(ValueError):
        remap_cuda.remap_source(rgba, H, W, CPU)


@pytest.mark.parametrize("warp", ["warp_equirect_to_views_cuda",
                                  "warp_equirect_to_views_plain"])
def test_the_warp_reads_texels_as_their_rgb(warp):
    """(H, W, 4) u8 texels, X any byte, warp as their (H, W, 3) bytes."""
    from gs360x_torch.kernels import warp_cuda
    rgb = torch.from_numpy(_pano(64, 32))
    x = torch.from_numpy(_rgb(5, 32, 64)[..., :1])
    texels = torch.cat([rgb, x], -1)
    kw = dict(width=24, height=20, hfov_deg=90.0, vfov_deg=75.0,
              interp="bicubic", planar=True)
    angles = ([0.0, 100.0], [10.0, -30.0], [0.0, 5.0])
    fn = getattr(warp_cuda, warp)
    got = fn(texels, *angles, **kw)
    assert got.shape == (2, 3, 20, 24)
    assert torch.equal(got, fn(rgb, *angles, **kw))


def test_the_texel_readers_read_the_window(monkeypatch):
    """``texel_decode_pct``: served ÷ requested of the calls that started
    in [bench.start, bench.end); None with none there, or without the
    counter."""
    from types import SimpleNamespace
    from portbench import harness
    from operator import add
    from gs360x_torch.runtime.profiling import WindowCounter
    r = SimpleNamespace(bench=SimpleNamespace(start=100.0, end=101.0))
    calls = [(99.5, False), (100.0, True), (100.6, True), (100.9, False),
             (101.0, False)]

    def counter(held):
        fed = WindowCounter(requested=add, served=add)
        for t, served in held:
            fed.add(t, requested=1, served=served)
        monkeypatch.setattr(tim, "_TEXELS", fed)
    for name in ("texel_decode_pct.perspcut", "texel_decode_pct.dualfisheye"):
        reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py")
        counter(calls)
        assert reader.read(r) == pytest.approx(200.0 / 3.0, rel=1e-12)
        counter(calls[:1] + calls[-1:])
        assert reader.read(r) is None
        monkeypatch.delattr(tim, "texel_decode_counts")
        assert reader.read(r) is None
        monkeypatch.undo()


# --- perspcut's run_plan: the same files as the packed decode ---------------

def _pano(w=256, h=128, shift=0.0):
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    img = np.stack([0.5 + 0.5 * np.sin(lon + shift),
                    0.5 + 0.5 * np.sin(lat),
                    0.5 + 0.5 * np.cos(2 * lon)], -1)
    return (img * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    """Three RGB JPEG frames and one gray (``L``) frame."""
    d = tmp_path_factory.mktemp("frames")
    for k in range(3):
        Image.fromarray(_pano(shift=0.6 * k)).save(
            d / f"f{k}.jpg", quality=98, subsampling=0)
    Image.fromarray(_pano(shift=2.0)[..., 1]).save(d / "f3.jpg", quality=95)
    return d


def _packed(monkeypatch):
    inner = tim.read_image
    monkeypatch.setattr(tim, "read_image",
                        lambda path, texels=False: inner(path))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_run_plan_writes_what_the_packed_decode_writes(frame_dir, tmp_path,
                                                       monkeypatch, backend):
    args = perspcut.create_arg_parser().parse_args(
        ["-i", str(frame_dir), "--size", "48", "--ext", "png", "--count",
         "4"])
    files = sorted(frame_dir.glob("*.jpg"))
    outs = {}
    for route in ("texels", "packed"):
        if route == "packed":
            _packed(monkeypatch)
        before = tim.texel_decode_counts()
        plan = build_view_plan(perspcut.config_from_args(args), files,
                               tmp_path / route)
        report = executor.run_plan(plan, device=CPU, backend=backend,
                                   quiet=True)
        after = tim.texel_decode_counts()
        assert report.ok == 16 and report.failed == 0
        asked = after["requested"] - before["requested"]
        served = after["served"] - before["served"]
        assert (asked, served) == ((4, 3) if route == "texels" else (0, 0))
        outs[route] = {p.name: p.read_bytes()
                       for p in (tmp_path / route).iterdir()}
    assert len(outs["texels"]) == 16
    assert outs["texels"] == outs["packed"]
