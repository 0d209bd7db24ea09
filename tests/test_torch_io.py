"""The port's host modules — :mod:`gs360x_torch.io.image`,
:mod:`gs360x_torch.io.video`, :mod:`gs360x_torch.native`,
:mod:`gs360x_torch.templates`, and the runtime helpers (``StageTimers``,
the cancel listener, the memory throttle) — against the originals in
:mod:`gs360x` on the fixtures of ``tests/test_io.py`` and
``tests/test_native.py``: written files byte-equal, decoded arrays equal,
the generated calibration XML byte-equal."""

import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from gs360x import native as jnative
from gs360x import templates as jtemplates
from gs360x.io import image as jim
from gs360x.io import video as jvio
from gs360x.runtime import cancel as jcancel
from gs360x.runtime import profiling as jprof
from gs360x.runtime import throttle as jthrottle
from gs360x_torch import native as tnative
from gs360x_torch import templates as ttemplates
from gs360x_torch.io import image as tim
from gs360x_torch.io import video as tvio
from gs360x_torch.runtime import cancel as tcancel
from gs360x_torch.runtime import profiling as tprof
from gs360x_torch.runtime import throttle as tthrottle

ROOT = pathlib.Path(__file__).resolve().parent.parent


def gradient_frames(n=10, w=64, h=32):
    """tests/test_io.py::gradient_frames."""
    frames = []
    for i in range(n):
        img = np.zeros((h, w, 3), np.uint8)
        img[..., 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
        img[..., 1] = int(i * 255 / max(1, n - 1))
        img[..., 2] = 128
        frames.append(img)
    return frames


# ---- io.image ---------------------------------------------------------------

def _image(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "u8":
        return rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    if kind == "gray":
        return rng.integers(0, 256, (32, 48), dtype=np.uint8)
    if kind == "u16":
        return (rng.random((41, 67, 3)) * 65535).astype(np.uint16)
    if kind == "planar-f32":
        return rng.random((3, 24, 40)).astype(np.float32)
    if kind == "planar-u8":
        return rng.integers(0, 256, (3, 24, 40), dtype=np.uint8)
    raise KeyError(kind)


@pytest.mark.parametrize("kind,ext,kw", [
    ("u8", ".png", {}), ("u8", ".jpg", {}), ("u8", ".jpg",
                                             {"jpeg_quality": 95}),
    ("u8", ".tif", {}), ("u8", ".bmp", {}), ("gray", ".png", {}),
    ("u16", ".png", {}), ("u16", ".tiff", {}), ("u16", ".jpg", {}),
    ("planar-f32", ".png", {"planar": True}),
    ("planar-u8", ".jpg", {"planar": True}),
])
def test_write_and_read_image_match_jax_package(tmp_path, kind, ext, kw):
    img = _image(kind)
    ref_path, got_path = tmp_path / f"jax{ext}", tmp_path / f"torch{ext}"
    jim.write_image(ref_path, img, **kw)
    tim.write_image(got_path, img, **kw)
    assert got_path.read_bytes() == ref_path.read_bytes()
    ref, got = jim.read_image(ref_path), tim.read_image(ref_path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tim.read_image_gray(ref_path),
                                  jim.read_image_gray(ref_path))


def test_float_conversions_match_jax_package():
    rng = np.random.default_rng(8)
    for img in (_image("u8"), _image("u16"),
                rng.random((5, 7, 3)).astype(np.float32) * 1.4 - 0.2):
        ref, got = jim.to_float01(img), tim.to_float01(img)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        for depth in (8, 16):
            np.testing.assert_array_equal(tim.from_float01(got, depth),
                                          jim.from_float01(ref, depth))
    assert tim.IMAGE_EXTS == jim.IMAGE_EXTS


def test_async_writer_matches_jax_package(tmp_path):
    imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(20)]
    for mod, name in ((jim, "jax"), (tim, "torch")):
        (tmp_path / name).mkdir()
        with mod.AsyncImageWriter(workers=4, max_pending=4) as writer:
            for i, img in enumerate(imgs):
                writer.submit(tmp_path / name / f"f{i}.png", img)
    for i in range(20):
        assert (tmp_path / "torch" / f"f{i}.png").read_bytes() == \
            (tmp_path / "jax" / f"f{i}.png").read_bytes()
    writer = tim.AsyncImageWriter()
    writer.submit(tmp_path / "nodir" / "deep" / "x.png",
                  np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="failed writing"):
        writer.close()


# ---- io.video ---------------------------------------------------------------

@pytest.mark.parametrize("chroma", ["444", "420jpeg"])
def test_y4m_matches_jax_package(tmp_path, chroma):
    frames = gradient_frames(6)
    ref_path, got_path = tmp_path / "jax.y4m", tmp_path / "torch.y4m"
    jvio.write_y4m(ref_path, frames, fps=10.0, chroma=chroma)
    tvio.write_y4m(got_path, frames, fps=10.0, chroma=chroma)
    assert got_path.read_bytes() == ref_path.read_bytes()
    ref_reader, got_reader = jvio.Y4MReader(ref_path), tvio.Y4MReader(ref_path)
    assert vars(got_reader.info()) == vars(ref_reader.info())
    ref, got = list(ref_reader.frames()), list(got_reader.frames())
    assert len(got) == len(ref) == 6
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_mjpeg_avi_matches_jax_package(tmp_path):
    frames = gradient_frames(6)
    ref_path, got_path = tmp_path / "jax.avi", tmp_path / "torch.avi"
    jvio.write_mjpeg_avi(ref_path, frames, fps=12.0)
    tvio.write_mjpeg_avi(got_path, frames, fps=12.0)
    assert got_path.read_bytes() == ref_path.read_bytes()
    assert vars(tvio.MJPEGAVIReader(ref_path).info()) == \
        vars(jvio.MJPEGAVIReader(ref_path).info())
    for a, b in zip(tvio.MJPEGAVIReader(ref_path).frames(),
                    jvio.MJPEGAVIReader(ref_path).frames()):
        np.testing.assert_array_equal(a, b)
    assert vars(tvio.probe_video(ref_path)) == vars(jvio.probe_video(ref_path))
    assert type(tvio.open_video(ref_path)).__name__ == \
        type(jvio.open_video(ref_path)).__name__


@pytest.mark.parametrize("kw", [{}, {"fps": 2.0}, {"fps": 6.0},
                                {"fps": 10.0, "start": 0.5, "end": 1.0}])
def test_iter_frames_matches_jax_package(tmp_path, kw):
    p = tmp_path / "v.y4m"
    jvio.write_y4m(p, gradient_frames(20), fps=10.0)
    ref, got = list(jvio.iter_frames(p, **kw)), list(tvio.iter_frames(p, **kw))
    assert len(got) == len(ref) and ref
    for (gi, gt, gimg), (ri, rt, rimg) in zip(got, ref):
        assert (gi, gt) == (ri, rt)
        np.testing.assert_array_equal(gimg, rimg)


@pytest.mark.parametrize("kw", [{}, {"fps": 2.0}, {"fps": 6.0},
                                {"fps": 25.0},
                                {"fps": 10.0, "start": 0.5, "end": 1.0},
                                {"start": 0.35, "end": 1.2}])
def test_mjpeg_iter_frames_matches_jax_package(tmp_path, kw):
    """The MJPEG-AVI route (each taken frame's JPEG decoded once, through
    Pillow's block) against the JAX package's, which decodes every frame."""
    p = tmp_path / "v.avi"
    jvio.write_mjpeg_avi(p, gradient_frames(20), fps=10.0)
    ref, got = list(jvio.iter_frames(p, **kw)), list(tvio.iter_frames(p, **kw))
    assert len(got) == len(ref) and ref
    for (gi, gt, gimg), (ri, rt, rimg) in zip(got, ref):
        assert (gi, gt) == (ri, rt)
        np.testing.assert_array_equal(gimg, rimg)


def test_yuv_conversions_match_jax_package():
    rgb = np.random.default_rng(3).integers(0, 256, (48, 64, 3), np.uint8)
    ref = jvio.rgb_to_yuv601(rgb)
    np.testing.assert_array_equal(tvio.rgb_to_yuv601(rgb), ref)
    np.testing.assert_array_equal(tvio.yuv601_to_rgb(ref),
                                  jvio.yuv601_to_rgb(ref))
    assert tvio.have_ffmpeg() == jvio.have_ffmpeg()


@pytest.mark.parametrize("bit_depth,fmt,dtype", [(8, "rgb24", np.uint8),
                                                 (10, "rgb48le", np.uint16)])
def test_ffmpeg_reader_bit_depth(monkeypatch, bit_depth, fmt, dtype):
    """tests/test_io.py::TestFFmpegReaderBitDepth on the port's reader:
    ffmpeg is faked, the command and the dtype are pinned."""
    captured = {}

    class FakeStdout:
        def __init__(self, data):
            self.data, self.pos = data, 0

        def read(self, n):
            out = self.data[self.pos:self.pos + n]
            self.pos += n
            return out

        def close(self):
            pass

    class FakeProc:
        def __init__(self, cmd):
            captured["cmd"] = cmd
            itemsize = 2 if "rgb48le" in cmd else 1
            self.stdout = FakeStdout(b"\x01" * (4 * 4 * 3 * itemsize))

        def wait(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", lambda cmd, **kw: FakeProc(cmd))
    reader = tvio.FFmpegReader.__new__(tvio.FFmpegReader)
    reader.path = "fake.mp4"
    reader.stream = None
    reader._info = tvio.VideoInfo(width=4, height=4, fps=30.0, n_frames=1,
                                  duration=1 / 30.0, bit_depth=bit_depth)
    frames = list(reader.frames())
    assert fmt in captured["cmd"]
    assert frames[0].dtype == dtype and frames[0].shape == (4, 4, 3)


# ---- native -----------------------------------------------------------------

@pytest.fixture
def both_native():
    if not (jnative.HAS_NATIVE and tnative.HAS_NATIVE):
        pytest.skip("native library not built (no toolchain)")


def test_native_builds_into_the_build_directory():
    """The port's library lands under build/gs360x_torch/, named by the
    source's hash, not beside the package; nothing is built at import."""
    if not tnative.HAS_NATIVE:
        pytest.skip("native library not built (no toolchain)")
    libs = list((ROOT / "build" / "gs360x_torch").glob(
        "libgs360x_native_*.so"))
    assert libs
    assert not list((ROOT / "gs360x_torch" / "native").glob("*.so"))
    probe = ("import sys, gs360x_torch.native as n; "
             "print(n._tried, 'gs360x' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, text=True,
                         capture_output=True, timeout=120, check=True).stdout
    assert out.split() == ["False", "False"]
    with pytest.raises(AttributeError):
        tnative.no_such_name


def test_native_layout_matches_jax_package(both_native):
    rng = np.random.default_rng(0)
    hwc = rng.integers(0, 256, (33, 47, 3), np.uint8)
    np.testing.assert_array_equal(tnative.deinterleave_u8(hwc),
                                  jnative.deinterleave_u8(hwc))
    chw = jnative.deinterleave_u8(hwc)
    np.testing.assert_array_equal(tnative.interleave_u8(chw), hwc)
    f32 = rng.random((3, 64, 80)).astype(np.float32) * 1.5 - 0.25
    for threads in (1, 4):
        np.testing.assert_array_equal(
            tnative.planar_f32_to_u8_hwc(f32, threads=threads),
            jnative.planar_f32_to_u8_hwc(f32, threads=threads))


def test_native_yuv_and_avi_scan_match_jax_package(both_native, tmp_path):
    rng = np.random.default_rng(3)
    yuv = jvio.rgb_to_yuv601(rng.integers(0, 256, (48, 64, 3), np.uint8))
    planes = np.ascontiguousarray(np.moveaxis(yuv, -1, 0))
    np.testing.assert_array_equal(tnative.yuv444_to_rgb(planes),
                                  jnative.yuv444_to_rgb(planes))
    flat = rng.integers(0, 256, 32 * 64 * 3 // 2, dtype=np.uint8)
    np.testing.assert_array_equal(tnative.yuv420_to_rgb(flat, 32, 64),
                                  jnative.yuv420_to_rgb(flat, 32, 64))
    p = tmp_path / "v.avi"
    jvio.write_mjpeg_avi(p, gradient_frames(5), fps=12.5)
    ref, got = jnative.avi_scan(p.read_bytes()), tnative.avi_scan(
        p.read_bytes())
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]
    with pytest.raises(ValueError):
        tnative.avi_scan(b"RIFFxxxxWAVE" + b"\x00" * 100)


def test_native_numpy_fallback_matches_the_library(both_native, monkeypatch):
    """With the library switched off the port's numpy paths give the
    library's layout results exactly and its YUV results within 1 LSB."""
    rng = np.random.default_rng(5)
    hwc = rng.integers(0, 256, (17, 23, 3), np.uint8)
    f32 = rng.random((3, 17, 23)).astype(np.float32)
    planes = np.ascontiguousarray(np.moveaxis(jvio.rgb_to_yuv601(hwc), -1, 0))
    flat = rng.integers(0, 256, 16 * 24 * 3 // 2, dtype=np.uint8)
    with_lib = (tnative.deinterleave_u8(hwc),
                tnative.planar_f32_to_u8_hwc(f32),
                tnative.yuv444_to_rgb(planes),
                tnative.yuv420_to_rgb(flat, 16, 24))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    assert tnative.HAS_NATIVE is False
    np.testing.assert_array_equal(tnative.deinterleave_u8(hwc), with_lib[0])
    np.testing.assert_array_equal(
        tnative.interleave_u8(with_lib[0]), hwc)
    np.testing.assert_array_equal(tnative.planar_f32_to_u8_hwc(f32),
                                  with_lib[1])
    for got, ref in ((tnative.yuv444_to_rgb(planes), with_lib[2]),
                     (tnative.yuv420_to_rgb(flat, 16, 24), with_lib[3])):
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    with pytest.raises(RuntimeError):
        tnative.avi_scan(b"RIFF")


# ---- templates --------------------------------------------------------------

def test_calibration_template_matches_jax_package(tmp_path, monkeypatch):
    ref = jtemplates.write_osmo360_default_calibration(tmp_path / "jax.xml")
    got = ttemplates.write_osmo360_default_calibration(tmp_path / "torch.xml")
    assert got.read_bytes() == ref.read_bytes()
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    got_path = ttemplates.default_osmo360_calibration_path()
    assert got_path == jtemplates.default_osmo360_calibration_path()
    assert got_path == tmp_path / "home" / ".gs360x" / \
        "osmo360_default_calib_v2.xml"
    assert got_path.read_bytes() == ref.read_bytes()


# ---- runtime helpers --------------------------------------------------------

def test_stage_timers_match_jax_package():
    assert tprof.__all__ == ["StageTimers", "spans", "maybe_trace",
                             "read_trace", "cuda_ms", "device_ms"]
    for cls in (jprof.StageTimers, tprof.StageTimers):
        timers = cls()
        assert timers.report() == "no stages recorded"
        with timers.stage("warp"):
            time.sleep(0.01)
        with timers.stage("warp"):
            pass
        assert list(timers.wrap_iter("decode", range(3))) == [0, 1, 2]
        assert timers.counts == {"warp": 2, "decode": 4}
        assert timers.totals["warp"] >= 0.01
        report = timers.report()
        assert report.startswith("decode ") and " | warp " in report
        assert report.endswith("s/2")


def test_throttle_and_cancel_match_jax_package():
    assert tthrottle.__all__ == jthrottle.__all__
    assert (tthrottle.MEMORY_HIGH_WATER, tthrottle.MEMORY_LOW_WATER) == \
        (jthrottle.MEMORY_HIGH_WATER, jthrottle.MEMORY_LOW_WATER)
    ref_ratio, got_ratio = (jthrottle.memory_usage_ratio(),
                            tthrottle.memory_usage_ratio())
    assert (got_ratio is None) == (ref_ratio is None)
    if ref_ratio is not None:
        assert 0.0 <= got_ratio <= 1.5 and abs(got_ratio - ref_ratio) < 0.2
    for mod in (jthrottle, tthrottle):
        limiter = mod.AdaptiveLimiter(3)
        limiter.set_target(10)
        assert limiter.target == 3
        limiter.set_target(0)
        assert limiter.target == 1
        entered = threading.Event()

        def second(limiter=limiter, entered=entered):
            with limiter:
                entered.set()

        with limiter:
            worker = threading.Thread(target=second, daemon=True)
            worker.start()
            assert not entered.wait(0.1)      # the gate holds at target 1
        worker.join(timeout=5)
        assert entered.is_set() and not worker.is_alive()
        with mod.MemoryMonitor(limiter, interval=0.01) as monitor:
            time.sleep(0.05)
        assert monitor._stop.is_set()
    stop = threading.Event()
    # stdin is not a TTY under pytest: no listener thread in either package
    assert tcancel.start_cancel_listener(stop) is None
    assert jcancel.start_cancel_listener(stop) is None
