"""The port's Video2Frames CLI (:mod:`gs360x_torch.tools.video2frames`,
``--device cpu``: the plain versions of ``planarize.cu`` and ``remap.cu``)
against the JAX package's (:mod:`gs360x.tools.video2frames`) on Y4M clips
written by ``gs360x.io.video.write_y4m``: the same file names, pixels
within 1 LSB with at most 0.1% of them differing (for the fisheye cut,
off the rim: output pixels whose lens radius is within 1e-6 of the image
circle may fall on either side in f32, and are counted), the same exit
codes; the 16-bit branch with the reader monkeypatched to yield u16
frames. The fisheye maps alone are held against JAX's at 1e-4 px."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs360x.core import camera as jcam
from gs360x.io import image as im
from gs360x.io import video as vio
from gs360x.kernels import warp as jwarp
from gs360x.tools import video2frames as jv2f
from gs360x_torch.io import video as tvio
from gs360x_torch.kernels import remap_cuda, warp_cuda
from gs360x_torch.kernels import warp as twin
from gs360x_torch.tools import video2frames as tv2f

torch.set_num_threads(1)

LSB_SHARE = 0.001


def _clip_frames(n, h=24, w=40, seed=0):
    """Smooth colour ramps plus noise, a different phase per frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    out = []
    for k in range(n):
        img = np.stack([0.5 + 0.45 * np.sin(xx / 5.0 + k),
                        0.5 + 0.45 * np.cos(yy / 4.0 - k),
                        (xx + yy) / (h + w)], -1)
        img = img + 0.05 * rng.random(img.shape)
        out.append(np.clip(np.rint(img * 255), 0, 255).astype(np.uint8))
    return out


@pytest.fixture
def clip(tmp_path):
    path = tmp_path / "clip.y4m"
    vio.write_y4m(path, _clip_frames(10), fps=10.0)
    return path


@pytest.fixture
def lens_clip(tmp_path):
    path = tmp_path / "lens.y4m"
    vio.write_y4m(path, _clip_frames(4, 64, 64, seed=3), fps=4.0)
    return path


def _rim_band(size, hfov, dfov, model):
    """Output pixels whose lens radius is within 1e-6 of 1 (f64)."""
    half = math.tan(math.radians(hfov) / 2.0)
    c = (2.0 * np.arange(size) + 1.0) / size - 1.0
    nx, ny = np.meshgrid(c * half, c * half)
    theta = np.arccos(1.0 / np.sqrt(nx * nx + ny * ny + 1.0))
    half_fov = math.radians(dfov) / 2.0
    r = (theta / half_fov if model == "equidistant"
         else np.sin(theta / 2.0) / math.sin(half_fov / 2.0))
    return np.abs(r - 1.0) < 1e-6


def _run_both(tmp_path, args, rim=None):
    ref_out, got_out = tmp_path / "jax", tmp_path / "torch"
    assert jv2f.main(args + ["-o", str(ref_out)]) == 0
    warp_cuda.reset_counters()
    remap_cuda.reset_counters()
    assert tv2f.main(args + ["-o", str(got_out), "--device", "cpu"]) == 0
    names = sorted(p.name for p in ref_out.iterdir())
    assert names and sorted(p.name for p in got_out.iterdir()) == names
    assert warp_cuda.PLAIN_CALLS["planarize"] == len(names)
    assert warp_cuda.LAUNCHES == {"planarize": 0, "warp": 0}
    assert remap_cuda.LAUNCHES["remap"] == 0
    rim_px = 0
    for name in names:
        ref = im.read_image(ref_out / name).astype(np.int64)
        got = im.read_image(got_out / name).astype(np.int64)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        diff = np.abs(got - ref)
        if rim is not None:
            rim_px += int((diff[rim].max(-1) > 0).sum())
            diff = diff[~rim]
        assert int(diff.max()) <= 1, name
        assert float((diff > 0).mean()) <= LSB_SHARE, name
    return names, rim_px


@pytest.mark.parametrize("extra", [
    [], ["--keep-rec709"], ["--start", "0.3", "--end", "0.8"],
    ["--name-suffix", " _X lens ", "--prefix", "lens"],
    ["--map-stream", "0:v:0"]])
def test_cli_matches_jax(tmp_path, clip, extra):
    names, _ = _run_both(tmp_path, ["-i", str(clip), "-f", "4", "-e", "png"]
                         + extra)
    if extra[:1] == ["--name-suffix"]:
        assert names[0] == "lens_0000000_X_lens.png"
    elif extra[:1] == ["--start"]:
        assert len(names) == 3
    else:
        assert names == [f"out_{i:07d}.png" for i in range(4)]


@pytest.mark.parametrize("model", ["equidistant", "equisolid"])
def test_fisheye_perspective_matches_jax(tmp_path, lens_clip, model):
    size, focal = 48, 12.0
    hfov = jcam.hfov_from_focal_mm(focal, 36.0)
    rim = _rim_band(size, hfov, 190.0, model)
    args = ["-i", str(lens_clip), "-f", "4", "-e", "png",
            "--fisheye-perspective", "--fisheye-size", str(size),
            "--fisheye-focal-mm", str(focal), "--fisheye-projection", model]
    names, rim_px = _run_both(tmp_path, args, rim=rim)
    assert len(names) == 4
    assert remap_cuda.PLAIN_CALLS["remap"] == len(names)
    assert rim_px <= int(rim.sum()) * len(names)


@pytest.mark.parametrize("model", ["equidistant", "equisolid"])
def test_fisheye_maps_match_jax(model):
    size, hfov, dfov, src_w, src_h = 96, 110.0, 190.0, 160, 128
    vfov = jcam.vfov_from_hfov(hfov, size, size)
    ru, rv, rvalid = (np.asarray(a) for a in jcam.fisheye_uv(
        jcam.perspective_rays(size, size, hfov, vfov), src_w, src_h, dfov,
        model=model))
    u, v, valid = twin.fisheye_perspective_maps(size, hfov, dfov, model,
                                                src_w, src_h)
    assert float(np.abs(u.numpy() - ru).max()) <= 1e-4
    assert float(np.abs(v.numpy() - rv).max()) <= 1e-4
    flips = valid.numpy() != rvalid
    assert not (flips & ~_rim_band(size, hfov, dfov, model)).any()
    # the plain warp against JAX's on a float source
    src = np.random.default_rng(1).random((src_h, src_w, 3), np.float32)
    ref = np.asarray(jwarp.warp_fisheye_to_perspective(
        jnp.asarray(src), size, hfov, dfov, model=model))
    got = twin.warp_fisheye_to_perspective(torch.from_numpy(src), size, hfov,
                                           dfov, model=model).numpy()
    keep = ~(flips | _rim_band(size, hfov, dfov, model))
    assert float(np.abs(got - ref)[keep].max()) <= 1e-4


def test_sixteen_bit_branch(tmp_path, clip, monkeypatch):
    frames16 = [f.astype(np.uint16) * 257 + np.uint16(k)
                for k, f in enumerate(_clip_frames(3, seed=9))]
    info = vio.probe_video(clip)
    info16 = vio.VideoInfo(info.width, info.height, 3.0, 3, 1.0, bit_depth=10)

    def iter16(path, *, fps=None, start=None, end=None, stream=None):
        for i, f in enumerate(frames16):
            yield i, i / 3.0, f

    # each package reads through its own copy of io.video
    for module in (vio, tvio):
        monkeypatch.setattr(module, "probe_video", lambda path: info16)
        monkeypatch.setattr(module, "iter_frames", iter16)
    ref_out, got_out = tmp_path / "jax", tmp_path / "torch"
    args = ["-i", str(clip), "-f", "3", "-e", "png"]
    assert jv2f.main(args + ["-o", str(ref_out)]) == 0
    assert tv2f.main(args + ["-o", str(got_out), "--device", "cpu"]) == 0
    names = sorted(p.name for p in ref_out.iterdir())
    assert len(names) == 3
    for name in names:
        ref = im.read_image(ref_out / name)
        got = im.read_image(got_out / name)
        assert ref.dtype == got.dtype == np.uint16
        assert int(np.abs(got.astype(int) - ref.astype(int)).max()) <= 1


def test_error_exits_match_jax(tmp_path, clip, capsys):
    missing = ["-i", str(tmp_path / "no.y4m"), "-f", "1"]
    assert tv2f.main(missing + ["--device", "cpu"]) == jv2f.main(missing) == 1
    zero = ["-i", str(clip), "-f", "0", "-o", str(tmp_path / "z")]
    assert tv2f.main(zero + ["--device", "cpu"]) == jv2f.main(zero) == 1
    bad = ["-i", str(clip), "-f", "1", "-o", str(tmp_path / "b"),
           "--map-stream", "a:1"]
    assert tv2f.main(bad + ["--device", "cpu"]) == jv2f.main(bad) == 1
    capsys.readouterr()
    out = tmp_path / "o"
    first = ["-i", str(clip), "-o", str(out), "-f", "1", "-e", "png"]
    assert tv2f.main(first + ["--device", "cpu"]) == 0
    assert tv2f.main(first + ["--device", "cpu"]) == 1
    got_err = capsys.readouterr().err
    assert jv2f.main(first) == 1
    assert got_err == capsys.readouterr().err
    assert "overwrite is disabled" in got_err
    assert tv2f.main(first + ["--overwrite", "--device", "cpu"]) == 0


def test_map_stream_parser_equals_jax():
    for spec in (None, "0:v:1", "v:0", "2", " 3 "):
        assert tv2f.parse_map_stream_selector(spec) == \
            jv2f.parse_map_stream_selector(spec)
    with pytest.raises(ValueError):
        tv2f.parse_map_stream_selector("a:1")


def test_cuda_device_without_a_card_raises(clip, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cuda"):
        tv2f.main(["-i", str(clip), "-f", "1", "-o", str(tmp_path / "c")])
