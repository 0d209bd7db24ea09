"""The port's perspcut CLI, the slice as a whole, against the JAX
package's CLI on the CPU: the same file names, pixels within 1 u8 LSB on
at most 0.1% of pixels, in image-directory and video mode; and
``--device cuda`` on a machine without a card raises."""

import math

import numpy as np
import pytest
import torch

from gs360x.io import image as im
from gs360x.io import video as vio
from gs360x.tools import perspcut as jax_perspcut
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.rig.presets import PerspCutConfig, build_view_plan
from gs360x_torch.runtime.executor import run_plan
from gs360x_torch.tools import perspcut as torch_perspcut

torch.set_num_threads(1)


def lonlat_pano(w=512, h=256, shift=0.0):
    """Self-checking panorama: a view at yaw psi has center pixel
    ch0 = 255*(0.5+0.5*sin psi), ch1 = 127.5 at pitch 0."""
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    img = np.stack([0.5 + 0.5 * np.sin(lon + shift),
                    0.5 + 0.5 * np.sin(lat),
                    0.5 + 0.5 * np.cos(2 * lon)], -1)
    return (img * 255).astype(np.uint8)


def _assert_same_outputs(ref_dir, got_dir):
    ref_names = sorted(p.name for p in ref_dir.iterdir())
    got_names = sorted(p.name for p in got_dir.iterdir())
    assert got_names == ref_names
    assert ref_names
    for name in ref_names:
        ref = im.read_image(ref_dir / name).astype(np.int32)
        got = im.read_image(got_dir / name).astype(np.int32)
        assert got.shape == ref.shape
        diff = np.abs(got - ref)
        assert int(diff.max()) <= 1, name
        assert float((diff > 0).mean()) <= 0.001, name


@pytest.fixture(scope="module")
def pano_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("panos")
    im.write_image(d / "pano_0001.png", lonlat_pano())
    im.write_image(d / "pano_0002.png", lonlat_pano(shift=0.7))
    return d


@pytest.fixture(scope="module")
def jax_image_out(pano_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_out")
    assert jax_perspcut.main(["-i", str(pano_dir), "-o", str(out),
                              "--size", "128", "--ext", "png"]) == 0
    return out


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_image_mode_matches_jax(pano_dir, jax_image_out, tmp_path, backend,
                                capsys):
    out = tmp_path / "torch_out"
    warp_cuda.reset_counters()
    rc = torch_perspcut.main(["-i", str(pano_dir), "-o", str(out),
                              "--size", "128", "--ext", "png",
                              "--device", "cpu", "--backend", backend])
    assert rc == 0
    assert "[OK] Completed: success=16, failed=0, total=16" in \
        capsys.readouterr().out
    # one warp per (group, frame), all of it on the plain path on the CPU
    assert warp_cuda.PLAIN_CALLS["warp"] == 2
    assert warp_cuda.LAUNCHES == {"planarize": 0, "warp": 0}
    _assert_same_outputs(jax_image_out, out)
    # self-check: view A (yaw 0) and view C (yaw 90) of the first pano
    for view, yaw in (("A", 0.0), ("C", 90.0)):
        img = im.read_image(out / f"pano_0001_{view}.png")
        center = img[63:65, 63:65].astype(float).mean(axis=(0, 1))
        assert abs(center[0] - 255 * (0.5 + 0.5 * math.sin(
            math.radians(yaw)))) <= 2
        assert abs(center[1] - 127.5) <= 2


def test_video_mode_matches_jax(tmp_path):
    clip = tmp_path / "clip.y4m"
    vio.write_y4m(clip, [lonlat_pano(256, 128, shift=0.3 * i)
                         for i in range(5)], fps=5.0)
    args = ["-i", str(clip), "-f", "5", "--size", "64", "--ext", "png",
            "--count", "4"]
    ref_out, got_out = tmp_path / "jax", tmp_path / "torch"
    assert jax_perspcut.main(args + ["-o", str(ref_out)]) == 0
    assert torch_perspcut.main(args + ["-o", str(got_out),
                                       "--device", "cpu"]) == 0
    assert len(list(got_out.iterdir())) == 20
    _assert_same_outputs(ref_out, got_out)


def test_dry_run_prints_the_same_plan(pano_dir, capsys):
    args = ["-i", str(pano_dir), "--dry-run", "--preset", "fisheyelike"]
    assert jax_perspcut.main(args) == 0
    ref = capsys.readouterr().out
    assert torch_perspcut.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == ref


def test_device_cuda_without_a_card_raises(pano_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    out = tmp_path / "never"
    warp_cuda.reset_counters()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_perspcut.main(["-i", str(pano_dir), "-o", str(out),
                             "--size", "32", "--device", "cuda"])
    assert not out.exists()
    assert warp_cuda.PLAIN_CALLS == {"planarize": 0, "warp": 0}


@pytest.mark.parametrize("preset,match", [("fisheyelike", "slice 2"),
                                          ("fisheyeXY", "slice 3")])
def test_cuda_plan_outside_the_kernel_gate_raises(pano_dir, tmp_path, preset,
                                                  match):
    # on a CUDA device, pitched and fisheye groups raise before any work
    # instead of running the plain twin on the card (checked without one:
    # the gate raises before the device is touched)
    out = tmp_path / "never"
    files = sorted(pano_dir.glob("*.png"))
    plan = build_view_plan(PerspCutConfig(preset=preset, size=32), files, out)
    warp_cuda.reset_counters()
    with pytest.raises(NotImplementedError, match=match):
        run_plan(plan, device=torch.device("cuda"), backend="auto",
                 quiet=True)
    assert not out.exists()
    assert warp_cuda.PLAIN_CALLS == {"planarize": 0, "warp": 0}


def test_exit_codes_match(tmp_path, capsys):
    missing = ["-i", str(tmp_path / "nope")]
    assert torch_perspcut.main(missing + ["--device", "cpu"]) == \
        jax_perspcut.main(missing) == 1
    clip = tmp_path / "clip.y4m"
    vio.write_y4m(clip, [lonlat_pano(64, 32)], fps=10.0)
    no_fps = ["-i", str(clip)]
    assert torch_perspcut.main(no_fps + ["--device", "cpu"]) == \
        jax_perspcut.main(no_fps) == 1
