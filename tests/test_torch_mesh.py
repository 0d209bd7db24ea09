"""The port's data mesh (``gs360x_torch.runtime.mesh``) and batched video
path against the JAX package on the CPU, at the sizes of
``tests/test_warp.py``'s mesh tests (frames 128x256, views 64x64 or
64x128, 2 views), frames drawn from ``np.random.default_rng``:

* ``warp_frames_sharded`` against ``gs360x.runtime.mesh`` on a 1-device
  JAX CPU mesh, bilinear and bicubic, every quantize and colour-move
  setting (f32 within 5e-5, u8 within 1 LSB, u16 within 257);
* ``warp_frames_sharded_cuda``'s plain route against
  ``warp_frames_sharded_pallas`` in interpret mode (within 1 LSB);
* the view the Pallas path refuses for its window budgets, accepted here
  and equal to the plain twin;
* a 3-device CPU mesh bitwise equal to a 1-device mesh, an uneven batch
  padded and its pad dropped, the shape errors;
* ``sharded_batch_stats`` against JAX (rtol 1e-5) and over 3 devices;
* the batched ``warp_equirect_to_views_cuda`` on CPU tensors against the
  per-frame plain version stacked, bitwise, and its grid limit;
* the executor's batched video path: ``_run_video_sharded`` at ``n_batch``
  4 (one full batch, a short tail) and over a 3-device mesh (a tail padded
  to the mesh size) writes the
  files of ``n_batch`` 1 byte for byte, with and without a frame
  selection.

The card's side (batched launches bitwise the single-frame launches) is in
``tests/test_torch_cuda.py``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs360x.kernels import warp_pallas as wp
from gs360x.kernels.warp_pallas import PallasFallback
from gs360x.runtime import mesh as jmesh
from gs360x.io import video as vio
from gs360x_torch.io import image as imagelib
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.rig.presets import PerspCutConfig, build_view_plan
from gs360x_torch.runtime import executor as texec
from gs360x_torch.runtime import mesh as tmesh
from gs360x_torch.runtime.profiling import StageTimers

torch.set_num_threads(1)

CPU = torch.device("cpu")
YAWS = np.array([0.0, 90.0])
ZEROS = np.zeros(2)
VIEW = dict(width=64, height=64, hfov_deg=90.0, vfov_deg=90.0)
F32_TOL = 5e-5
LSB_TOL = {None: F32_TOL, 8: 1, 16: 257}


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_device_tables():
    """The JAX meshes here hold one CPU device; ``tests/test_warp.py``
    runs the same sharded Pallas warp over conftest's 8. The kernel's
    device-table caches keep arrays made under this module's mesh, which
    fail that test when both modules run in one process."""
    yield
    for cache in (wp._YAW_DEV_CACHE, wp._WIDE2_DEV_CACHE,
                  wp._WIDE3_DEV_CACHE):
        cache.clear()


def _frames(seed, n=2, h=128, w=256, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random((n, h, w, 3), dtype=np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, (n, h, w, 3),
                        dtype=dtype)


def _jax_mesh():
    return jmesh.data_mesh(jax.devices("cpu")[:1])


def _cpu_mesh(n=1):
    return tmesh.data_mesh([CPU] * n)


def _joined(blocks):
    return torch.cat([b.cpu() for b in blocks]).numpy()


def _max_diff(a, b):
    return float(np.abs(np.asarray(a).astype(np.float64)
                        - np.asarray(b).astype(np.float64)).max())


CASES = [(interp, bits, keep, np.uint8)
         for interp in ("bilinear", "bicubic")
         for bits in (None, 8, 16)
         for keep in (None, False, True)] + [
    ("bicubic", 16, None, np.uint16), ("bicubic", 16, False, np.uint16),
    ("bilinear", None, None, np.float32)]


@pytest.mark.parametrize("interp,bits,keep,dtype", CASES)
def test_warp_frames_sharded_matches_jax(interp, bits, keep, dtype):
    frames = _frames(0, dtype=dtype)
    kw = dict(interp=interp, keep_rec709=keep, quantize_bits=bits, **VIEW)
    ref = np.asarray(jmesh.warp_frames_sharded(
        _jax_mesh(), jnp.asarray(frames), YAWS.astype(np.float32),
        ZEROS.astype(np.float32), ZEROS.astype(np.float32), **kw))
    blocks = tmesh.warp_frames_sharded(_cpu_mesh(), frames, YAWS, ZEROS,
                                       ZEROS, **kw)
    got = _joined(blocks)
    assert got.dtype == ref.dtype
    assert got.shape == ref.shape == (2, 2, 64, 64, 3)
    assert _max_diff(got, ref) <= LSB_TOL[bits]


@pytest.mark.parametrize("keep", [None, False])
def test_warp_frames_sharded_cuda_matches_pallas(keep):
    frames = _frames(1)
    rows = frames.reshape(2, 128, 256 * 3)
    kw = dict(width=128, height=64, hfov_deg=90.0, vfov_deg=90.0,
              interp="bilinear", quantize_bits=8, keep_rec709=keep)
    ref = np.asarray(jmesh.warp_frames_sharded_pallas(
        _jax_mesh(), jnp.asarray(rows[:1]), YAWS, ZEROS, ZEROS,
        interpret=True, **kw))
    warp_cuda.reset_counters()
    got = _joined(tmesh.warp_frames_sharded_cuda(
        _cpu_mesh(), torch.from_numpy(rows[:1]), YAWS, ZEROS, ZEROS, **kw))
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape == (1, 2, 3, 64, 128)
    assert _max_diff(got, ref) <= 1
    # the plain route on CPU tensors: no launch
    assert warp_cuda.LAUNCHES == {"planarize": 0, "warp": 0}
    assert warp_cuda.PLAIN_CALLS["warp"] == 1


def test_over_budget_view_is_accepted_and_matches_the_plain_twin():
    # tests/test_warp.py: the Pallas path refuses this view (~32 source
    # rows an output row, past every window class); the CUDA kernel has no
    # window budgets and takes it (a known deviation, ROADMAP C)
    rows = np.random.default_rng(2).random((1, 2048, 256 * 3),
                                           dtype=np.float32)
    kw = dict(width=128, height=64, hfov_deg=90.0, vfov_deg=179.0,
              interp="bicubic")
    with pytest.raises(PallasFallback):
        jmesh.warp_frames_sharded_pallas(
            _jax_mesh(), jnp.zeros((1, 2048, 256 * 3), jnp.float32),
            [0.0], [0.0], [0.0], interpret=True, **kw)
    got = _joined(tmesh.warp_frames_sharded_cuda(
        _cpu_mesh(), rows, [0.0], [0.0], [0.0], **kw))
    twin = _joined(tmesh.warp_frames_sharded(
        _cpu_mesh(), rows.reshape(1, 2048, 256, 3), [0.0], [0.0], [0.0],
        **kw))
    assert got.shape == (1, 1, 3, 64, 128)
    assert np.isfinite(got).all()
    assert _max_diff(got, np.transpose(twin, (0, 1, 4, 2, 3))) <= F32_TOL


@pytest.mark.parametrize("keep", [None, True])
def test_three_device_mesh_equals_one_device_cuda_route(keep):
    frames = _frames(3, n=5)
    kw = dict(interp="bicubic", quantize_bits=8, keep_rec709=keep, **VIEW)
    one = tmesh.warp_frames_sharded_cuda(_cpu_mesh(1), frames, YAWS, ZEROS,
                                         ZEROS, **kw)
    three = tmesh.warp_frames_sharded_cuda(_cpu_mesh(3), frames, YAWS,
                                           ZEROS, ZEROS, **kw)
    # 5 frames padded to 6 over 3 devices: blocks of 2, 2 and 1 after the
    # pad is dropped
    assert [len(b) for b in three] == [2, 2, 1]
    assert np.array_equal(_joined(three), _joined(one))
    assert _joined(three).shape == (5, 2, 3, 64, 64)


def test_three_device_mesh_equals_one_device_plain_twin():
    frames = _frames(4, n=6)
    kw = dict(interp="bilinear", quantize_bits=16, keep_rec709=False,
              **VIEW)
    one = tmesh.warp_frames_sharded(_cpu_mesh(1), frames, YAWS, ZEROS,
                                    ZEROS, **kw)
    three = tmesh.warp_frames_sharded(_cpu_mesh(3), frames, YAWS, ZEROS,
                                      ZEROS, **kw)
    assert [len(b) for b in three] == [2, 2, 2]
    assert np.array_equal(_joined(three), _joined(one))


def test_shard_frames_splits_and_refuses_uneven_batches():
    frames = torch.arange(6 * 2).reshape(6, 2)
    blocks = tmesh.shard_frames(_cpu_mesh(3), frames)
    assert [b.tolist() for b in blocks] == [[[0, 1], [2, 3]],
                                            [[4, 5], [6, 7]],
                                            [[8, 9], [10, 11]]]
    # blocks it made pass as they are
    assert tmesh.shard_frames(_cpu_mesh(3), blocks) is blocks
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_frames(_cpu_mesh(3), frames[:5])
    with pytest.raises(ValueError, match="one block"):
        tmesh.shard_frames(_cpu_mesh(2), blocks)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.warp_frames_sharded(_cpu_mesh(2), _frames(5, n=3), YAWS, ZEROS,
                                  ZEROS, **VIEW)


def test_data_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: data_mesh() takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.data_mesh()
    mesh = tmesh.data_mesh([CPU, "cpu"])
    assert mesh.size == 2 and mesh.devices == (CPU, CPU)
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS == "data"


def test_sharded_batch_stats_matches_jax():
    frames = _frames(6, n=3, dtype=np.float32)
    ref_lum, ref_ten = jmesh.sharded_batch_stats(_jax_mesh(),
                                                 jnp.asarray(frames))
    for n in (1, 3):
        lum, ten = tmesh.sharded_batch_stats(_cpu_mesh(n), frames)
        assert lum.dtype == ten.dtype == torch.float32
        np.testing.assert_allclose(float(lum), float(ref_lum), rtol=1e-5)
        np.testing.assert_allclose(float(ten), float(ref_ten), rtol=1e-5)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("out_dtype", [None, torch.uint8, torch.uint16])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_batched_wrapper_equals_the_per_frame_plain_version(dtype, out_dtype,
                                                           planar):
    frames = torch.from_numpy(_frames(7, n=3, h=64, w=128, dtype=dtype))
    kw = dict(width=48, height=32, hfov_deg=80.0, vfov_deg=60.0,
              interp="bicubic", planar=planar)
    got = warp_cuda.warp_equirect_to_views_cuda(
        frames.reshape(3, 64, 128 * 3), YAWS, ZEROS, ZEROS,
        out_dtype=out_dtype, **kw)
    ref = torch.stack([warp_cuda.quantize_plain(
        warp_cuda.warp_equirect_to_views_plain(f, YAWS, ZEROS, ZEROS, **kw),
        out_dtype) for f in frames])
    assert got.shape == ((3, 2, 3, 32, 48) if planar else (3, 2, 32, 48, 3))
    assert got.dtype == (out_dtype or torch.float32)
    assert torch.equal(got, ref)
    # (B, H, W, 3) frames are the same batch; one frame stays unbatched
    assert torch.equal(warp_cuda.warp_equirect_to_views_cuda(
        frames, YAWS, ZEROS, ZEROS, out_dtype=out_dtype, **kw), ref)
    assert torch.equal(warp_cuda.warp_equirect_to_views_cuda(
        frames[1], YAWS, ZEROS, ZEROS, out_dtype=out_dtype, **kw), ref[1])


def test_batched_wrapper_refuses_more_than_a_grid_of_frame_views():
    frames = torch.zeros((2, 8, 16 * 3), dtype=torch.uint8)
    many = np.zeros(32768)
    warp_cuda.reset_counters()
    with pytest.raises(ValueError, match="65535"):
        warp_cuda.warp_equirect_to_views_cuda(
            frames, many, many, many, width=4, height=4, hfov_deg=90.0,
            vfov_deg=90.0)
    assert warp_cuda.PLAIN_CALLS == {"planarize": 0, "warp": 0}
    # 32767 views of 2 frames fit: the limit is on B * V
    fit = np.zeros(32767)
    out = warp_cuda.warp_equirect_to_views_cuda(
        frames, fit, fit, fit, width=4, height=4, hfov_deg=90.0,
        vfov_deg=90.0, planar=True)
    assert out.shape == (2, 32767, 3, 4, 4)


def _pano(h, w, shift):
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * np.pi, ys * np.pi / 2)
    img = np.stack([0.5 + 0.5 * np.sin(lon + shift), 0.5 + 0.5 * np.sin(lat),
                    0.5 + 0.5 * np.cos(2 * lon)], -1)
    noise = np.random.default_rng(int(shift * 10)).random(img.shape)
    return ((0.9 * img + 0.1 * noise) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "clip.y4m"
    vio.write_y4m(path, [_pano(128, 256, 0.4 * i) for i in range(6)],
                  fps=6.0)
    return path


def _run_batched(clip, out_dir, n_batch, n_dev, backend, selected):
    cfg = PerspCutConfig(count=4, size=64, size_explicit=True, ext="png",
                         fps=6.0, input_is_video=True)
    plan = build_view_plan(cfg, [clip], out_dir)
    plan.selected_frames = selected
    out_dir.mkdir(parents=True)
    report = texec.ExecutionReport()
    warp_cuda.reset_counters()
    with imagelib.AsyncImageWriter(workers=2) as writer:
        texec._run_video_sharded(
            plan, writer, report, threading.Event(), lambda d, t: None,
            "bicubic", None, True, StageTimers(), n_batch, _cpu_mesh(n_dev),
            backend=backend)
    return report, dict(warp_cuda.PLAIN_CALLS)


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("selected", [None, {0, 2, 3, 4, 5}])
@pytest.mark.parametrize("n_batch,n_dev", [(4, 1), (3, 3)])
def test_batched_video_path_writes_the_per_frame_files(
        clip, tmp_path, n_batch, n_dev, selected, backend):
    ref_dir, got_dir = tmp_path / "per_frame", tmp_path / "batched"
    ref, _ = _run_batched(clip, ref_dir, 1, 1, backend, selected)
    got, plain = _run_batched(clip, got_dir, n_batch, n_dev, backend,
                              selected)
    n_frames = 6 if selected is None else len(selected)
    names = sorted(p.name for p in ref_dir.iterdir())
    assert len(names) == 4 * n_frames
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        assert (got_dir / name).read_bytes() == (ref_dir / name).read_bytes()
    for report in (ref, got):
        assert report.total == report.ok == 4 * n_frames
        assert report.skipped == report.failed == 0
    if backend == "auto":
        # the plain route of the CUDA wrapper, one call a frame: the tail
        # batch is padded only to a multiple of the mesh size
        sizes = [min(n_batch, n_frames - k)
                 for k in range(0, n_frames, n_batch)]
        assert plain["warp"] == sum(-(-b // n_dev) * n_dev for b in sizes)


def test_batched_video_path_skips_existing_files(clip, tmp_path):
    out_dir = tmp_path / "out"
    first, _ = _run_batched(clip, out_dir, 4, 1, "auto", None)
    cfg = PerspCutConfig(count=4, size=64, size_explicit=True, ext="png",
                         fps=6.0, input_is_video=True)
    plan = build_view_plan(cfg, [clip], out_dir)
    report = texec.ExecutionReport()
    with imagelib.AsyncImageWriter(workers=2) as writer:
        texec._run_video_sharded(
            plan, writer, report, threading.Event(), lambda d, t: None,
            "bicubic", None, False, StageTimers(), 4, _cpu_mesh(),
            backend="auto")
    assert first.ok == 24
    assert report.skipped == report.total == 24 and report.ok == 0
