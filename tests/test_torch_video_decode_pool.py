"""perspcut's video mode on an MJPEG-AVI clip decodes its frames on the
decode pool (``executor._decode_width()`` threads of
``runtime/prefetch.Prefetcher``, results in order): the files written at a
width above 1 are those of width 1; only the source frames that output
ticks take are decoded, each once (ffmpeg's fps rule,
``io/video.pick_frames``), and CSV selection drops frames before their
decode; a corrupt frame fails at its own position; a stop ends the loop
and its threads while it waits; and the per-frame decode
(``io/video.decode_jpeg_frame``: Pillow's RGBX block packed to RGB) is
byte for byte Pillow's ``convert("RGB")``, by every route a host without a
card runs."""

import pathlib
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gs360x_torch.io import image as imagelib
from gs360x_torch.io import video as videolib
from gs360x_torch.rig.presets import build_view_plan
from gs360x_torch.runtime import executor
from gs360x_torch.runtime import mesh as meshlib
from gs360x_torch.runtime import profiling as tprof
from gs360x_torch.tools import perspcut
from portbench import avi, scenes

torch.set_num_threads(1)

SEED = 2 ** 33 + 24
H, W, SIZE, FRAMES, FPS = 64, 128, 32, 12, 30.0
SCENE = {"octaves": 3, "shapes": 12, "grain_lsb": 2}


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """3 seeded q95 4:4:4 JPEG frames, the clip's per-frame settings."""
    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i in range(3):
        path = d / f"d{i}.jpg"
        Image.fromarray(scenes.scene(SEED, i, H, W, SCENE)).save(
            path, format="JPEG", quality=95, subsampling=0)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def clip(jpegs, tmp_path_factory):
    """The JPEGs cycled over 12 frames at 30 fps."""
    path = tmp_path_factory.mktemp("clip") / "clip.avi"
    avi.write_clip(path, jpegs, [k % len(jpegs) for k in range(FRAMES)], FPS)
    return path


def _plan(clip_path, out_dir, fps=FPS):
    args = perspcut.create_arg_parser().parse_args(
        ["-i", str(clip_path), "--preset", "default", "--size", str(SIZE),
         "--ext", "png", "-f", str(fps)])
    args.input_is_video, args.video_bit_depth = True, 8
    return build_view_plan(perspcut.config_from_args(args), [clip_path],
                           out_dir)


def _run(plan, n_batch=1, stop_event=None):
    """``_run_video_sharded`` on a 1-device CPU mesh; (report, the decode
    pool's counts over the run)."""
    plan.out_dir.mkdir(parents=True, exist_ok=True)
    report = executor.ExecutionReport()
    t0 = time.perf_counter()
    with imagelib.AsyncImageWriter(workers=2) as writer:
        executor._run_video_sharded(
            plan, writer, report, stop_event or threading.Event(),
            lambda d, t: None, plan.interpolation, None, True,
            tprof.StageTimers(), n_batch,
            meshlib.data_mesh([torch.device("cpu")]), backend="auto")
    return report, executor.decode_overlap(t0, time.perf_counter())


def _ticks(fps, n=FRAMES):
    """ffmpeg's fps filter by hand: the source frame of each output tick."""
    picks, k = [], 0
    while round(k / fps * FPS) < n:
        picks.append(round(k / fps * FPS))
        k += 1
    return picks


def _files(out_dir):
    return {p.name: p.read_bytes() for p in pathlib.Path(out_dir).iterdir()}


# --- the pool against one thread ---------------------------------------------

@pytest.mark.parametrize("n_batch", [1, 4])
def test_pool_writes_what_one_thread_writes(clip, tmp_path, monkeypatch,
                                            n_batch):
    written = {}
    for width in (1, 3):
        monkeypatch.setattr(executor, "_decode_width", lambda w=width: w)
        report, pool = _run(_plan(clip, tmp_path / f"w{width}"), n_batch)
        assert report.ok == report.total == FRAMES * 8
        assert pool["decodes"] == FRAMES and pool["width"] == width
        written[width] = _files(tmp_path / f"w{width}")
    assert sorted(written[3]) == sorted(written[1])
    assert sorted(written[1]) == sorted(
        f"clip_{k:07d}_{v}.png" for k in range(FRAMES) for v in "ABCDEFGH")
    assert written[3] == written[1]


def test_width_one_stream_keeps_one_thread(jpegs, tmp_path):
    """A Y4M stream decodes in its iterator's next(): width 1, every frame
    once."""
    path = tmp_path / "clip.y4m"
    videolib.write_y4m(path, [imagelib.read_image(p) for p in jpegs] * 2,
                       fps=FPS)
    report, pool = _run(_plan(path, tmp_path / "out"), 4)
    assert report.ok == 6 * 8
    assert pool["decodes"] == 6 and pool["width"] == 1
    assert pool["overlapped"] == 0


# --- what is decoded -----------------------------------------------------------

@pytest.mark.parametrize("fps", [10, 60])
def test_each_taken_frame_is_decoded_once(clip, tmp_path, fps):
    """-f below the clip's rate decodes only the frames the ticks take, -f
    above it each taken frame once, however many ticks take it."""
    picks = _ticks(fps)
    report, pool = _run(_plan(clip, tmp_path / "out", fps), 4)
    assert pool["decodes"] == len(set(picks))
    assert len(set(picks)) == (4 if fps == 10 else FRAMES)
    assert report.ok == len(picks) * 8
    # each tick's views are its source frame's
    files = _files(tmp_path / "out")
    first = {}
    for k, src in enumerate(picks):
        got = files[f"clip_{k:07d}_A.png"]
        assert first.setdefault(src, got) == got


@pytest.mark.parametrize("fps", [10, 30, 60])
def test_iter_frames_decodes_each_taken_frame_once(clip, monkeypatch, fps):
    calls = []
    inner = videolib.decode_jpeg_frame

    def counted(data):
        calls.append(1)
        return inner(data)
    monkeypatch.setattr(videolib, "decode_jpeg_frame", counted)
    picks = _ticks(fps)
    got = list(videolib.iter_frames(clip, fps=fps))
    assert [k for k, _t, _f in got] == list(range(len(picks)))
    assert len(calls) == len(set(picks))


def test_csv_selection_decodes_only_the_selected(clip, tmp_path):
    plan = _plan(clip, tmp_path / "out")
    plan.selected_frames = {1, 4, 9}
    report, pool = _run(plan, 4)
    assert pool["decodes"] == 3
    assert report.ok == 3 * 8
    assert {name.split("_")[1] for name in _files(tmp_path / "out")} == {
        f"{k:07d}" for k in (1, 4, 9)}


# --- failures and the stop ---------------------------------------------------

@pytest.mark.parametrize("width", [1, 3])
def test_a_corrupt_frame_fails_at_its_position(clip, tmp_path, monkeypatch,
                                               width):
    bad = tmp_path / "bad.avi"
    raw = bytearray(clip.read_bytes())
    off, size = videolib.MJPEGAVIReader(clip)._offsets[3]
    raw[off:off + size] = bytes(size)
    bad.write_bytes(bytes(raw))
    monkeypatch.setattr(executor, "_decode_width", lambda: width)
    batches = []
    inner = executor._warp_frames_batch

    def counted(frames, *args, **kwargs):
        batches.append(len(frames))
        return inner(frames, *args, **kwargs)
    monkeypatch.setattr(executor, "_warp_frames_batch", counted)
    with pytest.raises(OSError):
        _run(_plan(bad, tmp_path / "out"), 1)
    # frames 0-2 went to the card, none after the corrupt one
    assert batches == [1, 1, 1]


def test_a_stop_while_the_loop_waits_ends_it(clip, tmp_path, monkeypatch):
    inner = videolib.decode_jpeg_frame

    def slow(data):
        time.sleep(0.5)
        return inner(data)
    monkeypatch.setattr(videolib, "decode_jpeg_frame", slow)
    monkeypatch.setattr(executor, "_decode_width", lambda: 3)
    before = set(threading.enumerate())
    stop = threading.Event()
    runner = threading.Thread(
        target=_run, args=(_plan(clip, tmp_path / "out"), 4, stop))
    runner.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    stop.set()
    runner.join(3.0)
    assert not runner.is_alive()
    while set(threading.enumerate()) - before and \
            time.perf_counter() - t0 < 3.0:
        time.sleep(0.02)
    assert not set(threading.enumerate()) - before
    assert len(list((tmp_path / "out").iterdir())) < FRAMES * 8


# --- the per-frame decode ------------------------------------------------------

def _jpeg(tmp_path, h, w, mode="RGB"):
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = tmp_path / f"{mode}_{h}x{w}.jpg"
    Image.fromarray(img).convert(mode).save(path, format="JPEG", quality=95,
                                            subsampling=0)
    return path


@pytest.mark.parametrize("route", ["block", "no_block", "numpy_pack"])
@pytest.mark.parametrize("shape", [(64, 128), (37, 53), (1, 3)])
def test_decode_is_pillows_convert(tmp_path, monkeypatch, route, shape):
    """Bytes, shape, type and layout of ``convert("RGB")``: through the
    block and the pack a host without a card runs (numpy's strided copy),
    and without the block allocator (``convert``); no texel decode
    counted."""
    path = _jpeg(tmp_path, *shape)
    if route == "no_block":
        monkeypatch.delattr(Image.core, "new_block")
    if route == "numpy_pack":
        monkeypatch.setattr(videolib, "_LIBRARY_PACK", False)
    texels = imagelib.texel_decode_counts()
    got = videolib.decode_jpeg_frame(memoryview(path.read_bytes()))
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == (*shape, 3)
    assert got.flags.c_contiguous
    assert np.array_equal(got, ref)
    assert imagelib.texel_decode_counts() == texels


@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_decode_of_other_jpegs_is_pillows_convert(tmp_path, mode):
    path = _jpeg(tmp_path, 40, 56, mode)
    got = videolib.decode_jpeg_frame(path.read_bytes())
    with Image.open(path) as im:
        assert im.mode == mode
        ref = np.asarray(im.convert("RGB"))
    assert got.shape == (40, 56, 3) and np.array_equal(got, ref)


def test_reader_frames_are_its_payloads_decoded(clip, jpegs):
    reader = videolib.MJPEGAVIReader(clip)
    payloads = list(reader.payloads())
    assert [bytes(p) for p in payloads] == [
        jpegs[k % len(jpegs)].read_bytes() for k in range(FRAMES)]
    for frame, payload in zip(reader.frames(), payloads):
        assert np.array_equal(frame, videolib.decode_jpeg_frame(payload))


@pytest.mark.parametrize("bad", ["rgb", "strided", "u16"])
def test_pack_refuses_what_is_not_a_block(bad):
    """Only a C-contiguous (H, W, 4) u8 block reaches the pointer pack."""
    block = np.zeros((4, 6, 4), np.uint8)
    arr = {"rgb": block[..., :3], "strided": block[:, ::2],
           "u16": block.astype(np.uint16)}[bad]
    with pytest.raises(ValueError):
        videolib._pack_rgb(arr)
