"""perspcut's video mode on an MJPEG-AVI clip, on the CPU, against the
benchmark's plain reference (``portbench/reference/video.py``: the cut,
the colour move and the quantize in float64, which imports nothing of the
port): through ``perspcut.main`` (one frame a batch on the CPU) and
``executor._run_video_sharded`` at 4 frames a batch; the reference's
colour move against ``core/color.video_color_move_planar`` in f32; the
clip the benchmark muxes (``portbench/avi.py``) read back by the port's
reader; the spans and counters video mode adds (``video_open``,
``batch_stack``, ``batch_upload``, ``color_quantize``,
``io/video.open_counts``, ``executor.video_frames_warped``) with their
counts in a run and absent from image mode; ``full360coverage --add-top
--add-bottom`` (pitched and pole views) against the reference, the
view-class counter ``executor.view_counts`` and its pole test; and the
benchmark's readers of them on synthetic readings."""

import dataclasses
import json
import pathlib
import threading
import time
from operator import add

import numpy as np
import pytest
import torch
from PIL import Image

from gs360x_torch import native
from gs360x_torch.core import color as colorlib
from gs360x_torch.io import image as imagelib
from gs360x_torch.io import video as videolib
from gs360x_torch.rig.presets import build_view_plan
from gs360x_torch.runtime import executor
from gs360x_torch.runtime import mesh as meshlib
from gs360x_torch.runtime import prefetch
from gs360x_torch.runtime import profiling as tprof
from gs360x_torch.tools import perspcut
from portbench import avi, scenes
from portbench.reference import compare
from portbench.reference import video as refvideo

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED = 2 ** 33 + 21      # more than 32 bits, as the benchmark's seeds are
H, W, SIZE, FRAMES, FPS = 128, 256, 48, 6, 30.0
SCENE = {"octaves": 4, "shapes": 24, "grain_lsb": 2}
# the benchmark's own copy of the `default` preset's table, at 48 px
VIEWS = dict(json.loads(
    (ROOT / "portbench/configs/perspcut-video-8k-default.json").read_text()
)["views"], size=SIZE)
NEW_SPANS = ("video_open", "batch_stack", "batch_upload", "color_quantize")
# perspcut's flags of each preset the tests run, and the benchmark's copy of
# its table (ids, yaw, pitch; focal length) at 48 px
POLES_CONFIG = json.loads((
    ROOT / "portbench/configs/perspcut-video-8k-full360-poles.json"
).read_text())
PRESETS = {
    "default": (("--preset", "default"), VIEWS),
    "full360-poles": (("--preset", "full360coverage", "--add-top",
                       "--add-bottom"),
                      dict(POLES_CONFIG["views"], size=SIZE)),
}

# The gate on a written view against the float64 reference. The port
# computes in f32: a value whose float64 result lies within f32's error of
# a rounding boundary rounds the other way, 1 LSB, on 0.015% of the values
# here; nothing else may differ (the colour move's steepest slope, 12.92
# times, takes f32's relative error of ~1e-7 to ~1e-6 of the range, far
# under the 1/255 of a LSB).
MAX_LSB = 1
OFF_SHARE = 0.005        # 30 times the share measured; bfloat16 reads 0.56


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(clip, the JPEG files it holds): 2 seeded frames (q95 4:4:4, the
    clip's per-frame settings) cycled over 6 frames at 30 fps."""
    d = tmp_path_factory.mktemp("clip")
    jpegs = []
    for i in range(2):
        path = d / f"d{i}.jpg"
        Image.fromarray(scenes.scene(SEED, i, H, W, SCENE)).save(
            path, format="JPEG", quality=95, subsampling=0)
        jpegs.append(path)
    path = d / "clip.avi"
    avi.write_clip(path, jpegs, [k % 2 for k in range(FRAMES)], FPS)
    return path, jpegs


def _main(clip_path, out_dir, *extra, preset="default"):
    return perspcut.main(["-i", str(clip_path), "-o", str(out_dir),
                          *PRESETS[preset][0], "--size", str(SIZE),
                          "--ext", "png", "-f", str(int(FPS)), "--device",
                          "cpu", "-j", "2", *extra])


def _batched(clip_path, out_dir, n_batch, preset="default"):
    """``_run_video_sharded`` at ``n_batch`` frames a batch on a 1-device
    CPU mesh, the plan as ``perspcut.main`` builds it."""
    args = perspcut.create_arg_parser().parse_args(
        ["-i", str(clip_path), *PRESETS[preset][0], "--size", str(SIZE),
         "--ext", "png", "-f", str(int(FPS))])
    args.input_is_video, args.video_bit_depth = True, 8
    plan = build_view_plan(perspcut.config_from_args(args), [clip_path],
                           out_dir)
    out_dir.mkdir(parents=True)
    report = executor.ExecutionReport()
    with imagelib.AsyncImageWriter(workers=2) as writer:
        executor._run_video_sharded(
            plan, writer, report, threading.Event(), lambda d, t: None,
            plan.interpolation, None, True, tprof.StageTimers(), n_batch,
            meshlib.data_mesh([torch.device("cpu")]), backend="auto")
    return report


def _against_reference(out_dir, jpegs, views=VIEWS):
    """(largest difference in LSB, largest share of a view's values that
    differ) of every written view of ``views``' table against the
    reference's."""
    frames = [torch.from_numpy(compare.read_u8(p).copy()) for p in jpegs]
    worst, share = 0, 0.0
    for k in range(FRAMES):
        for view in views["layout"]:
            got = compare.read_u8(out_dir / f"clip_{k:07d}_{view['id']}.png")
            ref = refvideo.cut_move_view(frames[k % len(frames)], view,
                                         views).numpy()
            diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
            worst = max(worst, int(diff.max()))
            share = max(share, float((diff > 0).mean()))
    return worst, share


# --- the video path against the reference --------------------------------

@pytest.mark.parametrize("n_batch", [1, 4])
def test_video_mode_matches_the_reference(clip, tmp_path, n_batch):
    clip_path, jpegs = clip
    out = tmp_path / "out"
    if n_batch == 1:
        assert _main(clip_path, out) == 0
    else:
        report = _batched(clip_path, out, n_batch)
        assert report.ok == report.total == FRAMES * 8
    assert len(list(out.iterdir())) == FRAMES * 8
    worst, share = _against_reference(out, jpegs)
    assert worst <= MAX_LSB and share <= OFF_SHARE, (worst, share)


@pytest.mark.parametrize("n_batch", [1, 4])
def test_full360_poles_video_mode_matches_the_reference(clip, tmp_path,
                                                        n_batch):
    """``full360coverage --add-top --add-bottom``: 14 views a frame, 8
    pitched ±30° and 2 over the poles, whose taps reflect over the pole
    onto the opposite meridian; every written view within the gate."""
    clip_path, jpegs = clip
    out = tmp_path / "out"
    if n_batch == 1:
        assert _main(clip_path, out, preset="full360-poles") == 0
    else:
        report = _batched(clip_path, out, n_batch, preset="full360-poles")
        assert report.ok == report.total == FRAMES * 14
    assert len(list(out.iterdir())) == FRAMES * 14
    worst, share = _against_reference(out, jpegs,
                                      PRESETS["full360-poles"][1])
    assert worst <= MAX_LSB and share <= OFF_SHARE, (worst, share)


def test_full360_poles_layout_is_the_tools():
    """The benchmark's table, from which ``drivers/perspcut_video.py``
    names the files it expects, is the one ``build_view_plan`` makes of the configuration's
    own flags: ids, yaws and pitches in order, size and FOV."""
    from portbench.reference import equirect
    args = perspcut.create_arg_parser().parse_args(
        ["-i", "clip.avi", *POLES_CONFIG["args"]])
    args.input_is_video, args.video_bit_depth = True, 8
    plan = build_view_plan(perspcut.config_from_args(args),
                           [pathlib.Path("clip.avi")], pathlib.Path("out"))
    views = POLES_CONFIG["views"]
    assert [(v.view_id, v.yaw_deg, v.pitch_deg, v.roll_deg)
            for v in plan.unique_views()] == [
        (v["id"], v["yaw"], v["pitch"], 0.0) for v in views["layout"]]
    fov = equirect.fov_deg(views["focal_mm"], views["sensor_mm"][0])
    for v in plan.unique_views():
        assert (v.width, v.height) == (views["size"], views["size"])
        assert v.projection == views["projection"]
        assert v.hfov_deg == pytest.approx(fov, abs=1e-9)
        assert v.vfov_deg == pytest.approx(fov, abs=1e-9)


def test_four_frames_a_batch_writes_the_per_frame_files(clip, tmp_path):
    clip_path, _ = clip
    assert _main(clip_path, tmp_path / "one") == 0
    _batched(clip_path, tmp_path / "four", 4)
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert sorted(p.name for p in (tmp_path / "four").iterdir()) == names
    for name in names:
        assert (tmp_path / "four" / name).read_bytes() == \
            (tmp_path / "one" / name).read_bytes()


def _bfloat16_move(inner):
    def move(rgb, keep_rec709=False):
        return inner(rgb.to(torch.bfloat16),
                     keep_rec709=keep_rec709).to(rgb.dtype)
    return move


@pytest.mark.parametrize("fault", ["left_out", "bfloat16"])
def test_the_gate_fails_without_the_colour_move(clip, tmp_path, monkeypatch,
                                                fault):
    """The comparison catches a colour move left out or computed in
    bfloat16, the precision below the f32 the path computes in."""
    clip_path, jpegs = clip
    inner = colorlib.video_color_move_planar
    monkeypatch.setattr(colorlib, "video_color_move_planar",
                        (lambda rgb, keep_rec709=False: rgb)
                        if fault == "left_out" else _bfloat16_move(inner))
    assert _main(clip_path, tmp_path / "out") == 0
    worst, share = _against_reference(tmp_path / "out", jpegs)
    assert worst > MAX_LSB and share > OFF_SHARE, (worst, share)


# --- the reference's colour move against the port's ------------------------

def test_reference_matrix_is_core_colors():
    """Derived from the chromaticities and D65, it agrees with the
    port's matrix, built from XYZ matrices published to 7 decimals,
    within their rounding."""
    got = refvideo.bt709_to_smpte170m().numpy()
    assert np.abs(got - colorlib.BT709_TO_SMPTE170M).max() <= 5e-7
    # the primaries' white: each row of an RGB -> RGB move at one white
    # point sums to 1
    assert np.abs(got.sum(1) - 1.0).max() <= 1e-12


def test_reference_color_move_against_the_port_in_f32():
    g = torch.Generator().manual_seed(5)
    # [-0.1, 1.1): a cubic overshoots [0, 1] at hard edges; and each curve's
    # break
    x = torch.rand(3, 96, 96, generator=g) * 1.2 - 0.1
    x[:, 0, :4] = torch.tensor([0.081, 0.0, 1.0, 0.0031308 * 4.5])[None]
    prog = colorlib.video_color_move_planar(x)
    ref = refvideo.color_move(x.double().permute(1, 2, 0)).permute(2, 0, 1)
    # the port's matrix is within 2.2e-7 of the derived one, and the sRGB
    # OETF's slope (up to ~13 just above its break) takes that to ~3e-6
    # (2.9e-6 measured): 1e-5 is 0.0026 of a LSB
    assert (prog.double() - ref).abs().max().item() <= 1e-5
    low = refvideo.color_move(x.to(torch.bfloat16).permute(1, 2, 0))
    # bfloat16 misses by several LSB: the control's premise
    assert (low.permute(2, 0, 1).double() - ref).abs().max().item() \
        > 2.0 / 255


# --- the clip and the port's reader -----------------------------------------

@pytest.mark.parametrize("scan", ["native", "python"])
def test_clip_reads_back_as_pillows_decode(clip, monkeypatch, scan):
    clip_path, jpegs = clip
    if scan == "python":
        # the library as if it failed to load: HAS_NATIVE is the module's
        # __getattr__, and a patch of it would leave a plain attribute
        # behind for the worker's later tests
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
        assert native.HAS_NATIVE is False
    elif not native.HAS_NATIVE:
        pytest.skip("no C++ compiler for the native library")
    reader = videolib.open_video(clip_path)
    assert isinstance(reader, videolib.MJPEGAVIReader)
    info = reader.info()
    assert (info.width, info.height, info.n_frames) == (W, H, FRAMES)
    assert info.fps == FPS and info.bit_depth == 8
    frames = list(reader.frames())
    assert len(frames) == FRAMES
    for k, frame in enumerate(frames):
        with Image.open(jpegs[k % 2]) as im:
            assert np.array_equal(frame, np.asarray(im.convert("RGB")))
    got = [i for i, _t, _f in videolib.iter_frames(clip_path, fps=FPS)]
    assert got == list(range(FRAMES))


# --- spans and counters -----------------------------------------------------

def _held(t0, t1):
    held = {}
    for name, tid, s, e, _cpu in tprof.spans(since=t0):
        if t0 <= s < t1:
            held.setdefault(name, []).append((tid, s, e))
    return held


@pytest.mark.parametrize("n_batch", [1, 4])
def test_video_spans_and_counters(clip, tmp_path, capsys, n_batch):
    clip_path, _ = clip
    size = clip_path.stat().st_size
    total0 = videolib.open_counts()
    t0 = time.perf_counter()
    if n_batch == 1:
        assert _main(clip_path, tmp_path / "out", "--stats") == 0
        # main's probe, _run_video's probe, the frame iterator's open
        opens = 3
    else:
        _batched(clip_path, tmp_path / "out", n_batch)
        opens = 1     # the frame iterator's
    t1 = time.perf_counter()
    held = _held(t0, t1)
    batches = -(-FRAMES // n_batch)
    assert len(held["video_open"]) == opens
    # one stack, one upload and one colour move a (group, batch): the
    # default preset is one view group
    for name in ("batch_stack", "batch_upload", "color_quantize"):
        assert len(held[name]) == batches, name
    assert videolib.open_counts(t0, t1) == {"opens": opens,
                                            "bytes": opens * size}
    total = videolib.open_counts()
    assert total["opens"] - total0["opens"] == opens
    assert executor.video_frames_warped(t0, t1) == FRAMES
    # one decode span a decoded frame, on the decode pool's threads; every
    # open lies on the loop's thread, outside them
    decodes = held["decode"]
    assert len(decodes) == FRAMES
    nested = [o for o in held["video_open"]
              if any(d[0] == o[0] and d[1] <= o[1] and o[2] <= d[2]
                     for d in decodes)]
    assert len(nested) == 0
    if n_batch == 1:
        stats = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[STATS]")][-1]
        pool = executor.decode_overlap()
        assert f"video opens {total['opens']}, {total['bytes']} bytes" \
            f" | decodes overlapped {pool['overlapped']} of " \
            f"{pool['decodes']}, width {pool['width']}" in stats


def test_image_mode_runs_none_of_them(tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    for k in range(2):
        imagelib.write_image(frames / f"f{k}.png",
                             scenes.scene(SEED, k, H, W, SCENE))
    opens0 = videolib.open_counts()
    warped0 = executor.video_frames_warped()
    t0 = time.perf_counter()
    assert perspcut.main(["-i", str(frames), "-o", str(tmp_path / "out"),
                          "--size", str(SIZE), "--ext", "png", "--device",
                          "cpu", "-j", "2"]) == 0
    held = _held(t0, time.perf_counter())
    assert "warp_dispatch" in held
    assert not set(NEW_SPANS) & set(held)
    assert videolib.open_counts() == opens0
    assert executor.video_frames_warped() == warped0


# --- the view-class counter ---------------------------------------------------

def _stats_line(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[STATS]")][-1]


@pytest.mark.parametrize("n_batch", [1, 4])
def test_view_counts_full360_poles(clip, tmp_path, capsys, n_batch):
    """Video mode at ``full360coverage --add-top --add-bottom``: 14
    view-frames a frame, 10 off the horizon, 2 holding a pole, one frame a
    batch through ``perspcut.main`` (and its ``[STATS]``) or 4 on the
    batched path."""
    clip_path, _ = clip
    t0 = time.perf_counter()
    if n_batch == 1:
        assert _main(clip_path, tmp_path / "out", "--stats",
                     preset="full360-poles") == 0
    else:
        _batched(clip_path, tmp_path / "out", n_batch,
                 preset="full360-poles")
    assert executor.view_counts(t0, time.perf_counter()) == {
        "views": 14 * FRAMES, "off_horizon": 10 * FRAMES,
        "pole": 2 * FRAMES}
    if n_batch == 1:
        assert (f"views {14 * FRAMES} (off-horizon {10 * FRAMES}, pole "
                f"{2 * FRAMES})") in _stats_line(capsys)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_view_counts_image_mode_default(tmp_path, capsys, backend):
    """Image mode at ``default``: 8 view-frames a frame on the horizon, on
    the kernel wrapper's path and the plain twin's alike."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for k in range(2):
        imagelib.write_image(frames / f"f{k}.png",
                             scenes.scene(SEED, k, H, W, SCENE))
    t0 = time.perf_counter()
    assert perspcut.main(["-i", str(frames), "-o", str(tmp_path / "out"),
                          "--size", str(SIZE), "--ext", "png", "--device",
                          "cpu", "-j", "2", "--backend", backend,
                          "--stats"]) == 0
    assert executor.view_counts(t0, time.perf_counter()) == {
        "views": 16, "off_horizon": 0, "pole": 0}
    assert "views 16 (off-horizon 0, pole 0)" in _stats_line(capsys)


FOV_14MM = 2 * np.degrees(np.arctan(18.0 / 14.0))     # 104.25°


@pytest.mark.parametrize("projection,fov,pitch,holds", [
    ("perspective", FOV_14MM, 90.0, True),
    ("perspective", FOV_14MM, -90.0, True),
    ("perspective", FOV_14MM, 30.0, False),     # top edge at 82.1°
    ("perspective", FOV_14MM, -30.0, False),
    ("perspective", FOV_14MM, 38.5, True),      # top edge at 90.6°
    ("perspective", FOV_14MM, -38.5, True),
    ("perspective", FOV_14MM, 0.0, False),
    ("fisheye_v360", 190.0, 0.0, True),         # θ 90° within 95°
    ("fisheye_v360", 170.0, 0.0, False),        # 90° beyond 85°
    ("equisolid", 170.0, 10.0, True),           # 80° within 85°
])
def test_holds_pole_at_the_frustum_edge(projection, fov, pitch, holds):
    from gs360x_torch.rig.spec import ViewSpec
    view = ViewSpec("V", 45.0, pitch, fov, fov, SIZE, SIZE, projection)
    assert executor.holds_pole(view) is holds


def test_rolled_views_count_off_the_horizon():
    from gs360x_torch.rig.spec import ViewSpec
    views = [ViewSpec("A", 0.0, 0.0, FOV_14MM, FOV_14MM, SIZE, SIZE),
             ViewSpec("B", 90.0, 0.0, FOV_14MM, FOV_14MM, SIZE, SIZE,
                      roll_deg=15.0),
             ViewSpec("C", 0.0, 90.0, FOV_14MM, FOV_14MM, SIZE, SIZE)]
    assert executor._view_classes(views) == (2, 1)


# --- the benchmark's readers ----------------------------------------------

# (name, thread, start, end, CPU s) around a window of 100-101 s: one span
# of each kind before it, two batches of 4 frames in it
SYNTHETIC = [
    ("video_open", 1, 99.0, 99.5, 0.5),
    ("batch_stack", 1, 99.6, 99.7, 0.1),
    ("video_open", 1, 100.0, 100.2, 0.2),          # _run_video's probe
    ("decode", 2, 100.2, 100.9, 0.6),              # holds the next open
    ("video_open", 2, 100.21, 100.41, 0.2),
    ("decode", 2, 100.9, 101.2, 0.3),              # ends past the window
    ("batch_stack", 1, 100.5, 100.54, 0.04),
    ("batch_upload", 1, 100.54, 100.58, 0.04),
    ("color_quantize", 1, 100.58, 100.59, 0.01),
    ("batch_stack", 1, 100.8, 100.84, 0.04),
    ("batch_upload", 1, 100.84, 100.9, 0.06),
    ("color_quantize", 1, 100.9, 100.91, 0.01),
]
READERS = {
    "video_open_s": 0.4,
    "batch_stack_ms_per_frame": 80.0 / 8,
    "batch_upload_ms_per_frame": 100.0 / 8,
    # the decode spans' 1000 ms less the nested open's 200 ms
    "decode_ms_per_frame.video": 800.0 / 8,
    # kernels: 2 warp launches of 40 µs, 0.8 ms of others
    "color_quantize_ms_per_frame": 0.8 / 8,
    # 8 frames at 9 µs against 80 µs of warp launches
    "mesh_warp_roofline": 100.0 * 8 * 9.0 / 80.0,
    # busy 0.88 ms of the 1 s window
    "device_idle_pct.video": 100.0 * (1 - 0.88e-3),
    # 7 of the window's 8 frame decodes started beside another (DECODES)
    "decode_overlap_pct.video": 100.0 * 7 / 8,
}
# (start, overlapped) of the stage's decodes: one before the window, the 8
# frames of its two batches in it (the first alone), one at its end
DECODES = ([(99.5, True), (100.2, False)]
           + [(100.3 + 0.08 * k, True) for k in range(7)] + [(101.0, True)])


def _feed(monkeypatch, decodes):
    """``prefetch.decode_overlap``'s counter, holding ``decodes``."""
    fed = tprof.WindowCounter(decodes=add, overlapped=add, width=max)
    for t, overlapped in decodes:
        fed.add(t, decodes=1, overlapped=overlapped, width=8)
    monkeypatch.setattr(prefetch, "_DECODES", fed)


def _readings():
    from portbench import harness
    from portbench.trace import WINDOW_LABEL, Trace

    bench = harness.Bench(torch.device("cpu"), True, ROOT)
    bench.start, bench.end, bench.anchor = 100.0, 101.0, 100.0
    ops = [("warp_equirect_kernel<f>", 1000.0, 40.0),
           ("vectorized_elementwise_kernel<c>", 1100.0, 500.0),
           ("warp_equirect_kernel<f>", 5000.0, 40.0),
           ("vectorized_elementwise_kernel<q>", 5100.0, 300.0)]
    trace = Trace(
        [{"ph": "X", "cat": "user_annotation", "name": WINDOW_LABEL,
          "ts": 0.0, "dur": 1e6}]
        + [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
           for n, t, d in ops])
    outcome = harness.Outcome(e2e={}, attempted=1, failed=0,
                              check=lambda dtype: {},
                              work={"mesh_warp": {"frame_us": 9.0}})
    return harness.Readings(outcome, bench, {}, trace)


def _reader(name):
    from portbench import harness
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_readers_are_the_cells_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = "perspcut-video.8k-default.mjpeg-avi"
    mine = {m["name"] for m in spec["per_layer"]
            if m.get("workloads") == [cell]}
    assert mine == set(READERS)


@pytest.mark.parametrize("name", list(READERS))
def test_reader(name, monkeypatch):
    monkeypatch.setattr(tprof, "spans", lambda since=None: list(SYNTHETIC))
    monkeypatch.setattr(executor, "video_frames_warped",
                        lambda start=None, end=None: 8)
    _feed(monkeypatch, DECODES)
    assert _reader(name).read(_readings()) == pytest.approx(READERS[name],
                                                            rel=1e-9)


@pytest.mark.parametrize("name", sorted(set(READERS)
                                        - {"device_idle_pct.video"}))
def test_reader_without_its_program(name, monkeypatch):
    """No frame warped or decoded in the window, or a program without the
    counters and the ring (one older than these spans): None, never a
    raise."""
    reader = _reader(name)
    monkeypatch.setattr(tprof, "spans", lambda since=None: list(SYNTHETIC))
    monkeypatch.setattr(executor, "video_frames_warped",
                        lambda start=None, end=None: 0)
    _feed(monkeypatch, [DECODES[0], DECODES[-1]])
    if name != "video_open_s":
        assert reader.read(_readings()) is None
    monkeypatch.delattr(executor, "video_frames_warped")
    monkeypatch.delattr(executor, "decode_overlap")
    monkeypatch.delattr(tprof, "spans")
    assert reader.read(_readings()) is None


# the full360 cell's readers: two batches of 4 frames × 14 views in the
# window (8 frames' worth), one frame's views before it and one at its end
FULL360_READERS = {
    "offhorizon_view_pct.full360": 100.0 * 10 / 14,
    "pole_view_pct.full360": 100.0 * 2 / 14,
    # 112 view-frames ÷ 14 = 8 frames at 9 µs against 80 µs of warp launches
    "mesh_warp_roofline.full360": 100.0 * 8 * 9.0 / 80.0,
}
VIEW_EVENTS = [(99.5, 1), (100.3, 4), (100.7, 4), (101.0, 1)]


def _feed_views(monkeypatch, events):
    """``executor.view_counts``' counter, holding ``events`` (start,
    frames) of the full360 layout."""
    fed = tprof.WindowCounter(views=add, off_horizon=add, pole=add)
    for t, frames in events:
        fed.add(t, views=14 * frames, off_horizon=10 * frames,
                pole=2 * frames)
    monkeypatch.setattr(executor, "_VIEWS", fed)


def test_full360_readers_are_the_cells_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = "perspcut-video.8k-full360-poles.mjpeg-avi"
    mine = {m["name"] for m in spec["per_layer"]
            if m.get("workloads") == [cell]}
    assert mine == set(FULL360_READERS)


@pytest.mark.parametrize("name", list(FULL360_READERS))
def test_full360_reader(name, monkeypatch):
    _feed_views(monkeypatch, VIEW_EVENTS)
    assert _reader(name).read(_readings()) == pytest.approx(
        FULL360_READERS[name], rel=1e-9)


@pytest.mark.parametrize("name", list(FULL360_READERS))
def test_full360_reader_without_its_program(name, monkeypatch):
    """No view warped in the window, no trace, or a program without the
    counter (the parent of ``view_counts``): None, never a raise."""
    reader = _reader(name)
    _feed_views(monkeypatch, [VIEW_EVENTS[0], VIEW_EVENTS[-1]])
    assert reader.read(_readings()) is None
    _feed_views(monkeypatch, VIEW_EVENTS)
    r = _readings()
    if name == "mesh_warp_roofline.full360":
        assert reader.read(dataclasses.replace(r, trace=None)) is None
    monkeypatch.delattr(executor, "view_counts")
    assert reader.read(r) is None
