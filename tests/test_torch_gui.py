"""The port's GUI modules (``gs360x_torch.gui``, all but the Tk ``app``)
against their counterparts in the JAX package, on the same inputs.

``test_gui_case_against_jax`` is a parametrised counterpart of every case of
``tests/test_gui.py`` (argv builders, overlay math, settings, the process
runner) and ``tests/test_gui_monitor_preview.py`` (the output monitor, the
segmentation preview, the score-review thumbnail): each case runs once with
either package's modules and the two results must be equal (arrays
bitwise). Where the JAX case draws random U-Net weights (JAX's own init),
both packages take the shipped weights instead, read by each package's own
reader (the port's through ``params_from_flax``). The segmentation preview
also runs on a synthetic photo-style scene at the default thresholds: its
instance rows equal, its overlay equal wherever the probability does not lie
within ``MASK_BAND`` of the threshold.

Beside them: every tab of ``forms.TABS`` builds the same argv in both
packages and ``tool_argv`` differs only in the package of the tool;
``plyview.render_points`` and ``overlay.plan_overlays`` bitwise;
``pointedit``, ``maskedit`` and ``scorereview`` (CSV round trip,
``render_chart``, ``frame_thumbnail``) equal; a settings file written by one
package is read by the other; and ``gui/app.py``'s imports, read from its
AST, name only the port, ``tkinter``, Pillow, numpy or the standard
library (no display is needed: nothing here creates a ``tk.Tk``)."""

import ast
import csv
import dataclasses
import importlib
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKGS = ("gs360x", "gs360x_torch")
MASK_BAND = 1e-4   # |p - threshold| within which a mask pixel may flip


def mod(pkg: str, name: str):
    """``<pkg>.<name>``, e.g. ``mod("gs360x_torch", "gui.forms")``."""
    return importlib.import_module(f"{pkg}.{name}")


def assert_same(a, b, where="result"):
    """Deep equality: arrays bitwise (dtype too), dataclasses by field."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        assert_same(dataclasses.asdict(a), dataclasses.asdict(b), where)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for key in a:
            assert_same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def wait_for(done, polls=600):
    for _ in range(polls):   # generous under load
        if done:
            return
        time.sleep(0.05)


def packaged_params(pkg: str):
    """The shipped U-Net weights, read by the package's own reader."""
    return mod(pkg, "models.synthseg").load_packaged_weights()


def preview_kw(pkg: str) -> dict:
    """The preview's arguments: the shipped weights, and for the port its
    device (the CPU here; the app passes the card)."""
    kw = {"params": packaged_params(pkg)}
    if pkg == "gs360x_torch":
        kw["device"] = torch.device("cpu")
    return kw


def write_image(pkg, path, img):
    mod(pkg, "io.image").write_image(path, img)


# ---- the cases of tests/test_gui.py and tests/test_gui_monitor_preview.py --
# each takes the package and a directory of its own, and returns what the
# JAX test asserts on


def argv_video2frames(pkg, tmp):
    return mod(pkg, "gui.forms").build_video2frames_argv(
        {"video": "/v.y4m", "fps": 2.5, "output": "/o",
         "keep_rec709": True, "map_stream": "0:v:1"})


def argv_defaults_omitted(pkg, tmp):
    return mod(pkg, "gui.forms").build_perspcut_argv(
        {"input_dir": "/p", "preset": "default", "count": 8, "size": 1600,
         "focal_mm": 12.0, "ext": "jpg", "backend": "auto"})


def argv_perspcut_overrides(pkg, tmp):
    return mod(pkg, "gui.forms").build_perspcut_argv(
        {"input_dir": "/p", "preset": "fisheyelike", "size": 2000,
         "setcam": "A=10", "add_top": True})


def argv_dualfisheye_extract_queue(pkg, tmp):
    return mod(pkg, "gui.forms").build_dualfisheye_extract_queue(
        {"video": "/c.mp4", "fps": 2.0})


def argv_camconvert_per_format_input_flag(pkg, tmp):
    forms = mod(pkg, "gui.forms")
    return [forms.build_camconvert_argv(
        {"cmd": "colmap", "input": "/cm", "out": "/o"}),
        forms.build_camconvert_argv(
            {"cmd": "realityscan-csv", "input": "/a.csv", "out": "/o",
             "width": 1600, "height": 1600})]


TAB_SAMPLES = {
    "video2frames": {"video": "/v", "fps": 1},
    "frameselector": {"in_dir": "/d"},
    "perspcut": {"input_dir": "/d"},
    "maskseg": {"input_dir": "/d"},
    "plyopt": {"input": "/c.ply"},
    "ms360xml": {"xml": "/x.xml"},
    "dualfisheye": {"camera_xml": "/c.xml"},
    "camconvert": {"cmd": "colmap", "input": "/cm", "out": "/o"},
    "scene": {"source": "/s"},
}


def argv_all_tabs_build(pkg, tmp):
    return [(title, module, list(fields), build(TAB_SAMPLES[module]))
            for title, module, fields, build in mod(pkg, "gui.forms").TABS]


def argv_tool_argv_launches_module(pkg, tmp):
    argv = mod(pkg, "gui.runner").tool_argv("perspcut", ["-i", "/p"])
    assert argv[0] == sys.executable
    assert argv[2] == f"{pkg}.tools.perspcut"
    return argv[:2] + ["<pkg>.tools.perspcut"] + argv[3:]


def view_spec(pkg, *args, **kw):
    return mod(pkg, "rig.spec").ViewSpec(*args, **kw)


def overlay_front_view_centered(pkg, tmp):
    view = view_spec(pkg, "A", 0.0, 0.0, 90.0, 90.0, 100, 100)
    return mod(pkg, "gui.overlay").view_overlay(view, 1000, 500)


def overlay_seam_view_splits(pkg, tmp):
    view = view_spec(pkg, "E", 180.0, 0.0, 90.0, 90.0, 100, 100)
    return mod(pkg, "gui.overlay").view_overlay(view, 1000, 500)


def overlay_fisheye_circle(pkg, tmp):
    view = view_spec(pkg, "X", 0.0, 0.0, 180.0, 180.0, 100, 100,
                     projection="fisheye_v360")
    return mod(pkg, "gui.overlay").view_overlay(view, 1000, 500)


def overlay_plan_overlays_count(pkg, tmp):
    views = [view_spec(pkg, t, i * 45.0, 0.0, 90.0, 90.0, 10, 10)
             for i, t in enumerate("ABCD")]
    return mod(pkg, "gui.overlay").plan_overlays(views, 800, 400)


def settings_round_trip(pkg, tmp):
    settings = mod(pkg, "gui.settings")
    s = settings.Settings(tmp / "cfg.json")
    s.set("theme", "dark")
    s.update_tab("perspcut", {"size": 2048})
    s.save()
    s2 = settings.Settings(tmp / "cfg.json")
    return [s2.get("theme"), s2.tab("perspcut"),
            (tmp / "cfg.json").read_text()]


def settings_corrupt_file_ignored(pkg, tmp):
    p = tmp / "bad.json"
    p.write_text("{not json")
    return mod(pkg, "gui.settings").Settings(p).tab("x")


def runner_streams_and_completes(pkg, tmp):
    runner = mod(pkg, "gui.runner").ProcessRunner()
    lines, done = [], []
    ok = runner.run("t", [sys.executable, "-c",
                          "print('hello'); print('world')"],
                    lines.append, done.append)
    wait_for(done)
    return [ok, done, "".join(lines)]


def runner_single_flight(pkg, tmp):
    runner = mod(pkg, "gui.runner").ProcessRunner()
    lines = []
    runner.run("k", [sys.executable, "-c", "import time; time.sleep(2)"],
               lines.append)
    again = runner.run("k", [sys.executable, "-c", "pass"], lines.append)
    return [again, runner.stop("k"), lines[0]]


def runner_queue_sequential(pkg, tmp):
    runner = mod(pkg, "gui.runner").ProcessRunner()
    lines, done = [], []
    runner.run_queue("q", [[sys.executable, "-c", "print('one')"],
                           [sys.executable, "-c", "print('two')"]],
                     lines.append, done.append)
    wait_for(done)
    return [done, "".join(lines)]


def runner_queue_aborts_on_failure(pkg, tmp):
    runner = mod(pkg, "gui.runner").ProcessRunner()
    lines, done = [], []
    runner.run_queue("q2", [[sys.executable, "-c", "raise SystemExit(3)"],
                            [sys.executable, "-c", "print('never')"]],
                     lines.append, done.append)
    wait_for(done)
    return [done, "".join(lines)]


def monitor_patterns_expand_frame_slots(pkg, tmp):
    return mod(pkg, "gui.monitor").patterns_for_outputs(
        ["clip_%07d_A.jpg", "clip_%07d_A.jpg", "one.png"])


def monitor_counts_only_matches(pkg, tmp):
    for name in ("clip_0000001_A.jpg", "clip_0000002_A.jpg", "other.txt"):
        (tmp / name).write_bytes(b"x")
    return mod(pkg, "gui.monitor").count_matches(tmp, ["clip_*_A.jpg"])


def monitor_stepped_reports_until_total(pkg, tmp):
    reports = []
    mon = mod(pkg, "gui.monitor").OutputMonitor(
        tmp, ["f_*.jpg"], 4, lambda p, d, t: reports.append((p, d, t)))
    first = mon.poll_once(0)
    for i in range(4):
        (tmp / f"f_{i}.jpg").write_bytes(b"x")
    return [first, mon.poll_once(0), reports]


def monitor_baseline_excludes_preexisting(pkg, tmp):
    monitor = mod(pkg, "gui.monitor")
    (tmp / "f_0.jpg").write_bytes(b"x")
    reports = []
    mon = monitor.OutputMonitor(tmp, ["f_*.jpg"], 2,
                                lambda p, d, t: reports.append(d))
    initial = monitor.count_matches(tmp, ["f_*.jpg"])
    (tmp / "f_1.jpg").write_bytes(b"x")
    return [mon.poll_once(initial), reports]


def monitor_unknown_total_reports_growth(pkg, tmp):
    reports = []
    mon = mod(pkg, "gui.monitor").OutputMonitor(
        tmp, ["*"], 0, lambda p, d, t: reports.append((p, d)))
    (tmp / "a.jpg").write_bytes(b"x")
    return [mon.poll_once(0), reports]


def segpreview_overlay_and_rows(pkg, tmp):
    rng = np.random.default_rng(0)
    img = (rng.random((64, 96, 3)) * 255).astype(np.uint8)
    return mod(pkg, "gui.segpreview").preview_segmentation(
        img, targets=("person",), score_thresh=0.0, mask_thresh=0.0,
        **preview_kw(pkg))


def segpreview_downscales_large_inputs(pkg, tmp):
    img = np.zeros((1400, 700, 3), np.uint8)
    return mod(pkg, "gui.segpreview").preview_segmentation(
        img, score_thresh=1.1, **preview_kw(pkg))


def segpreview_first_image_of_dir(pkg, tmp):
    write_image(pkg, tmp / "b.png", np.zeros((32, 32, 3), np.uint8))
    write_image(pkg, tmp / "a.png", np.full((32, 32, 3), 99, np.uint8))
    return mod(pkg, "gui.segpreview").preview_first_image(
        tmp, score_thresh=1.1, **preview_kw(pkg))


def _review_session(pkg, tmp, filename):
    csv_path = tmp / "sel.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "input_mode", "filename", "pair_base",
                    "x_filename", "y_filename", "score", "brightness_mean",
                    "group_score", "flow_motion", "selected(1=keep)"])
        w.writerow([0, "single", filename, "", "", "", 1.0, 0.5, 1.0, 0.0,
                    1])
    return mod(pkg, "gui.scorereview").ReviewSession.load(csv_path)


def thumbnail_of_cursor_frame(pkg, tmp):
    write_image(pkg, tmp / "frame.png", np.full((480, 640, 3), 200, np.uint8))
    session = _review_session(pkg, tmp, "frame.png")
    return mod(pkg, "gui.scorereview").frame_thumbnail(session, tmp,
                                                       max_edge=100)


def thumbnail_missing_file_reports_reason(pkg, tmp):
    session = _review_session(pkg, tmp, "gone.png")
    return mod(pkg, "gui.scorereview").frame_thumbnail(session, tmp)


CASES = {fn.__name__: fn for fn in (
    # tests/test_gui.py
    argv_video2frames, argv_defaults_omitted, argv_perspcut_overrides,
    argv_dualfisheye_extract_queue, argv_camconvert_per_format_input_flag,
    argv_all_tabs_build, argv_tool_argv_launches_module,
    overlay_front_view_centered, overlay_seam_view_splits,
    overlay_fisheye_circle, overlay_plan_overlays_count,
    settings_round_trip, settings_corrupt_file_ignored,
    runner_streams_and_completes, runner_single_flight,
    runner_queue_sequential, runner_queue_aborts_on_failure,
    # tests/test_gui_monitor_preview.py
    monitor_patterns_expand_frame_slots, monitor_counts_only_matches,
    monitor_stepped_reports_until_total,
    monitor_baseline_excludes_preexisting,
    monitor_unknown_total_reports_growth,
    segpreview_overlay_and_rows, segpreview_downscales_large_inputs,
    segpreview_first_image_of_dir,
    thumbnail_of_cursor_frame, thumbnail_missing_file_reports_reason)}


@pytest.mark.parametrize("case", list(CASES))
def test_gui_case_against_jax(case, tmp_path):
    got = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        got[pkg] = CASES[case](pkg, tmp_path / pkg)
    assert_same(got["gs360x"], got["gs360x_torch"], case)


def test_every_case_of_the_jax_gui_tests_has_a_counterpart():
    """27 cases: one for each test of the two JAX files, by name."""
    names = []
    for name in ("test_gui.py", "test_gui_monitor_preview.py"):
        tree = ast.parse((ROOT / "tests" / name).read_text())
        names += [node.name[len("test_"):] for node in ast.walk(tree)
                  if isinstance(node, ast.FunctionDef)
                  and node.name.startswith("test_")]
    assert len(names) == len(CASES) == 27
    for name in names:
        assert any(case.endswith(name) for case in CASES), name


# ---- the segmentation preview on a scene, at the default thresholds -------


def test_segpreview_on_a_scene_against_jax():
    """A synthseg photo-style scene with persons in it, the shipped weights
    and the default thresholds: the instance rows are equal; the overlays
    are equal wherever the port's probability of the target class lies
    outside ``MASK_BAND`` of the mask threshold."""
    from gs360x_torch.models import segmentation as tseg
    from gs360x_torch.models import synthseg as tsyn

    img, _labels = tsyn.generate_scene(np.random.default_rng(3), size=160)
    img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    got = {pkg: mod(pkg, "gui.segpreview").preview_segmentation(
        img, targets=("person",), **preview_kw(pkg)) for pkg in PKGS}
    (j_overlay, j_rows), (t_overlay, t_rows) = got["gs360x"], \
        got["gs360x_torch"]
    assert t_rows, "no person found: the scene does not test the preview"
    assert_same(j_rows, t_rows, "rows")
    predictor = tseg.SegmentationPredictor(packaged_params("gs360x_torch"),
                                           device=torch.device("cpu"))
    prob = predictor.probabilities(
        img.astype(np.float32) / 255.0,
        [tseg.CLASS_TO_INDEX["person"]])[0].numpy()
    outside = np.abs(prob - tseg.MASK_THRESH) >= MASK_BAND
    assert t_overlay.shape == j_overlay.shape == img.shape
    np.testing.assert_array_equal(t_overlay[outside], j_overlay[outside])


# ---- the modules the JAX GUI tests above do not reach ---------------------


def test_tabs_and_tool_argv_against_jax():
    """Every tab of ``forms.TABS``: the same title, fields and argv; the
    runner launches the same tool of the port's own package."""
    jforms, tforms = mod("gs360x", "gui.forms"), mod("gs360x_torch",
                                                     "gui.forms")
    assert len(jforms.TABS) == len(tforms.TABS) == 9
    for jtab, ttab in zip(jforms.TABS, tforms.TABS):
        assert jtab[:3] == ttab[:3]
        sample = TAB_SAMPLES[ttab[1]]
        assert jtab[3](sample) == ttab[3](sample)
        jargv = mod("gs360x", "gui.runner").tool_argv(jtab[1], ["-x"])
        targv = mod("gs360x_torch", "gui.runner").tool_argv(ttab[1], ["-x"])
        assert targv[2] == jargv[2].replace("gs360x.tools.",
                                            "gs360x_torch.tools.")
        assert targv[:2] + targv[3:] == jargv[:2] + jargv[3:]


def _cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * 2.0,
            rng.integers(0, 256, (n, 3)).astype(np.uint8))


@pytest.mark.parametrize("mode", ["perspective", "ortho", "budget",
                                  "orbited"])
def test_plyview_render_points_against_jax(mode):
    """The rasterizer with the grid, axes and frusta, bitwise."""
    xyz, rgb = _cloud()
    segs = np.array([[[-1, 0, 0], [1, 0, 0]], [[0, -1, 0], [0, 1, 2]]],
                    float)
    images = []
    for pkg in PKGS:
        plyview = mod(pkg, "gui.plyview")
        cam = plyview.OrbitCamera(distance=8.0, ortho=mode == "ortho")
        if mode == "orbited":
            cam.orbit(30.0, 12.0)
            cam.pan(0.3, -0.2)
            cam.zoom(0.8)
        images.append(plyview.render_points(
            xyz, rgb, cam, 96, 64, splat=2, segments=segs,
            point_budget=500 if mode == "budget" else None))
        images.append((cam.quat, cam.eye()))
    assert_same(images[:2], images[2:])


def test_plan_overlays_of_a_preset_against_jax():
    """The overlays of ``full360coverage``'s plan (pitched views across the
    seam) and of ``fisheyeXY``'s, bitwise."""
    got = []
    for pkg in PKGS:
        presets = mod(pkg, "rig.presets")
        for preset in ("full360coverage", "fisheyeXY"):
            plan = presets.build_view_plan(
                presets.PerspCutConfig(preset=preset),
                [pathlib.Path("p.jpg")], pathlib.Path("."))
            got.append(mod(pkg, "gui.overlay").plan_overlays(
                plan.unique_views(), 1024, 512))
    assert_same(got[:2], got[2:])


@pytest.mark.parametrize("op", ["remove_by_color", "bbox_fill_palette",
                                "bbox_fill_color", "sky_dome"])
def test_pointedit_against_jax(op):
    xyz, rgb = _cloud(500, seed=1)
    xyz = xyz.astype(np.float32)
    got = []
    for pkg in PKGS:
        pe = mod(pkg, "gui.pointedit")
        if op == "remove_by_color":
            got.append(pe.remove_points_by_color(xyz, rgb, rgb[7], 60.0))
        elif op == "bbox_fill_palette":
            got.append(pe.add_bbox_fill_points(xyz, rgb, (0, 0, 0),
                                               (1, 2, 3), 50, seed=4))
        elif op == "bbox_fill_color":
            got.append(pe.add_bbox_fill_points(xyz, rgb, (-1, -1, -1),
                                               (1, 1, 1), 10,
                                               color=(1, 2, 3)))
        else:
            got.append(pe.add_sky_dome(xyz, rgb, axis=(0, 1, 0),
                                       scale=10.0, count=100))
    assert_same(got[0], got[1], op)


def test_maskedit_against_jax(tmp_path):
    """Strokes, an erased line, undo and clear, the overlay, the layer's
    path, its PNG and its reload: equal."""
    got = []
    for pkg in PKGS:
        me = mod(pkg, "gui.maskedit")
        c = me.MaskCanvas(48, 64)
        c.stroke(20, 30, 9)
        c.line(5, 3, 40, 60, 3)
        c.line(20, 10, 20, 50, 2, erase=True)
        c.stroke(0, 63, 6)
        c.undo()
        states = [c.mask.copy(), c.painted_pixels()]
        c.clear()
        c.undo()
        img = np.full((48, 64, 3), 120, np.uint8)
        out = me.save_layer(c, tmp_path / pkg, "shot_0001_C.png")
        back = me.load_layer(tmp_path / pkg, "shot_0002_C.png", (48, 64))
        got.append([states, c.overlay_rgb(img), out.name, out.read_bytes(),
                    back.mask, me.layer_path_for_image(tmp_path, "x.png")
                    .name])
    assert_same(got[0], got[1])


def _selection_csv(path, n=30):
    rng = np.random.default_rng(0)
    from gs360x_torch.tools.frameselector import CSV_HEADER
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for i in range(n):
            score = 100.0 + 50.0 * float(rng.random())
            bright = 0.1 if i == 21 else 0.6
            score = 1.0 if i == 7 else score
            w.writerow([i, "single", f"frame_{i:04d}.png", "", "", "",
                        score, bright, score, 0.5, 1 if i % 2 == 0 else 0])


def test_scorereview_against_jax(tmp_path):
    """A selection CSV through ``ReviewSession`` (navigation, suspects,
    toggles, zoom, save) and ``render_chart`` (linear and log),
    ``summary_line``, ``zoom_label``, ``apply_argv`` and
    ``frame_thumbnail``: equal, and each package reads the other's saved
    CSV."""
    got = []
    for pkg in PKGS:
        sr = mod(pkg, "gui.scorereview")
        d = tmp_path / pkg
        d.mkdir()
        _selection_csv(d / "sel.csv")
        write_image(pkg, d / "frame_0003.png",
                    np.arange(240 * 320 * 3, dtype=np.uint8)
                    .reshape(240, 320, 3))
        s = sr.ReviewSession.load(d / "sel.csv")
        row = [s.suspects(), s.next_suspect(), s.next_suspect(True)]
        s.cursor = 3
        s.toggle()
        s.zoom(0.5)
        s.pan(2)
        row += [s.kept_count(), sr.summary_line(s), sr.zoom_label(s),
                sr.render_chart(s, 320, 120)]
        s.log_scale = True
        row += [sr.render_chart(s, 320, 120),
                sr.frame_thumbnail(s, d, max_edge=64),
                sr.apply_argv(d / "sel.csv", d)[::2]]
        s.save(d / "edited.csv")
        row.append((d / "edited.csv").read_text())
        got.append(row)
    assert_same(got[0], got[1])
    for pkg, other in zip(PKGS, PKGS[::-1]):
        s = mod(pkg, "gui.scorereview").ReviewSession.load(
            tmp_path / other / "edited.csv")
        assert s.entries[3].keep and s.kept_count() == 16


@pytest.mark.parametrize("writer", PKGS)
def test_settings_file_is_shared(writer, tmp_path):
    """Both packages keep ``~/.gs360x/gui_settings.json`` in one format: a
    file one writes, the other reads."""
    reader = PKGS[1 - PKGS.index(writer)]
    w = mod(writer, "gui.settings")
    r = mod(reader, "gui.settings")
    assert w.DEFAULT_PATH == r.DEFAULT_PATH
    s = w.Settings(tmp_path / "gui_settings.json")
    s.set("backend", "auto")
    s.update_tab("maskseg", {"mode": "alpha", "mask_expand_pixels": "9"})
    s.save()
    back = r.Settings(tmp_path / "gui_settings.json")
    assert back.get("backend") == "auto"
    assert back.tab("maskseg") == {"mode": "alpha", "mask_expand_pixels": "9"}


def test_app_imports_only_the_port():
    """Every import of ``gui/app.py``, at module level or inside a Tk
    callback, names ``gs360x_torch``, ``tkinter``, Pillow, numpy or the
    standard library; it is the only GUI module that names ``tkinter``."""
    allowed = {"gs360x_torch", "tkinter", "PIL", "numpy"}
    gui = ROOT / "gs360x_torch" / "gui"
    for path in sorted(gui.glob("*.py")):
        names = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
        roots = {name.split(".")[0] for name in names}
        if path.name == "app.py":
            assert {"gs360x_torch", "tkinter"} <= roots
            stray = roots - allowed - set(sys.stdlib_module_names)
            assert not stray, sorted(stray)
            assert not [n for n in names if n.split(".")[0] == "gs360x_torch"
                        and n.count(".") and n.split(".")[1] not in (
                            "gui", "rig", "tools", "io", "core", "models",
                            "device")], names
        else:
            assert "tkinter" not in roots, path.name
            assert "gs360x" not in roots, path.name
