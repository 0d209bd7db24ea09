"""Tkinter application: tabbed front-end over the gs360x_torch CLI tools.

Generic rendering of :mod:`gs360x_torch.gui.forms` tab specs: every tab
gets a form, Run/Stop buttons, and a streamed log pane; the 360PerspCut tab
adds a live preview canvas drawing view-footprint overlays on the loaded
panorama (the reference GUI's core interactions, ``gs360_GUI.py:1446-1493,
8598-8879``). Settings persist per tab across sessions. Each tab launches
its tool as ``python -m gs360x_torch.tools.<module>``, which runs on the
card (the tools' ``--device`` defaults to ``cuda``); the segmentation
preview runs the U-Net in this process on the card too. Needs a display
and ``tkinter``.
"""

from __future__ import annotations

import pathlib
import threading
import queue
import tkinter as tk
from tkinter import filedialog, ttk
from typing import Dict

from gs360x_torch.gui import forms, overlay
from gs360x_torch.gui.runner import ProcessRunner, tool_argv
from gs360x_torch.gui.settings import Settings

OVERLAY_COLORS = ("#ff5252", "#40c4ff", "#69f0ae", "#ffd740", "#ff6e40",
                  "#b388ff", "#64ffda", "#ffab40")


class ToolTab(ttk.Frame):
    def __init__(self, master, app, title, module, fields, build_argv):
        super().__init__(master)
        self.app = app
        self.title = title
        self.module = module
        self.fields = fields
        self.build_argv = build_argv
        self.vars: Dict[str, tk.Variable] = {}
        self._build()
        self._restore()

    # ---- form -------------------------------------------------------------

    def _build(self):
        form = ttk.Frame(self)
        form.pack(side="top", fill="x", padx=8, pady=6)
        for row, (key, label, kind, default) in enumerate(self.fields):
            ttk.Label(form, text=label).grid(row=row, column=0, sticky="w",
                                             padx=4, pady=2)
            if kind == "bool":
                var = tk.BooleanVar(value=bool(default))
                ttk.Checkbutton(form, variable=var).grid(
                    row=row, column=1, sticky="w")
            elif kind.startswith("choice:"):
                var = tk.StringVar(value=str(default))
                ttk.Combobox(form, textvariable=var, state="readonly",
                             values=kind.split(":", 1)[1].split("|"),
                             width=28).grid(row=row, column=1, sticky="w")
            else:
                var = tk.StringVar(value=str(default))
                entry = ttk.Entry(form, textvariable=var, width=48)
                entry.grid(row=row, column=1, sticky="we")
                if kind in ("path", "dir"):
                    ttk.Button(form, text="…", width=3,
                               command=lambda v=var, k=kind:
                               self._browse(v, k)).grid(row=row, column=2)
            self.vars[key] = var
        form.columnconfigure(1, weight=1)

        btns = ttk.Frame(self)
        btns.pack(side="top", fill="x", padx=8)
        ttk.Button(btns, text="Run", command=self.run).pack(side="left")
        ttk.Button(btns, text="Stop", command=self.stop).pack(side="left",
                                                              padx=4)
        ttk.Button(btns, text="Show command",
                   command=self.show_command).pack(side="left", padx=4)

        self.log = tk.Text(self, height=14, state="disabled",
                           font=("monospace", 9))
        self.log.pack(side="bottom", fill="both", expand=True, padx=8,
                      pady=6)

    def _browse(self, var, kind):
        path = (filedialog.askdirectory() if kind == "dir"
                else filedialog.askopenfilename())
        if path:
            var.set(path)

    # ---- values / settings --------------------------------------------------

    def values(self) -> Dict:
        out = {}
        for key, _label, kind, _default in self.fields:
            val = self.vars[key].get()
            if kind == "int" and str(val).strip():
                try:
                    val = int(float(val))
                except ValueError:
                    pass
            elif kind == "float" and str(val).strip():
                try:
                    val = float(val)
                except ValueError:
                    pass
            out[key] = val
        return out

    def _restore(self):
        saved = self.app.settings.tab(self.module)
        for key, var in self.vars.items():
            if key in saved:
                try:
                    var.set(saved[key])
                except tk.TclError:
                    pass

    def persist(self):
        self.app.settings.update_tab(self.module,
                                     {k: v.get() for k, v in
                                      self.vars.items()})

    # ---- run --------------------------------------------------------------

    def append_log(self, text: str):
        self.app.log_queue.put((self, text))

    def run(self):
        self.persist()
        self.app.settings.save()
        try:
            argv = tool_argv(self.module, self.build_argv(self.values()))
        except (KeyError, ValueError) as exc:
            self.append_log(f"[ERR] bad arguments: {exc}\n")
            return
        self.append_log("$ " + " ".join(argv) + "\n")
        self._start_output_monitor()
        self.app.runner.run(self.module, argv, self.append_log,
                            on_done=lambda rc: self._stop_output_monitor())

    def _start_output_monitor(self):
        """Poll the output folder and log file-count growth during a run
        (reference gs360_GUI.py:19196-19267)."""
        from gs360x_torch.gui.monitor import OutputMonitor

        self._out_monitor = None
        values = self.values()
        out = (values.get("out_dir") or values.get("output_dir")
               or values.get("output") or "")
        out_path = pathlib.Path(str(out)) if str(out).strip() else None
        if out_path is None:
            return
        out_path.mkdir(parents=True, exist_ok=True)

        def report(pct, done, total):
            if pct >= 0:
                self.append_log(
                    f"[monitor] {pct:3d}% ({done}/{total}) files\n")
            else:
                self.append_log(f"[monitor] {done} file(s) written\n")

        mon = OutputMonitor(out_path, ["*"], 0, report, interval_sec=10.0)
        if mon.start():
            self._out_monitor = mon

    def _stop_output_monitor(self):
        mon = getattr(self, "_out_monitor", None)
        if mon is not None:
            mon.stop()
            self._out_monitor = None

    def stop(self):
        if self.app.runner.stop(self.module):
            self.append_log("[INFO] stop requested\n")

    def show_command(self):
        try:
            argv = tool_argv(self.module, self.build_argv(self.values()))
            self.append_log("$ " + " ".join(argv) + "\n")
        except (KeyError, ValueError) as exc:
            self.append_log(f"[ERR] bad arguments: {exc}\n")


class PerspCutTab(ToolTab):
    """360PerspCut tab with the view-footprint preview canvas."""

    def _build(self):
        super()._build()
        bar = ttk.Frame(self)
        bar.pack(side="top", fill="x", padx=8)
        ttk.Button(bar, text="Preview overlays",
                   command=self.preview).pack(side="left")
        self.canvas = tk.Canvas(self, height=240, bg="#202020")
        self.canvas.pack(side="top", fill="x", padx=8, pady=4)
        self._photo = None

    def preview(self):
        import numpy as np

        from gs360x_torch.rig.presets import PerspCutConfig, build_view_plan
        from gs360x_torch.tools.perspcut import config_from_args

        values = self.values()
        cfg = PerspCutConfig(
            preset=values.get("preset", "default"),
            count=int(values.get("count") or 8),
            addcam=str(values.get("addcam", "")),
            delcam=str(values.get("delcam", "")),
            setcam=str(values.get("setcam", "")),
            add_top=bool(values.get("add_top")),
            add_bottom=bool(values.get("add_bottom")),
            size=int(values.get("size") or 1600),
            focal_mm=float(values.get("focal_mm") or 12.0))
        plan = build_view_plan(cfg, [pathlib.Path("preview.jpg")],
                               pathlib.Path("."))
        self.append_log(plan.preview_views_line + "\n")

        cw = max(int(self.canvas.winfo_width()), 480)
        ch = cw // 2
        self.canvas.configure(height=ch)
        self.canvas.delete("all")

        # background: the first panorama in the input dir, if any
        in_dir = pathlib.Path(str(values.get("input_dir") or "."))
        bg = None
        if in_dir.is_dir():
            for p in sorted(in_dir.iterdir()):
                if p.suffix.lower() in (".jpg", ".jpeg", ".png"):
                    bg = p
                    break
        if bg is not None:
            try:
                from PIL import Image, ImageTk

                img = Image.open(bg).convert("RGB").resize((cw, ch))
                self._photo = ImageTk.PhotoImage(img)
                self.canvas.create_image(0, 0, image=self._photo,
                                         anchor="nw")
            except Exception:
                pass

        views = plan.unique_views()
        overlays = overlay.plan_overlays(views, cw, ch)
        for i, ov in enumerate(overlays):
            color = OVERLAY_COLORS[i % len(OVERLAY_COLORS)]
            for seg in ov.segments:
                pts = [coord for xy in seg for coord in
                       (float(xy[0]), float(xy[1]))]
                if len(pts) >= 4:
                    self.canvas.create_line(*pts, fill=color, width=2)
            self.canvas.create_text(ov.label_xy[0], ov.label_xy[1],
                                    text=ov.view_id, fill=color,
                                    font=("sans", 10, "bold"))


class FrameSelectorTab(ToolTab):
    """FrameSelector tab with the score-review chart (reference
    ``gs360_GUI.py:15809-17790``): load a selection CSV, navigate the
    per-frame score bars, toggle keep/drop, save, and apply."""

    def _build(self):
        super()._build()
        from gs360x_torch.gui import scorereview  # headless logic

        self.scorereview = scorereview
        self.session = None
        self.csv_path = None
        bar = ttk.Frame(self)
        bar.pack(side="top", fill="x", padx=8)
        ttk.Button(bar, text="Review CSV…",
                   command=self.load_csv).pack(side="left")
        ttk.Button(bar, text="Save CSV",
                   command=self.save_csv).pack(side="left", padx=4)
        ttk.Button(bar, text="Apply (move rejects)",
                   command=self.apply_csv).pack(side="left", padx=4)
        self.logscale_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(bar, text="log scale", variable=self.logscale_var,
                        command=self.redraw).pack(side="left", padx=8)
        self.status = ttk.Label(bar, text="no CSV loaded")
        self.status.pack(side="left", padx=8)
        mid = ttk.Frame(self)
        mid.pack(side="top", fill="x", padx=8, pady=4)
        self.chart = tk.Canvas(mid, height=220, bg="#181818",
                               highlightthickness=0)
        self.chart.pack(side="left", fill="x", expand=True)
        self._chart_photo = None
        # frame preview panel (reference gs360_GUI.py:15809-17790 shows
        # the cursor frame beside the chart)
        right = ttk.Frame(mid)
        right.pack(side="left", padx=(6, 0))
        self.preview_canvas = tk.Canvas(right, width=240, height=180,
                                        bg="#101010",
                                        highlightthickness=0)
        self.preview_canvas.pack(side="top")
        self.preview_caption = ttk.Label(right, text="")
        self.preview_caption.pack(side="top")
        self._preview_photo = None
        for key, fn in (("<Left>", lambda e: self.nav(-1)),
                        ("<Right>", lambda e: self.nav(+1)),
                        ("<space>", lambda e: self.toggle()),
                        ("<s>", lambda e: self.suspect(False)),
                        ("<S>", lambda e: self.suspect(True)),
                        ("<plus>", lambda e: self.zoom(0.5)),
                        ("<minus>", lambda e: self.zoom(2.0))):
            self.chart.bind(key, fn)
        self.chart.bind("<Button-1>", self.click)

    def load_csv(self):
        path = filedialog.askopenfilename(
            filetypes=[("CSV", "*.csv"), ("All", "*")])
        if not path:
            return
        try:
            self.session = self.scorereview.ReviewSession.load(path)
        except (OSError, ValueError) as exc:
            self.append_log(f"[ERR] {exc}\n")
            return
        self.csv_path = path
        self.chart.focus_set()
        self.redraw()

    def save_csv(self):
        if self.session and self.csv_path:
            self.session.save(self.csv_path)
            self.append_log(f"[OK] saved {self.csv_path}\n")

    def apply_csv(self):
        if not (self.session and self.csv_path):
            return
        self.save_csv()
        in_dir = str(self.values().get("in_dir") or
                     pathlib.Path(self.csv_path).parent)
        argv = tool_argv("frameselector",
                         self.scorereview.apply_argv(self.csv_path, in_dir))
        self.append_log("$ " + " ".join(argv) + "\n")
        self.app.runner.run(self.module, argv, self.append_log)

    def nav(self, delta):
        if self.session:
            self.session.move(delta)
            self.redraw()

    def toggle(self):
        if self.session:
            self.session.toggle()
            self.redraw()

    def suspect(self, backwards):
        if self.session:
            self.session.next_suspect(backwards)
            self.redraw()

    def zoom(self, factor):
        if self.session:
            self.session.zoom(factor)
            self.redraw()

    def click(self, event):
        self.chart.focus_set()
        if not self.session:
            return
        n = self.session.view_count
        w = max(int(self.chart.winfo_width()), 1)
        k = int((event.x - 18) / max(w - 36, 1) * n)
        self.session.cursor = int(min(max(self.session.view_start + k,
                                          0), len(self.session.entries) - 1))
        self.redraw()

    def redraw(self):
        if not self.session:
            return
        self.session.log_scale = bool(self.logscale_var.get())
        w = max(int(self.chart.winfo_width()), 480)
        h = max(int(self.chart.winfo_height()), 160)
        img = self.scorereview.render_chart(self.session, w, h)
        try:
            from PIL import Image, ImageTk

            self._chart_photo = ImageTk.PhotoImage(Image.fromarray(img))
            self.chart.delete("all")
            self.chart.create_image(0, 0, image=self._chart_photo,
                                    anchor="nw")
        except Exception:
            pass
        self.status.configure(
            text=self.scorereview.summary_line(self.session) + "  " +
            self.scorereview.zoom_label(self.session))
        self.update_preview()

    def update_preview(self):
        if not self.session:
            return
        in_dir = str(self.values().get("in_dir") or
                     (pathlib.Path(self.csv_path).parent
                      if self.csv_path else "."))
        thumb, caption = self.scorereview.frame_thumbnail(
            self.session, in_dir, max_edge=240)
        self.preview_caption.configure(text=caption)
        self.preview_canvas.delete("all")
        if thumb is None:
            return
        try:
            from PIL import Image, ImageTk

            self._preview_photo = ImageTk.PhotoImage(
                Image.fromarray(thumb))
            self.preview_canvas.configure(width=thumb.shape[1],
                                          height=thumb.shape[0])
            self.preview_canvas.create_image(0, 0,
                                             image=self._preview_photo,
                                             anchor="nw")
        except Exception:
            pass


class _ViewerMixin:
    """Shared orbit-viewer canvas behavior for the PLY / scene tabs:
    render via :mod:`gs360x_torch.gui.plyview` (pure numpy), drag to orbit,
    wheel to zoom, right-drag to pan (reference ``gs360_GUI.py:
    13614-13762``)."""

    def _init_viewer(self, height=340):
        from gs360x_torch.gui import plyview

        self.plyview = plyview
        self.camera = plyview.OrbitCamera()
        self.viewer = tk.Canvas(self, height=height, bg="#101014",
                                highlightthickness=0)
        self.viewer.pack(side="top", fill="both", expand=True, padx=8,
                         pady=4)
        self._viewer_photo = None
        self._drag = None
        self.viewer.bind("<ButtonPress-1>", self._drag_start)
        self.viewer.bind("<B1-Motion>", lambda e: self._drag_move(e, "orbit"))
        self.viewer.bind("<ButtonPress-3>", self._drag_start)
        self.viewer.bind("<B3-Motion>", lambda e: self._drag_move(e, "pan"))
        self.viewer.bind("<ButtonRelease-1>", self._drag_end)
        self.viewer.bind("<ButtonRelease-3>", self._drag_end)
        self.viewer.bind("<MouseWheel>", self._wheel)
        self.viewer.bind("<Button-4>", lambda e: self._zoom(1 / 1.15))
        self.viewer.bind("<Button-5>", lambda e: self._zoom(1.15))
        self.xyz = None
        self.rgb = None
        self.segments = None

    def _drag_start(self, event):
        self._drag = (event.x, event.y)

    def _drag_end(self, _event):
        self._drag = None
        self.redraw_viewer(interactive=False)

    def _drag_move(self, event, mode):
        if self._drag is None:
            self._drag = (event.x, event.y)
            return
        dx = event.x - self._drag[0]
        dy = event.y - self._drag[1]
        self._drag = (event.x, event.y)
        if mode == "orbit":
            self.camera.orbit(-dx * 0.4, -dy * 0.4)
        else:
            s = self.camera.distance * 0.002
            self.camera.pan(-dx * s, dy * s)
        self.redraw_viewer(interactive=True)

    def _wheel(self, event):
        self._zoom(1.15 if event.delta < 0 else 1 / 1.15)

    def _zoom(self, factor):
        self.camera.zoom(factor)
        self.redraw_viewer(interactive=False)

    def redraw_viewer(self, interactive=False):
        if self.xyz is None:
            return
        w = max(int(self.viewer.winfo_width()), 480)
        h = max(int(self.viewer.winfo_height()), 240)
        budget = (self.plyview.INTERACTIVE_POINT_BUDGET if interactive
                  else self.plyview.STATIC_POINT_BUDGET)
        img = self.plyview.render_points(
            self.xyz, self.rgb, self.camera, w, h,
            point_budget=budget, segments=self.segments)
        try:
            from PIL import Image, ImageTk

            self._viewer_photo = ImageTk.PhotoImage(Image.fromarray(img))
            self.viewer.delete("all")
            self.viewer.create_image(0, 0, image=self._viewer_photo,
                                     anchor="nw")
        except Exception:
            pass

    def _set_cloud(self, xyz, rgb, *, fit=True):
        import numpy as np

        self.xyz = np.asarray(xyz, np.float64)
        self.rgb = np.asarray(rgb, np.uint8)
        if fit and len(self.xyz):
            self.camera.fit(self.xyz)
        self.redraw_viewer()


class PlyOptTab(ToolTab, _ViewerMixin):
    """PointCloudOptimizer tab: CLI form + interactive viewer with the
    reference's in-viewer edits (sky dome, remove-by-color, bbox fill,
    save — ``gs360_GUI.py:12392-13428``)."""

    def _build(self):
        super()._build()
        bar = ttk.Frame(self)
        bar.pack(side="top", fill="x", padx=8)
        ttk.Button(bar, text="Open PLY…",
                   command=self.open_ply).pack(side="left")
        ttk.Button(bar, text="Save PLY…",
                   command=self.save_ply).pack(side="left", padx=4)
        ttk.Button(bar, text="Add sky dome",
                   command=self.add_sky).pack(side="left", padx=4)
        ttk.Button(bar, text="Remove color",
                   command=self.remove_color).pack(side="left", padx=4)
        self.color_var = tk.StringVar(value="135,206,250")
        ttk.Entry(bar, textvariable=self.color_var,
                  width=12).pack(side="left")
        self.tol_var = tk.StringVar(value="30")
        ttk.Entry(bar, textvariable=self.tol_var, width=5).pack(side="left")
        self.viewer_status = ttk.Label(bar, text="")
        self.viewer_status.pack(side="left", padx=8)
        self._init_viewer()

    def open_ply(self):
        from gs360x_torch.io import ply as plyio

        path = filedialog.askopenfilename(
            filetypes=[("PLY", "*.ply"), ("All", "*")])
        if not path:
            return
        try:
            xyz, rgb = plyio.load_ply_xyz_rgb(path)
        except (OSError, ValueError) as exc:
            self.append_log(f"[ERR] {exc}\n")
            return
        self._set_cloud(xyz, rgb)
        self._status(f"{len(self.xyz):,} pts — {path}")

    def save_ply(self):
        from gs360x_torch.io import ply as plyio

        if self.xyz is None:
            return
        path = filedialog.asksaveasfilename(defaultextension=".ply")
        if path:
            plyio.save_ply_xyz_rgb(path, self.xyz, self.rgb)
            self.append_log(f"[OK] saved {path}\n")

    def add_sky(self):
        from gs360x_torch.gui import pointedit

        if self.xyz is None:
            return
        self.xyz, self.rgb = pointedit.add_sky_dome(self.xyz, self.rgb)
        self._set_cloud(self.xyz, self.rgb, fit=False)
        self._status(f"{len(self.xyz):,} pts (sky dome added)")

    def remove_color(self):
        from gs360x_torch.gui import pointedit

        if self.xyz is None:
            return
        try:
            color = tuple(int(v) for v in
                          self.color_var.get().split(","))
            tol = float(self.tol_var.get())
        except ValueError:
            self.append_log("[ERR] color must be R,G,B\n")
            return
        self.xyz, self.rgb, removed = pointedit.remove_points_by_color(
            self.xyz, self.rgb, color, tol)
        self._set_cloud(self.xyz, self.rgb, fit=False)
        self._status(f"{len(self.xyz):,} pts ({removed:,} removed)")

    def _status(self, text):
        self.viewer_status.configure(text=text)


class SceneViewerTab(ToolTab, _ViewerMixin):
    """CameraOptimization tab: loads any supported scene format and
    renders points + camera frusta (reference ``gs360_GUI.py:
    7755-8597, 14184-15663``)."""

    def _build(self):
        super()._build()
        bar = ttk.Frame(self)
        bar.pack(side="top", fill="x", padx=8)
        ttk.Button(bar, text="Load scene…",
                   command=self.load_scene_file).pack(side="left")
        ttk.Button(bar, text="Load COLMAP dir…",
                   command=self.load_scene_dir).pack(side="left", padx=4)
        ttk.Button(bar, text="Preview transform",
                   command=self.preview_transform).pack(side="left", padx=4)
        self.scene_status = ttk.Label(bar, text="")
        self.scene_status.pack(side="left", padx=8)
        self._init_viewer()
        self._base_xyz = None
        self._base_segments = None

    def load_scene_file(self):
        path = filedialog.askopenfilename()
        if path:
            self._load(path)

    def load_scene_dir(self):
        path = filedialog.askdirectory()
        if path:
            self._load(path)

    def _load(self, path):
        import numpy as np

        from gs360x_torch.io import scene as scenelib

        try:
            sc = scenelib.load_scene(path)
        except (OSError, ValueError) as exc:
            self.append_log(f"[ERR] {exc}\n")
            return
        segs = []
        scale = 1.0
        if len(sc.points_xyz):
            span = float(np.linalg.norm(sc.points_xyz.max(0)
                                        - sc.points_xyz.min(0)))
            scale = max(span * 0.02, 1e-3)
        for pose in sc.cameras:
            segs.append(scenelib.frustum_segments(pose, scale=scale))
        self.segments = np.concatenate(segs) if segs else None
        self._set_cloud(sc.points_xyz, sc.points_rgb)
        if not len(sc.points_xyz) and self.segments is not None:
            self.camera.fit(self.segments.reshape(-1, 3))
            self.redraw_viewer()
        self._base_xyz = self.xyz
        self._base_segments = self.segments
        self.scene_status.configure(
            text=f"{sc.source_kind}: {len(sc.cameras)} cams, "
                 f"{len(sc.points_xyz):,} pts")
        for line in sc.normalization_log:
            self.append_log(f"[INFO] {line}\n")

    def preview_transform(self):
        """Apply the form's camera-rot / scale values to the display
        (reference 'preview world transform' — the CLI run then makes
        it real via --camera-rot-*-deg)."""
        import numpy as np

        from gs360x_torch.core import pose as posemath

        if self._base_xyz is None:
            return
        v = self.values()

        def f(key, default):
            try:
                return float(v.get(key) or default)
            except (TypeError, ValueError):
                return default

        rot = (posemath.rot_z_deg(f("camera_rot_z_deg", 0.0))
               @ posemath.rot_y_deg(f("camera_rot_y_deg", 0.0))
               @ posemath.rot_x_deg(f("camera_rot_x_deg", 0.0)))
        cam_s = f("camera_scale", 1.0)
        pts_s = f("pointcloud_scale", 1.0)
        self.xyz = (self._base_xyz @ rot.T) * pts_s
        if self._base_segments is not None:
            self.segments = (self._base_segments.reshape(-1, 3) @ rot.T
                             ).reshape(self._base_segments.shape) * cam_s
        self.redraw_viewer()


class DualFisheyeTab(ToolTab):
    """DualFisheyePipeline tab with the two-stage lens extraction queue
    (reference ``gs360_GUI.py:9788-9819``): Video2Frames runs twice —
    ``-map 0:v:1`` with ``_Y`` suffix, then ``-map 0:v:0`` with ``_X``
    — sequentially through the process runner's queue."""

    def _build(self):
        super()._build()
        bar = ttk.Frame(self)
        bar.pack(side="top", fill="x", padx=8)
        ttk.Button(bar, text="Extract lens streams…",
                   command=self.extract_streams).pack(side="left")
        ttk.Label(bar, text="video").pack(side="left", padx=(8, 2))
        self.video_var = tk.StringVar(value="")
        ttk.Entry(bar, textvariable=self.video_var,
                  width=36).pack(side="left")
        ttk.Button(bar, text="…", width=3,
                   command=lambda: self._pick_video()).pack(side="left")
        ttk.Label(bar, text="fps").pack(side="left", padx=(8, 2))
        self.fps_var = tk.StringVar(value="2")
        ttk.Entry(bar, textvariable=self.fps_var, width=5).pack(side="left")

    def _pick_video(self):
        path = filedialog.askopenfilename()
        if path:
            self.video_var.set(path)

    def extract_streams(self):
        video = self.video_var.get().strip()
        if not video:
            self._pick_video()
            video = self.video_var.get().strip()
            if not video:
                return
        try:
            fps = float(self.fps_var.get())
        except ValueError:
            self.append_log("[ERR] fps must be a number\n")
            return
        jobs = forms.build_dualfisheye_extract_queue(
            {"video": video, "fps": fps})
        argvs = [tool_argv("video2frames", j) for j in jobs]
        for argv in argvs:
            self.append_log("$ " + " ".join(argv) + "\n")
        self.app.runner.run_queue(self.module, argvs, self.append_log)


class MaskSegTab(ToolTab):
    """SegmentationMask tab with the paint-based manual add-mask editor
    (reference ``gs360_GUI.py:4531-5735``): painted layers save into the
    form's manual-mask dir and merge into every matching frame when the
    CLI runs with ``--manual-mask-dir``."""

    def _build(self):
        super()._build()
        from gs360x_torch.gui import maskedit

        self.maskedit = maskedit
        self.canvas_model = None
        self.image = None
        self.image_path = None
        bar = ttk.Frame(self)
        bar.pack(side="top", fill="x", padx=8)
        ttk.Button(bar, text="Edit mask for image…",
                   command=self.open_image).pack(side="left")
        ttk.Button(bar, text="Save layer",
                   command=self.save_layer).pack(side="left", padx=4)
        ttk.Button(bar, text="Undo",
                   command=self.undo).pack(side="left", padx=4)
        ttk.Button(bar, text="Clear",
                   command=self.clear).pack(side="left", padx=4)
        self.brush_var = tk.StringVar(value="20")
        ttk.Label(bar, text="brush").pack(side="left", padx=(8, 2))
        ttk.Entry(bar, textvariable=self.brush_var,
                  width=4).pack(side="left")
        self.erase_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(bar, text="erase",
                        variable=self.erase_var).pack(side="left", padx=4)
        ttk.Button(bar, text="Preview segmentation",
                   command=self.preview_segmentation).pack(side="left",
                                                           padx=8)
        self.edit_status = ttk.Label(bar, text="")
        self.edit_status.pack(side="left", padx=8)
        self.paint = tk.Canvas(self, height=300, bg="#101014",
                               highlightthickness=0)
        self.paint.pack(side="top", fill="both", expand=True, padx=8,
                        pady=4)
        self._paint_photo = None
        self._last = None
        self.paint.bind("<ButtonPress-1>", self._paint_start)
        self.paint.bind("<B1-Motion>", self._paint_move)
        self.paint.bind("<ButtonRelease-1>", lambda e: self._end())

    def _manual_dir(self):
        d = str(self.values().get("manual_mask_dir") or "").strip()
        if not d:
            d = filedialog.askdirectory(title="Manual mask dir")
            if d and "manual_mask_dir" in self.vars:
                self.vars["manual_mask_dir"].set(d)
        return d or None

    def open_image(self):
        import numpy as np

        from gs360x_torch.io.image import read_image

        path = filedialog.askopenfilename()
        if not path:
            return
        try:
            img = read_image(path)
        except (OSError, ValueError) as exc:
            self.append_log(f"[ERR] {exc}\n")
            return
        if img.dtype != np.uint8:
            img = (img >> 8).astype(np.uint8)
        self.image = img
        self.image_path = path
        d = self._manual_dir()
        existing = self.maskedit.load_layer(d, path, img.shape[:2]) \
            if d else None
        self.canvas_model = existing or self.maskedit.MaskCanvas(
            *img.shape[:2])
        self._redraw()
        self.edit_status.configure(
            text=f"{pathlib.Path(path).name} "
                 f"({'loaded layer' if existing else 'new layer'})")

    def _scale(self):
        h, w = self.image.shape[:2]
        cw = max(int(self.paint.winfo_width()), 100)
        ch = max(int(self.paint.winfo_height()), 100)
        return min(cw / w, ch / h)

    def _paint_start(self, event):
        self._last = (event.y, event.x)
        self._apply(event)

    def _paint_move(self, event):
        self._apply(event)

    def _end(self):
        self._last = None

    def _apply(self, event):
        if self.canvas_model is None:
            return
        s = self._scale()
        try:
            radius = max(1, int(float(self.brush_var.get()) / s))
        except ValueError:
            radius = 20
        y, x = int(event.y / s), int(event.x / s)
        ly, lx = self._last or (event.y, event.x)
        self.canvas_model.line(int(ly / s), int(lx / s), y, x, radius,
                               erase=bool(self.erase_var.get()))
        self._last = (event.y, event.x)
        self._redraw()

    def _redraw(self):
        if self.image is None:
            return
        overlay = self.canvas_model.overlay_rgb(self.image)
        s = self._scale()
        try:
            from PIL import Image, ImageTk

            pil = Image.fromarray(overlay)
            pil = pil.resize((max(1, int(overlay.shape[1] * s)),
                              max(1, int(overlay.shape[0] * s))))
            self._paint_photo = ImageTk.PhotoImage(pil)
            self.paint.delete("all")
            self.paint.create_image(0, 0, image=self._paint_photo,
                                    anchor="nw")
        except Exception:
            pass

    def save_layer(self):
        if self.canvas_model is None or self.image_path is None:
            return
        d = self._manual_dir()
        if not d:
            return
        out = self.maskedit.save_layer(self.canvas_model, d,
                                       self.image_path)
        self.append_log(f"[OK] manual layer: {out} "
                        f"({self.canvas_model.painted_pixels()} px)\n")

    def undo(self):
        if self.canvas_model and self.canvas_model.undo():
            self._redraw()

    def clear(self):
        if self.canvas_model:
            self.canvas_model.clear()
            self._redraw()


    def preview_segmentation(self):
        """In-process model preview on the first input image (reference
        seg preview sheet, gs360_GUI.py:4531-5735)."""
        values = self.values()
        in_dir = str(values.get("input_dir") or "")
        if not in_dir.strip():
            self.append_log("[ERR] set the input dir first\n")
            return
        self.append_log("[INFO] running segmentation preview...\n")

        def work():
            try:
                from gs360x_torch.device import resolve_device
                from gs360x_torch.gui.segpreview import preview_first_image
                from gs360x_torch.models import segmentation as seg

                params = None
                ckpt = str(values.get("checkpoint") or "").strip()
                if ckpt:
                    params = seg.load_checkpoint(pathlib.Path(ckpt))
                else:
                    from gs360x_torch.models import synthseg
                    # the port's cached default, then the JAX package's
                    # (Orbax: load_checkpoint raises that it cannot read it)
                    for default in (synthseg.default_weights_path(),
                                    synthseg.default_checkpoint_path()):
                        if default.exists():
                            params = seg.load_checkpoint(default)
                            break
                name, (overlay, rows) = preview_first_image(
                    in_dir, device=resolve_device("cuda"), params=params,
                    targets=[str(values.get("target") or "person")])
                lines = [f"[preview] {name}: {len(rows)} instance(s)"]
                for r in rows:
                    lines.append(
                        f"  {r['class_name']:<12} score={r['score']:.2f} "
                        f"area={r['area_pct']:.1f}%")
                self.append_log("\n".join(lines) + "\n")
                self.app.root.after(0, self._show_preview_overlay, overlay)
            except Exception as exc:
                self.append_log(f"[ERR] preview failed: {exc}\n")

        threading.Thread(target=work, daemon=True).start()

    def _show_preview_overlay(self, overlay):
        try:
            from PIL import Image, ImageTk

            win = tk.Toplevel(self)
            win.title("Segmentation preview")
            photo = ImageTk.PhotoImage(Image.fromarray(overlay))
            lbl = tk.Label(win, image=photo)
            lbl.image = photo  # keep a reference
            lbl.pack()
        except Exception:
            pass


class ConfigTab(ttk.Frame):
    """Config tab (reference ``gs360_GUI.py:8881-8931``): theme, ffmpeg
    path, default warp backend — persisted in the settings JSON and read
    by the tool tabs at argv-build time."""

    def __init__(self, master, app):
        super().__init__(master)
        self.app = app
        form = ttk.Frame(self)
        form.pack(side="top", fill="x", padx=8, pady=8)

        ttk.Label(form, text="Theme").grid(row=0, column=0, sticky="w",
                                           padx=4, pady=4)
        style = ttk.Style()
        self.theme_var = tk.StringVar(
            value=app.settings.get("theme", style.theme_use()))
        ttk.Combobox(form, textvariable=self.theme_var, state="readonly",
                     values=sorted(style.theme_names()),
                     width=24).grid(row=0, column=1, sticky="w")

        ttk.Label(form, text="ffmpeg path").grid(row=1, column=0,
                                                 sticky="w", padx=4, pady=4)
        self.ffmpeg_var = tk.StringVar(
            value=app.settings.get("ffmpeg_path", ""))
        ttk.Entry(form, textvariable=self.ffmpeg_var,
                  width=48).grid(row=1, column=1, sticky="we")
        ttk.Button(form, text="…", width=3,
                   command=self._browse_ffmpeg).grid(row=1, column=2)

        ttk.Label(form, text="Warp backend").grid(row=2, column=0,
                                                  sticky="w", padx=4,
                                                  pady=4)
        self.backend_var = tk.StringVar(
            value=app.settings.get("backend", "auto"))
        ttk.Combobox(form, textvariable=self.backend_var, state="readonly",
                     values=["auto", "pallas", "xla"],
                     width=24).grid(row=2, column=1, sticky="w")

        ttk.Button(form, text="Apply",
                   command=self.apply).grid(row=3, column=1, sticky="w",
                                            pady=8)
        self.status = ttk.Label(form, text="")
        self.status.grid(row=4, column=0, columnspan=3, sticky="w", padx=4)
        form.columnconfigure(1, weight=1)

        saved_theme = app.settings.get("theme")
        if saved_theme and saved_theme in style.theme_names():
            try:
                style.theme_use(saved_theme)
            except tk.TclError:
                pass

    def _browse_ffmpeg(self):
        path = filedialog.askopenfilename(title="ffmpeg binary")
        if path:
            self.ffmpeg_var.set(path)

    def apply(self):
        import os

        theme = self.theme_var.get()
        try:
            ttk.Style().theme_use(theme)
        except tk.TclError:
            pass
        self.app.settings.set("theme", theme)
        self.app.settings.set("ffmpeg_path", self.ffmpeg_var.get().strip())
        self.app.settings.set("backend", self.backend_var.get())
        if self.ffmpeg_var.get().strip():
            # subprocess tools resolve ffmpeg via PATH; prepend its dir
            ffdir = str(pathlib.Path(self.ffmpeg_var.get()).parent)
            if ffdir not in os.environ.get("PATH", ""):
                os.environ["PATH"] = ffdir + os.pathsep + \
                    os.environ.get("PATH", "")
        self.app.settings.save()
        self.status.configure(text="applied + saved")

    def persist(self):
        pass  # applied immediately


class App:
    def __init__(self, root: tk.Tk, settings_path=None):
        self.root = root
        self.settings = Settings(settings_path)
        self.runner = ProcessRunner()
        self.log_queue: "queue.Queue" = queue.Queue()
        root.title("gs360x — 360° → photogrammetry / 3DGS toolkit (CUDA)")
        root.geometry("980x720")

        notebook = ttk.Notebook(root)
        notebook.pack(fill="both", expand=True)
        self.tabs = []
        for title, module, fields, build in forms.TABS:
            cls = {"perspcut": PerspCutTab,
                   "frameselector": FrameSelectorTab,
                   "plyopt": PlyOptTab,
                   "maskseg": MaskSegTab,
                   "dualfisheye": DualFisheyeTab,
                   "camconvert": SceneViewerTab}.get(module, ToolTab)
            tab = cls(notebook, self, title, module, fields, build)
            notebook.add(tab, text=title)
            self.tabs.append(tab)
        config = ConfigTab(notebook, self)
        notebook.add(config, text="Config")
        self.tabs.append(config)

        root.protocol("WM_DELETE_WINDOW", self.close)
        self._drain_logs()

    def _drain_logs(self):
        try:
            while True:
                tab, text = self.log_queue.get_nowait()
                tab.log.configure(state="normal")
                tab.log.insert("end", text)
                tab.log.see("end")
                tab.log.configure(state="disabled")
        except queue.Empty:
            pass
        self.root.after(100, self._drain_logs)

    def close(self):
        for tab in self.tabs:
            tab.persist()
        self.settings.save()
        self.runner.stop_all()
        self.root.destroy()


def main() -> int:
    root = tk.Tk()
    App(root)
    root.mainloop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
