"""gs360x-torch-perspcut — equirect panoramas/video → perspective or
fisheye cuts, on an NVIDIA GPU through the port's CUDA kernels.

Port of :mod:`gs360x.tools.perspcut`: the same flags, presets, camera
grammar, plan lines, output naming and exit codes, plus ``--device
{cuda,cpu}`` (default ``cuda``), which takes the place of JAX's
``JAX_PLATFORMS``. ``--device cuda`` without a card raises; ``--device
cpu`` runs the plain torch versions of the kernels.

Compat notes: ``--ffmpeg`` and ``--print-cmd`` are accepted for drop-in
compatibility; ``--print-cmd``/``--dry-run`` print the declarative view plan
(there are no ffmpeg commands to show). ``-j/--jobs`` sizes the async
encode pool.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import signal
import sys
import threading
from typing import List

from gs360x.io.image import IMAGE_EXTS
from gs360x_torch.device import DEVICE_CHOICES, resolve_device
from gs360x_torch.rig.presets import (PRESET_CHOICES, PerspCutConfig,
                                      build_view_plan)
from gs360x_torch.rig.spec import RenderPlan


class StoreWithFlag(argparse.Action):
    """Record whether a value was explicitly set (preset-override policy)."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        setattr(namespace, f"{self.dest}_explicit", True)


def create_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=("Batch convert equirectangular images/video into "
                     "perspective or fisheye views on an NVIDIA GPU "
                     "(PyTorch + CUDA kernels), including "
                     "virtual camera add/delete/set operations."),
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        epilog=("Notes: presets can be overridden with --focal-mm / --size / "
                "--sensor-mm. Priority: --hfov overrides --focal-mm. "
                "Use --setcam to specify absolute or relative pitch values "
                "per camera."))
    ap.add_argument("-i", "--in", dest="input_dir", required=True,
                    help="Input folder (equirectangular images) or a video file")
    ap.add_argument("-o", "--out", dest="out_dir", default=None,
                    help="Output folder. Defaults to <input>/_geometry")
    ap.add_argument("--preset", choices=PRESET_CHOICES, default="default",
                    help=("default=8-view baseline / fisheyelike=10-view mix "
                          "(17mm) / full360coverage=8-view wide cover (14mm) / "
                          "2views=front/back (6mm, 3600px) / evenMinus30 / "
                          "evenPlus30 / fisheyeXY=fisheye X/Y pair (3600px FOV180)"))
    ap.add_argument("--count", type=int, default=8,
                    help="Horizontal division count (4=90deg, 8=45deg)")
    ap.add_argument("--addcam", default="", action=StoreWithFlag,
                    help="Add virtual cameras, e.g. 'B', 'B:U', 'D:D20', 'F:U15'")
    ap.add_argument("--addcam-deg", type=float, default=30.0,
                    help="Default magnitude when U/D omit a value")
    ap.add_argument("--add-top", action="store_true",
                    help="Include cube-map style top view (pitch +90)")
    ap.add_argument("--add-bottom", action="store_true",
                    help="Include cube-map style bottom view (pitch -90)")
    ap.add_argument("--add-topdown", action="store_true", dest="add_topdown",
                    help=argparse.SUPPRESS)
    ap.add_argument("--delcam", default="", action=StoreWithFlag,
                    help="Remove baseline cameras by letter, e.g. 'B,D'")
    ap.add_argument("--setcam", default="",
                    help="Override/adjust pitch: 'A=30','A=U','A=D20','A:+10'")
    ap.add_argument("--size", type=int, default=1600, action=StoreWithFlag,
                    help="Square output size per view")
    ap.add_argument("--ext", default="jpg", help="Output extension")
    ap.add_argument("--jpeg-quality-95", action="store_true",
                    help="Encode jpg at ~95%% quality instead of maximum")
    ap.add_argument("-f", "--fps", type=float, default=None,
                    help="Frame extraction rate when input is a video")
    ap.add_argument("--start", type=float, default=None,
                    help="Start time (s) for video input")
    ap.add_argument("--end", type=float, default=None,
                    help="End time (s) for video input")
    ap.add_argument("--keep-rec709", action="store_true",
                    help="Keep Rec.709 transfer for video (default: sRGB)")
    ap.add_argument("--hfov", type=float, default=None, action=StoreWithFlag,
                    help="Horizontal FOV in degrees (overrides focal length)")
    ap.add_argument("--focal-mm", type=float, default=12.0, action=StoreWithFlag,
                    help="Focal length (mm) when --hfov is not set")
    ap.add_argument("--sensor-mm", default="36 36",
                    help="Sensor width/height in mm, e.g. '36 36' or '36x24'")
    ap.add_argument("-j", "--jobs", default="auto",
                    help="Async encode workers (number or 'auto')")
    ap.add_argument("--print-cmd", choices=["once", "none", "all"], default="once",
                    help="How many view-plan lines to print")
    ap.add_argument("--ffmpeg", default="ffmpeg", help=argparse.SUPPRESS)
    ap.add_argument("--dry-run", action="store_true",
                    help="Print the full view plan without executing")
    ap.add_argument("--interp", choices=["bilinear", "bicubic", "nearest"],
                    default="bicubic", help="Resampling kernel")
    ap.add_argument("--backend", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="Warp backend, JAX spelling: auto and pallas = the "
                         "CUDA kernels on a CUDA device (a view outside the "
                         "kernel gate, e.g. tilted or fisheye, raises "
                         "NotImplementedError there); xla = the plain torch "
                         "twin")
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "present; cpu runs the plain torch versions")
    ap.add_argument("--stats", action="store_true",
                    help="Print per-stage pipeline timers "
                         "(decode/warp/fetch) after the run.")
    ap.add_argument("--no-overwrite", action="store_true",
                    help="Skip outputs that already exist (resume)")
    ap.add_argument("--select-csv", dest="select_csv", default=None,
                    help="FrameSelector CSV: export only frames marked "
                         "selected (video inputs; use the CSV's "
                         "extraction fps for -f)")
    return ap


def config_from_args(args) -> PerspCutConfig:
    return PerspCutConfig(
        preset=args.preset, count=args.count, addcam=args.addcam,
        addcam_deg=args.addcam_deg, delcam=args.delcam, setcam=args.setcam,
        add_top=args.add_top or getattr(args, "add_topdown", False),
        add_bottom=args.add_bottom or getattr(args, "add_topdown", False),
        size=args.size, ext=args.ext, jpeg_quality_95=args.jpeg_quality_95,
        fps=args.fps, start=args.start, end=args.end,
        keep_rec709=args.keep_rec709, hfov=args.hfov, focal_mm=args.focal_mm,
        sensor_mm=args.sensor_mm, interpolation=args.interp,
        size_explicit=getattr(args, "size_explicit", False),
        hfov_explicit=getattr(args, "hfov_explicit", False),
        focal_mm_explicit=getattr(args, "focal_mm_explicit", False),
        addcam_explicit=getattr(args, "addcam_explicit", False),
        delcam_explicit=getattr(args, "delcam_explicit", False),
        input_is_video=getattr(args, "input_is_video", False),
        video_bit_depth=getattr(args, "video_bit_depth", 8),
    )


def plan_line(job) -> str:
    v = job.view
    return (f"$ warp {job.source.name} -> {job.output_name} "
            f"[{v.projection} yaw={v.yaw_deg:g} pitch={v.pitch_deg:g} "
            f"hfov={v.hfov_deg:g} vfov={v.vfov_deg:g} {v.width}x{v.height}]")


def print_info_lines(plan: RenderPlan) -> None:
    if plan.preview_views_line:
        print(plan.preview_views_line)
        if plan.sensor_line:
            print(plan.sensor_line)
        if plan.realityscan_line:
            print(plan.realityscan_line)
        if plan.metashape_line:
            print(plan.metashape_line)


def read_selection_csv(path: pathlib.Path):
    """FrameSelector CSV -> set of selected extracted-frame indices.

    The GUI's "apply frame selection to video export" rewrite
    The executor replays the CSV's index column against the same-fps frame
    iterator and keeps the original numbering.
    """
    import csv as csvlib

    selected = set()
    with open(path, newline="") as f:
        rd = csvlib.DictReader(f)
        if rd.fieldnames is None or "index" not in rd.fieldnames:
            raise ValueError("not a FrameSelector CSV (no 'index' column)")
        flag_col = next((c for c in rd.fieldnames
                         if c.startswith("selected")), None)
        if flag_col is None:
            raise ValueError("no 'selected' column")
        for row in rd:
            try:
                if int(float(row[flag_col])) == 1:
                    selected.add(int(row["index"]))
            except (TypeError, ValueError):
                continue
    return selected


def main(argv=None) -> int:
    ap = create_arg_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for attr in ("size", "hfov", "focal_mm", "addcam", "delcam"):
        setattr(args, f"{attr}_explicit", getattr(args, f"{attr}_explicit", False))

    input_path = pathlib.Path(args.input_dir).expanduser().resolve()
    files: List[pathlib.Path] = []
    if input_path.is_dir():
        args.input_is_video = False
        args.video_bit_depth = 8
        out_dir = (pathlib.Path(args.out_dir).resolve() if args.out_dir
                   else input_path / "_geometry")
        files = [p for p in sorted(input_path.iterdir())
                 if p.is_file() and p.suffix.lower() in IMAGE_EXTS]
        if not files:
            print("[WARN] No target images found (tif/jpg/png)", file=sys.stderr)
            return 0
    elif input_path.is_file():
        args.input_is_video = True
        if args.fps is None or args.fps <= 0:
            print("[ERR] -f/--fps must be specified for video inputs",
                  file=sys.stderr)
            return 1
        out_dir = (pathlib.Path(args.out_dir).resolve() if args.out_dir
                   else input_path.parent / f"{input_path.stem}_geometry")
        try:
            from gs360x.io.video import probe_video
            args.video_bit_depth = probe_video(input_path).bit_depth
        except Exception:
            args.video_bit_depth = 8
        files = [input_path]
    else:
        print("[ERR] Input path not found:", input_path, file=sys.stderr)
        return 1

    plan = build_view_plan(config_from_args(args), files, out_dir)

    if args.select_csv:
        if not args.input_is_video:
            print("[ERR] --select-csv applies to video inputs only",
                  file=sys.stderr)
            return 1
        try:
            plan.selected_frames = read_selection_csv(
                pathlib.Path(args.select_csv).expanduser().resolve())
        except Exception as exc:
            print(f"[ERR] cannot read selection CSV: {exc}", file=sys.stderr)
            return 1
        print(f"[INFO] CSV frame selection: {len(plan.selected_frames)} "
              "frame(s) (match the CSV's extraction fps with -f)")

    if args.dry_run:
        for job in plan.jobs:
            print(plan_line(job))
        print(f"\n[DRY] Exiting without execution (total {plan.total} commands)")
        return 0

    if args.print_cmd == "all":
        for job in plan.jobs:
            print(plan_line(job))
    elif args.print_cmd == "once" and plan.jobs:
        print(plan_line(plan.jobs[0]))

    workers = (max(1, (os.cpu_count() or 1)) if str(args.jobs).lower() == "auto"
               else max(1, int(args.jobs)))
    print(f"[INFO] encode workers: {workers} / planned outputs: {plan.total}")
    print_info_lines(plan)

    stop_event = threading.Event()

    def on_signal(sig, frame):
        if not stop_event.is_set():
            print("\n[INFO] Cancel requested. Finishing in-flight work...",
                  file=sys.stderr)
            stop_event.set()

    try:
        signal.signal(signal.SIGINT, on_signal)
        signal.signal(signal.SIGTERM, on_signal)
    except (ValueError, OSError):
        pass  # not the main thread

    # interactive 'q' cancel on a TTY (shared across long-running tools)
    from gs360x.runtime.cancel import start_cancel_listener
    start_cancel_listener(stop_event)

    from gs360x_torch.runtime.executor import run_plan
    report = run_plan(plan, device=device, backend=args.backend,
                      overwrite=not args.no_overwrite,
                      writer_workers=workers, stop_event=stop_event,
                      stats=args.stats)

    if stop_event.is_set():
        print(f"[STOPPED] Interrupted: success={report.ok}, "
              f"failed={report.failed}, total={report.total}")
        return 130
    for err in report.errors:
        print(f"[ERR] {err}", file=sys.stderr)
    print(f"[OK] Completed: success={report.ok}, failed={report.failed}, "
          f"total={report.total}"
          + (f", skipped={report.skipped}" if report.skipped else ""))
    return 0 if report.failed == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
