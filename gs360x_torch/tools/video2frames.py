"""gs360x-torch-video2frames — extract frames from a video at N fps on an
NVIDIA GPU through the port's CUDA kernels.

Port of :mod:`gs360x.tools.video2frames`: the same flags, messages, file
names (``{prefix}_%07d{suffix}.{ext}``), exit codes (1, and 130 on SIGINT)
and software pipeline, plus ``--device {cuda,cpu}`` (default ``cuda``;
``cuda`` without a card raises) and ``--stats``.

Per frame on the device: the decoded u8/u16 frame is uploaded once as
(H, W·3) rows, ``planarize.cu`` turns it into f32 planes scaled by 1/255
(1/65535), the Rec.709→SMPTE-170M (+ sRGB unless ``--keep-rec709``) colour
move runs as plain torch ops, ``--fisheye-perspective`` adds one
``remap.cu`` launch (bicubic, 0 outside the lens) over maps built once per
geometry and kept resident, and the result is quantized (8 bit, or 16 for
>8-bit sources) before one fetch. The colour move comes before the fisheye
cut, as in JAX: the two do not commute. ``--device cpu`` runs the plain
versions of both kernels.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gs360x_torch.io import video as vio
from gs360x_torch.io.image import AsyncImageWriter
from gs360x_torch.runtime.profiling import StageTimers
from gs360x_torch.core import camera as cam
from gs360x_torch.core import color as colorlib
from gs360x_torch.device import DEVICE_CHOICES, resolve_device
from gs360x_torch.kernels import remap_cuda, warp_cuda
from gs360x_torch.kernels import warp as twin
from gs360x_torch.runtime.executor import _quantize_device, upload_rows
from gs360x_torch.runtime.prefetch import Prefetcher

FISHEYE_INPUT_FOV_DEG = 190.0

_SCALE = {np.dtype(np.uint8): 1.0 / 255.0, np.dtype(np.uint16): 1.0 / 65535.0,
          np.dtype(np.float32): 1.0}


def create_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Extract frames from a video at N fps on an NVIDIA GPU "
                    "(PyTorch + CUDA kernels; no ffmpeg required for "
                    "y4m/mjpeg-avi).")
    ap.add_argument("-i", "-in", dest="video", required=True,
                    help="Input video file path.")
    ap.add_argument("-o", "-out", dest="output", default=None,
                    help="Output directory (defaults next to the input).")
    ap.add_argument("-f", "--fps", type=float, required=True,
                    help="Frame extraction rate (e.g. 5, 2.5).")
    ap.add_argument("-e", "--ext", default="jpg",
                    help="Output image extension (default: jpg).")
    ap.add_argument("--prefix", default="out",
                    help="Filename prefix (default: out).")
    ap.add_argument("--start", type=float, default=0.0,
                    help="Optional start time in seconds.")
    ap.add_argument("--end", type=float, default=None,
                    help="Optional end time in seconds.")
    ap.add_argument("--keep-rec709", action="store_true",
                    help="Keep Rec.709 transfer instead of sRGB.")
    ap.add_argument("--overwrite", action="store_true",
                    help="Overwrite existing frames.")
    ap.add_argument("--ffmpeg", default="ffmpeg", help=argparse.SUPPRESS)
    ap.add_argument("--map-stream", dest="map_stream", default=None,
                    help="Stream selector like '0:v:1' (dual-fisheye lens).")
    ap.add_argument("--name-suffix", dest="name_suffix", default="",
                    help="Suffix before the extension (e.g. _X).")
    ap.add_argument("--fisheye-perspective", action="store_true",
                    help="Experimental fisheye→perspective transform.")
    ap.add_argument("--fisheye-focal-mm", type=float, default=8.0)
    ap.add_argument("--fisheye-size", type=int, default=3840)
    ap.add_argument("--fisheye-projection", type=str.lower,
                    choices=("equidistant", "equisolid"), default="equisolid")
    ap.add_argument("--fisheye-input-fov", type=float,
                    default=FISHEYE_INPUT_FOV_DEG)
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "present; cpu runs the plain torch versions")
    ap.add_argument("--stats", action="store_true",
                    help="Print per-stage pipeline timers "
                         "(decode/dispatch/fetch) after the run.")
    return ap


def parse_map_stream_selector(spec):
    """'0:v:N' / 'v:N' / 'N' → video stream index (None = default)."""
    if spec is None:
        return None
    s = str(spec).strip()
    m = re.match(r"^(?:0:)?(?:v:)?(\d+)$", s)
    if not m:
        raise ValueError(f"unsupported --map-stream selector: {spec!r} "
                         "(expected like '0:v:1')")
    return int(m.group(1))


class FisheyeCut:
    """The ``--fisheye-perspective`` cut: one
    :class:`~gs360x_torch.kernels.remap_cuda.PreparedRemap` per source
    shape, its maps (and rim) built once on ``device`` and kept resident."""

    def __init__(self, size: int, hfov: float, dfov: float, model: str,
                 device: torch.device):
        self.size, self.hfov, self.dfov, self.model = size, hfov, dfov, model
        self.device = device
        self._prepared: Dict[Tuple[int, int], remap_cuda.PreparedRemap] = {}

    def prepared(self, src_h: int, src_w: int) -> remap_cuda.PreparedRemap:
        """The resident remap for a ``src_w``×``src_h`` source (its maps
        built on the first call)."""
        prep = self._prepared.get((src_h, src_w))
        if prep is None:
            u, v, valid = twin.fisheye_perspective_maps(
                self.size, self.hfov, self.dfov, self.model, src_w, src_h,
                device=self.device)
            prep = remap_cuda.PreparedRemap(u, v, valid, src_w=src_w,
                                            src_h=src_h, device=self.device)
            self._prepared[(src_h, src_w)] = prep
        return prep

    def __call__(self, planes: torch.Tensor) -> torch.Tensor:
        """(3, H, W) f32 planes → (3, size, size) f32."""
        prep = self.prepared(planes.shape[1], planes.shape[2])
        return prep(planes, interp="bicubic", fill=0.0)


def decoded_frames(path, *, fps: float, start: float = 0.0,
                   end: Optional[float] = None, stream: Optional[int] = None):
    """(index, t, rgb) of every frame the tool extracts: the decoder of
    :mod:`gs360x_torch.io.video` (Y4M, MJPEG-AVI, or ffmpeg where present)
    resampled to ``fps``."""
    return vio.iter_frames(path, fps=fps, start=start, end=end,
                           stream=stream)


def frame_to_device(rgb: np.ndarray, *, device: torch.device,
                    keep_rec709: bool, fisheye: Optional[FisheyeCut],
                    bits: int) -> torch.Tensor:
    """One decoded (H, W, 3) u8/u16 frame → quantized (3, h, w) planes on
    ``device``: upload, planarize (×1/255 or ×1/65535), colour move,
    optional fisheye cut, quantize. The fetch is the caller's."""
    scale = _SCALE.get(rgb.dtype)
    if scale is None or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"unsupported frame {rgb.shape} {rgb.dtype}: "
                         "expected (H, W, 3) uint8/uint16")
    planes = warp_cuda.planarize_rows(upload_rows(rgb, device), scale,
                                      torch.float32)
    frame = colorlib.video_color_move_planar(planes, keep_rec709=keep_rec709)
    if fisheye is not None:
        frame = fisheye(frame)
    return _quantize_device(frame, bits)


def main(argv=None) -> int:
    try:
        return _main(argv)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv=None) -> int:
    args = create_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    in_path = pathlib.Path(args.video).expanduser().resolve()
    if not in_path.is_file():
        print(f"[ERR] Input video not found: {in_path}", file=sys.stderr)
        return 1
    if args.fps <= 0:
        print("[ERR] --fps must be > 0", file=sys.stderr)
        return 1
    try:
        stream = parse_map_stream_selector(args.map_stream)
    except ValueError as exc:
        print(f"[ERR] {exc}", file=sys.stderr)
        return 1

    out_dir = (pathlib.Path(args.output).resolve() if args.output
               else in_path.parent / f"{in_path.stem}_frames")
    out_dir.mkdir(parents=True, exist_ok=True)
    ext = args.ext.lower().lstrip(".")
    suffix = re.sub(r"\s+", "_", args.name_suffix.strip())

    if not args.overwrite:
        existing = next(out_dir.glob(f"{args.prefix}_*{suffix}.{ext}"), None)
        if existing is not None:
            print("Output exists and overwrite is disabled. "
                  f"First match: {existing.name}", file=sys.stderr)
            print("Enable --overwrite to replace existing frames.",
                  file=sys.stderr)
            return 1

    try:
        info = vio.probe_video(in_path)
    except Exception as exc:
        print(f"[ERR] cannot probe video: {exc}", file=sys.stderr)
        return 1
    bit_depth = info.bit_depth
    bits = 16 if bit_depth > 8 else 8
    est_total = None
    if info.n_frames and info.fps:
        span = info.n_frames / info.fps
        t1 = min(args.end, span) if args.end else span
        span = max(0.0, t1 - args.start)
        est_total = int(span * args.fps) + 1
    print(f"[INFO] {info.width}x{info.height} @ {info.fps:g} fps, "
          f"{bit_depth}-bit, extracting at {args.fps:g} fps")

    fisheye = None
    if args.fisheye_perspective:
        hfov = cam.hfov_from_focal_mm(max(args.fisheye_focal_mm, 1e-6), 36.0)
        fisheye = FisheyeCut(max(args.fisheye_size, 1), hfov,
                             args.fisheye_input_fov, args.fisheye_projection,
                             device)
        print(f"[INFO] fisheye→perspective: {fisheye.size}px "
              f"hfov={hfov:.1f}° model={args.fisheye_projection}")

    timers = StageTimers()
    written = 0
    t0 = time.time()
    stop = threading.Event()
    pending = None  # (idx, device frame) dispatched, not yet fetched
    # software pipeline: decode N+1 (thread) || device work N+1 (queued)
    # || fetch+encode N (here + writer pool) — same shape as the executor
    with AsyncImageWriter(workers=8) as writer:
        def drain(entry):
            nonlocal written
            idx, frame = entry
            with timers.stage("fetch"):
                arr = frame.cpu().numpy()
            name = f"{args.prefix}_{idx:07d}{suffix}.{ext}"
            writer.submit(out_dir / name, arr, planar=True)
            written += 1
            if est_total:
                elapsed = time.time() - t0
                eta = elapsed / written * (est_total - written)
                sys.stdout.write(
                    f"Extracting... {min(100, written * 100 // est_total):3d}%"
                    f" ({written}/{est_total}) ETA {eta:5.1f}s\r")
                sys.stdout.flush()

        try:
            frames = decoded_frames(in_path, fps=args.fps, start=args.start,
                                    end=args.end, stream=stream)
            # one thread decodes: 4 frames taken and not yet passed
            for idx, _t, rgb in Prefetcher(timers.wrap_iter("decode", frames),
                                           stop, depth=3):
                with timers.stage("dispatch"):
                    frame = frame_to_device(
                        rgb, device=device, keep_rec709=args.keep_rec709,
                        fisheye=fisheye, bits=bits)
                if pending is not None:
                    drain(pending)
                pending = (idx, frame)
            if pending is not None:
                drain(pending)
                pending = None
        finally:
            stop.set()
    if est_total:
        sys.stdout.write("\n")
    if args.stats:
        print(f"[STATS] {timers.report()} | wall {time.time() - t0:.2f}s")
    print(f"[OK] wrote {written} frame(s) to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
