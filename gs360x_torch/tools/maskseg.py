"""gs360x-torch-maskseg — subject segmentation masks for photogrammetry
cleanup, on an NVIDIA GPU.

Port of :mod:`gs360x.tools.maskseg`: the same flags, messages, output
files, refinement order (close → optional shadow → expand → edge fuse →
manual add layer → output mode) and exit codes (1 on bad input, 130 on
SIGINT), plus ``--device {cuda,cpu}`` (default ``cuda``; ``cuda`` without a
card raises). ``--cpu``, ``--cpu-workers`` and ``--gpu-prefetch-workers``
are accepted and unused, as in the JAX tool.

Per image: decode on the host, then on the device the resize to the
inference size, the U-Net (:mod:`gs360x_torch.models.segmentation`, f32
convs), the softmax and the resize back of the target classes'
probabilities, one fetch; instance separation on the host
(:mod:`gs360x_torch.models.instances`); close, the shadow heuristic's blur,
the expansion and the inpaint on the device
(:mod:`gs360x_torch.kernels.morphology`); PNG encode on the host.

Weights resolve in the JAX tool's order: the shipped weights, then the
cached default, which ``--build-default`` trains on the device first, then
``--allow-random``, else an error. The port's checkpoints are the
single-file msgpack that ``gs360x.models.segmentation.save_weights``
writes: ``--checkpoint`` takes such a file, and the cached default is
``~/.cache/gs360x/seg_default_v3_torch.msgpack``. An Orbax directory, given
to ``--checkpoint`` or cached by the JAX package when the port has no
default of its own, gets an ``[ERR]`` line.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys
from typing import List, Optional

import numpy as np
import torch

from gs360x_torch.device import DEVICE_CHOICES, resolve_device
from gs360x_torch.models import segmentation as seg
from gs360x_torch.runtime.profiling import StageTimers

CLOSE_KERNEL = 5
DEFAULT_MASK_EXPAND_PIXELS = 15
DEFAULT_MASK_EXPAND_PERCENT = 1.0
DEFAULT_EDGE_FUSE_PIXELS = 25
SHADOW_T = 0.82
SHADOW_SIGMA = 21
SHADOW_SAT_MAX = 115
INPAINT_ITERS = 256
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".tif", ".tiff"}

TARGET_CHOICES = ["person", "bicycle", "car", "motorcycle", "bus", "truck",
                  "animal"]
TARGET_NAME_ALIASES = {
    "motorbike": "motorcycle",
}


def normalize_target_name(name: str) -> str:
    text = str(name or "").strip().lower()
    return TARGET_NAME_ALIASES.get(text, text)


# --------------------------------------------------------------------------
# mask refinement (reference :384-558)
# --------------------------------------------------------------------------


def refine_mask(mask: np.ndarray, close: int = CLOSE_KERNEL, *,
                device: torch.device) -> np.ndarray:
    from gs360x_torch.kernels.morphology import close_mask

    if close <= 1:
        return mask
    out = close_mask(torch.from_numpy(mask > 0).to(device), close)
    return (out > 0).cpu().numpy().astype(np.uint8) * 255


def expand_mask(mask: np.ndarray, mode: str, pixels: int,
                percent: float, *, device: torch.device) -> np.ndarray:
    from gs360x_torch.kernels.morphology import dilate_radius

    h, w = mask.shape
    if mode == "percent":
        radius = int(round(max(h, w) * percent / 100.0))
    else:
        radius = int(pixels)
    return dilate_radius(mask, radius, device=device) if radius > 0 else mask


def fuse_mask_to_edges(mask: np.ndarray, fuse_pixels: int) -> np.ndarray:
    """Extend mask blobs that come within fuse_pixels of a frame border all
    the way to that border (reference :439-496): rigs/tripods at the frame
    bottom otherwise leave slivers."""
    if fuse_pixels <= 0 or not mask.any():
        return mask
    out = (mask > 0).copy()
    h, w = out.shape
    f = int(fuse_pixels)
    # for each border: columns/rows whose band already contains mask pixels
    cols = out[:f, :].any(axis=0)
    out[:f, cols] = True
    cols = out[-f:, :].any(axis=0)
    out[-f:, cols] = True
    rows = out[:, :f].any(axis=1)
    out[rows, :f] = True
    rows = out[:, -f:].any(axis=1)
    out[rows, -f:] = True
    return out.astype(np.uint8) * 255


def estimate_shadow_mask(rgb01: np.ndarray, subject_mask: np.ndarray, *,
                         device: torch.device) -> np.ndarray:
    """Dark, low-saturation pixels near the subject (simplified version of
    reference :499-558)."""
    from gs360x_torch.kernels.morphology import dilate_radius, gaussian_blur

    if not subject_mask.any():
        return np.zeros_like(subject_mask)
    luma = (0.299 * rgb01[..., 0] + 0.587 * rgb01[..., 1]
            + 0.114 * rgb01[..., 2])
    blurred = gaussian_blur(
        torch.from_numpy(np.ascontiguousarray(luma, np.float32)).to(device),
        sigma=float(SHADOW_SIGMA) / 3.0, radius=SHADOW_SIGMA // 2
    ).cpu().numpy()
    dark = luma < SHADOW_T * np.maximum(blurred, 1e-6)
    mx = rgb01.max(axis=-1)
    mn = rgb01.min(axis=-1)
    sat = np.where(mx > 1e-6, (mx - mn) / np.maximum(mx, 1e-6), 0.0)
    low_sat = sat * 255.0 <= SHADOW_SAT_MAX
    near = dilate_radius(subject_mask, 25, device=device) > 0
    shadow = dark & low_sat & near & ~(subject_mask > 0)
    return shadow.astype(np.uint8) * 255


# --------------------------------------------------------------------------
# manual layers (reference :566-624)
# --------------------------------------------------------------------------


def extract_multicam_view_id(stem: str) -> Optional[str]:
    m = re.search(r"_((?:[A-Z]|\d{2,})(?:_(?:U|D|U\d+|D\d+))?)$",
                  stem.upper())
    return m.group(1) if m else None


def manual_mask_key_for_path(path: pathlib.Path) -> str:
    vid = extract_multicam_view_id(path.stem)
    return f"view__{vid}" if vid else f"file__{path.stem}"


def load_manual_add_layer(in_path: pathlib.Path,
                          manual_dir: Optional[pathlib.Path],
                          shape) -> Optional[np.ndarray]:
    if manual_dir is None:
        return None
    mask_path = manual_dir / f"{manual_mask_key_for_path(in_path)}__add.png"
    if not mask_path.exists():
        return None
    from PIL import Image

    img = Image.open(str(mask_path)).convert("L")
    if img.size != (shape[1], shape[0]):
        img = img.resize((shape[1], shape[0]), Image.NEAREST)
    arr = np.asarray(img)
    return np.where(arr > 127, 255, 0).astype(np.uint8)


# --------------------------------------------------------------------------
# output modes (reference :740-817)
# --------------------------------------------------------------------------


def write_output(mode: str, in_path: pathlib.Path, out_dir: pathlib.Path,
                 rgb: np.ndarray, mask: Optional[np.ndarray], *,
                 device: torch.device) -> pathlib.Path:
    from PIL import Image

    out_dir.mkdir(parents=True, exist_ok=True)
    stem = in_path.stem
    h, w = rgb.shape[:2]
    if mask is not None and mask.shape != (h, w):
        mask = np.asarray(Image.fromarray(mask).resize((w, h),
                                                       Image.NEAREST))
    if mode == "alpha":
        alpha = np.zeros((h, w), np.uint8) if mask is None else 255 - mask
        out = out_dir / f"{stem}.png"
        Image.fromarray(np.dstack([rgb, alpha])).save(str(out))
        return out
    if mode == "cutout":
        alpha = np.zeros((h, w), np.uint8) if mask is None else mask
        out = out_dir / f"{stem}_cutout.png"
        Image.fromarray(np.dstack([rgb, alpha])).save(str(out))
        return out
    if mode == "mask":
        m = np.zeros((h, w), np.uint8) if mask is None else mask
        out = out_dir / f"{stem}.png"
        Image.fromarray(255 - m).save(str(out))  # subject black, bg white
        return out

    # keep_person / remove_person / inpaint
    if mask is None or not mask.any():
        result = rgb
    else:
        m = mask > 0
        if mode == "keep_person":
            result = np.zeros_like(rgb)
            result[m] = rgb[m]
        elif mode == "remove_person":
            result = rgb.copy()
            result[m] = 0
        else:  # inpaint
            from gs360x_torch.kernels.morphology import diffusion_inpaint

            img = torch.from_numpy(np.array(rgb)).to(device).to(
                torch.float32) / 255.0
            filled = diffusion_inpaint(img, torch.from_numpy(m).to(device),
                                       iters=INPAINT_ITERS)
            result = torch.clamp(filled * 255.0 + 0.5, 0, 255).to(
                torch.uint8).cpu().numpy()
    out = out_dir / f"{stem}_{mode}.png"
    Image.fromarray(result).save(str(out))
    return out


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def create_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=("Generate subject segmentation masks (person/vehicle/"
                     "animal) for photogrammetry cleanup."))
    ap.add_argument("-i", "--in", dest="input_dir", required=True)
    ap.add_argument("-o", "--out", dest="output_dir", default=None)
    ap.add_argument("--mode", default="mask",
                    choices=["mask", "alpha", "cutout", "keep_person",
                             "remove_person", "inpaint"])
    ap.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--cpu-workers", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--gpu-prefetch-workers", type=int, default=2,
                    help=argparse.SUPPRESS)
    ap.add_argument("--target", choices=TARGET_CHOICES, default=None,
                    help="Built-in target group (default: person)")
    ap.add_argument("--target-name", default=None,
                    help="Free-form class name (e.g. 'motorbike')")
    ap.add_argument("--include_shadow", action="store_true")
    ap.add_argument("--mask-expand-mode", choices=["pixels", "percent"],
                    default="pixels")
    ap.add_argument("--mask-expand-pixels", type=int,
                    default=DEFAULT_MASK_EXPAND_PIXELS)
    ap.add_argument("--mask-expand-percent", type=float,
                    default=DEFAULT_MASK_EXPAND_PERCENT)
    ap.add_argument("--edge-fuse-pixels", type=int,
                    default=DEFAULT_EDGE_FUSE_PIXELS)
    ap.add_argument("--manual-mask-dir", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="Single-file msgpack weights (the format "
                         "gs360x.models.segmentation.save_weights writes; "
                         "default: the shipped weights)")
    ap.add_argument("--allow-random", action="store_true",
                    help="Proceed with randomly initialized weights when "
                         "no checkpoint is available (debug only)")
    ap.add_argument("--build-default", action="store_true",
                    help="Build the default checkpoint (trains the U-Net "
                         "on a generated corpus on the device, cached in "
                         "~/.cache)")
    ap.add_argument("--score-thresh", type=float, default=seg.SCORE_THRESH)
    ap.add_argument("--mask-thresh", type=float, default=seg.MASK_THRESH)
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "present; cpu runs everything on the CPU")
    return ap


def resolve_targets(args) -> List[str]:
    name = args.target
    if args.target_name:
        name = normalize_target_name(args.target_name)
    if not name:
        name = "person"
    classes = seg.TARGET_TO_CLASSES.get(name)
    if classes is None:
        if name in seg.CLASS_TO_INDEX:
            classes = [name]
        else:
            raise ValueError(f"unsupported target: {name!r} (supported: "
                             f"{', '.join(seg.TARGET_TO_CLASSES)})")
    return classes


def main(argv=None, timers=None) -> int:
    """``timers``: a :class:`~gs360x_torch.runtime.profiling.StageTimers`
    that receives the wall of each stage (decode, infer, instances,
    refine, encode) when given."""
    try:
        return _main(argv, timers)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _load_params(args, device: torch.device):
    """The weights in the JAX tool's order, as ``(state_dict or None,
    exit code or None)``: ``--checkpoint``, the shipped weights, the port's
    cached default (trained on ``device`` first with ``--build-default``),
    the JAX package's cached Orbax default (refused), ``--allow-random``."""
    from gs360x_torch.models import synthseg

    if args.checkpoint:
        try:
            params = seg.load_checkpoint(
                pathlib.Path(args.checkpoint).resolve())
        except (OSError, ValueError) as exc:
            print(f"[ERR] failed to load checkpoint: {exc}", file=sys.stderr)
            return None, 1
        print(f"[INFO] loaded checkpoint: {args.checkpoint}")
        return params, None
    # the reference downloads COCO weights at first use
    # (gs360_SegmentationMaskTool.py:262-288); the repo's equivalent
    # out-of-the-box capability is the SHIPPED pretrained weights
    packaged = synthseg.packaged_weights_path()
    if packaged.exists():
        try:
            params = seg.load_weights(packaged)
            print(f"[INFO] loaded shipped weights: {packaged.name}")
            return params, None
        except (OSError, ValueError) as exc:
            print(f"[WARN] shipped weights failed to load: {exc}",
                  file=sys.stderr)
    default = synthseg.default_weights_path()
    if args.build_default and not default.exists():
        print("[INFO] building default checkpoint (one-time, trains "
              "the U-Net on a generated corpus)...")
        synthseg.build_default_checkpoint(default, device=device)
    if default.exists():
        try:
            params = seg.load_weights(default)
        except (OSError, ValueError) as exc:
            print(f"[ERR] failed to load default checkpoint: {exc}",
                  file=sys.stderr)
            return None, 1
        print(f"[INFO] loaded default checkpoint: {default}")
        print("[INFO] (synthetic-corpus weights; fine-tune with "
              "gs360x-torch-segtrain for photographic masks)")
        return params, None
    orbax = synthseg.default_checkpoint_path()
    if orbax.exists():
        print(f"[ERR] failed to load default checkpoint: {orbax} is an "
              "Orbax checkpoint; Orbax checkpoints are not readable by the "
              "port", file=sys.stderr)
        return None, 1
    if args.allow_random:
        print("[WARN] --allow-random: the segmentation net is "
              "randomly initialized (structural output only)",
              file=sys.stderr)
        return None, None
    print("[ERR] no segmentation weights: pass --checkpoint, or "
          "--build-default to create the cached default, or "
          "--allow-random to proceed with random weights",
          file=sys.stderr)
    return None, 1


def _main(argv=None, timers=None) -> int:
    args = create_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.mask_expand_pixels < 0 or args.mask_expand_percent < 0 \
            or args.edge_fuse_pixels < 0:
        print("[ERR] expansion values must be >= 0", file=sys.stderr)
        return 1
    in_dir = pathlib.Path(args.input_dir).expanduser().resolve()
    if not in_dir.is_dir():
        print(f"[ERR] input dir not found: {in_dir}", file=sys.stderr)
        return 1
    out_dir = (pathlib.Path(args.output_dir).expanduser().resolve()
               if args.output_dir else in_dir / "masks")
    try:
        targets = resolve_targets(args)
    except ValueError as exc:
        print(f"[ERR] {exc}", file=sys.stderr)
        return 1
    manual_dir = (pathlib.Path(args.manual_mask_dir).resolve()
                  if args.manual_mask_dir else None)

    files = sorted(p for p in in_dir.iterdir()
                   if p.is_file() and p.suffix.lower() in IMAGE_EXTS)
    if not files:
        print("[WARN] no input images found", file=sys.stderr)
        return 0

    params, rc = _load_params(args, device)
    if rc is not None:
        return rc
    timers = StageTimers() if timers is None else timers
    predictor = seg.SegmentationPredictor(params, device=device,
                                          timers=timers)
    print(f"[INFO] {len(files)} image(s), targets={targets}, "
          f"mode={args.mode}")

    from gs360x_torch.io.image import read_image, to_float01

    done = 0
    for path in files:
        with timers.stage("decode"):
            rgb = read_image(path)
            if rgb.dtype != np.uint8:
                rgb = (to_float01(rgb) * 255).astype(np.uint8)
            rgb01 = rgb.astype(np.float32) / 255.0
        mask = predictor.combined_mask(
            rgb01, targets, score_thresh=args.score_thresh,
            mask_thresh=args.mask_thresh)
        with timers.stage("refine"):
            if mask is not None:
                mask = refine_mask(mask, device=device)
                if args.include_shadow:
                    mask = np.maximum(mask, estimate_shadow_mask(
                        rgb01, mask, device=device))
                mask = expand_mask(mask, args.mask_expand_mode,
                                   args.mask_expand_pixels,
                                   args.mask_expand_percent, device=device)
                mask = fuse_mask_to_edges(mask, args.edge_fuse_pixels)
            add = load_manual_add_layer(path, manual_dir, rgb.shape[:2])
            if add is not None:
                mask = add if mask is None else np.maximum(mask, add)
        with timers.stage("encode"):
            write_output(args.mode, path, out_dir, rgb, mask, device=device)
        done += 1
        print(f"[{done}/{len(files)}] {path.name}"
              + ("" if mask is None else " (subject found)"), flush=True)

    print(f"[OK] wrote {done} output(s) to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
