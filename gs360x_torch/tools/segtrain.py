"""gs360x-torch-segtrain — train the segmentation U-Net on labeled masks,
on an NVIDIA GPU.

Port of :mod:`gs360x.tools.segtrain`: given a folder of images and a folder
of same-stem mask PNGs (pixel value = class id, see
:data:`gs360x_torch.models.segmentation.TARGET_TO_CLASSES`; any nonzero
value in a single-target dataset maps to the chosen class), it trains the
U-Net and writes weights that ``gs360x-torch-maskseg --checkpoint`` reads.
The same flags, messages, split, epoch loop and numpy rng, and exit codes
(2 without ``-i/-m/-o``, 1 for fewer than two pairs, 130 on SIGINT), plus
``--device {cuda,cpu}`` (default ``cuda``; ``cuda`` without a card raises).

Training is data-parallel over every visible card (:func:`train_mesh`),
as the JAX CLI's is over every device: ``devices`` reads the mesh's size,
the batch is ``--batch-size`` rounded down to a multiple of it (at least
one a device), and each step splits it over the cards
(:func:`~gs360x_torch.models.segmentation.train_step` on a mesh). With
``--device cpu`` the mesh is the one CPU device.
``-o`` and ``--resume`` take the single-file msgpack of
:func:`~gs360x_torch.models.segmentation.save_weights` (which
``flax.serialization`` reads), not an Orbax directory; ``--resume``
fine-tunes at the width of the weights it reads. ``--make-default`` trains
the cached default that ``gs360x-torch-maskseg`` falls back to, at the
port's cache path unless ``-o`` is given.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gs360x_torch.device import DEVICE_CHOICES, resolve_device

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff")


def find_pairs(image_dir: pathlib.Path, mask_dir: pathlib.Path
               ) -> List[Tuple[pathlib.Path, pathlib.Path]]:
    """Match images to masks by stem (mask extension may differ)."""
    masks = {}
    for p in sorted(mask_dir.iterdir()):
        if p.suffix.lower() in IMAGE_EXTS:
            masks.setdefault(p.stem, p)
    pairs = []
    for p in sorted(image_dir.iterdir()):
        if p.suffix.lower() in IMAGE_EXTS and p.stem in masks:
            pairs.append((p, masks[p.stem]))
    return pairs


def load_pair(img_path, mask_path, size: int, target_class: Optional[int]
              ) -> Tuple[np.ndarray, np.ndarray]:
    from gs360x_torch.io.image import read_image, to_float01

    img = to_float01(read_image(img_path))
    mask = read_image(mask_path)
    if mask.ndim == 3:
        mask = mask[..., 0]
    img = resize_bilinear_np(img, size, size)
    sh, sw = mask.shape
    ys = np.minimum(((np.arange(size) + 0.5) * sh / size).astype(np.int64),
                    sh - 1)
    xs = np.minimum(((np.arange(size) + 0.5) * sw / size).astype(np.int64),
                    sw - 1)
    mask = mask[ys][:, xs]
    if target_class is not None:
        mask = np.where(mask > 0, target_class, 0)
    return img.astype(np.float32), mask.astype(np.int32)


def resize_bilinear_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host bilinear resize (training data prep; no cv2 dependency)."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    ys = (np.arange(h) + 0.5) * sh / h - 0.5
    xs = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, sh - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def train_mesh(device: torch.device):
    """The data mesh of the training steps: every visible card when
    ``device`` is a card, whichever it names; the one CPU device
    otherwise."""
    from gs360x_torch.runtime.mesh import data_mesh

    return data_mesh() if device.type == "cuda" else data_mesh([device])


def build_arg_parser() -> argparse.ArgumentParser:
    from gs360x_torch.models import segmentation as seg

    ap = argparse.ArgumentParser(
        description="Train the gs360x segmentation U-Net on labeled masks.")
    ap.add_argument("--make-default", action="store_true",
                    help="Build the synthetic-corpus default checkpoint "
                         "used by gs360x-torch-maskseg when no --checkpoint "
                         "is given (cached in ~/.cache/gs360x)")
    ap.add_argument("-i", "--image-dir", required=False, default=None)
    ap.add_argument("-m", "--mask-dir", required=False, default=None,
                    help="Same-stem mask PNGs (pixel value = class id)")
    ap.add_argument("-o", "--checkpoint", required=False, default=None,
                    help="Output single-file msgpack weights")
    ap.add_argument("--resume", default=None,
                    help="Existing msgpack weights to fine-tune from")
    ap.add_argument("--target", choices=sorted(seg.TARGET_TO_CLASSES),
                    default=None,
                    help="Binary dataset: map all nonzero mask pixels to "
                         "this target's first class id")
    ap.add_argument("--size", type=int, default=256,
                    help="Training crop/resize (default 256)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="Batch of each step")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--val-fraction", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=list(DEVICE_CHOICES), default="cuda",
                    help="Torch device: cuda raises when no card is "
                         "present; cpu trains on the CPU")
    return ap


def main(argv=None) -> int:
    try:
        return _main(argv)
    except KeyboardInterrupt:
        # reference contract: SIGINT stops cleanly with exit code 130
        print("\n[INFO] Interrupt received, stopping...", file=sys.stderr)
        return 130


def _main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.make_default:
        from gs360x_torch.models import synthseg
        path = (pathlib.Path(args.checkpoint).resolve() if args.checkpoint
                else synthseg.default_weights_path())
        synthseg.build_default_checkpoint(
            path, device=resolve_device(args.device))
        return 0
    if not (args.image_dir and args.mask_dir and args.checkpoint):
        print("[ERR] -i/--image-dir, -m/--mask-dir and -o/--checkpoint are "
              "required (or use --make-default)", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    from gs360x_torch.models import segmentation as seg

    image_dir = pathlib.Path(args.image_dir)
    mask_dir = pathlib.Path(args.mask_dir)
    pairs = find_pairs(image_dir, mask_dir)
    if len(pairs) < 2:
        print(f"[ERR] need >=2 image/mask pairs, found {len(pairs)} "
              f"(images: {image_dir}, masks: {mask_dir})", file=sys.stderr)
        return 1

    target_class = None
    if args.target:
        target_class = seg.CLASS_TO_INDEX[
            seg.TARGET_TO_CLASSES[args.target][0]]

    mesh = train_mesh(device)
    print(f"[INFO] {len(pairs)} pairs, size {args.size}, devices "
          f"{mesh.size}")
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(pairs))
    n_val = max(1, int(len(pairs) * args.val_fraction)) \
        if len(pairs) >= 10 else 0
    val_idx = set(order[:n_val].tolist())

    images, labels, val_images, val_labels = [], [], [], []
    for k, (ip, mp) in enumerate(pairs):
        try:
            img, mask = load_pair(ip, mp, args.size, target_class)
        except Exception as exc:
            print(f"[WARN] skip {ip.name}: {exc}", file=sys.stderr)
            continue
        (val_images if k in val_idx else images).append(img)
        (val_labels if k in val_idx else labels).append(mask)
    if not images:
        print("[ERR] no loadable pairs", file=sys.stderr)
        return 1
    images = np.stack(images)
    labels = np.stack(labels)
    print(f"[INFO] train {len(images)}, val {len(val_images)}")

    params = None
    if args.resume:
        try:
            params = seg.load_checkpoint(pathlib.Path(args.resume).resolve())
        except (OSError, ValueError) as exc:
            print(f"[ERR] failed to load checkpoint: {exc}", file=sys.stderr)
            return 1
    state = seg.create_train_state(
        torch.Generator().manual_seed(args.seed), learning_rate=args.lr,
        features=params and seg.features_from_params(params), params=params,
        mesh=mesh)
    if args.resume:
        print(f"[INFO] resumed from {args.resume}")

    # the JAX CLI's rounding: a multiple of the mesh, at least one a device
    n_dev = mesh.size
    bs = max(n_dev, (args.batch_size // n_dev) * n_dev)
    steps_per_epoch = max(1, len(images) // bs)
    t0 = time.time()
    for epoch in range(args.epochs):
        perm = rng.permutation(len(images))
        losses = []
        for s in range(steps_per_epoch):
            idx = perm[s * bs:(s + 1) * bs]
            if len(idx) < bs:  # pad the tail batch by wrapping
                idx = np.concatenate([idx, perm[:bs - len(idx)]])
            xb = torch.from_numpy(images[idx]).to(mesh.devices[0])
            yb = torch.from_numpy(labels[idx]).to(mesh.devices[0])
            losses.append(float(seg.train_step(state, xb, yb)))
        msg = (f"[INFO] epoch {epoch + 1}/{args.epochs} "
               f"loss {np.mean(losses):.4f}")
        if len(val_images):
            acc = pixel_accuracy(state, np.stack(val_images),
                                 np.stack(val_labels), bs)
            msg += f" val_acc {acc:.3f}"
        print(msg, flush=True)

    out = pathlib.Path(args.checkpoint).expanduser().resolve()
    seg.save_weights(out, state.model.state_dict())
    print(f"[OK] checkpoint: {out} ({time.time() - t0:.1f}s)")
    return 0


@torch.inference_mode()
def pixel_accuracy(state, images: np.ndarray, labels: np.ndarray,
                   batch: int) -> float:
    """The share of validation pixels whose argmax class is the label's,
    counted on the device ``batch`` images at a time."""
    from gs360x_torch.models.segmentation import train_convs

    device = next(state.model.parameters()).device
    right = torch.zeros((), dtype=torch.int64, device=device)
    with train_convs():
        for k in range(0, len(images), batch):
            x = torch.from_numpy(images[k:k + batch]).to(device)
            y = torch.from_numpy(labels[k:k + batch]).to(device)
            pred = state.model(x.permute(0, 3, 1, 2)).argmax(1)
            right += (pred == y).sum()
    return int(right) / labels.size


if __name__ == "__main__":
    sys.exit(main())
