"""Segmentation preview sheet (reference ``gs360_GUI.py:4531-5735``).

The reference GUI runs the detector in-process on a sample image and
shows a tinted instance overlay plus a per-instance list before the user
commits to a batch run. Headless core: the Tk tab renders the returned
overlay and rows. The U-Net runs on ``device`` (the app passes the card;
the scipy instance split runs on the host).
"""

from __future__ import annotations

import pathlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

# distinct tint per instance, cycled (RGB 0-255)
INSTANCE_COLORS = (
    (239, 83, 80), (66, 165, 245), (102, 187, 106), (255, 202, 40),
    (171, 71, 188), (38, 198, 218), (255, 112, 67), (141, 110, 99),
)


def preview_segmentation(rgb_u8: np.ndarray, *, device, params=None,
                         targets: Sequence[str] = ("person",),
                         score_thresh: Optional[float] = None,
                         mask_thresh: Optional[float] = None,
                         alpha: float = 0.45,
                         max_size: int = 640
                         ) -> Tuple[np.ndarray, List[dict]]:
    """Run the segmentation net on one image and build the preview sheet.

    Returns ``(overlay_rgb_u8, instances)`` where each instance row is
    ``{'class_name', 'score', 'area_pct', 'color'}`` in detection order.
    The image is downscaled to ``max_size`` on the long edge first (the
    preview is interactive; the batch run sees full resolution).
    """
    from gs360x_torch.models import segmentation as seg

    kw = {}
    if score_thresh is not None:
        kw["score_thresh"] = float(score_thresh)
    if mask_thresh is not None:
        kw["mask_thresh"] = float(mask_thresh)

    img = np.asarray(rgb_u8)
    h, w = img.shape[:2]
    scale = max(h, w) / float(max_size)
    if scale > 1.0:
        nh, nw = int(round(h / scale)), int(round(w / scale))
        ys = (np.arange(nh) * (h / nh)).astype(int)
        xs = (np.arange(nw) * (w / nw)).astype(int)
        img = img[ys][:, xs]

    # expand aggregate targets (e.g. animal -> bird/cat/dog)
    classes: List[str] = []
    for t in targets:
        classes.extend(seg.TARGET_TO_CLASSES.get(t, [t]))

    predictor = seg.SegmentationPredictor(params, device=device)
    dets = predictor.detect(img.astype(np.float32) / 255.0, classes, **kw)

    overlay = img.astype(np.float32)
    total_px = float(overlay.shape[0] * overlay.shape[1])
    rows: List[dict] = []
    for i, det in enumerate(dets):
        color = INSTANCE_COLORS[i % len(INSTANCE_COLORS)]
        m = det["mask"]
        overlay[m] = ((1.0 - alpha) * overlay[m]
                      + alpha * np.asarray(color, np.float32))
        rows.append({
            "class_name": det["class_name"],
            "score": round(float(det["score"]), 3),
            "area_pct": round(100.0 * float(m.sum()) / total_px, 2),
            "color": color,
        })
    return overlay.astype(np.uint8), rows


def preview_first_image(in_dir, *, device, **kw):
    """Convenience: preview on the first image found in a directory."""
    from gs360x_torch.io.image import read_image, to_float01

    d = pathlib.Path(in_dir)
    exts = {".jpg", ".jpeg", ".png", ".tif", ".tiff"}
    for p in sorted(d.iterdir()):
        if p.is_file() and p.suffix.lower() in exts:
            rgb = read_image(p)
            if rgb.dtype != np.uint8:
                rgb = (to_float01(rgb) * 255).astype(np.uint8)
            return p.name, preview_segmentation(rgb, device=device, **kw)
    raise FileNotFoundError(f"no images in {d}")
