"""Instance separation for class-probability masks.

The reference's Mask R-CNN emits per-DETECTION masks, so two adjacent
people produce two instances even when their silhouettes touch
(``cli_tools/gs360_SegmentationMaskTool.py:334-356`` unions
per-detection masks after a score>=0.7 gate).  A semantic U-Net merges
touching subjects into one connected component; this module recovers the
instance structure with marker-based watershed:

1. each component is ASPECT-NORMALISED (its bounding box resampled
   square-ish) — people are ~3:1 tall, and side-by-side tall silhouettes
   have no separate euclidean-distance peaks until the long axis is
   compressed;
2. smoothed-distance peaks seed a watershed flood over inverted
   distance;
3. adjacent pieces whose SADDLE is nearly as deep as their peaks are
   merged back (a wide-shallow interface means one body — e.g. head on
   torso; genuinely separate bodies meet at a narrow, deep crease).

Host-side numpy/scipy on the (small) mask raster, mirroring where the
reference runs its mask post-processing (CPU, after inference).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy import ndimage as ndi


def _split_component(crop: np.ndarray, smooth_sigma: float,
                     rel_peak: float, merge_ratio: float) -> np.ndarray:
    """Split one connected component (bool crop) into instance labels
    (int32, 0 = outside)."""
    h, w = crop.shape
    # aspect-normalise: compress the long axis so tall/wide subjects
    # become round-ish and develop one distance peak per body
    zy = min(1.0, w / h) if h else 1.0
    zx = min(1.0, h / w) if w else 1.0
    nh = max(8, int(round(h * zy)))
    nw = max(8, int(round(w * zx)))
    norm = ndi.zoom(crop.astype(np.float32), (nh / h, nw / w),
                    order=0) > 0.5
    if not norm.any():
        return crop.astype(np.int32)
    dist = ndi.distance_transform_edt(norm)
    sm = ndi.gaussian_filter(dist, smooth_sigma)
    dmax = float(sm.max())
    if dmax <= 0:
        return crop.astype(np.int32)
    size = max(3, int(round(dmax)))
    peaks = norm & (sm >= ndi.maximum_filter(sm, size=size) - 1e-6) \
        & (sm >= rel_peak * dmax)
    seeds, n_seeds = ndi.label(peaks)
    if n_seeds <= 1:
        return crop.astype(np.int32)

    inv = np.full(norm.shape, np.uint16(65535))
    inv[norm] = ((dmax - sm[norm]) / dmax * 60000.0).astype(np.uint16)
    markers = np.where(norm, seeds, -1).astype(np.int32)
    ws = ndi.watershed_ift(inv, markers)
    ws = np.where(norm, np.maximum(ws, 0), 0)

    # saddle-ratio merge-back: pieces joined by a neck nearly as fat as
    # their bodies are one subject.  Ratios use the UNSMOOTHED distance —
    # smoothing flattens the crease between separate bodies toward the
    # merge threshold.
    peak_val = ndi.maximum(dist, seeds, index=np.arange(1, n_seeds + 1))
    peak_val = np.atleast_1d(peak_val)
    parent = list(range(n_seeds + 1))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for shift in ((0, 1), (1, 0)):
        a = ws[:nh - shift[0], :nw - shift[1]]
        b = ws[shift[0]:, shift[1]:]
        edge = (a > 0) & (b > 0) & (a != b)
        if not edge.any():
            continue
        la, lb = a[edge], b[edge]
        sv = np.minimum(dist[:nh - shift[0], :nw - shift[1]][edge],
                        dist[shift[0]:, shift[1]:][edge])
        for pa, pb, s in zip(la, lb, sv):
            ra, rb = find(int(pa)), find(int(pb))
            if ra == rb:
                continue
            if s >= merge_ratio * min(peak_val[pa - 1], peak_val[pb - 1]):
                parent[max(ra, rb)] = min(ra, rb)
    ws = np.vectorize(lambda v: find(int(v)) if v > 0 else 0,
                      otypes=[np.int32])(ws)

    # back to the original raster; nearest-label fill for pixels the
    # nearest-neighbour zoom misassigned
    back = ndi.zoom(ws, (h / nh, w / nw), order=0)
    back = np.where(crop, back, 0).astype(np.int32)
    lost = crop & (back == 0)
    if lost.any():
        if (back > 0).any():
            idx = ndi.distance_transform_edt(
                back == 0, return_indices=True, return_distances=False)
            back[lost] = back[tuple(i[lost] for i in idx)]
        else:
            back[lost] = 1
    return back


def split_instances(binary: np.ndarray, *, smooth_sigma: float = 2.0,
                    rel_peak: float = 0.45, merge_ratio: float = 0.8,
                    min_area: int = 16) -> Tuple[np.ndarray, int]:
    """Split a binary class mask into instance labels.

    Returns ``(labels int32 (H, W), count)`` with labels 1..count.
    Connected components with a single (normalised-space) distance peak
    pass through unchanged; multi-peak components are watershed-split
    with saddle-ratio merge-back.
    """
    binary = np.asarray(binary, bool)
    comp_labels, n_comp = ndi.label(binary)
    out = np.zeros(binary.shape, np.int32)
    count = 0
    slices = ndi.find_objects(comp_labels)
    for comp, sl in enumerate(slices, start=1):
        if sl is None:
            continue
        m_full = comp_labels == comp
        area = int(m_full.sum())
        if area < min_area:
            continue
        crop = m_full[sl]
        pieces = _split_component(crop, smooth_sigma, rel_peak,
                                  merge_ratio)
        for lbl in np.unique(pieces):
            if lbl <= 0:
                continue
            piece = pieces == lbl
            if int(piece.sum()) < min_area:
                continue
            count += 1
            out[sl][piece] = count
        # absorb sub-min_area slivers into the nearest labelled pixel
        lost = m_full[sl] & (out[sl] == 0)
        if lost.any() and (out[sl] > 0).any():
            sub = out[sl]
            idx = ndi.distance_transform_edt(
                sub == 0, return_indices=True, return_distances=False)
            sub[lost] = sub[tuple(i[lost] for i in idx)]
            out[sl] = sub
    return out, count


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two boolean masks."""
    inter = float(np.logical_and(a, b).sum())
    union = float(np.logical_or(a, b).sum())
    return inter / union if union > 0 else 0.0


def average_precision(dets: List[dict], n_gt: int, *,
                      iou_thresh: float = 0.5) -> float:
    """Instance AP at one IoU threshold (COCO-style, single class).

    ``dets``: [{'mask', 'score', 'gts': [gt bool masks of the same
    image]}] pooled across images — each det carries ITS image's GT
    list so images stay separable after pooling.  Detections are ranked
    by score; each greedily matches the best still-unmatched GT of its
    image at IoU >= ``iou_thresh``; AP integrates the interpolated
    precision-recall curve over recall (the metric the reference's Mask
    R-CNN is trained against, ``gs360_SegmentationMaskTool.py:262-288``).
    """
    if n_gt == 0:
        return 1.0 if not dets else 0.0
    order = sorted(range(len(dets)), key=lambda i: -dets[i]["score"])
    matched: dict = {}
    tp = np.zeros(len(order))
    fp = np.zeros(len(order))
    for rank, i in enumerate(order):
        det = dets[i]
        gts = det["gts"]
        taken = matched.setdefault(id(gts), set())
        best_iou, best_j = 0.0, -1
        for j, g in enumerate(gts):
            if j in taken:
                continue
            iou = mask_iou(det["mask"], g)
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_iou >= iou_thresh:
            taken.add(best_j)
            tp[rank] = 1
        else:
            fp[rank] = 1
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    # interpolated precision (monotone non-increasing from the right)
    for k in range(len(precision) - 2, -1, -1):
        precision[k] = max(precision[k], precision[k + 1])
    ap = 0.0
    prev_r = 0.0
    for k in range(len(recall)):
        ap += (recall[k] - prev_r) * precision[k]
        prev_r = recall[k]
    return float(ap)


def instance_masks(binary: np.ndarray, prob: np.ndarray, *,
                   score_thresh: float, max_count: int,
                   **split_kw) -> List[dict]:
    """Instance dicts [{'mask', 'score'}] for one class probability map."""
    labels, count = split_instances(binary, **split_kw)
    dets = []
    for inst in range(1, count + 1):
        m = labels == inst
        score = float(prob[m].mean())
        if score >= score_thresh:
            dets.append({"mask": m, "score": score})
    return dets
