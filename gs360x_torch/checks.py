"""Measurements that check the port's results, kept apart from the modules
the tools import: the four capability numbers of a segmentation model, and
the comparison of two ``centroid`` voxel pick sets. ``chip_smoke.py`` and
the tests call them."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from gs360x_torch.kernels import voxel
from gs360x_torch.models import instances, synthseg


def capability(logits) -> dict:
    """The four capability numbers of ``tests/test_synthseg.py`` for one
    model: the subject IoU on 16 held-out corpus scenes (seed 99), on 16
    photo-style scenes (rng 4242) and on 16 scenes of the held-out transfer
    generator (rng 777), all at 64², and the person instances' AP@0.5 on 12
    instance scenes (rng 888). ``logits`` maps an (N, 64, 64, 3) f32 numpy
    batch to its (N, NUM_CLASSES, 64, 64) logits as a numpy array, so one
    function measures any package's model. Returns the four numbers and
    ``n_gt``, the instances counted."""
    def iou(images, labels):
        pred = np.asarray(logits(images)).argmax(1)
        inter = float(((pred > 0) & (labels > 0)).sum())
        return inter / max(float(((pred > 0) | (labels > 0)).sum()), 1.0)

    def scenes(generator, seed, **kw):
        rng = np.random.default_rng(seed)
        pairs = [generator(rng, size=64, **kw) for _ in range(16)]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    got = {"heldout": iou(*synthseg.generate_corpus(16, size=64, seed=99)),
           "photo": iou(*scenes(synthseg.generate_scene, 4242,
                                photo_style=True)),
           "transfer": iou(*scenes(synthseg.generate_transfer_scene, 777))}
    person = synthseg.CLASS_TO_INDEX["person"]
    rng = np.random.default_rng(888)
    dets_all, n_gt = [], 0
    for _ in range(12):
        im, _sem, inst = synthseg.generate_instance_scene(
            rng, size=64, n_people=(2, 3))
        lg = torch.from_numpy(np.array(logits(im[None]), np.float32)[0])
        prob = torch.softmax(lg, dim=0)[person].numpy()
        lg = lg.numpy()
        dets = instances.instance_masks(lg.argmax(0) == person, prob,
                                        score_thresh=0.3, max_count=10)
        gts = [inst == k for k in range(1, inst.max() + 1)
               if (inst == k).sum() >= 16]
        for d in dets:
            d["gts"] = gts
        dets_all.extend(dets)
        n_gt += len(gts)
    got["AP@0.5"] = instances.average_precision(dets_all, n_gt,
                                                iou_thresh=0.5)
    got["n_gt"] = n_gt
    return got


def centroid_pick_differences(xyz: np.ndarray, keys: np.ndarray,
                              got: np.ndarray, ref: np.ndarray
                              ) -> Tuple[int, int]:
    """Compare two ``centroid`` pick sets of one cloud (sorted original
    indices, one a voxel, ``keys`` the cloud's (N, 3) voxel keys): the
    number of voxels whose picks differ, and of those the number that are
    not near-ties. A near-tie is a voxel where the two picks' distances to
    its f64 centroid differ by no more than the f32 centroid's rounding can
    move them: ``2·n·2**-24·√3·max|p|`` for a voxel of n points, plus the
    f32 rounding of the scores."""
    k = keys.astype(np.int64)
    bits = voxel.PACK_BITS
    if int(k.max()) < 1 << bits:
        packed = (k[:, 0] << 2 * bits) | (k[:, 1] << bits) | k[:, 2]
    else:
        packed = np.unique(k, axis=0, return_inverse=True)[1].ravel()
    a = dict(zip(packed[got].tolist(), got.tolist()))
    b = dict(zip(packed[ref].tolist(), ref.tolist()))
    if a.keys() != b.keys():
        raise ValueError("the two pick sets cover different voxels")
    differ = [v for v in a if a[v] != b[v]]
    eps = 2.0 ** -24
    far = 0
    for v in differ:
        pts = xyz[packed == v].astype(np.float64)
        c = pts.mean(axis=0)
        da, db = (float(np.sqrt(((xyz[i] - c) ** 2).sum())) for i in
                  (a[v], b[v]))
        tol = 2 * len(pts) * eps * math.sqrt(3) * float(np.abs(pts).max()) \
            + 4 * eps * max(da, db)
        far += abs(da - db) > tol
    return len(differ), far
