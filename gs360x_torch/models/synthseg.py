"""Synthetic labelled corpus and the shipped segmentation weights (the
port of :mod:`gs360x.models.synthseg`).

The shipped weights (``gs360x_torch/models/weights/``, a byte-equal copy of
the JAX package's single-file msgpack) are the tool's out-of-the-box
capability, as the reference's downloaded COCO weights are its. They load
through :mod:`gs360x_torch.models.weights`, without ``flax``. The corpus
generators are numpy and the JAX package's, copied: the same seed gives the
same scenes, which the capability gates of both packages use.
:func:`build_default_checkpoint` trains the cached default with the JAX
package's recipe and the same numpy stream, and writes it as single-file
msgpack at :func:`default_weights_path`, beside the JAX package's Orbax
directory (:func:`default_checkpoint_path`), which the port cannot read.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

from gs360x_torch.models.segmentation import CLASS_TO_INDEX

# v3: texture-diverse corpus + photometric domain randomization
DEFAULT_CHECKPOINT_VERSION = "seg_default_v3"


def default_checkpoint_path() -> pathlib.Path:
    """Where the JAX package caches its default (Orbax) checkpoint."""
    return (pathlib.Path.home() / ".cache" / "gs360x"
            / DEFAULT_CHECKPOINT_VERSION)


def default_weights_path() -> pathlib.Path:
    """Where the port caches its default (single-file msgpack) weights."""
    return (pathlib.Path.home() / ".cache" / "gs360x"
            / f"{DEFAULT_CHECKPOINT_VERSION}_torch.msgpack")


# shipped pretrained weights: trained by tools/seg_eval.py on the full
# photo-style corpus config and committed as a single msgpack file
PACKAGED_WEIGHTS_NAME = "seg_unet_64_v10.msgpack"
PACKAGED_WEIGHTS_FEATURES = (16, 32, 64)
PACKAGED_WEIGHTS_INPUT = 64


def packaged_weights_path() -> pathlib.Path:
    return (pathlib.Path(__file__).resolve().parent / "weights"
            / PACKAGED_WEIGHTS_NAME)


def load_packaged_weights():
    """The shipped weights as a ``state_dict`` (None if absent)."""
    from gs360x_torch.models import segmentation as seg

    path = packaged_weights_path()
    if not path.exists():
        return None
    return seg.load_weights(path)


def _texture(rng, h, w, base, amp=0.25, freq=6.0):
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    ph = rng.uniform(0, 2 * math.pi, 6)
    t = (np.sin(freq * 2 * math.pi * xx + ph[0])
         + np.sin(freq * 1.3 * 2 * math.pi * yy + ph[1])
         + np.sin(freq * 0.7 * 2 * math.pi * (xx + yy) + ph[2]))
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        out[..., c] = np.clip(
            base[c] + amp * t / 3.0
            + 0.05 * rng.standard_normal((h, w)), 0, 1)
    return out


def _ellipse_mask(h, w, cy, cx, ry, rx, angle=0.0):
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    ca, sa = math.cos(angle), math.sin(angle)
    dy, dx = yy - cy, xx - cx
    u = (ca * dx + sa * dy) / max(rx, 1.0)
    v = (-sa * dx + ca * dy) / max(ry, 1.0)
    return (u * u + v * v) <= 1.0


def _draw_person(rng, h, w):
    """Vertical capsule (torso+legs) with a head disc — tall aspect."""
    cy = rng.uniform(0.45, 0.7) * h
    cx = rng.uniform(0.2, 0.8) * w
    height = rng.uniform(0.3, 0.55) * h
    width = height * rng.uniform(0.22, 0.35)
    m = _ellipse_mask(h, w, cy, cx, height / 2, width / 2)
    head_r = width * rng.uniform(0.45, 0.6)
    m |= _ellipse_mask(h, w, cy - height / 2 - head_r * 0.6, cx,
                       head_r, head_r)
    return m


def _draw_car(rng, h, w, long=True):
    """Horizontal rounded body + cabin bump + two wheel discs."""
    cy = rng.uniform(0.55, 0.8) * h
    cx = rng.uniform(0.25, 0.75) * w
    length = rng.uniform(0.35, 0.6) * w * (1.2 if long else 0.8)
    ht = length * rng.uniform(0.22, 0.3)
    m = _ellipse_mask(h, w, cy, cx, ht / 2, length / 2)
    m |= _ellipse_mask(h, w, cy - ht * 0.5, cx, ht * 0.45, length * 0.28)
    for s in (-0.3, 0.3):
        m |= _ellipse_mask(h, w, cy + ht * 0.45, cx + s * length,
                           ht * 0.28, ht * 0.28)
    return m


def _draw_twowheeler(rng, h, w):
    """Two wheel rings + slanted frame bar — sparse, thin structure."""
    cy = rng.uniform(0.55, 0.8) * h
    cx = rng.uniform(0.3, 0.7) * w
    wb = rng.uniform(0.2, 0.35) * w
    r = wb * rng.uniform(0.3, 0.4)
    m = np.zeros((h, w), bool)
    for s in (-0.5, 0.5):
        outer = _ellipse_mask(h, w, cy, cx + s * wb, r, r)
        inner = _ellipse_mask(h, w, cy, cx + s * wb, r * 0.55, r * 0.55)
        m |= outer & ~inner
    m |= _ellipse_mask(h, w, cy - r * 0.7, cx, r * 0.3, wb * 0.55,
                       angle=rng.uniform(-0.3, 0.3))
    return m


def _draw_animal(rng, h, w):
    """Horizontal body blob + head + leg stubs — low, wide aspect."""
    cy = rng.uniform(0.55, 0.8) * h
    cx = rng.uniform(0.25, 0.75) * w
    length = rng.uniform(0.25, 0.45) * w
    ht = length * rng.uniform(0.4, 0.55)
    m = _ellipse_mask(h, w, cy, cx, ht / 2, length / 2)
    m |= _ellipse_mask(h, w, cy - ht * 0.25, cx + length * 0.55,
                       ht * 0.35, ht * 0.35)
    for s in (-0.3, -0.1, 0.1, 0.3):
        m |= _ellipse_mask(h, w, cy + ht * 0.55, cx + s * length,
                           ht * 0.35, ht * 0.12)
    return m


_CLASS_DRAWERS = {
    "person": _draw_person,
    "bicycle": _draw_twowheeler,
    "car": lambda rng, h, w: _draw_car(rng, h, w, long=False),
    "motorcycle": _draw_twowheeler,
    "bus": lambda rng, h, w: _draw_car(rng, h, w, long=True),
    "truck": lambda rng, h, w: _draw_car(rng, h, w, long=True),
    "bird": _draw_animal,
    "cat": _draw_animal,
    "dog": _draw_animal,
}

# distinct appearance per class family so the net has a learnable cue
_CLASS_BASE = {
    "person": (0.75, 0.35, 0.30), "bicycle": (0.25, 0.25, 0.30),
    "car": (0.30, 0.45, 0.75), "motorcycle": (0.35, 0.30, 0.35),
    "bus": (0.85, 0.75, 0.25), "truck": (0.55, 0.60, 0.65),
    "bird": (0.55, 0.70, 0.40), "cat": (0.65, 0.55, 0.40),
    "dog": (0.50, 0.40, 0.30),
}


def _fractal_texture(rng, h, w, base, amp=0.22, octaves=4):
    """Multi-octave value noise — closer to photographic texture
    statistics than the single-band sin fields of :func:`_texture`."""
    acc = np.zeros((h, w), np.float64)
    norm = 0.0
    for o in range(octaves):
        gh = max(2, (h >> (octaves - 1 - o)) or 2)
        gw = max(2, (w >> (octaves - 1 - o)) or 2)
        g = rng.standard_normal((gh, gw))
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        gi = (g[y0][:, x0] * (1 - fy) * (1 - fx)
              + g[y0 + 1][:, x0] * fy * (1 - fx)
              + g[y0][:, x0 + 1] * (1 - fy) * fx
              + g[y0 + 1][:, x0 + 1] * fy * fx)
        wgt = 0.5 ** (octaves - 1 - o)
        acc += wgt * gi
        norm += wgt
    acc /= norm
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        out[..., c] = np.clip(
            base[c] + amp * acc + 0.03 * rng.standard_normal((h, w)), 0, 1)
    return out


def _patch_texture(rng, h, w, base, amp=0.22):
    """Two-tone patchwork: thresholded low-frequency noise picks between
    two flat tones with ragged boundaries.  A TRAINING-ONLY third
    texture family (alongside the sin fields and value noise) so the
    net can't key on one texture process; the transfer eval families
    (oriented stripes, Voronoi cells) stay held out."""
    g = rng.standard_normal((max(2, h // 8), max(2, w // 8)))
    ys = np.linspace(0, g.shape[0] - 1, h)
    xs = np.linspace(0, g.shape[1] - 1, w)
    y0 = np.clip(ys.astype(int), 0, g.shape[0] - 2)
    x0 = np.clip(xs.astype(int), 0, g.shape[1] - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    gi = (g[y0][:, x0] * (1 - fy) * (1 - fx) + g[y0 + 1][:, x0] * fy
          * (1 - fx) + g[y0][:, x0 + 1] * (1 - fy) * fx
          + g[y0 + 1][:, x0 + 1] * fy * fx)
    two_tone = np.where(gi > rng.uniform(-0.5, 0.5), amp, -amp)
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        out[..., c] = np.clip(
            base[c] + two_tone + 0.03 * rng.standard_normal((h, w)), 0, 1)
    return out


def _spectral_texture(rng, h, w, base, amp=0.22):
    """Random anisotropic band-pass noise: white noise filtered by a
    Gaussian bump at a random (orientation, frequency, bandwidth) in the
    Fourier plane.  One PROCESS spans a continuum of looks — oriented
    banding, granules, blobs — so the net can't key on any single
    texture statistic.  A TRAINING-ONLY fourth family; the transfer
    eval's explicit stripe/Voronoi generators remain held out (different
    construction, characteristically non-Gaussian phase structure)."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    ang = rng.uniform(0, math.pi)
    f0 = rng.uniform(0.02, 0.25)
    bw = rng.uniform(0.02, 0.15)
    aniso = rng.uniform(1.0, 6.0)
    fu = np.cos(ang) * fx + np.sin(ang) * fy
    fv = -np.sin(ang) * fx + np.cos(ang) * fy
    filt = np.exp(-((np.abs(fu) - f0) ** 2 / (2 * bw * bw)
                    + fv * fv * aniso / (2 * bw * bw)))
    spec = np.fft.rfft2(rng.standard_normal((h, w))) * filt
    g = np.fft.irfft2(spec, s=(h, w))
    sd = float(g.std()) or 1.0
    g = g / sd
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        out[..., c] = np.clip(
            base[c] + amp * g + 0.03 * rng.standard_normal((h, w)), 0, 1)
    return out


def _band_texture(rng, h, w, base, amp=0.22):
    """Hard-edged oriented bands: the spectral field thresholded to two
    tones.  Covers the flat-regions-with-hard-oriented-boundaries
    statistic (a strong false-positive trigger for nets that key on
    edges) without using the eval's explicit sin-phase stripe process."""
    t = _spectral_texture(rng, h, w, np.zeros(3), amp=1.0)[..., 0]
    two = np.where(t > rng.uniform(-0.3, 0.3), amp, -amp)
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        out[..., c] = np.clip(
            base[c] + two + 0.03 * rng.standard_normal((h, w)), 0, 1)
    return out


def _train_texture(rng, h, w, base, amp):
    """Random training texture family (photo-style scenes)."""
    r = rng.random()
    if r < 0.4:
        return _fractal_texture(rng, h, w, base, amp=amp)
    if r < 0.65:
        return _patch_texture(rng, h, w, base, amp=amp)
    if r < 0.85:
        return _spectral_texture(rng, h, w, base, amp=amp)
    return _band_texture(rng, h, w, base, amp=amp)


def _shade(rng, img, m):
    """Directional lighting across a subject (photographic-style cue)."""
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return
    ang = rng.uniform(0, 2 * math.pi)
    proj = (np.cos(ang) * (xs - xs.mean()) + np.sin(ang) * (ys - ys.mean()))
    ext = max(float(np.abs(proj).max()), 1.0)
    shade = 1.0 + rng.uniform(0.15, 0.4) * (proj / ext)
    img[ys, xs] = np.clip(img[ys, xs] * shade[:, None], 0, 1)


def generate_scene(rng: np.random.Generator, size: int = 128,
                   max_subjects: int = 3, photo_style: bool = False):
    """One synthetic scene: (image f32 (S,S,3), labels int32 (S,S)).

    ``photo_style=True`` renders with photographic statistics — fractal
    textures, directional subject shading, contact shadows, clutter
    distractors, vignette, sensor noise — and allows ADJACENT same-class
    subjects (the instance-separation case). The held-out capability
    fixtures use this mode so the IoU gate measures generalisation
    beyond the training corpus' flat-texture look."""
    h = w = size
    if photo_style:
        sky = _train_texture(rng, h, w, rng.uniform(0.45, 0.85, 3),
                             amp=0.12)
        ground = _train_texture(rng, h, w, rng.uniform(0.2, 0.5, 3),
                                amp=0.25)
    else:
        sky = _texture(rng, h, w, rng.uniform(0.4, 0.8, 3), amp=0.1,
                       freq=2)
        ground = _texture(rng, h, w, rng.uniform(0.2, 0.55, 3), amp=0.2,
                          freq=8)
    horizon = int(rng.uniform(0.3, 0.6) * h)
    img = sky.copy()
    img[horizon:] = ground[horizon:]
    labels = np.zeros((h, w), np.int32)

    # clutter distractors: background-labelled shapes the net must ignore
    if photo_style:
        for _ in range(rng.integers(0, 4)):
            cy = rng.uniform(0.55, 0.9) * h
            cx = rng.uniform(0.05, 0.95) * w
            rr = rng.uniform(0.03, 0.1) * h
            mc = _ellipse_mask(h, w, cy, cx, rr,
                               rr * rng.uniform(0.7, 1.8),
                               angle=rng.uniform(0, math.pi))
            tex = _train_texture(rng, h, w, rng.uniform(0.25, 0.7, 3),
                                 amp=0.15)
            img[mc] = tex[mc]

    names = list(_CLASS_DRAWERS)
    n_subj = int(rng.integers(1, max_subjects + 1))
    for si in range(n_subj):
        name = names[rng.integers(len(names))]
        m = _CLASS_DRAWERS[name](rng, h, w)
        if photo_style and rng.random() < 0.5:
            # mild scale jitter (0.7-1.4x) — the transfer eval's wider
            # 0.55-1.6x range keeps its extremes held out
            m = _zoom_mask(m, rng.uniform(0.7, 1.4))
        if photo_style and name == "person" and rng.random() < 0.5:
            # adjacent second person — the touching-instances case
            m2 = np.roll(m, int(rng.uniform(0.12, 0.22) * w), axis=1)
            m = m | m2
        if not m.any():
            continue
        base = np.clip(np.asarray(_CLASS_BASE[name])
                       + rng.uniform(-0.08, 0.08, 3), 0, 1)
        if photo_style:
            tex = _train_texture(rng, h, w, base, amp=0.15)
        else:
            tex = _texture(rng, h, w, base, amp=0.12, freq=10)
        img[m] = tex[m]
        if photo_style:
            _shade(rng, img, m)
            # contact shadow under the subject
            ys, xs = np.nonzero(m)
            sh = _ellipse_mask(h, w, ys.max(), xs.mean(),
                               max(2.0, 0.04 * h),
                               max(3.0, (xs.max() - xs.min()) * 0.55))
            sh &= ~m
            img[sh] *= rng.uniform(0.55, 0.8)
        labels[m] = CLASS_TO_INDEX[name]

    if photo_style:
        yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                             indexing="ij")
        vig = 1.0 - rng.uniform(0.1, 0.3) * (yy * yy + xx * xx)
        img *= vig[..., None]
        img = np.clip(img + 0.015 * rng.standard_normal(img.shape), 0, 1)
    return img.astype(np.float32), labels


# --------------------------------------------------------------------------
# Held-out TRANSFER configuration (eval-only)
# --------------------------------------------------------------------------
#
# A photo-style IoU gate on fixtures from the generator family the model
# trained on measures corpus memorization rather than transfer.
# Everything below is reserved for EVALUATION — never sampled by
# generate_corpus or the default-checkpoint build — and differs from the
# training config along every axis: texture family (oriented stripes and
# Voronoi cells vs the training sin-fields and value-noise), subject scale
# range (0.55-1.6x zoom of the drawers' native sizes), occlusion (forced
# overlap stacks) and illumination (a global linear gradient vs the
# training vignette).


def _stripe_texture(rng, h, w, base, amp=0.2):
    """Oriented square-ish stripe bands — a texture process unused in
    training (hard-edged, anisotropic; the sin fields are soft and the
    value noise isotropic)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    ang = rng.uniform(0, math.pi)
    freq = rng.uniform(6.0, 18.0)
    t = np.sin(2 * math.pi * freq
               * (math.cos(ang) * xx + math.sin(ang) * yy)
               + rng.uniform(0, 2 * math.pi))
    duty = rng.uniform(-0.3, 0.3)
    bands = np.tanh(6.0 * (t - duty))            # hard-ish edges
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        out[..., c] = np.clip(
            base[c] + amp * bands + 0.02 * rng.standard_normal((h, w)),
            0, 1)
    return out


def _cell_texture(rng, h, w, base, amp=0.2, n_sites=None):
    """Voronoi-cell mosaic: per-cell flat brightness with darkened cell
    borders — piecewise-constant statistics unseen in training."""
    n = n_sites or int(rng.integers(8, 24))
    sy = rng.uniform(0, h, n)
    sx = rng.uniform(0, w, n)
    val = rng.uniform(-1.0, 1.0, n)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    d = (yy[..., None] - sy) ** 2 + (xx[..., None] - sx) ** 2
    part = np.partition(d, 1, axis=-1)
    nearest = np.argmin(d, axis=-1)
    border = (np.sqrt(part[..., 1]) - np.sqrt(part[..., 0])) < 1.5
    field = val[nearest] - 0.6 * border
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        out[..., c] = np.clip(
            base[c] + amp * field + 0.02 * rng.standard_normal((h, w)),
            0, 1)
    return out


def _zoom_mask(m, factor):
    """Rescale a subject mask about its own centroid (pure numpy
    nearest-neighbour resample of the full raster)."""
    h, w = m.shape
    if not m.any():
        return m
    ys, xs = np.nonzero(m)
    cy, cx = ys.mean(), xs.mean()
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    sy = np.clip(np.rint(cy + (yy - cy) / factor), 0, h - 1).astype(int)
    sx = np.clip(np.rint(cx + (xx - cx) / factor), 0, w - 1).astype(int)
    return m[sy, sx]


def generate_transfer_scene(rng: np.random.Generator, size: int = 64,
                            max_subjects: int = 3,
                            zoom=(0.55, 1.6), occlude_prob: float = 0.5,
                            grad=(0.1, 0.25)):
    """One scene from the held-out transfer config (see section comment).

    Returns ``(image f32 (S,S,3), labels int32 (S,S))`` like
    :func:`generate_scene` but with unseen texture families, shifted
    subject scales, forced occlusion pairs, and gradient illumination.
    The ADVERSARIAL eval config (tools/seg_eval.py) reuses this with
    ``zoom=(0.3, 0.6)``, ``occlude_prob=1.0``, ``grad=(0.25, 0.45)`` —
    small subjects, every pair occluding, harsh light."""
    h = w = size
    sky = _stripe_texture(rng, h, w, rng.uniform(0.45, 0.8, 3), amp=0.1)
    ground = _cell_texture(rng, h, w, rng.uniform(0.2, 0.5, 3), amp=0.18)
    horizon = int(rng.uniform(0.3, 0.6) * h)
    img = sky.copy()
    img[horizon:] = ground[horizon:]
    labels = np.zeros((h, w), np.int32)

    names = list(_CLASS_DRAWERS)
    n_subj = int(rng.integers(1, max_subjects + 1))
    prev_mask = None
    for si in range(n_subj):
        name = names[rng.integers(len(names))]
        m = _CLASS_DRAWERS[name](rng, h, w)
        m = _zoom_mask(m, rng.uniform(*zoom))
        if prev_mask is not None and rng.random() < occlude_prob \
                and m.any() and prev_mask.any():
            # forced partial occlusion: shift this subject so it
            # overlaps 20-50% of the previous one
            ys, xs = np.nonzero(prev_mask)
            my, mx = np.nonzero(m)
            m = np.roll(np.roll(m, int(ys.mean() - my.mean()
                                       + rng.uniform(-0.1, 0.1) * h),
                                axis=0),
                        int(xs.mean() - mx.mean()
                            + rng.uniform(0.15, 0.35) * w), axis=1)
        if not m.any():
            continue
        base = np.clip(np.asarray(_CLASS_BASE[name])
                       + rng.uniform(-0.08, 0.08, 3), 0, 1)
        tex = (_stripe_texture(rng, h, w, base, amp=0.12)
               if rng.random() < 0.5
               else _cell_texture(rng, h, w, base, amp=0.12))
        img[m] = tex[m]
        _shade(rng, img, m)
        labels[m] = CLASS_TO_INDEX[name]      # later subject occludes
        prev_mask = m

    # global illumination gradient (training uses a radial vignette)
    ang = rng.uniform(0, 2 * math.pi)
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    g = 1.0 + rng.uniform(*grad) * (math.cos(ang) * xx
                                    + math.sin(ang) * yy)
    img = np.clip(img * g[..., None]
                  + 0.015 * rng.standard_normal(img.shape), 0, 1)
    return img.astype(np.float32), labels


def generate_instance_scene(rng: np.random.Generator, size: int = 96,
                            n_people=(2, 4), photo_style: bool = True):
    """Multi-person scene with per-instance ground truth.

    Returns ``(image, sem_labels, inst_labels)`` where ``inst_labels``
    is int32 (S, S) with ids 1..N over VISIBLE person pixels (later
    subjects occlude earlier ones, like the reference's per-detection
    masks after depth ordering).  Instances are placed with a mix of
    clear separation and near-adjacency so instance AP exercises the
    watershed split path."""
    h = w = size
    if photo_style:
        sky = _fractal_texture(rng, h, w, rng.uniform(0.45, 0.85, 3),
                               amp=0.12)
        ground = _fractal_texture(rng, h, w, rng.uniform(0.2, 0.5, 3),
                                  amp=0.25)
    else:
        sky = _texture(rng, h, w, rng.uniform(0.4, 0.8, 3), amp=0.1,
                       freq=2)
        ground = _texture(rng, h, w, rng.uniform(0.2, 0.55, 3), amp=0.2,
                          freq=8)
    horizon = int(rng.uniform(0.3, 0.5) * h)
    img = sky.copy()
    img[horizon:] = ground[horizon:]
    sem = np.zeros((h, w), np.int32)
    inst = np.zeros((h, w), np.int32)

    n = int(rng.integers(n_people[0], n_people[1] + 1))
    anchor_cx = rng.uniform(0.25, 0.75) * w
    for k in range(1, n + 1):
        m = _draw_person(rng, h, w)
        if k > 1 and rng.random() < 0.5:
            # near-adjacent to the anchor column (the touching case)
            ys, xs = np.nonzero(m)
            m = np.roll(m, int(anchor_cx + 0.14 * w * (k - 1)
                               - xs.mean()), axis=1)
        base = np.clip(np.asarray(_CLASS_BASE["person"])
                       + rng.uniform(-0.1, 0.1, 3), 0, 1)
        tex = (_fractal_texture(rng, h, w, base, amp=0.15) if photo_style
               else _texture(rng, h, w, base, amp=0.12, freq=10))
        img[m] = tex[m]
        if photo_style:
            _shade(rng, img, m)
        sem[m] = CLASS_TO_INDEX["person"]
        inst[m] = k
    if photo_style:
        img = np.clip(img + 0.015 * rng.standard_normal(img.shape), 0, 1)
    return img.astype(np.float32), sem, inst


def generate_corpus(n_scenes: int = 256, size: int = 128, seed: int = 0,
                    photo_frac: float = 0.5):
    """Training corpus: a mix of flat-texture and photo-style scenes so
    the net learns shape cues under both appearance families."""
    rng = np.random.default_rng(seed)
    imgs, labs = [], []
    for i in range(n_scenes):
        img, lab = generate_scene(rng, size=size,
                                  photo_style=(rng.random() < photo_frac))
        imgs.append(img)
        labs.append(lab)
    return np.stack(imgs), np.stack(labs)


def augment_batch(rng: np.random.Generator, im: np.ndarray) -> np.ndarray:
    """Photometric domain randomization for segmentation training.

    Per-batch gain/bias/gamma jitter, occasional 1-px box blur, and
    variable sensor noise — the net must segment through appearance
    shifts, which (with the texture-diverse corpus) is what lifts the
    held-out-config transfer IoU (tests/test_synthseg.py) from ~0.41 to
    ~0.58. Flips are the caller's job (labels move with them)."""
    if rng.random() < 0.8:
        gain = rng.uniform(0.85, 1.15, (len(im), 1, 1, 3))
        bias = rng.uniform(-0.08, 0.08, (len(im), 1, 1, 3))
        gamma = rng.uniform(0.75, 1.35, (len(im), 1, 1, 1))
        im = np.clip(np.clip(im * gain + bias, 1e-4, 1.0) ** gamma,
                     0, 1).astype(np.float32)
    if rng.random() < 0.3:
        b = im
        im = ((b + np.roll(b, 1, 1) + np.roll(b, -1, 1)
               + np.roll(b, 1, 2) + np.roll(b, -1, 2)) / 5.0
              ).astype(np.float32)
    if rng.random() < 0.5:
        im = np.clip(im + rng.uniform(0.01, 0.05)
                     * rng.standard_normal(im.shape), 0, 1
                     ).astype(np.float32)
    if rng.random() < 0.15:
        # posterize: quantizing to a few flat levels manufactures hard
        # region boundaries out of ANY texture — the net must not fire
        # on flat-region edges (the transfer eval's stripe/Voronoi look)
        levels = float(rng.integers(3, 8))
        im = (np.rint(im * (levels - 1)) / (levels - 1)).astype(
            np.float32)
    if rng.random() < 0.5:
        # linear illumination gradient at a random angle — lighting is
        # an appearance nuisance the net must see varied in training
        # (the vignette alone taught only the radial pattern)
        n, h, w = im.shape[:3]
        ang = rng.uniform(0, 2 * math.pi, n)
        mag = rng.uniform(0.08, 0.3, n)
        yy, xx = np.meshgrid(np.linspace(-1, 1, h),
                             np.linspace(-1, 1, w), indexing="ij")
        grad = 1.0 + mag[:, None, None] * (
            np.cos(ang)[:, None, None] * xx[None]
            + np.sin(ang)[:, None, None] * yy[None])
        im = np.clip(im * grad[..., None], 0, 1).astype(np.float32)
    return im


def build_default_checkpoint(path=None, *, steps: int = 400,
                             n_scenes: int = 256, size: int = 128,
                             batch: int = 16, seed: int = 0,
                             verbose: bool = True, device: torch.device
                             ) -> pathlib.Path:
    """Train the U-Net on the synthetic corpus on ``device`` and save its
    weights (at :func:`default_weights_path` unless ``path``): the JAX
    package's recipe, whose numpy stream gives the same batches."""
    from gs360x_torch.models import segmentation as seg

    path = pathlib.Path(path) if path else default_weights_path()
    images, labels = generate_corpus(n_scenes=n_scenes, size=size,
                                     seed=seed)
    state = seg.create_train_state(torch.Generator().manual_seed(seed),
                                   1e-3, device=device)
    rng = np.random.default_rng(seed + 1)
    for step in range(steps):
        idx = rng.integers(0, len(images), batch)
        im, lb = images[idx], labels[idx]
        if rng.random() < 0.5:           # horizontal flip
            im = im[:, :, ::-1].copy()
            lb = lb[:, :, ::-1].copy()
        im = augment_batch(rng, im)
        loss = seg.train_step(state, torch.from_numpy(im).to(device),
                              torch.from_numpy(lb).to(device),
                              fg_weight=4.0)
        if verbose and (step + 1) % max(1, steps // 10) == 0:
            print(f"[synthseg] step {step + 1}/{steps} "
                  f"loss {float(loss):.3f}", flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    seg.save_weights(path, state.model.state_dict())
    if verbose:
        print(f"[synthseg] default checkpoint saved: {path}")
    return path
