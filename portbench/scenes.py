"""The benchmark's input generator: photo-like scenes, Osmo 360 lens
images and D-Log M style ``.cube`` LUTs, all from a seed.

One general generator reads a cell's traffic file (``workloads/``) and its
configuration (``configs/``): the configuration gives the shapes (an 8K
equirect frame, a 3840² lens), the traffic how many distinct inputs, how
many names link to them and the scene's statistics. A scene is

- a smooth colour field summed over several octaves (a sky, walls,
  shading),
- flat and outlined shapes with hard edges (buildings, signs, poles),
- a fine grain of a few LSB (sensor noise),

so that JPEG decode and encode cost what they cost on photographs, which a
smooth test pattern does not. Every seed draws the same number of octaves,
shapes and grain values: the seed changes the content, not the amount of
work. Inputs are written as JPEG q98 4:4:4 with optimized Huffman tables,
the settings frames come out of Video2Frames with.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import os
import pathlib
from typing import List, Sequence

import numpy as np
from PIL import Image, ImageDraw

# the encoder settings of the inputs (Video2Frames' default frame files)
INPUT_JPEG = dict(quality=98, subsampling=0, optimize=True)
# the grain tile's sides: not multiples of the 8x8 JPEG block
GRAIN_TILE = (529, 541)


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """The generator of one input: the run's seed and the input's keys."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *keys])


def _field(rng: np.random.Generator, h: int, w: int,
           octaves: int) -> np.ndarray:
    """A smooth (h, w, 3) u8 colour field: ``octaves`` random grids, each
    twice as fine and 0.55 times as strong as the last, summed at an
    eighth of the size and resized up once (bicubic)."""
    ih, iw = max(4, h // 8), max(4, w // 8)
    acc = np.zeros((ih, iw, 3), np.float32)
    gh, gw = 2, 4
    amp = 1.0
    for _ in range(octaves):
        grid = rng.random((gh, gw, 3), dtype=np.float32)
        up = np.stack([np.asarray(Image.fromarray(grid[..., c], "F").resize(
            (iw, ih), Image.BICUBIC)) for c in range(3)], -1)
        acc += amp * up
        gh, gw, amp = gh * 2, gw * 2, amp * 0.55
    lo, hi = acc.min(), acc.max()
    acc = 20.0 + 215.0 * (acc - lo) / max(hi - lo, 1e-6)
    small = Image.fromarray(np.clip(acc, 0, 255).astype(np.uint8), "RGB")
    return np.asarray(small.resize((w, h), Image.BICUBIC))


def _shapes(rng: np.random.Generator, img: np.ndarray, count: int) -> None:
    """Draw ``count`` rectangles, ellipses and polygons with hard edges
    into ``img`` (in place), sized from 1/40 to 1/6 of the shorter side."""
    h, w = img.shape[:2]
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    side = min(h, w)
    for _ in range(count):
        kind = int(rng.integers(0, 3))
        cx, cy = rng.random() * w, rng.random() * h
        r = side * (1 / 40 + rng.random() * (1 / 6 - 1 / 40))
        colour = tuple(int(c) for c in rng.integers(0, 256, 3))
        outline = tuple(int(c) for c in rng.integers(0, 256, 3))
        width = int(1 + rng.integers(0, max(2, side // 400)))
        box = [cx - r, cy - r * (0.3 + rng.random()), cx + r,
               cy + r * (0.3 + rng.random())]
        if kind == 0:
            draw.rectangle(box, fill=colour, outline=outline, width=width)
        elif kind == 1:
            draw.ellipse(box, fill=colour, outline=outline, width=width)
        else:
            n = 3 + int(rng.integers(0, 5))
            ang = np.sort(rng.random(n)) * 2 * math.pi
            rad = r * (0.4 + 0.6 * rng.random(n))
            pts = [(float(cx + a * math.cos(t)), float(cy + a * math.sin(t)))
                   for a, t in zip(rad, ang)]
            draw.polygon(pts, fill=colour, outline=outline)
    img[...] = np.asarray(pil)


def _grain(rng: np.random.Generator, img: np.ndarray, lsb: int) -> np.ndarray:
    """``img`` plus a tiled grain of integers in [-lsb, lsb], clipped."""
    th, tw = GRAIN_TILE
    tile = rng.integers(-lsb, lsb + 1, (th, tw, 3), dtype=np.int16)
    h, w = img.shape[:2]
    reps = (-(-h // th), -(-w // tw), 1)
    noise = np.tile(tile, reps)[:h, :w]
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def scene(seed: int, index: int, h: int, w: int, scene_params: dict
          ) -> np.ndarray:
    """The ``index``-th distinct (h, w, 3) u8 scene of ``seed``."""
    rng = rng_for(seed, index)
    img = np.array(_field(rng, h, w, int(scene_params["octaves"])))
    _shapes(rng, img, int(scene_params["shapes"]))
    return _grain(rng, img, int(scene_params["grain_lsb"]))


def lens_image(seed: int, index: int, size: int, scene_params: dict
               ) -> np.ndarray:
    """A (size, size, 3) u8 fisheye lens image: a scene inside the image
    circle (``circle`` of the half side), black outside, as a lens of the
    Osmo 360 records it."""
    img = scene(seed, index, size, size, scene_params)
    c = (size - 1) / 2.0
    ax = (np.arange(size, dtype=np.float32) - c) / (size / 2.0)
    inside = (ax[None, :] ** 2 + ax[:, None] ** 2) \
        <= float(scene_params["circle"]) ** 2
    return img * inside[..., None].astype(np.uint8)


def write_jpeg(path: pathlib.Path, img: np.ndarray) -> int:
    """Write ``img`` with the inputs' encoder settings; its bytes."""
    Image.fromarray(img).save(path, **INPUT_JPEG)
    return path.stat().st_size


def _threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def make_inputs(seed: int, shape: Sequence[int], traffic: dict,
                out_dir: pathlib.Path) -> List[pathlib.Path]:
    """The traffic's distinct inputs as JPEG files under ``out_dir``.

    ``shape`` is (h, w) of an equirect frame, or (size,) of a lens pair:
    then input ``i`` is the pair ``p<i>_X.jpg`` / ``p<i>_Y.jpg`` (lens
    images ``2i`` and ``2i + 1``). Returns the files in order."""
    out_dir.mkdir(parents=True, exist_ok=True)
    params = traffic["scene"]
    n = int(traffic["distinct"])
    if len(shape) == 2:
        jobs = [(out_dir / f"d{i}.jpg", i) for i in range(n)]

        def make(job):
            path, i = job
            write_jpeg(path, scene(seed, i, shape[0], shape[1], params))
            return path
    else:
        jobs = [(out_dir / f"p{i}_{lens}.jpg", 2 * i + k)
                for i in range(n) for k, lens in enumerate("XY")]

        def make(job):
            path, i = job
            write_jpeg(path, lens_image(seed, i, shape[0], params))
            return path
    with cf.ThreadPoolExecutor(_threads()) as pool:
        return list(pool.map(make, jobs))


def link_names(targets: Sequence[pathlib.Path], names: Sequence[str],
               link_dir: pathlib.Path) -> List[pathlib.Path]:
    """``names[k]`` in ``link_dir`` as a relative symbolic link to
    ``targets[k % len(targets)]``: a folder of many inputs that costs the
    disk nothing."""
    link_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for k, name in enumerate(names):
        link = link_dir / name
        target = targets[k % len(targets)]
        os.symlink(os.path.relpath(target, link_dir), link)
        out.append(link)
    return out


# --------------------------------------------------------------------------
# .cube LUT: a D-Log M style decode to Rec.709
# --------------------------------------------------------------------------


def cube_table(seed: int, size: int) -> np.ndarray:
    """A (size, size, size, 3) LUT indexed [r, g, b]: a smooth monotone
    log-to-linear curve a channel, ``(exp(k t) - 1) / (exp(k) - 1)`` with
    ``k`` drawn in [3, 6], a 3x3 gamut matrix near the identity whose rows
    sum to 1, then the Rec.709 OETF, clipped to [0, 1] — the shape of a
    D-Log M to Rec.709 LUT."""
    rng = rng_for(seed, 1 << 20)
    k = 3.0 + 3.0 * rng.random(3)
    mat = np.eye(3) + 0.12 * (rng.random((3, 3)) - 0.5)
    mat /= mat.sum(axis=1, keepdims=True)
    t = np.linspace(0.0, 1.0, size)
    lin = [(np.exp(k[c] * t) - 1.0) / (np.exp(k[c]) - 1.0) for c in range(3)]
    r, g, b = np.meshgrid(lin[0], lin[1], lin[2], indexing="ij")
    rgb = np.stack([r, g, b], -1) @ mat.T
    rgb = np.clip(rgb, 0.0, 1.0)
    out = np.where(rgb < 0.018, 4.5 * rgb, 1.099 * rgb ** 0.45 - 0.099)
    return np.clip(out, 0.0, 1.0)


def write_cube(path: pathlib.Path, table: np.ndarray) -> int:
    """Write a [r, g, b]-indexed table as a ``.cube`` file (red fastest,
    six decimals); its bytes."""
    n = table.shape[0]
    rows = np.transpose(table, (2, 1, 0, 3)).reshape(-1, 3)
    body = "\n".join(f"{r:.6f} {g:.6f} {b:.6f}" for r, g, b in rows)
    path.write_text(f"TITLE \"portbench D-Log M style\"\nLUT_3D_SIZE {n}\n"
                    f"DOMAIN_MIN 0 0 0\nDOMAIN_MAX 1 1 1\n{body}\n")
    return path.stat().st_size
