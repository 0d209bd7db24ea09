"""Manual mask editor: paint-based add-layers for the segmentation tool.

Rebuilds the reference GUI's manual mask editor (``gs360_GUI.py:
4531-5735``): the user paints subject regions the network missed; layers
save as ``view__<ID>__add.png`` (or ``file__<stem>``) in a manual-mask
directory that ``gs360x-torch-maskseg --manual-mask-dir`` merges
into every matching frame. The painting model (brush strokes on a binary
canvas) is pure numpy; the Tk tab only forwards mouse events.
"""

from __future__ import annotations

import pathlib
from typing import List, Optional, Tuple

import numpy as np

from gs360x_torch.tools.maskseg import manual_mask_key_for_path


class MaskCanvas:
    """Binary paint canvas with circular brush, undo, and PNG save."""

    def __init__(self, height: int, width: int):
        self.mask = np.zeros((height, width), np.uint8)
        self._undo: List[Tuple[slice, slice, np.ndarray]] = []

    @property
    def shape(self) -> Tuple[int, int]:
        return self.mask.shape  # type: ignore[return-value]

    def _disk_patch(self, y: int, x: int, radius: int):
        h, w = self.mask.shape
        r = max(1, int(radius))
        y0, y1 = max(0, y - r), min(h, y + r + 1)
        x0, x1 = max(0, x - r), min(w, x + r + 1)
        if y0 >= y1 or x0 >= x1:
            return None
        yy, xx = np.ogrid[y0:y1, x0:x1]
        disk = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
        return slice(y0, y1), slice(x0, x1), disk

    def stroke(self, y: int, x: int, radius: int, *,
               erase: bool = False) -> None:
        patch = self._disk_patch(int(y), int(x), radius)
        if patch is None:
            return
        ys, xs, disk = patch
        self._undo.append((ys, xs, self.mask[ys, xs].copy()))
        if len(self._undo) > 256:
            self._undo.pop(0)
        region = self.mask[ys, xs]
        region[disk] = 0 if erase else 255
        self.mask[ys, xs] = region

    def line(self, y0: int, x0: int, y1: int, x1: int, radius: int, *,
             erase: bool = False) -> None:
        """Stamp the brush along a drag segment (dense enough to be
        gapless at any drag speed)."""
        n = int(max(abs(y1 - y0), abs(x1 - x0)) // max(1, radius // 2)) + 1
        for t in np.linspace(0.0, 1.0, n + 1):
            self.stroke(round(y0 + (y1 - y0) * t),
                        round(x0 + (x1 - x0) * t), radius, erase=erase)

    def undo(self) -> bool:
        if not self._undo:
            return False
        ys, xs, prev = self._undo.pop()
        self.mask[ys, xs] = prev
        return True

    def clear(self) -> None:
        self._undo.append((slice(None), slice(None), self.mask.copy()))
        self.mask[:] = 0

    def painted_pixels(self) -> int:
        return int((self.mask > 0).sum())

    def overlay_rgb(self, image: np.ndarray,
                    color=(255, 64, 64), alpha: float = 0.45) -> np.ndarray:
        """Blend the painted layer over the frame for display."""
        out = np.asarray(image, np.float32).copy()
        sel = self.mask > 0
        out[sel] = (out[sel] * (1.0 - alpha)
                    + np.asarray(color, np.float32) * alpha)
        return out.astype(np.uint8)


def layer_path_for_image(manual_dir, image_path) -> pathlib.Path:
    """Where the add-layer for this frame saves — shared per multi-cam
    view id, matching ``maskseg --manual-mask-dir`` lookup."""
    key = manual_mask_key_for_path(pathlib.Path(image_path))
    return pathlib.Path(manual_dir) / f"{key}__add.png"


def save_layer(canvas: MaskCanvas, manual_dir, image_path) -> pathlib.Path:
    from PIL import Image

    out = layer_path_for_image(manual_dir, image_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(canvas.mask).save(str(out))
    return out


def load_layer(manual_dir, image_path,
               shape: Tuple[int, int]) -> Optional[MaskCanvas]:
    """Open an existing add-layer for editing (resized to the frame)."""
    path = layer_path_for_image(manual_dir, image_path)
    if not path.exists():
        return None
    from PIL import Image

    img = Image.open(str(path)).convert("L")
    if img.size != (shape[1], shape[0]):
        img = img.resize((shape[1], shape[0]), Image.NEAREST)
    canvas = MaskCanvas(*shape)
    canvas.mask = np.where(np.asarray(img) > 127, 255, 0).astype(np.uint8)
    return canvas


__all__ = ["MaskCanvas", "layer_path_for_image", "save_layer", "load_layer"]
