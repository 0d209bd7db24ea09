"""Morphology and inpainting on an explicit device (the port of
:mod:`gs360x.kernels.morphology`), as plain torch ops.

Max and min over a k×k square are separable and exact, so :func:`dilate`
and :func:`erode` pool a (k, 1) window, then a (1, k) one: bitwise the JAX
package's k² shifted slices over an edge-padded mask, at a cost linear in
k. The edge padding needs no pad here: a window that reaches past the edge
already holds the edge pixel, so max-pooling's −inf padding gives the same
result. :func:`gaussian_blur` adds shifted, weighted copies in the JAX
order (a convolution would run TF32 on the card); :func:`diffusion_inpaint`
runs the Jacobi steps with ``torch.roll``. Connected-component labelling
stays on the host (scipy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage


def _max_square(img: torch.Tensor, k: int) -> torch.Tensor:
    """k×k max over an (H, W) float tensor, edge-padded, centred at
    ``k // 2`` (for an even k one row and column more before than after,
    as the JAX pool's slices)."""
    h, w = img.shape
    pad = k // 2
    x = F.max_pool2d(img[None, None], (k, 1), stride=1, padding=(pad, 0))
    x = F.max_pool2d(x, (1, k), stride=1, padding=(0, pad))
    return x[0, 0, :h, :w]


def dilate(mask: torch.Tensor, k: int) -> torch.Tensor:
    return _max_square(mask.to(torch.float32), k)


def erode(mask: torch.Tensor, k: int) -> torch.Tensor:
    return -_max_square(-mask.to(torch.float32), k)


def close_mask(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Morphological close (dilate then erode), cv2.MORPH_CLOSE semantics."""
    return erode(dilate(mask, k), k)


def dilate_radius(mask: np.ndarray, radius: int, *,
                  device: torch.device) -> np.ndarray:
    """Dilate a binary mask by ~radius pixels on ``device`` (square
    element, matching the reference's ellipse within a couple px)."""
    if radius <= 0:
        return mask
    m = torch.from_numpy(np.ascontiguousarray(mask > 0)).to(device)
    out = dilate(m, 2 * radius + 1)
    return (out > 0).cpu().numpy().astype(np.uint8) * 255


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int
                  ) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) f32 tensor with edge padding:
    the weighted shifted rows, then columns, summed in the JAX order."""
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=img.device)
    kernel = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    kernel = kernel / torch.sum(kernel)
    h, w = img.shape
    p = F.pad(img[None, None], (0, 0, radius, radius), mode="replicate")[0, 0]
    img = sum(kernel[i] * p[i:i + h] for i in range(2 * radius + 1))
    p = F.pad(img[None, None], (radius, radius, 0, 0), mode="replicate")[0, 0]
    return sum(kernel[i] * p[:, i:i + w] for i in range(2 * radius + 1))


def diffusion_inpaint(img: torch.Tensor, mask: torch.Tensor,
                      iters: int = 256) -> torch.Tensor:
    """Fill masked pixels by Jacobi diffusion from the boundary.

    The stand-in for cv2's Telea inpaint: iteratively replaces masked
    pixels with their 4-neighborhood mean while clamping unmasked pixels to
    the source. ``img``: (H, W, C) float; ``mask``: (H, W) bool (True =
    fill), both on the same device.
    """
    m = mask.to(img.dtype)[..., None]
    keep = img * (1 - m)
    # initialize holes with the image mean so diffusion converges faster
    fill0 = torch.sum(keep, dim=(0, 1)) / torch.clamp(torch.sum(1 - m),
                                                       min=1.0)
    x = keep + fill0 * m
    for _ in range(iters):
        up = torch.roll(x, 1, 0)
        down = torch.roll(x, -1, 0)
        left = torch.roll(x, 1, 1)
        right = torch.roll(x, -1, 1)
        avg = (up + down + left + right) * 0.25
        x = keep + avg * m
    return x


def connected_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected labeling on the host (scipy). Returns (labels, count);
    labels 1..count, 0 = background."""
    labels, count = ndimage.label(np.asarray(mask) > 0)
    return labels.astype(np.int32), int(count)
