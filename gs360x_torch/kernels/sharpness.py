"""Sharpness and image statistics for frame selection (port of
:mod:`gs360x.kernels.sharpness`).

The JAX module is plain ``jnp`` (no Pallas kernel), so these are ordinary
torch ops on the tensor's device:

* :func:`laplacian_variance` — variance of the 3×3 Laplacian (cv2 ksize=3
  kernel ``[[2,0,2],[0,-8,0],[2,0,2]]``, REFLECT_101 border);
* :func:`tenengrad` — mean squared 3×3 Sobel magnitude;
* :func:`fft_energy` — mean FFT magnitude outside a radius ``min(h,w)//8``
  donut (complex64);
* :func:`sobel_yavg` — the ffmpeg backend's ``sobel,signalstats`` YAVG
  equivalent: mean of the Sobel magnitude clamped to [0, 255];
* :func:`score_frame` — the raw feature tuple the FrameSelector blends.

Every 3×3 filter is shifted adds over a REFLECT_101 pad in the JAX tap
order, not ``conv2d``: cuDNN may run a convolution in TF32 on Hopper,
which would drift from the f32 JAX results.

Gray convention: float32 in [0, 255] (16-bit inputs are rescaled by
255/65535). Every metric takes an optional validity mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# hybrid blend constants, the JAX module's
HYBRID_LAPVAR_WEIGHT = 0.6
HYBRID_TENENGRAD_WEIGHT = 0.3
HYBRID_FFT_WEIGHT = 0.1
HYBRID_MOTION_REFERENCE = 5000.0
HYBRID_MOTION_PENALTY_WEIGHT = 0.4
HYBRID_DARK_THRESHOLD = 0.35
HYBRID_DARK_PENALTY_WEIGHT = 0.5

METRICS = ("hybrid", "lapvar", "tenengrad", "fft", "sobel-yavg")


# --------------------------------------------------------------------------
# padding + convolution helpers
# --------------------------------------------------------------------------


def _reflect101_pad(img: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """cv2 BORDER_REFLECT_101 (edge pixel not duplicated): torch's
    ``reflect``, which wants a leading batch dimension."""
    return F.pad(img[None], (pad, pad, pad, pad), mode="reflect")[0]


def _conv3x3(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Same-size 3×3 convolution with REFLECT_101 border, as shifted adds
    in the JAX module's tap order (row-major, zero taps skipped)."""
    p = _reflect101_pad(img)
    h, w = img.shape
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            k = float(kernel[dy, dx])
            if k == 0.0:
                continue
            out = out + k * p[dy:dy + h, dx:dx + w]
    return out


_LAPLACIAN_K3 = np.array([[2.0, 0.0, 2.0],
                          [0.0, -8.0, 0.0],
                          [2.0, 0.0, 2.0]])
_SOBEL_X = np.array([[-1.0, 0.0, 1.0],
                     [-2.0, 0.0, 2.0],
                     [-1.0, 0.0, 1.0]])
_SOBEL_Y = _SOBEL_X.T


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    m = mask.to(x.dtype)
    denom = torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(x * m) / denom


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def laplacian_variance(gray: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Population variance of the ksize=3 Laplacian (cv2 semantics)."""
    lap = _conv3x3(gray, _LAPLACIAN_K3)
    mean = _masked_mean(lap, mask)
    return _masked_mean((lap - mean) ** 2, mask)


def tenengrad(gray: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of gx² + gy² with 3×3 Sobel."""
    gx = _conv3x3(gray, _SOBEL_X)
    gy = _conv3x3(gray, _SOBEL_Y)
    return _masked_mean(gx * gx + gy * gy, mask)


def sobel_magnitude(gray: torch.Tensor) -> torch.Tensor:
    gx = _conv3x3(gray, _SOBEL_X)
    gy = _conv3x3(gray, _SOBEL_Y)
    return torch.sqrt(gx * gx + gy * gy)


def sobel_yavg(gray: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ffmpeg-backend equivalent: mean of the |Sobel| image clamped to
    [0, 255]."""
    mag = torch.clamp(sobel_magnitude(gray), 0.0, 255.0)
    return _masked_mean(mag, mask)


def fft_energy(gray: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean high-frequency FFT magnitude (donut r = min(h,w)//8), the FFT
    in complex64."""
    f = torch.fft.fftshift(torch.fft.fft2(gray.to(torch.float32)))
    h, w = gray.shape
    cy, cx = h // 2, w // 2
    r = max(1, min(h, w) // 8)
    yy = torch.arange(h, device=gray.device)[:, None] - cy
    xx = torch.arange(w, device=gray.device)[None, :] - cx
    donut = (yy * yy + xx * xx) >= r * r
    hf = torch.abs(f) * donut.to(gray.dtype)
    return _masked_mean(hf, mask)


def brightness_mean(gray: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean luma normalized to [0, 1]."""
    return _masked_mean(gray, mask) / 255.0


def highlight_ratio(gray: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    threshold: float = 0.95 * 255.0) -> torch.Tensor:
    return _masked_mean((gray >= threshold).to(gray.dtype), mask)


# --------------------------------------------------------------------------
# geometry helpers
# --------------------------------------------------------------------------


def circle_mask(h: int, w: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Inscribed-circle validity mask (the fisheye pair mode's mask), in
    f32 arithmetic as ``jnp`` evaluates it."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    r = min(h, w) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :] - cx
    return (yy * yy + xx * xx) <= r * r


def crop_by_ratio(shape: Tuple[int, int], ratio: float) -> Tuple[slice, slice]:
    """Vertical+horizontal center-crop slices (both axes cropped by the
    same ratio before scoring)."""
    h, w = shape
    ch = max(1, int(round(h * ratio)))
    cw = max(1, int(round(w * ratio)))
    y0 = (h - ch) // 2
    x0 = (w - cw) // 2
    return slice(y0, y0 + ch), slice(x0, x0 + cw)


def downscale_max_long(img: np.ndarray, max_long: int) -> np.ndarray:
    """Host-side area downscale so the long side is <= max_long (numpy box
    filter)."""
    if max_long <= 0 or max(img.shape[:2]) <= max_long:
        return img
    h, w = img.shape[:2]
    scale = max_long / float(max(h, w))
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    ys = (np.arange(nh + 1) * h / nh).astype(int)
    xs = (np.arange(nw + 1) * w / nw).astype(int)
    out = np.add.reduceat(np.add.reduceat(img.astype(np.float64), ys[:-1], 0),
                          xs[:-1], 1)
    counts = np.outer(np.diff(ys), np.diff(xs))
    return (out / counts).astype(img.dtype if img.dtype.kind == "f" else np.float32)


# --------------------------------------------------------------------------
# fused scoring
# --------------------------------------------------------------------------


def score_frame(gray: torch.Tensor, mask: Optional[torch.Tensor], *,
                metric: str, use_mask: bool) -> Tuple[torch.Tensor, ...]:
    """Score one pre-cropped (H, W) f32 gray frame on its device; returns
    the raw feature tuple (lap_energy, tenengrad, fft, brightness,
    highlight_ratio) as 0-d tensors. The hybrid blend normalizes
    dataset-globally on the host, after every frame is scored."""
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r}: expected one of "
                         f"{', '.join(METRICS)}")
    m = mask if use_mask else None
    zero = torch.zeros((), dtype=torch.float32, device=gray.device)
    bright = brightness_mean(gray, m)
    p255 = highlight_ratio(gray, m)
    lap = ten = fft = zero
    if metric in ("hybrid", "lapvar"):
        lv = laplacian_variance(gray, m)
        lap = lv * lv  # the blend takes lap_score^2
    if metric in ("hybrid", "tenengrad"):
        ten = tenengrad(gray, m)
    if metric in ("hybrid", "fft"):
        fft = fft_energy(gray, m)
    if metric == "sobel-yavg":
        ten = sobel_yavg(gray, m)
    return lap, ten, fft, bright, p255


def hybrid_combine(lap_norm, ten_norm, fft_norm, motion_factor):
    """Normalized-feature blend (reference constants)."""
    return (HYBRID_LAPVAR_WEIGHT * lap_norm
            + HYBRID_TENENGRAD_WEIGHT * ten_norm
            + HYBRID_FFT_WEIGHT * fft_norm) * motion_factor


def motion_factor_from_tenengrad(ten_score: float) -> float:
    """Blur-from-motion penalty derived from tenengrad (host scalar)."""
    ratio = ten_score / (ten_score + HYBRID_MOTION_REFERENCE)
    ratio = max(0.0, min(1.0, ratio))
    return max(0.0, 1.0 - HYBRID_MOTION_PENALTY_WEIGHT * (1.0 - ratio))


def brightness_weight(bright_mean: float) -> float:
    """Darkness penalty weight (host scalar)."""
    if bright_mean < HYBRID_DARK_THRESHOLD:
        dark_ratio = bright_mean / HYBRID_DARK_THRESHOLD
    else:
        dark_ratio = 1.0
    dark_ratio = max(0.0, min(1.0, dark_ratio))
    return max(0.0, 1.0 - HYBRID_DARK_PENALTY_WEIGHT * (1.0 - dark_ratio))
