"""Optical flow for frame selection (port of :mod:`gs360x.kernels.flow`):
Shi–Tomasi corners + pyramidal Lucas–Kanade, and dense Farneback.

The JAX module is plain ``jnp`` (no Pallas kernel), so these are ordinary
torch ops on the tensor's device, with the JAX module's constants and
arithmetic order:

* :func:`shi_tomasi_corners` — a fixed budget of ``N_POINTS`` corners
  (padded with invalid entries); the top-k is a stable descending sort,
  so ties go to the lower index as they do in ``lax.top_k``;
* :func:`lk_track` — all points batched, ``LK_ITERS`` fixed iterations per
  level, patches sampled with the JAX module's clipping;
* :func:`farneback_flow` — separable Gaussian-weighted moments as shifted
  sums in the kernel's order, the 6×6 normal-matrix inverse and the 2×2
  solves as explicit multiply-adds.

No convolution, ``einsum`` or ``matmul`` is used, so TF32 never enters on
the card. The FrameSelector consumes one scalar per frame pair:
:func:`mean_flow_magnitude` (LK) or :func:`mean_flow_magnitude_farneback`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

N_POINTS = 512           # corner budget
QUALITY_LEVEL = 0.01
MIN_DISTANCE = 5
LK_WIN = 15              # odd window size
LK_LEVELS = 2
LK_ITERS = 10

FARNEBACK_WINSIZE = 15
FARNEBACK_ITERS = 3
FARNEBACK_POLY_N = 5
FARNEBACK_POLY_SIGMA = 1.1


def _edge_pad(img: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """``jnp.pad(mode="edge")`` of a 2-D image (torch's ``replicate``,
    which wants a leading batch dimension)."""
    return F.pad(img[None], (left, right, top, bottom), mode="replicate")[0]


def _box_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """k×k box filter via two 1-D passes (edge padding). Each pass is the
    sum of k shifted rows (columns) times the f32 reciprocal of k: XLA
    compiles the JAX module's ``/ k`` into that multiply."""
    pad = k // 2
    h, w = img.shape
    inv_k = float(np.float32(1.0 / k))
    p = _edge_pad(img, pad, pad, 0, 0)
    img = sum(p[i:i + h, :] for i in range(k)) * inv_k
    p = _edge_pad(img, 0, 0, pad, pad)
    return sum(p[:, i:i + w] for i in range(k)) * inv_k


def _scharr_grads(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3×3 Sobel derivatives (edge padding)."""
    p = _edge_pad(img, 1, 1, 1, 1)
    h, w = img.shape

    def sl(dy, dx):
        return p[dy:dy + h, dx:dx + w]

    gx = (sl(0, 2) + 2 * sl(1, 2) + sl(2, 2)
          - sl(0, 0) - 2 * sl(1, 0) - sl(2, 0)) / 8.0
    gy = (sl(2, 0) + 2 * sl(2, 1) + sl(2, 2)
          - sl(0, 0) - 2 * sl(0, 1) - sl(0, 2)) / 8.0
    return gx, gy


def _max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k running maximum, -inf outside (a maximum is exact, so the pool
    equals the JAX module's shifted maxima)."""
    return F.max_pool2d(x[None, None], k, stride=1, padding=k // 2)[0, 0]


def shi_tomasi_corners(gray: torch.Tensor, n_points: int = N_POINTS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k Shi–Tomasi corners with min-distance NMS.

    Returns (points (n, 2) float32 as (x, y), valid (n,) bool)."""
    gx, gy = _scharr_grads(gray)
    ixx = _box_blur(gx * gx, 7)
    iyy = _box_blur(gy * gy, 7)
    ixy = _box_blur(gx * gy, 7)
    # min eigenvalue of the structure tensor
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    response = tr / 2.0 - disc
    # NMS within MIN_DISTANCE and quality threshold
    local_max = response >= _max_pool_same(response, 2 * MIN_DISTANCE + 1)
    threshold = QUALITY_LEVEL * torch.max(response)
    good = local_max & (response >= threshold)
    score = torch.where(good, response,
                        torch.full_like(response, -math.inf)).reshape(-1)
    # lax.top_k: descending, ties to the lower index
    top_val, top_idx = torch.sort(score, descending=True, stable=True)
    top_val, top_idx = top_val[:n_points], top_idx[:n_points]
    w = gray.shape[1]
    pts = torch.stack([(top_idx % w).to(torch.float32),
                       torch.div(top_idx, w, rounding_mode="floor")
                       .to(torch.float32)], dim=-1)
    return pts, torch.isfinite(top_val)


def _bilinear_patches(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                      half: int) -> torch.Tensor:
    """Sample a (2·half+1)² patch around each continuous center (cx[i],
    cy[i]): (N,) centers → (N, size, size), clipped as in JAX."""
    size = 2 * half + 1
    d = torch.arange(size, dtype=torch.float32, device=img.device) - half
    ys = cy[:, None, None] + d[None, :, None]
    xs = cx[:, None, None] + d[None, None, :]
    h, w = img.shape
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 2)
    fx = torch.clamp(xs - x0.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(ys - y0.to(torch.float32), 0.0, 1.0)
    flat = img.reshape(-1)

    def tap(yy, xx):
        return flat[yy * w + xx]

    p00 = tap(y0, x0)
    p01 = tap(y0, x0 + 1)
    p10 = tap(y0 + 1, x0)
    p11 = tap(y0 + 1, x0 + 1)
    return (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
            + p10 * (1 - fx) * fy + p11 * fx * fy)


def _pyr_down(img: torch.Tensor) -> torch.Tensor:
    """2× downscale with a small box blur."""
    return _box_blur(img, 3)[::2, ::2]


def _lk_level(prev, curr, pts, guess, half):
    """One pyramid level of iterative LK for all points at once."""
    gx, gy = _scharr_grads(prev)
    cx, cy = pts[:, 0], pts[:, 1]
    tpl = _bilinear_patches(prev, cx, cy, half)
    a_x = _bilinear_patches(gx, cx, cy, half)
    a_y = _bilinear_patches(gy, cx, cy, half)
    gxx = torch.sum(a_x * a_x, dim=(1, 2))
    gyy = torch.sum(a_y * a_y, dim=(1, 2))
    gxy = torch.sum(a_x * a_y, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-6
    safe = torch.where(inv_ok, det, torch.ones_like(det))
    dx, dy = guess[:, 0], guess[:, 1]
    for _ in range(LK_ITERS):
        patch = _bilinear_patches(curr, cx + dx, cy + dy, half)
        diff = patch - tpl
        bx = torch.sum(diff * a_x, dim=(1, 2))
        by = torch.sum(diff * a_y, dim=(1, 2))
        ddx = -(gyy * bx - gxy * by) / safe
        ddy = -(-gxy * bx + gxx * by) / safe
        dx = dx + torch.where(inv_ok, ddx, torch.zeros_like(ddx))
        dy = dy + torch.where(inv_ok, ddy, torch.zeros_like(ddy))
    return torch.stack([dx, dy], dim=-1), inv_ok


def lk_track(prev: torch.Tensor, curr: torch.Tensor, pts: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal LK displacement for each point. Returns (disp (n, 2),
    ok (n,))."""
    pyr_prev = [prev]
    pyr_curr = [curr]
    for _ in range(LK_LEVELS):
        pyr_prev.append(_pyr_down(pyr_prev[-1]))
        pyr_curr.append(_pyr_down(pyr_curr[-1]))

    half = LK_WIN // 2
    disp = torch.zeros((pts.shape[0], 2), dtype=torch.float32,
                       device=prev.device)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=prev.device)
    for level in range(LK_LEVELS, -1, -1):
        scale = 2.0 ** level
        d, lvl_ok = _lk_level(pyr_prev[level], pyr_curr[level],
                              pts / scale, disp / scale, half)
        disp = d * scale
        ok = ok & lvl_ok
    h, w = prev.shape
    end = pts + disp
    inside = ((end[:, 0] >= 0) & (end[:, 0] <= w - 1)
              & (end[:, 1] >= 0) & (end[:, 1] <= h - 1))
    return disp, ok & inside


def _corr1d(img: torch.Tensor, kernel: Sequence[float], axis: int,
            pad: int) -> torch.Tensor:
    """'same' cross-correlation along one axis with edge-clamp padding:
    ``out[i] = Σ_j kernel[j] · img[i + j - pad]``, summed in j order."""
    if axis == 0:
        imp = _edge_pad(img, pad, pad, 0, 0)
        n = img.shape[0]
        taps = [imp[j:j + n, :] for j in range(len(kernel))]
    else:
        imp = _edge_pad(img, 0, 0, pad, pad)
        n = img.shape[1]
        taps = [imp[:, j:j + n] for j in range(len(kernel))]
    out = float(kernel[0]) * taps[0]
    for k, tap in zip(kernel[1:], taps[1:]):
        out = out + float(k) * tap
    return out


def _poly_expansion(img: torch.Tensor, n: int, sigma: float
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Farneback polynomial expansion: per-pixel quadratic fit f(x) ~ c +
    bᵀx + xᵀAx over a Gaussian applicability window.

    Separable weighted moments + the precomputed normal-matrix inverse.
    Returns (b = [bx, by], A = [a00, a01, a11]) as (H, W) planes (A is
    symmetric)."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    w = np.exp(-x * x / (2.0 * sigma * sigma))
    s0, s2, s4 = (w.sum(), (w * x * x).sum(), (w * x ** 4).sum())
    # normal matrix over basis [1, x, y, x^2, y^2, xy]
    G = np.zeros((6, 6))
    G[0, 0] = s0 * s0
    G[0, 3] = G[3, 0] = G[0, 4] = G[4, 0] = s2 * s0
    G[1, 1] = G[2, 2] = s2 * s0
    G[3, 3] = G[4, 4] = s4 * s0
    G[3, 4] = G[4, 3] = s2 * s2
    G[5, 5] = s2 * s2
    ginv = np.linalg.inv(G).astype(np.float32)

    k0 = w.astype(np.float32)
    k1 = (w * x).astype(np.float32)
    k2 = (w * x * x).astype(np.float32)

    # order along rows (y) first, then along cols (x)
    t0 = _corr1d(img, k0, 0, n)
    t1 = _corr1d(img, k1, 0, n)
    t2 = _corr1d(img, k2, 0, n)
    m = [_corr1d(t0, k0, 1, n),    # m00
         _corr1d(t0, k1, 1, n),    # m10: x moment
         _corr1d(t1, k0, 1, n),    # m01: y moment
         _corr1d(t0, k2, 1, n),    # m20
         _corr1d(t2, k0, 1, n),    # m02
         _corr1d(t1, k1, 1, n)]    # m11

    def coef(i):
        """Σ_j Ginv[i, j] · m[j], the nonzero terms in j order."""
        out = None
        for j in range(6):
            g = float(ginv[i, j])
            if g == 0.0:
                continue
            term = g * m[j]
            out = term if out is None else out + term
        return out

    c3, c4, c5 = coef(3), coef(4), coef(5)
    return [coef(1), coef(2)], [c3, 0.5 * c5, c4]


def _bilinear_field(field: torch.Tensor, xq: torch.Tensor, yq: torch.Tensor
                    ) -> torch.Tensor:
    """Sample an (H, W, C) field at float coords with edge clamping →
    (H, W, C)."""
    h, w = field.shape[:2]
    x0 = torch.clamp(torch.floor(xq).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(yq).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(xq - x0.to(torch.float32), 0.0, 1.0)[..., None]
    fy = torch.clamp(yq - y0.to(torch.float32), 0.0, 1.0)[..., None]
    flat = field.reshape(h * w, -1)

    def tap(yy, xx):
        return flat[yy * w + xx]

    return ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x1))
            + fy * ((1 - fx) * tap(y1, x0) + fx * tap(y1, x1)))


def _box_blur_same(img: torch.Tensor, k: int) -> torch.Tensor:
    kern = [float(np.float32(1.0 / k))] * k
    return _corr1d(_corr1d(img, kern, 0, k // 2), kern, 1, k // 2)


def farneback_flow(prev: torch.Tensor, curr: torch.Tensor, *,
                   winsize: int = FARNEBACK_WINSIZE,
                   iterations: int = FARNEBACK_ITERS,
                   poly_n: int = FARNEBACK_POLY_N,
                   poly_sigma: float = FARNEBACK_POLY_SIGMA) -> torch.Tensor:
    """Dense Farneback optical flow (single level). Each iteration
    re-samples the second frame's expansion at the current flow and
    solves the windowed 2×2 normal equations. Returns (H, W, 2) [dx, dy]
    in pixels."""
    (b1x, b1y), (a1_00, a1_01, a1_11) = _poly_expansion(prev, poly_n,
                                                        poly_sigma)
    b2, a2 = _poly_expansion(curr, poly_n, poly_sigma)
    field2 = torch.stack([*b2, *a2], dim=-1)   # (H, W, 5)
    h, w = prev.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=prev.device),
        torch.arange(w, dtype=torch.float32, device=prev.device),
        indexing="ij")
    fx = torch.zeros((h, w), dtype=torch.float32, device=prev.device)
    fy = torch.zeros_like(fx)
    for _ in range(iterations):
        warped = _bilinear_field(field2, xx + fx, yy + fy)
        b2x, b2y, a2_00, a2_01, a2_11 = warped.unbind(-1)
        a00 = 0.5 * (a1_00 + a2_00)
        a01 = 0.5 * (a1_01 + a2_01)   # = a10 (symmetric)
        a11 = 0.5 * (a1_11 + a2_11)
        db0 = -0.5 * (b2x - b1x) + (a00 * fx + a01 * fy)
        db1 = -0.5 * (b2y - b1y) + (a01 * fx + a11 * fy)
        g11 = a00 * a00 + a01 * a01
        g12 = a00 * a01 + a01 * a11
        g22 = a01 * a01 + a11 * a11
        h1 = a00 * db0 + a01 * db1
        h2 = a01 * db0 + a11 * db1
        g11 = _box_blur_same(g11, winsize)
        g12 = _box_blur_same(g12, winsize)
        g22 = _box_blur_same(g22, winsize)
        h1 = _box_blur_same(h1, winsize)
        h2 = _box_blur_same(h2, winsize)
        det = g11 * g22 - g12 * g12
        ok = torch.abs(det) > 1e-9
        safe = torch.where(ok, det, torch.ones_like(det))
        fx_new = (g22 * h1 - g12 * h2) / safe
        fy_new = (g11 * h2 - g12 * h1) / safe
        fx = torch.where(ok, fx_new, fx)
        fy = torch.where(ok, fy_new, fy)
    return torch.stack([fx, fy], dim=-1)


def mean_flow_magnitude_farneback(prev_gray: torch.Tensor,
                                  curr_gray: torch.Tensor) -> float:
    """Mean dense-flow magnitude (the Farneback branch of the
    FrameSelector's motion scalar)."""
    flow = farneback_flow(prev_gray.to(torch.float32),
                          curr_gray.to(torch.float32))
    mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    out = float(torch.mean(mag))
    return out if math.isfinite(out) else float("nan")


def mean_flow_magnitude(prev_gray: torch.Tensor, curr_gray: torch.Tensor
                        ) -> float:
    """Mean |displacement| of tracked corners — the FrameSelector motion
    scalar. Returns NaN when nothing tracks (the caller substitutes the
    missing-high sentinel)."""
    pts, valid = shi_tomasi_corners(prev_gray)
    disp, ok = lk_track(prev_gray, curr_gray, pts)
    use = valid & ok
    mag = torch.linalg.vector_norm(disp, dim=-1)
    denom = torch.sum(use)
    mean = torch.sum(torch.where(use, mag, torch.zeros_like(mag))) \
        / torch.clamp(denom, min=1)
    return float(mean) if int(denom) > 0 else float("nan")
