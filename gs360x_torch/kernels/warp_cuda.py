"""CUDA warp path — the counterpart of :mod:`gs360x.kernels.warp_pallas`.

Two hand-written kernels (``gs360x_torch/csrc``) carry the perspcut main
path on the card:

* ``planarize.cu`` — interleaved (H, 3·W) rows → planar (3, H, W),
  replacing ``_planarize_mxu_kernel`` / ``_planarize_kernel``;
* ``warp_equirect.cu`` — planar source → (V, 3, h, w) f32 views of every
  class the JAX entry sorts views into (yaw ring, narrow, tilted, wide:
  poles in view, pitched and rolled views, ``fisheye_v360`` and
  ``equisolid`` outputs), replacing ``_warp_kernel_yaw2``, ``_warp_kernel``,
  ``_warp_kernel_wide3`` and the fallbacks ``_warp_kernel_wide2``,
  ``_warp_kernel_wide`` and ``_warp_kernel_yaw``.

Each wrapper checks its inputs, launches its kernel on PyTorch's current
stream for a CUDA tensor (or raises), and runs its plain torch version
for a CPU tensor — only then. ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` counts plain-version runs, so a run shows which path it
took.

Every view the JAX entry accepts launches: the projections and interps
that :func:`gs360x.kernels.warp_pallas.warp_equirect_to_views_pallas`
refuses with ``PallasFallback`` raise ``ValueError`` here, on either
device.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gs360x_torch.kernels import _build
from gs360x_torch.kernels import warp as twin

LAUNCHES: Dict[str, int] = {"planarize": 0, "warp": 0}
PLAIN_CALLS: Dict[str, int] = {"planarize": 0, "warp": 0}

_KIND = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
# planarize.cu's paths, by their code in the C entry: one thread per pixel;
# 48-byte chunks loaded by each thread; 48-byte chunks staged in shared
# memory by a bulk copy
PLANARIZE_VARIANTS = ("scalar", "regs", "bulk")
_INTERP = {"bilinear": 0, "bicubic": 1}
_PROJECTION = {"perspective": 0, "fisheye_v360": 1, "equisolid": 2}
_SCALE = {torch.uint8: 1.0 / 255.0, torch.uint16: 1.0 / 65535.0,
          torch.float32: 1.0}

_TABLE_CACHE: dict = {}


def reset_counters() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for key in counts:
            counts[key] = 0


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")


# --------------------------------------------------------------------------
# planarize
# --------------------------------------------------------------------------


def planarize_rows_plain(rows: torch.Tensor, scale: float = 1.0,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain torch version of ``planarize.cu``: (H, 3·W) interleaved rows
    (u8/u16/f32) → planar (3, H, W). A u8 output keeps the bytes verbatim;
    a float output is ``float(value) * scale`` in f32."""
    h, w3 = rows.shape
    planes = rows.reshape(h, w3 // 3, 3).permute(2, 0, 1)
    if out_dtype == torch.uint8:
        if rows.dtype != torch.uint8:
            raise ValueError("a u8 planar output needs a u8 source")
        return planes.contiguous()
    return (planes.to(torch.float32) * scale).contiguous()


def planarize_rows(rows: torch.Tensor, scale: float = 1.0,
                   out_dtype: Optional[torch.dtype] = None,
                   variant: str = "auto") -> torch.Tensor:
    """(H, 3·W) interleaved rows → planar (3, H, W), same contract as
    :func:`gs360x.kernels.warp_pallas._planarize_rows` (``out_dtype``
    None means f32). CUDA tensors run ``planarize.cu``; CPU tensors run
    :func:`planarize_rows_plain`.

    ``variant`` picks the kernel's path on a CUDA tensor: ``auto`` (what
    the main path runs: the kept vector variant where the input
    qualifies, else ``scalar``), or one of :data:`PLANARIZE_VARIANTS`
    forced, for comparisons; a vector variant the input does not qualify
    for raises."""
    out_dtype = out_dtype or torch.float32
    if rows.dim() != 2 or rows.shape[1] % 3:
        raise ValueError(f"planarize_rows: expected (H, 3*W) rows, got "
                         f"{tuple(rows.shape)}")
    if rows.dtype not in _KIND or out_dtype not in (torch.uint8,
                                                    torch.float32):
        raise ValueError(f"planarize_rows: unsupported {rows.dtype} -> "
                         f"{out_dtype}")
    if variant != "auto" and variant not in PLANARIZE_VARIANTS:
        raise ValueError(f"planarize_rows: variant {variant!r}: expected "
                         f"auto or one of {', '.join(PLANARIZE_VARIANTS)}")
    if rows.device.type == "cpu":
        PLAIN_CALLS["planarize"] += 1
        return planarize_rows_plain(rows, scale, out_dtype)
    _require_cuda(rows, "planarize_rows")
    if out_dtype == torch.uint8 and rows.dtype != torch.uint8:
        raise ValueError("a u8 planar output needs a u8 source")
    rows = rows.contiguous()
    h, w3 = rows.shape
    out = torch.empty((3, h, w3 // 3), dtype=out_dtype, device=rows.device)
    lib = _build.load()
    args = (ctypes.c_void_p(rows.data_ptr()), _KIND[rows.dtype],
            ctypes.c_void_p(out.data_ptr()), _KIND[out_dtype], h, w3 // 3,
            float(scale))
    with torch.cuda.device(rows.device):
        if variant == "auto":
            err = lib.gs360x_planarize(*args, _stream(rows))
        else:
            err = lib.gs360x_planarize_variant(
                *args, PLANARIZE_VARIANTS.index(variant), _stream(rows))
    _build.check(err, "planarize")
    LAUNCHES["planarize"] += 1
    return out


def planarize_variant(rows: torch.Tensor, out: torch.Tensor) -> str:
    """The variant ``planarize.cu`` launches for ``rows`` → ``out`` (CUDA
    tensors) when asked for ``auto``: the kept vector variant when H·W is
    a multiple of the pixels per chunk (16 for a u8 output, 4 for f32) and
    both bases are 16-byte aligned, else ``scalar``."""
    _require_cuda(rows, "planarize_variant")
    rows = rows.contiguous()
    code = _build.load().gs360x_planarize_auto_variant(
        ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _KIND[out.dtype], rows.shape[0], rows.shape[1] // 3)
    return PLANARIZE_VARIANTS[code]


# --------------------------------------------------------------------------
# warp
# --------------------------------------------------------------------------


def _rot_matrix(yaw_deg: float, pitch_deg: float, roll_deg: float
                ) -> np.ndarray:
    """f64 ``Ry(yaw) · Rx(pitch) · Rz(roll)``, the convention of
    :func:`gs360x.kernels.warp_pallas._rot_matrix`."""
    cy, sy = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    cp, sp = (math.cos(math.radians(pitch_deg)),
              math.sin(math.radians(pitch_deg)))
    cr, sr = (math.cos(math.radians(roll_deg)),
              math.sin(math.radians(roll_deg)))
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return ry @ rx @ rz


def view_table(yaws: Sequence[float], pitches: Sequence[float],
               rolls: Sequence[float], hfov_deg: float,
               vfov_deg: float, projection: str = "perspective"
               ) -> np.ndarray:
    """Host (V, 16) f32 view table: ``rot[0:9]`` row-major, then
    ``tan(hfov/2)``, ``tan(vfov/2)`` for perspective views, or the rim
    angle ``half = hfov/2`` (radians) and the equisolid scale
    ``sin(half/2)`` for fisheye outputs; zeros after — the table
    ``warp_equirect_to_views_pallas`` builds for its kernels."""
    n = len(yaws)
    table = np.zeros((max(n, 1), 16), np.float32)
    for vi in range(n):
        rot = _rot_matrix(float(yaws[vi]), float(pitches[vi]),
                          float(rolls[vi])).astype(np.float32)
        table[vi, 0:9] = rot.reshape(-1)
        if projection == "perspective":
            table[vi, 9] = math.tan(math.radians(hfov_deg) / 2.0)
            table[vi, 10] = math.tan(math.radians(vfov_deg) / 2.0)
        else:
            half = math.radians(hfov_deg) / 2.0
            table[vi, 9] = half                   # theta at the rim
            table[vi, 10] = math.sin(half / 2.0)  # equisolid scale
    return table


def _device_table(yaws, pitches, rolls, hfov_deg, vfov_deg, projection,
                  device: torch.device) -> torch.Tensor:
    """Device copy of :func:`view_table`, cached: view geometry is static
    across frames, so the upload does not recur per frame."""
    key = (tuple(yaws), tuple(pitches), tuple(rolls), float(hfov_deg),
           float(vfov_deg), projection, str(device))
    hit = _TABLE_CACHE.get(key)
    if hit is None:
        if len(_TABLE_CACHE) > 16:
            _TABLE_CACHE.clear()
        hit = torch.from_numpy(view_table(yaws, pitches, rolls, hfov_deg,
                                          vfov_deg, projection)).to(device)
        _TABLE_CACHE[key] = hit
    return hit


def _check_view_args(projection: str, interp: str) -> str:
    """The JAX entry's ``PallasFallback`` cases raise ``ValueError``;
    ``nearest`` runs bilinear, as the JAX executor maps it."""
    if projection not in _PROJECTION:
        raise ValueError(f"projection {projection!r}: expected one of "
                         f"{', '.join(_PROJECTION)}")
    if interp == "nearest":
        interp = "bilinear"
    if interp not in _INTERP:
        raise ValueError(f"interp {interp!r}: expected bicubic, bilinear or "
                         "nearest")
    return interp


def _as_rows(src: torch.Tensor) -> torch.Tensor:
    """Accept (H, W, 3) frames or pre-flattened (H, W·3) rows."""
    if src.dim() == 3:
        h, w, c = src.shape
        return src.reshape(h, w * c)
    return src


def warp_equirect_to_views_plain(src, yaws, pitches, rolls, *,
                                 width: int, height: int,
                                 hfov_deg: float, vfov_deg: float,
                                 projection: str = "perspective",
                                 interp: str = "bicubic",
                                 planar: bool = False) -> torch.Tensor:
    """Plain version of the warp path: the twin
    (:func:`gs360x_torch.kernels.warp.warp_equirect_to_views`) on the
    source normalized to [0, 1] f32 on its own device. Same arguments
    and layouts as :func:`warp_equirect_to_views_cuda`."""
    PLAIN_CALLS["warp"] += 1
    rows = _as_rows(src)
    h, w3 = rows.shape
    hwc = rows.reshape(h, w3 // 3, 3)
    if hwc.dtype == torch.float32:
        hwc_f = hwc
    else:
        hwc_f = hwc.to(torch.float32) / float(
            255 if hwc.dtype == torch.uint8 else 65535)
    out = twin.warp_equirect_to_views(
        hwc_f, np.asarray(yaws, np.float64), np.asarray(pitches, np.float64),
        np.asarray(rolls, np.float64), width=width, height=height,
        hfov_deg=hfov_deg, vfov_deg=vfov_deg, projection=projection,
        interp=interp)
    return out.permute(0, 3, 1, 2) if planar else out


def warp_equirect_to_views_cuda(src_rows, yaws, pitches, rolls, *,
                                width: int, height: int,
                                hfov_deg: float, vfov_deg: float,
                                projection: str = "perspective",
                                interp: str = "bicubic",
                                planar: bool = False) -> torch.Tensor:
    """Cut V views out of one equirect frame in one kernel launch.

    Mirrors :func:`gs360x.kernels.warp_pallas.warp_equirect_to_views_pallas`:
    ``src_rows`` is (H, W·3) (or (H, W, 3)) u8/u16/f32, angles are host
    values in degrees; returns (V, 3, height, width) f32 when ``planar``
    else (V, height, width, 3). ``interp="nearest"`` runs bilinear, as the
    JAX executor maps it for its kernels. ``projection`` is
    ``perspective``, ``fisheye_v360`` or ``equisolid`` (pixels outside a
    fisheye's image circle are 0); anything else raises ``ValueError``.

    CUDA tensors: ``planarize.cu`` then ``warp_equirect.cu``, for every
    view. CPU tensors: the plain version.
    """
    interp = _check_view_args(projection, interp)
    yaws = [float(y) for y in np.asarray(yaws, np.float64).reshape(-1)]
    pitches = [float(p) for p in np.asarray(pitches, np.float64).reshape(-1)]
    rolls = [float(r) for r in np.asarray(rolls, np.float64).reshape(-1)]
    rows = _as_rows(src_rows)
    if rows.dim() != 2 or rows.shape[1] % 3:
        raise ValueError(f"expected (H, W*3) rows or an (H, W, 3) frame, "
                         f"got {tuple(src_rows.shape)}")
    if rows.device.type == "cpu":
        return warp_equirect_to_views_plain(
            rows, yaws, pitches, rolls, width=width, height=height,
            hfov_deg=hfov_deg, vfov_deg=vfov_deg, projection=projection,
            interp=interp, planar=planar)
    _require_cuda(rows, "warp_equirect_to_views_cuda")
    if rows.dtype not in _KIND:
        raise ValueError(f"unsupported source dtype {rows.dtype}")
    if rows.dtype == torch.uint8:
        # u8 planes: the kernel reads raw bytes and applies 1/255 once
        planes = planarize_rows(rows, 1.0, torch.uint8)
    else:
        planes = planarize_rows(rows, _SCALE[rows.dtype], torch.float32)
    out = warp_planes(planes, yaws, pitches, rolls, width=width,
                      height=height, hfov_deg=hfov_deg, vfov_deg=vfov_deg,
                      projection=projection, interp=interp)
    return out if planar else out.permute(0, 2, 3, 1)


def warp_planes(planes: torch.Tensor, yaws, pitches, rolls, *,
                width: int, height: int, hfov_deg: float, vfov_deg: float,
                projection: str = "perspective",
                interp: str = "bicubic") -> torch.Tensor:
    """Launch ``warp_equirect.cu`` on a planar CUDA source: (3, H, W) u8
    (scaled by 1/255 in the kernel) or f32 (read as is) → (V, 3, height,
    width) f32."""
    interp = _check_view_args(projection, interp)
    _require_cuda(planes, "warp_planes")
    if planes.dim() != 3 or planes.shape[0] != 3 \
            or planes.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"warp_planes: expected (3, H, W) u8/f32 planes, "
                         f"got {tuple(planes.shape)} {planes.dtype}")
    planes = planes.contiguous()
    src_h, src_w = planes.shape[1], planes.shape[2]
    table = _device_table(yaws, pitches, rolls, hfov_deg, vfov_deg,
                          projection, planes.device)
    n_views = len(yaws)
    out = torch.empty((n_views, 3, height, width), dtype=torch.float32,
                      device=planes.device)
    scale = _SCALE[torch.uint8] if planes.dtype == torch.uint8 else 1.0
    lib = _build.load()
    with torch.cuda.device(planes.device):
        err = lib.gs360x_warp_equirect(
            ctypes.c_void_p(planes.data_ptr()), _KIND[planes.dtype], src_h,
            src_w, ctypes.c_void_p(table.data_ptr()), n_views,
            ctypes.c_void_p(out.data_ptr()), height, width, _INTERP[interp],
            _PROJECTION[projection], float(scale), _stream(planes))
    _build.check(err, "warp_equirect")
    LAUNCHES["warp"] += 1
    return out
