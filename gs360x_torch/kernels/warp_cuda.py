"""CUDA warp path — the counterpart of :mod:`gs360x.kernels.warp_pallas`.

Two hand-written kernels (``gs360x_torch/csrc``) carry the perspcut main
path on the card:

* ``planarize.cu`` — the source pass, replacing ``_planarize_mxu_kernel`` /
  ``_planarize_kernel``: interleaved (H, 3·W) rows → (H, W) RGBX texels
  (:func:`texelize_rows`, the u8 main paths) or → planar (3, H, W)
  (:func:`planarize_rows`: f32 planes with the scale fused for u16 and f32
  frames and the colour chains, u8 planes for callers that want planes);
* ``warp_equirect.cu`` — texels or planes → (V, 3, h, w) views of every
  class the JAX entry sorts views into (yaw ring, narrow, tilted, wide:
  poles in view, pitched and rolled views, ``fisheye_v360`` and
  ``equisolid`` outputs), replacing ``_warp_kernel_yaw2``, ``_warp_kernel``,
  ``_warp_kernel_wide3`` and the fallbacks ``_warp_kernel_wide2``,
  ``_warp_kernel_wide`` and ``_warp_kernel_yaw``; a batch of B frames →
  (B, V, 3, h, w) in one launch (the frame axis of
  ``gs360x.runtime.mesh.warp_frames_sharded_pallas``).

On the card the warp is bound by instruction issue, not by bytes. A tap of
a u8 frame is therefore one 4-byte texel load for its three channels
(planes, the TPU's layout, cost three loads and their address arithmetic),
and ``out_dtype`` lets the kernel store the views as u8 or u16,
``rint(clamp(x, 0, 1) · 255 | 65535)``: bitwise :func:`quantize_plain` of
its f32 store, without the f32 views ever reaching device memory. Image
mode asks for that; f32 (``out_dtype=None``) stays for the video colour
move and for the parity gates.

Each wrapper checks its inputs, launches its kernel on PyTorch's current
stream for a CUDA tensor (or raises), and runs its plain torch version
for a CPU tensor — only then. ``LAUNCHES`` counts kernel launches,
``PLAIN_CALLS`` plain-version runs and ``QUANTIZE_PASSES`` runs of the
plain quantize, so a run shows which path it took.

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
# frames × views of one warp launch: the grid's z axis
MAX_FRAME_VIEWS = 65535
PLAIN_CALLS: Dict[str, int] = {"planarize": 0, "warp": 0}
# runs of the four-pass plain quantize (video mode, Video2Frames, the CPU
# route): 0 where a kernel's store quantized
QUANTIZE_PASSES: Dict[str, int] = {"quantize": 0}

_KIND = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_KIND_TEXELS = 3   # (H, W) RGBX u8: a source layout and a planarize output
# planarize.cu's paths, by their code in the C entry: element loads and
# stores; one 16-byte store a plane (or of 4 texels) a thread
PLANARIZE_VARIANTS = ("scalar", "regs")
_INTERP = {"bilinear": 0, "bicubic": 1}
_PROJECTION = {"perspective": 0, "fisheye_v360": 1, "equisolid": 2}
_SCALE = {torch.uint8: 1.0 / 255.0, torch.uint16: 1.0 / 65535.0,
          torch.float32: 1.0}

_TABLE_CACHE: dict = {}


def reset_counters() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS, QUANTIZE_PASSES):
        for key in counts:
            counts[key] = 0


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")


def quantize_plain(x: torch.Tensor, out_dtype: Optional[torch.dtype]
                   ) -> torch.Tensor:
    """Plain version of the kernels' quantizing store: float [0, 1] →
    ``rint(clamp(x, 0, 1) · 255)`` u8 or ``· 65535`` u16, half to even
    (four passes over ``x``); ``x`` itself for None or f32."""
    if out_dtype in (None, torch.float32):
        return x
    if out_dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"out_dtype {out_dtype}: expected float32, uint8 "
                         "or uint16")
    full = 255.0 if out_dtype == torch.uint8 else 65535.0
    QUANTIZE_PASSES["quantize"] += 1
    return torch.round(torch.clamp(x, 0.0, 1.0) * full).to(out_dtype)


def _out_kind(out_dtype: Optional[torch.dtype]) -> tuple:
    """(dtype, kind code of the C entries) of a kernel's store."""
    out_dtype = out_dtype or torch.float32
    if out_dtype not in _KIND:
        raise ValueError(f"out_dtype {out_dtype}: expected float32, uint8 "
                         "or uint16")
    return out_dtype, _KIND[out_dtype]


def is_texels(t: torch.Tensor) -> bool:
    """Whether ``t`` has the texel layout: (H, W, 4) u8."""
    return t.dim() == 3 and t.shape[2] == 4 and t.dtype == torch.uint8


def aligned_texels(texels: torch.Tensor) -> torch.Tensor:
    """``texels`` as the kernels read them: contiguous, on a 4-byte
    boundary. What :func:`texelize_rows` returns passes as it is; a sliced
    or offset view is copied, never read misaligned."""
    texels = texels.contiguous()
    return texels.clone() if texels.data_ptr() % 4 else texels


def wrap_tap_column(x, w: int):
    """The rule ``warp_equirect.cu`` wraps a tap column by, for integer
    (arrays of) ``x`` in [-w, 2w): one conditional add, one conditional
    subtract, no remainder. ``u`` lies in [-0.5, w - 0.5], so an unshifted
    tap column lies in [-2, w + 1], and a pole-shifted one (+ w/2) in
    [-2, 1.5·w + 1]: both inside the rule's range for w >= 4."""
    x = x + np.where(x < 0, w, 0)
    return x - np.where(x >= w, w, 0)


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
    the main path runs: the vector path where the input
    qualifies, else ``scalar``), or one of :data:`PLANARIZE_VARIANTS`
    forced, for tests; ``regs`` raises for an input that does not
    qualify."""
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


def texelize_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``planarize.cu``'s texel mode: (H, 3·W) u8
    rows → (H, W, 4) RGBX texels, X = 0."""
    h, w3 = rows.shape
    return torch.nn.functional.pad(rows.reshape(h, w3 // 3, 3), (0, 1))


def texelize_rows(rows: torch.Tensor, variant: str = "auto") -> torch.Tensor:
    """(H, 3·W) interleaved u8 rows → (H, W, 4) RGBX texels, X = 0: the
    source layout ``warp_equirect.cu`` and ``remap.cu`` read with one
    4-byte load a tap. CUDA tensors run ``planarize.cu``'s texel mode into
    a fresh allocation (so the texels are aligned); CPU tensors run
    :func:`texelize_rows_plain`. ``variant`` as in :func:`planarize_rows`."""
    if rows.dim() != 2 or rows.shape[1] % 3:
        raise ValueError(f"texelize_rows: expected (H, 3*W) rows, got "
                         f"{tuple(rows.shape)}")
    if rows.dtype != torch.uint8:
        raise ValueError(f"texelize_rows: expected uint8 rows, got "
                         f"{rows.dtype}")
    if variant != "auto" and variant not in PLANARIZE_VARIANTS:
        raise ValueError(f"texelize_rows: variant {variant!r}: expected "
                         f"auto or one of {', '.join(PLANARIZE_VARIANTS)}")
    if rows.device.type == "cpu":
        PLAIN_CALLS["planarize"] += 1
        return texelize_rows_plain(rows)
    _require_cuda(rows, "texelize_rows")
    rows = rows.contiguous()
    h, w3 = rows.shape
    out = torch.empty((h, w3 // 3, 4), dtype=torch.uint8, device=rows.device)
    code = -1 if variant == "auto" else PLANARIZE_VARIANTS.index(variant)
    with torch.cuda.device(rows.device):
        err = _build.load().gs360x_planarize_variant(
            ctypes.c_void_p(rows.data_ptr()), _KIND[torch.uint8],
            ctypes.c_void_p(out.data_ptr()), _KIND_TEXELS, h, w3 // 3, 1.0,
            code, _stream(rows))
    _build.check(err, "planarize (texels)")
    LAUNCHES["planarize"] += 1
    return out


def planarize_variant(rows: torch.Tensor, out: torch.Tensor) -> str:
    """The variant ``planarize.cu`` launches for ``rows`` → ``out`` (CUDA
    tensors; ``out`` planes, or texels from :func:`texelize_rows`) when
    asked for ``auto``: the vector path when H·W is a multiple of the
    pixels per chunk (16 for u8 planes, 4 for f32 planes and for texels)
    and both bases are 16-byte aligned, else ``scalar``."""
    _require_cuda(rows, "planarize_variant")
    rows = rows.contiguous()
    texels = tuple(out.shape) == (rows.shape[0], rows.shape[1] // 3, 4)
    code = _build.load().gs360x_planarize_auto_variant(
        ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _KIND_TEXELS if texels else _KIND[out.dtype], rows.shape[0],
        rows.shape[1] // 3)
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
    """Accept (H, W, 3) frames, (H, W, 4) RGBX texels (their X dropped) or
    pre-flattened (H, W·3) rows."""
    if is_texels(src):
        src = src[..., :3]
    if src.dim() == 3:
        h, w, c = src.shape
        return src.reshape(h, w * c)
    return src


def _batch_rows(src: torch.Tensor) -> tuple:
    """``(rows, batched)``: ``src`` as (B, H, W·3) rows, and whether it
    was a batch. One frame is (H, W·3) rows or an (H, W, 3) frame; a batch
    is (B, H, W·3) rows or (B, H, W, 3) frames. A 3-D tensor whose last
    axis is 3 is a frame: as rows it would be one pixel wide, which no warp
    takes; so are (H, W, 4) u8 texels, whose rows no third divides."""
    if src.dim() == 2:
        return src[None], False
    if src.dim() == 3:
        if src.shape[2] == 3 or is_texels(src):
            return _as_rows(src)[None], False
        return src, True
    if src.dim() == 4 and src.shape[3] == 3:
        b, h, w, c = src.shape
        return src.reshape(b, h, w * c), True
    raise ValueError(f"expected (H, W*3) rows or an (H, W, 3) frame, or a "
                     f"batch of either, got {tuple(src.shape)}")


def _check_grid(n_frames: int, n_views: int) -> None:
    """A launch warps every frame × view in one grid, whose z axis holds
    at most 65535: a larger batch raises, it is never split."""
    if n_frames * n_views > MAX_FRAME_VIEWS:
        raise ValueError(f"warp: {n_frames} frames x {n_views} views is "
                         f"more than {MAX_FRAME_VIEWS} in one launch")


def warp_equirect_to_views_plain(src, yaws, pitches, rolls, *,
                                 width: int, height: int,
                                 hfov_deg: float, vfov_deg: float,
                                 projection: str = "perspective",
                                 interp: str = "bicubic",
                                 planar: bool = False) -> torch.Tensor:
    """Plain version of the warp path: the twin
    (:func:`gs360x_torch.kernels.warp.warp_equirect_to_views`) on the
    source normalized to [0, 1] f32 on its own device. Same arguments
    and layouts as :func:`warp_equirect_to_views_cuda` with the f32
    store."""
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
                                planar: bool = False,
                                out_dtype: Optional[torch.dtype] = None
                                ) -> torch.Tensor:
    """Cut V views out of one equirect frame, or out of every frame of a
    batch, in one kernel launch.

    Mirrors :func:`gs360x.kernels.warp_pallas.warp_equirect_to_views_pallas`:
    ``src_rows`` is (H, W·3) (or (H, W, 3)) u8/u16/f32 or (H, W, 4) u8
    RGBX texels (:func:`is_texels`), angles are host values in degrees; returns (V, 3, height, width) when ``planar`` else
    (V, height, width, 3). A batch, (B, H, W·3) rows or (B, H, W, 3)
    frames (the frame axis of
    :func:`gs360x.runtime.mesh.warp_frames_sharded_pallas`), returns
    (B, V, 3, height, width) or (B, V, height, width, 3); B·V above 65535
    raises ``ValueError``. ``interp="nearest"`` runs bilinear, as the JAX
    executor maps it for its kernels. ``projection`` is ``perspective``,
    ``fisheye_v360`` or ``equisolid`` (pixels outside a fisheye's image
    circle are 0); anything else raises ``ValueError``. ``out_dtype``:
    None or f32 for float views in [0, 1]; u8 or u16 for views quantized by
    the kernel's store, bitwise :func:`quantize_plain` of the f32 views.

    CUDA tensors: one ``planarize.cu`` launch over all the rows (texels for
    u8 frames, scaled f32 planes (3, B·H, W) otherwise) then one
    ``warp_equirect.cu`` launch for every frame and view; texels go to
    :func:`warp_texels` as they are, with no ``planarize.cu`` launch. CPU
    tensors: the plain version of each frame, stacked, quantized by
    :func:`quantize_plain`.
    """
    interp = _check_view_args(projection, interp)
    _out_kind(out_dtype)
    yaws = [float(y) for y in np.asarray(yaws, np.float64).reshape(-1)]
    pitches = [float(p) for p in np.asarray(pitches, np.float64).reshape(-1)]
    rolls = [float(r) for r in np.asarray(rolls, np.float64).reshape(-1)]
    kw = dict(width=width, height=height, hfov_deg=hfov_deg,
              vfov_deg=vfov_deg, projection=projection, interp=interp,
              out_dtype=out_dtype)
    if is_texels(src_rows) and src_rows.device.type != "cpu":
        out = warp_texels(src_rows, yaws, pitches, rolls, **kw)
        return out if planar else out.permute(0, 2, 3, 1)
    rows, batched = _batch_rows(src_rows)
    if rows.shape[2] % 3:
        raise ValueError(f"expected (H, W*3) rows or an (H, W, 3) frame, "
                         f"got {tuple(src_rows.shape)}")
    n_frames, h, w3 = rows.shape
    _check_grid(n_frames, len(yaws))
    if rows.device.type == "cpu":
        out = quantize_plain(torch.stack([warp_equirect_to_views_plain(
            frame, yaws, pitches, rolls, width=width, height=height,
            hfov_deg=hfov_deg, vfov_deg=vfov_deg, projection=projection,
            interp=interp, planar=planar) for frame in rows]), out_dtype)
        return out if batched else out[0]
    _require_cuda(rows, "warp_equirect_to_views_cuda")
    if rows.dtype not in _KIND:
        raise ValueError(f"unsupported source dtype {rows.dtype}")
    all_rows = rows.reshape(n_frames * h, w3)
    if rows.dtype == torch.uint8:
        # texels of raw bytes: the kernel applies 1/255 once; (B·H, W, 4)
        # texels are (B, H, W, 4)
        out = warp_texels(texelize_rows(all_rows).view(n_frames, h, -1, 4),
                          yaws, pitches, rolls, **kw)
    else:
        _check_plane_index(n_frames * h * (w3 // 3), h, w3 // 3)
        # (3, B·H, W) planes: frame f's plane c at c·B·H·W + f·H·W
        planes = planarize_rows(all_rows, _SCALE[rows.dtype], torch.float32)
        out = warp_planes(planes.view(3, n_frames, h, -1).transpose(0, 1),
                          yaws, pitches, rolls, **kw)
    if not planar:
        out = out.permute(0, 1, 3, 4, 2)
    return out if batched else out[0]


def _check_plane_index(plane_stride: int, h: int, w: int) -> None:
    """A frame's last tap of its third plane, 2·plane_stride + H·W, must
    fit the kernel's 31-bit index (planes (3, B·H, W) of a batch have
    ``plane_stride`` B·H·W)."""
    if 2 * plane_stride + h * w >= 2 ** 31:
        raise ValueError(f"warp: a plane stride of {plane_stride} on {w}x{h} "
                         "frames is past the kernel's 31-bit index")


def _launch_warp(src: torch.Tensor, src_kind: int, n_frames: int,
                 frame_stride: int, plane_stride: int, src_h: int,
                 src_w: int, yaws, pitches, rolls, *, width: int,
                 height: int, hfov_deg: float, vfov_deg: float,
                 projection: str, interp: str,
                 out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One ``warp_equirect.cu`` launch over ``n_frames`` frames of ``src``
    (frame f at ``f · frame_stride`` elements, plane c of a frame at ``c ·
    plane_stride``) → (n_frames, V, 3, height, width)."""
    out_dtype, out_kind = _out_kind(out_dtype)
    if src_w < 2 or 3 * src_h * src_w >= 2 ** 31:
        raise ValueError(f"warp: a {src_w}x{src_h} source is outside the "
                         "kernel's range (W >= 2, 3*H*W < 2^31)")
    n_views = len(yaws)
    _check_grid(n_frames, n_views)
    table = _device_table(yaws, pitches, rolls, hfov_deg, vfov_deg,
                          projection, src.device)
    out = torch.empty((n_frames, n_views, 3, height, width), dtype=out_dtype,
                      device=src.device)
    scale = _SCALE[torch.uint8] if src.dtype == torch.uint8 else 1.0
    lib = _build.load()
    with torch.cuda.device(src.device):
        err = lib.gs360x_warp_equirect(
            ctypes.c_void_p(src.data_ptr()), src_kind, n_frames,
            frame_stride, plane_stride, src_h, src_w,
            ctypes.c_void_p(table.data_ptr()), n_views,
            ctypes.c_void_p(out.data_ptr()), out_kind, height, width,
            _INTERP[interp], _PROJECTION[projection], float(scale),
            _stream(src))
    _build.check(err, "warp_equirect")
    LAUNCHES["warp"] += 1
    return out


def warp_texels(texels: torch.Tensor, yaws, pitches, rolls, *,
                width: int, height: int, hfov_deg: float, vfov_deg: float,
                projection: str = "perspective", interp: str = "bicubic",
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch ``warp_equirect.cu`` on the (H, W, 4) RGBX u8 texels of a
    CUDA frame (:func:`texelize_rows`; scaled by 1/255 in the kernel) →
    (V, 3, height, width) of ``out_dtype`` (None: f32); on the (B, H, W, 4)
    texels of a batch → (B, V, 3, height, width), one launch. Texels that
    are not contiguous are copied, never read misaligned."""
    interp = _check_view_args(projection, interp)
    _require_cuda(texels, "warp_texels")
    batched = texels.dim() == 4
    if not is_texels(texels[0] if batched else texels):
        raise ValueError(f"warp_texels: expected (H, W, 4) or (B, H, W, 4) "
                         f"u8 texels, got {tuple(texels.shape)} "
                         f"{texels.dtype}")
    texels = aligned_texels(texels if batched else texels[None])
    n_frames, h, w = texels.shape[:3]
    out = _launch_warp(texels, _KIND_TEXELS, n_frames, h * w, h * w, h, w,
                       yaws, pitches, rolls, width=width, height=height,
                       hfov_deg=hfov_deg, vfov_deg=vfov_deg,
                       projection=projection, interp=interp,
                       out_dtype=out_dtype)
    return out if batched else out[0]


def warp_planes(planes: torch.Tensor, yaws, pitches, rolls, *,
                width: int, height: int, hfov_deg: float, vfov_deg: float,
                projection: str = "perspective", interp: str = "bicubic",
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch ``warp_equirect.cu`` on a planar CUDA source: (3, H, W) u8
    (scaled by 1/255 in the kernel) or f32 (read as is) → (V, 3, height,
    width) of ``out_dtype`` (None: f32); a batch (B, 3, H, W) → (B, V, 3,
    height, width), one launch. A batch's frame and plane strides are
    taken as they are where each plane's rows are contiguous, as in
    ``planarize_rows(...).view(3, B, H, W).transpose(0, 1)``."""
    interp = _check_view_args(projection, interp)
    _require_cuda(planes, "warp_planes")
    batched = planes.dim() == 4
    frames = planes if batched else planes[None]
    if frames.dim() != 4 or frames.shape[1] != 3 \
            or frames.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"warp_planes: expected (3, H, W) or (B, 3, H, W) "
                         f"u8/f32 planes, got {tuple(planes.shape)} "
                         f"{planes.dtype}")
    n_frames, _c, h, w = frames.shape
    if frames.stride(3) != 1 or frames.stride(2) != w \
            or frames.stride(1) < h * w \
            or (n_frames > 1 and frames.stride(0) < h * w):
        frames = frames.contiguous()
    plane_stride = frames.stride(1)
    _check_plane_index(plane_stride, h, w)
    out = _launch_warp(frames, _KIND[frames.dtype], n_frames,
                       frames.stride(0), plane_stride, h, w, yaws, pitches, rolls, width=width,
                       height=height, hfov_deg=hfov_deg, vfov_deg=vfov_deg,
                       projection=projection, interp=interp,
                       out_dtype=out_dtype)
    return out if batched else out[0]
