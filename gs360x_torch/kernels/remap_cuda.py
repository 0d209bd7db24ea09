"""CUDA remap path — the counterpart of :mod:`gs360x.kernels.remap_pallas`.

One hand-written kernel, ``gs360x_torch/csrc/remap.cu``, resamples one
source through V static coordinate maps in one launch (``cv2.remap``
semantics: ``out = valid ? sample(src, map_x, map_y) : fill``, taps clamped
to the source), replacing ``_remap_kernel`` (one map) and
``_remap_kernel_wide3`` (V maps over one source). Interps: ``nearest``,
``bilinear``, ``bicubic`` (v360 4-point Lagrange) and ``catmull-rom``;
sources are u8 or f32 with 1 or 3 channels.

On the card the remap is bound by bytes: maps and ``valid`` (9 bytes an
output pixel), the touched source, and the output. A u8 RGB source is
therefore read as RGBX texels (:func:`remap_source`,
``warp_cuda.texelize_rows``: one 4-byte load a tap for its three channels;
f32 sources and masks stay planes), and ``out_dtype`` lets the kernel store
u8 or u16, ``rint(clamp(x, 0, 1) · 255 | 65535)`` with ``fill`` quantized
alike: bitwise ``warp_cuda.quantize_plain`` of its f32 store at a quarter
of the written bytes. The dual-fisheye views and undistorted lenses ask
for u8; f32 (``out_dtype=None``) stays for chains that go on in float.

:class:`PreparedRemap` and :class:`PreparedRemapBatch` take the JAX
classes' arguments plus an explicit device, upload their maps once and keep
them resident. Every map shape launches: there is no window budget and no
``PallasFallback``. A source may be given as (H, W, C) or (H, W·C) rows, a
2-D single-channel image, or a ready source from :func:`remap_source` /
:func:`source_planes`, so that one source pass serves every map of a lens.

CUDA tensors launch the kernel (or raise); CPU tensors run the plain
version, :func:`remap_planes_plain` (the twin's
:func:`gs360x_torch.kernels.warp.remap`). ``LAUNCHES`` and ``PLAIN_CALLS``
count each, as in :mod:`gs360x_torch.kernels.warp_cuda`.
"""

from __future__ import annotations

import copy
import ctypes
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gs360x_torch.io import image as imagelib
from gs360x_torch.kernels import _build
from gs360x_torch.kernels import warp as twin
from gs360x_torch.kernels import warp_cuda

LAUNCHES: Dict[str, int] = {"remap": 0}
PLAIN_CALLS: Dict[str, int] = {"remap": 0}

INTERPS = ("nearest", "bilinear", "bicubic", "catmull-rom")
_INTERP = {name: code for code, name in enumerate(INTERPS)}
_KIND = {torch.uint8: 0, torch.float32: 2}
_KIND_TEXELS = 3   # (H, W) RGBX u8 texels, as warp_cuda.texelize_rows makes


def reset_counters() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for key in counts:
            counts[key] = 0


def _check_interp(interp: str) -> None:
    if interp not in _INTERP:
        raise ValueError(f"interp {interp!r}: expected one of "
                         f"{', '.join(INTERPS)}")


def _to_device(src: np.ndarray, device: Optional[torch.device]
               ) -> torch.Tensor:
    """A host image on ``device`` (CPU for None) in its own dtype (u8, u16,
    f32; anything else as f32): one copy of its bytes."""
    if src.dtype not in (np.uint8, np.uint16, np.float32):
        src = src.astype(np.float32)
    with warnings.catch_warnings():
        # decoders hand out read-only arrays; nothing here writes to them
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(src)).to(
            device or torch.device("cpu"))


def source_planes(src, src_h: int, src_w: int,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Planar (C, src_h, src_w) source for the remap, C in {1, 3}: u8
    planes are kept as bytes (the kernel scales by 1/255), u16 becomes f32
    scaled by 1/65535, floats become f32 as they are.

    ``src`` (numpy or torch) is (C, H, W) planes, (H, W, C), (H, W·3)
    interleaved rows or a 2-D (H, W) single-channel image; a numpy array
    goes to ``device`` once. Interleaved RGB goes through
    :func:`warp_cuda.planarize_rows` (``planarize.cu`` on the card)."""
    if isinstance(src, np.ndarray):
        src = _to_device(src, device)
    shape = tuple(src.shape)
    if src.dim() == 3 and shape[0] in (1, 3) and shape[1:] == (src_h, src_w):
        planes = src
    elif src.dim() == 3 and shape[:2] == (src_h, src_w) and shape[2] in (1, 3):
        if shape[2] == 1:
            planes = src.permute(2, 0, 1)
        else:
            return source_planes(src.reshape(src_h, src_w * 3), src_h, src_w)
    elif src.dim() == 2 and shape == (src_h, src_w):
        planes = src[None]
    elif src.dim() == 2 and shape == (src_h, src_w * 3):
        if src.dtype == torch.uint8:
            return warp_cuda.planarize_rows(src, 1.0, torch.uint8)
        scale = 1.0 / 65535.0 if src.dtype == torch.uint16 else 1.0
        return warp_cuda.planarize_rows(src.contiguous(), scale,
                                        torch.float32)
    else:
        raise ValueError(f"remap source {shape} does not match a "
                         f"{src_h}x{src_w} source (planes, HWC, rows or 2-D)")
    if planes.dtype == torch.uint8 or planes.dtype == torch.float32:
        return planes.contiguous()
    if planes.dtype == torch.uint16:
        return (planes.to(torch.float32) / 65535.0).contiguous()
    return planes.to(torch.float32).contiguous()


def remap_source(src, src_h: int, src_w: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The source in the layout ``remap.cu`` reads with the fewest loads:
    (src_h, src_w, 4) RGBX texels for a u8 RGB image given interleaved
    ((H, W, 3) or (H, W·3) rows, numpy or torch; texels pass through, a
    texel decode (``read_image(..., texels=True)``) to ``device`` as it
    is), else :func:`source_planes` (f32 and u16 sources, masks, ready
    planes)."""
    shape = tuple(src.shape)
    if isinstance(src, torch.Tensor) and warp_cuda.is_texels(src) \
            and shape[:2] == (src_h, src_w):
        return src
    if imagelib.is_texel_decode(src) and shape[:2] == (src_h, src_w):
        return _to_device(src, device)
    if src.dtype in (np.uint8, torch.uint8) \
            and shape in ((src_h, src_w, 3), (src_h, src_w * 3)):
        if isinstance(src, np.ndarray):
            src = _to_device(src, device)
        return warp_cuda.texelize_rows(src.reshape(src_h, src_w * 3))
    return source_planes(src, src_h, src_w, device)


def _planes_of(src: torch.Tensor) -> torch.Tensor:
    """(3, H, W) planes of a texel source, planes as they are: what the
    plain version reads."""
    return src[..., :3].permute(2, 0, 1) if warp_cuda.is_texels(src) else src


def remap_planes_plain(planes: torch.Tensor, map_x: torch.Tensor,
                       map_y: torch.Tensor, valid: Optional[torch.Tensor],
                       *, interp: str, fill: float) -> torch.Tensor:
    """Plain version of ``remap.cu``: the twin's ``remap`` (``wrap_x=False``)
    map by map on the source normalized to [0, 1] f32 on its own device.
    (C, H, W) planes, (V, h, w) maps → (V, C, h, w) f32."""
    PLAIN_CALLS["remap"] += 1
    src = planes.to(torch.float32)
    if planes.dtype == torch.uint8:
        src = src / 255.0
    hwc = src.permute(1, 2, 0)
    outs = [twin.remap(hwc, map_x[i], map_y[i], interp=interp, wrap_x=False,
                       valid=None if valid is None else valid[i].bool(),
                       fill=fill)
            for i in range(map_x.shape[0])]
    return torch.stack(outs).permute(0, 3, 1, 2)


def remap_planes(planes: torch.Tensor, map_x: torch.Tensor,
                 map_y: torch.Tensor, valid: Optional[torch.Tensor], *,
                 interp: str, fill: float = 0.0,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A source — (C, H, W) u8/f32 planes, C in {1, 3}, or (H, W, 4) RGBX
    u8 texels — through (V, h, w) f32 maps (and a (V, h, w) bool ``valid``
    or None) → (V, C, h, w) of ``out_dtype`` (None: f32; u8 or u16: the
    kernel's quantizing store) in one launch of ``remap.cu`` on a CUDA
    device; the plain version, quantized by ``warp_cuda.quantize_plain``,
    on the CPU."""
    _check_interp(interp)
    out_dtype, out_kind = warp_cuda._out_kind(out_dtype)
    texels = warp_cuda.is_texels(planes)
    if not texels and (planes.dim() != 3 or planes.shape[0] not in (1, 3)
                       or planes.dtype not in _KIND):
        raise ValueError(f"remap: expected (1|3, H, W) u8/f32 planes or "
                         f"(H, W, 4) u8 texels, got {tuple(planes.shape)} "
                         f"{planes.dtype}")
    if map_x.dim() != 3 or map_x.shape != map_y.shape or (
            valid is not None and valid.shape != map_x.shape):
        raise ValueError("remap: map_x, map_y (and valid) must share one "
                         f"(V, h, w) shape, got {tuple(map_x.shape)}, "
                         f"{tuple(map_y.shape)}")
    if planes.device.type == "cpu":
        return warp_cuda.quantize_plain(
            remap_planes_plain(_planes_of(planes), map_x, map_y, valid,
                               interp=interp, fill=fill), out_dtype)
    if planes.device.type != "cuda":
        raise ValueError(f"remap: expected a CUDA or CPU tensor, got "
                         f"{planes.device}")
    tensors = (map_x, map_y) + (() if valid is None else (valid,))
    if any(t.device != planes.device for t in tensors):
        raise ValueError("remap: maps and source must be on one device")
    if map_x.dtype != torch.float32 or map_y.dtype != torch.float32:
        raise ValueError("remap: maps must be float32")
    planes = warp_cuda.aligned_texels(planes) if texels \
        else planes.contiguous()
    map_x, map_y = map_x.contiguous(), map_y.contiguous()
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
    n_maps, out_h, out_w = map_x.shape
    if texels:
        (src_h, src_w), channels, kind = planes.shape[:2], 3, _KIND_TEXELS
    else:
        channels, src_h, src_w = planes.shape
        kind = _KIND[planes.dtype]
    if channels * src_h * src_w >= 2 ** 31:
        raise ValueError(f"remap: a {src_w}x{src_h} source is outside the "
                         "kernel's range (C*H*W < 2^31)")
    out = torch.empty((n_maps, channels, out_h, out_w), dtype=out_dtype,
                      device=planes.device)
    scale = 1.0 / 255.0 if planes.dtype == torch.uint8 else 1.0
    lib = _build.load()
    with torch.cuda.device(planes.device):
        err = lib.gs360x_remap(
            ctypes.c_void_p(planes.data_ptr()), kind, channels, src_h, src_w,
            ctypes.c_void_p(map_x.data_ptr()),
            ctypes.c_void_p(map_y.data_ptr()),
            ctypes.c_void_p(None if valid is None else valid.data_ptr()),
            n_maps, ctypes.c_void_p(out.data_ptr()), out_kind, out_h, out_w,
            _INTERP[interp], float(scale), float(fill),
            ctypes.c_void_p(
                torch.cuda.current_stream(planes.device).cuda_stream))
    _build.check(err, "remap")
    LAUNCHES["remap"] += 1
    return out


def _device_maps(maps: Sequence[tuple], device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Stack (map_x, map_y, valid-or-None) triples of one shape into
    resident (V, h, w) device tensors (valid is None when every map is
    all-valid)."""
    shape = tuple(np.shape(maps[0][0]))
    if len(shape) != 2:
        raise ValueError(f"remap maps must be 2-D, got {shape}")
    mxs, mys, vs = [], [], []
    for mx, my, valid in maps:
        if tuple(np.shape(mx)) != shape or tuple(np.shape(my)) != shape or (
                valid is not None and tuple(np.shape(valid)) != shape):
            raise ValueError("remap maps must share one output size")
        mxs.append(torch.as_tensor(mx, dtype=torch.float32, device=device))
        mys.append(torch.as_tensor(my, dtype=torch.float32, device=device))
        vs.append(None if valid is None else
                  torch.as_tensor(valid, device=device).to(torch.bool))
    if all(v is None for v in vs):
        valid_t = None
    else:
        valid_t = torch.stack([torch.ones(shape, dtype=torch.bool,
                                          device=device) if v is None else v
                               for v in vs])
    return torch.stack(mxs), torch.stack(mys), valid_t


class PreparedRemap:
    """One static remap with its maps resident on ``device``
    (:class:`gs360x.kernels.remap_pallas.PreparedRemap`'s arguments plus
    the device): each call ships only the source."""

    def __init__(self, map_x, map_y, valid=None, *, src_w: int, src_h: int,
                 device: torch.device):
        self.src_w, self.src_h = int(src_w), int(src_h)
        self.device = torch.device(device)
        self.map_x, self.map_y, self.valid = _device_maps(
            [(map_x, map_y, valid)], self.device)
        self.out_h, self.out_w = self.map_x.shape[1:]

    def __call__(self, src, *, interp: str = "bilinear", fill: float = 0.0,
                 planar: bool = True,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(C, h, w) of ``out_dtype`` (None: f32), or (h, w, C) when not
        ``planar``."""
        source = remap_source(src, self.src_h, self.src_w, self.device)
        out = remap_planes(source, self.map_x, self.map_y, self.valid,
                           interp=interp, fill=fill, out_dtype=out_dtype)[0]
        return out if planar else out.permute(1, 2, 0)


class PreparedRemapBatch:
    """V static maps of one output size over one source, one launch per
    frame (:class:`gs360x.kernels.remap_pallas.PreparedRemapBatch`'s
    arguments plus the device; ``interp`` is fixed here, as there)."""

    def __init__(self, maps, *, src_w: int, src_h: int,
                 interp: str = "bicubic", device: torch.device):
        if not maps:
            raise ValueError("PreparedRemapBatch: no maps")
        _check_interp(interp)
        self.interp = interp
        self.src_w, self.src_h = int(src_w), int(src_h)
        self.device = torch.device(device)
        self.map_x, self.map_y, self.valid = _device_maps(list(maps),
                                                          self.device)
        self.n_views = self.map_x.shape[0]
        self.out_h, self.out_w = self.map_x.shape[1:]

    def __call__(self, src, *, fill: float = 0.0, planar: bool = True,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(V, C, h, w) of ``out_dtype`` (None: f32), or (V, h, w, C) when
        not ``planar``."""
        source = remap_source(src, self.src_h, self.src_w, self.device)
        out = remap_planes(source, self.map_x, self.map_y, self.valid,
                           interp=self.interp, fill=fill,
                           out_dtype=out_dtype)
        return out if planar else out.permute(0, 2, 3, 1)

    def with_interp(self, interp: str) -> "PreparedRemapBatch":
        """The same resident maps under another interp (the dual-fisheye
        mask co-warp runs the views' maps with ``nearest``)."""
        _check_interp(interp)
        other = copy.copy(self)
        other.interp = interp
        return other


def remap_cuda(src, map_x, map_y, valid=None, *, interp: str = "bilinear",
               fill: float = 0.0, planar: bool = True,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """One-shot remap (:func:`gs360x.kernels.remap_pallas.remap_pallas`):
    ``out[y, x] = src[map_y[y, x], map_x[y, x]]`` interpolated, invalid
    pixels set to ``fill``; (C, h, w) f32, or (h, w, C) when not
    ``planar``. ``src`` is (H, W, C), (C, H, W) planes or, as in JAX,
    (H, W·3) rows. ``device`` defaults to the source's (CPU for numpy)."""
    if device is None:
        device = src.device if isinstance(src, torch.Tensor) \
            else torch.device("cpu")
    if src.ndim == 3 and src.shape[-1] in (1, 3):
        src_h, src_w = src.shape[0], src.shape[1]
    elif src.ndim == 3:
        src_h, src_w = src.shape[1], src.shape[2]
    else:
        src_h, src_w = src.shape[0], src.shape[1] // 3
    prepared = PreparedRemap(map_x, map_y, valid, src_w=src_w, src_h=src_h,
                             device=device)
    return prepared(src, interp=interp, fill=fill, planar=planar)
