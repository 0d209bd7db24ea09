"""Data parallelism over devices for the warp pipeline (port of
:mod:`gs360x.runtime.mesh`).

The only scale axis is frames × views: frames split across devices, each
device warps every view of its frames, and nothing crosses devices but the
reduction of :func:`sharded_batch_stats`. A mesh here is an ordered tuple
of ``torch.device``; a block of a batch lives on its device, and every
function that returns per-device results returns a list of blocks, one a
device, in batch order: their concatenation along dim 0 is the batch. The
caller (the executor) copies each block to the host once.

:func:`warp_frames_sharded_cuda` is the counterpart of
``warp_frames_sharded_pallas``: on each device one ``planarize.cu`` launch
and one ``warp_equirect.cu`` launch for all its frames × views. It has no
``check_view_budgets`` / ``PallasFallback``: the CUDA kernel has no window
budgets and takes every view :func:`warp_cuda.warp_equirect_to_views_cuda`
takes. :func:`warp_frames_sharded` is the counterpart of the XLA twin: the
plain torch warp with the colour move and the quantize.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gs360x_torch.core import color as colorlib
from gs360x_torch.kernels import sharpness as sharp
from gs360x_torch.kernels import warp as twin
from gs360x_torch.kernels import warp_cuda
from gs360x_torch.runtime.profiling import span

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: its devices in order, along :data:`DATA_AXIS`."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over every CUDA device, or over ``devices``.
    With no card and no ``devices`` it raises: it never falls back to the
    CPU (tests pass ``[torch.device("cpu")] * n``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh: no CUDA device is available; pass "
                               "the devices explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    # "cuda" names the current card: pin its index, as tensors report it
    devices = tuple(torch.device("cuda", torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None else d
                    for d in devices)
    if not devices:
        raise ValueError("data_mesh: no devices")
    return Mesh(devices)


def _as_tensor(frames) -> torch.Tensor:
    if isinstance(frames, np.ndarray):
        with warnings.catch_warnings():
            # decoders hand out read-only arrays; nothing here writes to them
            warnings.filterwarnings("ignore", message=".*not writable.*")
            return torch.from_numpy(np.ascontiguousarray(frames))
    return frames


def shard_frames(mesh: Mesh, frames) -> List[torch.Tensor]:
    """Split a (B, ...) batch (tensor or numpy array) into one contiguous
    block a device, each placed on its device: one copy a device. B must
    divide by the mesh size, else ``ValueError``. A list of blocks as this
    function returns them, one on each device of the mesh in order, is
    taken as it is (a batch uploaded once serves every view group)."""
    if isinstance(frames, list):
        if len(frames) != mesh.size or any(
                block.device != dev
                for block, dev in zip(frames, mesh.devices)) \
                or len({len(block) for block in frames}) != 1:
            raise ValueError("shard_frames: expected one block of equal "
                             "length on each device of the mesh")
        return frames
    frames = _as_tensor(frames)
    n = mesh.size
    if frames.shape[0] % n:
        raise ValueError(f"shard_frames: a batch of {frames.shape[0]} does "
                         f"not divide over {n} devices")
    per = frames.shape[0] // n
    return [frames[k * per:(k + 1) * per].to(dev)
            for k, dev in enumerate(mesh.devices)]


def _quantize(out: torch.Tensor, quantize_bits: Optional[int]):
    if quantize_bits is None:
        return out
    return warp_cuda.quantize_plain(
        out, torch.uint16 if quantize_bits > 8 else torch.uint8)


def warp_frames_sharded(mesh: Mesh, frames, yaws, pitches, rolls, *,
                        width: int, height: int, hfov_deg: float,
                        vfov_deg: float, interp: str = "bicubic",
                        projection: str = "perspective",
                        keep_rec709=None, quantize_bits=None
                        ) -> List[torch.Tensor]:
    """Warp a (B, H, W, C) frame batch (or the blocks :func:`shard_frames`
    made of it) data-parallel over the mesh with the plain torch warp (the
    XLA twin's counterpart). u8 / u16 frames are normalised on the device
    (``/ 255``, ``/ 65535``); the colour move
    (``keep_rec709`` not None) and the quantize to u8 / u16
    (``quantize_bits``) follow on the same device. B must divide by the
    mesh size. Returns the (b, V, height, width, C) channel-last block of
    each device, on it."""
    yaws = np.asarray(yaws, np.float32).reshape(-1)
    pitches = np.asarray(pitches, np.float32).reshape(-1)
    rolls = np.asarray(rolls, np.float32).reshape(-1)
    blocks = []
    for block in shard_frames(mesh, frames):
        if block.dtype == torch.uint8:
            block = block.to(torch.float32) / 255.0
        elif block.dtype == torch.uint16:
            block = block.to(torch.float32) / 65535.0
        out = torch.stack([twin.warp_equirect_to_views(
            frame, yaws, pitches, rolls, width=width, height=height,
            hfov_deg=hfov_deg, vfov_deg=vfov_deg, projection=projection,
            interp=interp) for frame in block])
        if keep_rec709 is not None:
            out = colorlib.video_color_move(out, keep_rec709=keep_rec709)
        blocks.append(_quantize(out, quantize_bits))
    return blocks


def pad_to_mesh(mesh: Mesh, frames):
    """A (B, ...) batch padded with copies of its last frame to a multiple
    of the mesh size (as it is when B divides)."""
    frames = _as_tensor(frames)
    pad = (-frames.shape[0]) % mesh.size
    if not pad:
        return frames
    return torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])])


def drop_tail(blocks: List[torch.Tensor], keep: int) -> List[torch.Tensor]:
    """The first ``keep`` frames of a batch split into ``blocks``: the pad
    past them is sliced off (never copied), and blocks left empty go."""
    out, start = [], 0
    for block in blocks:
        n = min(len(block), keep - start)
        if n > 0:
            out.append(block[:n])
        start += len(block)
    return out


def warp_frames_sharded_cuda(mesh: Mesh, frames_rows, yaws, pitches, rolls,
                             *, width: int, height: int, hfov_deg: float,
                             vfov_deg: float, interp: str = "bicubic",
                             projection: str = "perspective",
                             keep_rec709=None, quantize_bits=None
                             ) -> List[torch.Tensor]:
    """Warp a (B, H, W·3) u8 / u16 / f32 batch of rows (or (B, H, W, 3)
    frames, or the blocks :func:`shard_frames` made of either) data-parallel
    over the mesh: on each device one source pass and one warp launch for all
    its frames × views (:func:`warp_cuda.warp_equirect_to_views_cuda` on
    the device's block; its plain version on a CPU device). A batch that
    does not divide over the mesh is padded with copies of its last frame,
    and the pad is dropped from the result. With ``keep_rec709`` None the
    kernel's store quantizes to ``quantize_bits``; otherwise the f32 views
    go through ``video_color_move_planar`` and the plain quantize, inside
    a ``color_quantize`` span (:func:`profiling.span`).
    ``nearest`` runs bilinear. Returns the planar (b, V, 3, height, width)
    block of each device, on it, in batch order."""
    if isinstance(frames_rows, list):   # already sharded: no pad
        batch = sum(len(block) for block in frames_rows)
    else:
        frames_rows = _as_tensor(frames_rows)
        batch = int(frames_rows.shape[0])
        frames_rows = pad_to_mesh(mesh, frames_rows)
    fused = keep_rec709 is None and quantize_bits is not None
    store = {}
    if fused:
        store["out_dtype"] = (torch.uint16 if quantize_bits > 8
                              else torch.uint8)
    blocks = []
    for block in shard_frames(mesh, frames_rows):
        out = warp_cuda.warp_equirect_to_views_cuda(
            block, yaws, pitches, rolls, width=width, height=height,
            hfov_deg=hfov_deg, vfov_deg=vfov_deg, projection=projection,
            interp=interp, planar=True, **store)
        if not fused:
            # the colour move and the plain quantize: a ``color_quantize``
            # span (their launches, not their device time)
            with span("color_quantize"):
                if keep_rec709 is not None:
                    out = colorlib.video_color_move_planar(
                        out, keep_rec709=keep_rec709)
                out = _quantize(out, quantize_bits)
        blocks.append(out)
    return drop_tail(blocks, batch)


def sharded_batch_stats(mesh: Mesh, frames) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Mean luma and mean Tenengrad (of ``gray · 255``) of a (B, H, W, 3)
    float batch: each device sums its block's luma and its frames'
    Tenengrad, and the partial sums are reduced on the first device (the
    ``psum`` of the JAX version). Returns two 0-dim f32 tensors there."""
    lum_sum, ten_sum, pixels, count = [], [], 0, 0
    for block in shard_frames(mesh, frames):
        gray = (0.299 * block[..., 0] + 0.587 * block[..., 1]
                + 0.114 * block[..., 2])
        lum_sum.append(gray.sum(dtype=torch.float64))
        ten_sum.append(sum((sharp.tenengrad(g * 255.0).to(torch.float64)
                            for g in gray),
                           torch.zeros((), dtype=torch.float64,
                                       device=block.device)))
        pixels += gray.numel()
        count += gray.shape[0]
    first = mesh.devices[0]
    lum = sum(s.to(first) for s in lum_sum) / pixels
    ten = sum(s.to(first) for s in ten_sum) / count
    return lum.to(torch.float32), ten.to(torch.float32)
