"""The work of video mode's batched warp launch (``mesh.warp_frames_sharded_
cuda`` on one card: ``warp_equirect.cu`` with the frame axis), counted from
the configuration's shapes, and the least time the card could take for it:
``mesh_warp_roofline``'s denominator.

A batch's launch warps each of its frames through every view, so its work
is its frames' work: for each frame, the distinct source texels under the
taps (3 bytes each, u8), the f32 store (12 bytes an output pixel: video
mode's colour move stands between the warp and the quantize, so the
kernel stores f32, not the u8 of image mode), and the instructions of
:mod:`portbench.work` a bicubic pixel and its ray. At ``default`` the f32
store's bytes bound a frame (0.0897 ms, against 0.0844 ms by operations).
The constants and the arithmetic are :mod:`portbench.work`'s.
"""

from __future__ import annotations

import torch

from portbench.reference import equirect
from portbench.work import (TAP_INSNS_PER_PX, WARP_RAY_INSNS_PER_PX,
                            least_us, mark_texels)

F32_STORE_BYTES = 12


def mesh_warp_frame(cfg: dict, device=None) -> dict:
    """One frame's share of a batched warp launch: the least time
    (``us``), which bound it (``bound_by``), the source texels' share and
    the bytes and instructions counted."""
    frame, views = cfg["frame"], cfg["views"]
    h, w, size = frame["height"], frame["width"], int(views["size"])
    hfov = equirect.fov_deg(views["focal_mm"], views["sensor_mm"][0])
    vfov = equirect.fov_deg(views["focal_mm"], views["sensor_mm"][1])
    seen = torch.zeros(h * w, dtype=torch.bool, device=device)
    for view in views["layout"]:
        u, v = equirect.view_uv(view, size, hfov, vfov, h, w, torch.float32,
                                device)
        mark_texels(seen, u, v, None, h, w, True)
    pixels = len(views["layout"]) * size * size
    moved = int(seen.sum()) * 3 + pixels * F32_STORE_BYTES
    insns = pixels * (TAP_INSNS_PER_PX[views["interp"]]
                      + WARP_RAY_INSNS_PER_PX)
    out = least_us(moved, insns)
    out.update(source_share=float(seen.double().mean()), bytes=moved,
               insns=insns)
    return out


def mesh_warp_launch(cfg: dict, frames: int, device=None) -> dict:
    """A batched launch of ``frames`` frames: ``frames`` times a frame's
    work, bound by the same side."""
    one = mesh_warp_frame(cfg, device)
    return {"us": frames * one["us"], "frame_us": one["us"],
            "bound_by": one["bound_by"], "frames": frames,
            "source_share": one["source_share"]}
