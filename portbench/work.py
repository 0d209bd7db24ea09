"""The work a kernel launch must do, counted from the cell's shapes, and the
least time the card could take for it: the rooflines' denominators.

Frozen copies of ``chip_smoke.py``'s constants (their derivations below),
so that a change to the program cannot move the yardstick:

- ``HBM_TBS``: the H100 SXM's published device-memory bandwidth, 3.35 TB/s
  (NVIDIA's data sheet).
- ``FP32_ISSUE_T``: f32 instructions the card issues a second, 33.5 T
  (132 SMs × 128 lanes × 1.98 GHz; ``micro_ops_cuda.FP32_ISSUE_T``).
- ``TAP_INSNS_PER_PX``: f32 instructions an output pixel of the resampling
  kernels must issue. A mul + add the kernel contracts into an FMA is one,
  a lone op one. A cubic pixel: 3 channels x (16 tap FMAs along the rows +
  4 FMAs down the column) and two 4-tap weight sets (t², t³ and four
  cubics in Horner form, ~12 a set); a bilinear one: 3 channels x 3 lerps
  (a multiply and an FMA each) and 1 - fx, 1 - fy; a nearest one: the
  scale.
- ``WARP_RAY_INSNS_PER_PX``: the warp's ray, ~54 (the pixel centre 4, the
  normalised perspective ray 7, its rotation 9, atan2 ~16 and asin ~12 as
  polynomials, u and v 2, floor and fraction 4), which the remap, whose
  coordinates come from maps, does not have.
- ``TRACE_FAMILIES``: the kernels of the program's launch counters by
  function name, matched anywhere in a trace's (demangled) kernel name.

Bytes: each source byte a launch must read, once (the distinct texels
under the taps of the sampled pixels, 3 bytes each for u8, 12 for f32
planes: the layout's fourth byte is the design's cost, not the function's
need), the maps' entries of each sampled pixel and the valid plane, and
each output byte written once. The least time is the larger of bytes over
``HBM_TBS`` and instructions over ``FP32_ISSUE_T``; ``bound_by`` says which.
"""

from __future__ import annotations

import torch

from portbench.reference import equirect, fisheye

HBM_TBS = 3.35
FP32_ISSUE_T = 33.5
TAP_INSNS_PER_PX = {"bicubic": 3 * (16 + 4) + 24,
                    "catmull-rom": 3 * (16 + 4) + 24,
                    "bilinear": 3 * 3 * 2 + 2, "nearest": 3}
WARP_RAY_INSNS_PER_PX = 54
TRACE_FAMILIES = {"planarize": ("planarize_regs", "planarize_scalar",
                                "texelize_regs", "texelize_scalar"),
                  "warp": ("warp_equirect_kernel",),
                  "remap": ("remap_kernel",)}


def family(name: str) -> str:
    """The launch counter a kernel of the trace counts under, or
    ``other`` (plain torch operations)."""
    for fam, functions in TRACE_FAMILIES.items():
        if any(fn in name for fn in functions):
            return fam
    return "other"


def least_us(bytes_moved: float, insns: float) -> dict:
    by_bytes = bytes_moved / (HBM_TBS * 1e12) * 1e6
    by_ops = insns / (FP32_ISSUE_T * 1e12) * 1e6
    return {"us": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def mark_texels(seen: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                valid, src_h: int, src_w: int, equirect_src: bool) -> None:
    """Mark in ``seen`` (a flat (src_h·src_w) bool mask) the source texels
    under the 4x4 cubic taps of the pixels at (u, v) where ``valid`` (all
    where None), by the samplers' boundary rules: columns wrap and rows
    reflect over the poles on an equirect source, both clamp on a lens
    image."""
    x0, y0 = torch.floor(u).to(torch.int64), torch.floor(v).to(torch.int64)
    if valid is not None:
        x0, y0 = x0[valid], y0[valid]
    for dy in (-1, 0, 1, 2):
        yy = y0 + dy
        shift = 0
        if equirect_src:
            shift = torch.where((yy < 0) | (yy >= src_h), src_w // 2, 0)
            yy = torch.where(yy < 0, -1 - yy,
                             torch.where(yy >= src_h, 2 * src_h - 1 - yy, yy))
        yy = yy.clamp(0, src_h - 1)
        for dx in (-1, 0, 1, 2):
            xx = x0 + dx
            xx = torch.remainder(xx + shift, src_w) if equirect_src \
                else xx.clamp(0, src_w - 1)
            seen[(yy * src_w + xx).reshape(-1)] = True


def warp_launch(cfg: dict, device=None) -> dict:
    """One warp launch of perspcut's image mode: a u8 frame through every
    view of the configuration (one view group), the u8 store."""
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
    insns = pixels * (TAP_INSNS_PER_PX[views["interp"]]
                      + WARP_RAY_INSNS_PER_PX)
    out = least_us(int(seen.sum()) * 3 + pixels * 3, insns)
    out["source_share"] = float(seen.double().mean())
    return out


def remap_launches(cfg: dict, f32_planes: bool, device=None) -> dict:
    """dualfisheye's two remap launches a pair, one a lens over the SFM10
    views that lens serves (u8 store): their least times summed
    (``pair_us``) and the mean a launch (``us``). ``f32_planes``: the LUT
    route's f32 planes are the source (12 bytes a texel) instead of u8
    texels (3)."""
    calib = cfg["calibration"]
    h, w = calib["height"], calib["width"]
    size = int(cfg["views"]["size"])
    maps = fisheye.view_maps(cfg, torch.float32, device)
    total, by = 0.0, set()
    for lens in ("X", "Y"):
        group = [m for m in maps.values() if m[0] == lens]
        if not group:
            continue
        seen = torch.zeros(h * w, dtype=torch.bool, device=device)
        sampled = 0
        for _lens, mx, my, valid in group:
            sampled += int(valid.sum())
            mark_texels(seen, mx, my, valid, h, w, False)
        pixels = len(group) * size * size
        moved = (int(seen.sum()) * (12 if f32_planes else 3) + sampled * 8
                 + pixels + pixels * 3)
        launch = least_us(moved, sampled * TAP_INSNS_PER_PX[cfg["interp"]])
        total += launch["us"]
        by.add(launch["bound_by"])
    return {"us": total / 2, "pair_us": total,
            "bound_by": "+".join(sorted(by))}
