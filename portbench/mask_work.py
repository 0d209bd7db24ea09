"""The work of dualfisheye's mask co-warp launch (``remap.cu``, ``nearest``
over one u8 plane, the u8 store; one launch a lens over the SFM10 views it
serves), counted from the configuration's shapes, and the least time the
card could take for it: ``mask_remap_roofline``'s denominator.

A launch must read each distinct mask texel under the nearest taps of its
sampled pixels once (1 byte), the maps' 8 bytes of each sampled pixel, the
valid plane (1 byte a pixel) and write the u8 store (1 byte a pixel). A
sampled pixel issues one instruction (the tap's index). Bytes bound it.
The constants and the arithmetic are :mod:`portbench.work`'s.
"""

from __future__ import annotations

import re

import torch

from portbench.reference import fisheye
from portbench.work import least_us

# the nearest one-channel u8 launches among the trace's remap kernels, by
# the demangled name's template arguments (source, store, interp 0)
MASK_KERNEL = re.compile(
    r"remap_kernel<[\w:]*Planes<unsigned char, 1>, unsigned char, 0>")


def is_mask_launch(name: str) -> bool:
    return bool(MASK_KERNEL.search(name))


def mask_remap_launches(cfg: dict, device=None) -> dict:
    """dualfisheye's two mask launches a pair, one a lens: their least
    times summed (``pair_us``), the mean a launch (``us``), and the bytes
    a pair."""
    calib = cfg["calibration"]
    h, w = calib["height"], calib["width"]
    size = int(cfg["views"]["size"])
    maps = fisheye.view_maps(cfg, torch.float32, device)
    total, moved_pair, by = 0.0, 0, set()
    for lens in ("X", "Y"):
        group = [m for m in maps.values() if m[0] == lens]
        if not group:
            continue
        seen = torch.zeros(h * w, dtype=torch.bool, device=device)
        sampled = 0
        for _lens, mx, my, valid in group:
            sampled += int(valid.sum())
            col = torch.round(mx[valid]).clamp(0, w - 1).to(torch.int64)
            row = torch.round(my[valid]).clamp(0, h - 1).to(torch.int64)
            seen[row * w + col] = True
        pixels = len(group) * size * size
        moved = int(seen.sum()) + sampled * 8 + pixels + pixels
        launch = least_us(moved, sampled)
        total += launch["us"]
        moved_pair += moved
        by.add(launch["bound_by"])
    return {"us": total / 2, "pair_us": total, "pair_bytes": moved_pair,
            "bound_by": "+".join(sorted(by))}
