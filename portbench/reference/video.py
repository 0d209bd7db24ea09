"""perspcut's video mode, the plain way: a perspective view cut out of an
8K equirect frame, then the video colour move, then the quantize to u8,
in the order the tool applies them.

The colour move is the one ffmpeg's
``colorspace=iall=bt709:all=smpte170m:trc=iec61966-2-1`` names: the
Rec.709 inverse OETF to linear light, the linear BT.709 → SMPTE-170M
primaries matrix, the sRGB OETF. The matrix is derived here from the
published chromaticities (ITU-R BT.709: R 0.64, 0.33, G 0.30, 0.60, B
0.15, 0.06; SMPTE 170M: R 0.630, 0.340, G 0.310, 0.595, B 0.155, 0.070)
and the D65 white point (0.3127, 0.3290), through CIE XYZ.

Where this departs from ffmpeg's filter, as the tool does:

- ffmpeg converts YUV frames before any cut; here, as in the tool, the
  frame is decoded to RGB, cut, and the cut's unrounded values are moved
  (the tool's f32 store carries them into the move), then quantized once;
- ffmpeg's filter computes in fixed point, through lookup tables of its
  curves; here each step is computed in ``dtype`` and rounded half to even
  once, at the end;
- the cut's values are clipped to [0, 1] before the inverse OETF (a cubic
  overshoots at hard edges), and the moved linear values before the sRGB
  OETF, as the tool does.

The curves' constants are the published ones ffmpeg's filter uses too:
Rec.709 1.099, 0.018 (0.081 coded), 0.45, 4.5; sRGB 1.055, 0.0031308,
1 / 2.4, 12.92.

The cut is :func:`equirect.cut_view`'s own steps (the view's source
coordinates, the 16-tap cubic) without its quantize. Every function takes
the float ``dtype`` it computes in: float64 is the reference, bfloat16 the
control.
"""

from __future__ import annotations

import torch

from portbench.reference import equirect
from portbench.reference.resample import quantize_u8, sample_cubic

BT709_PRIMARIES = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
SMPTE170M_PRIMARIES = ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070))
D65_WHITE = (0.3127, 0.3290)


def rgb_to_xyz(primaries, white, dtype=torch.float64) -> torch.Tensor:
    """The 3x3 matrix that takes linear RGB of ``primaries`` (x, y of R,
    G, B) to CIE XYZ, with RGB (1, 1, 1) at ``white`` (x, y) and Y = 1."""
    def xyz(x, y):
        return torch.tensor([x / y, 1.0, (1.0 - x - y) / y],
                            dtype=torch.float64)
    cols = torch.stack([xyz(*p) for p in primaries], dim=1)
    scale = torch.linalg.solve(cols, xyz(*white))
    return (cols * scale[None, :]).to(dtype)


def bt709_to_smpte170m(dtype=torch.float64) -> torch.Tensor:
    """Linear BT.709 RGB → linear SMPTE-170M RGB, both at D65."""
    to_xyz = rgb_to_xyz(BT709_PRIMARIES, D65_WHITE)
    from_xyz = torch.linalg.inv(rgb_to_xyz(SMPTE170M_PRIMARIES, D65_WHITE))
    return (from_xyz @ to_xyz).to(dtype)


def rec709_inverse_oetf(v: torch.Tensor) -> torch.Tensor:
    """Rec.709 code values in [0, 1] to linear light."""
    v = v.clamp(0, 1)
    return torch.where(v < 0.081, v / 4.5,
                       ((v + 0.099) / 1.099) ** (1 / 0.45))


def srgb_oetf(lin: torch.Tensor) -> torch.Tensor:
    """Linear light in [0, 1] to sRGB code values."""
    lin = lin.clamp(0, 1)
    return torch.where(lin <= 0.0031308, 12.92 * lin,
                       1.055 * lin ** (1 / 2.4) - 0.055).clamp(0, 1)


def color_move(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) Rec.709 / BT.709 values to sRGB-coded SMPTE-170M values,
    in ``rgb``'s dtype."""
    mat = bt709_to_smpte170m(torch.float64).to(rgb.dtype).to(rgb.device)
    lin = rec709_inverse_oetf(rgb)
    moved = (lin[..., None, :] * mat).sum(-1)
    return srgb_oetf(moved)


def cut_move_view(frame_u8: torch.Tensor, view: dict, views_cfg: dict,
                  dtype=torch.float64) -> torch.Tensor:
    """One (size, size, 3) u8 view of an (H, W, 3) u8 frame as video mode
    writes it: cut, colour move, quantize, computed in ``dtype`` on the
    frame's device."""
    h, w = frame_u8.shape[:2]
    size = int(views_cfg["size"])
    hfov = equirect.fov_deg(views_cfg["focal_mm"], views_cfg["sensor_mm"][0])
    vfov = equirect.fov_deg(views_cfg["focal_mm"], views_cfg["sensor_mm"][1])
    u, v = equirect.view_uv(view, size, hfov, vfov, h, w, dtype,
                            frame_u8.device)
    src = frame_u8.to(dtype) / 255
    cut = sample_cubic(src, u, v, kernel=views_cfg["interp"], equirect=True)
    return quantize_u8(color_move(cut))
