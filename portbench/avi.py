"""A minimal MJPEG-AVI muxer of the benchmark's own: JPEG files, as they
are, one a frame, in a RIFF/AVI 1.0 file (``hdrl`` with ``avih`` and one
video stream's ``strh`` / ``strf``, ``movi`` with a ``00dc`` chunk a frame,
``idx1``), as a camera or ffmpeg's ``-c:v mjpeg`` lays an intra-only clip
out. The clip's frames are the very bytes of the files it was given, so
the reference decodes what the clip holds. Written in one pass: the sizes
are known from the files.
"""

from __future__ import annotations

import pathlib
import struct
from fractions import Fraction
from typing import Sequence

from PIL import Image


def _chunk_header(fourcc: bytes, size: int) -> bytes:
    return fourcc + struct.pack("<I", size)


def _padded(size: int) -> int:
    return size + (size & 1)


def write_clip(path: pathlib.Path, jpegs: Sequence[pathlib.Path],
               order: Sequence[int], fps: float) -> int:
    """Write ``jpegs[order[k]]`` as frame ``k`` of an MJPEG-AVI at ``fps``
    to ``path``; its bytes. Every file must have the first file's size in
    pixels."""
    data = [pathlib.Path(p).read_bytes() for p in jpegs]
    with Image.open(jpegs[0]) as im:
        w, h = im.size
    for p in jpegs[1:]:
        with Image.open(p) as im:
            if im.size != (w, h):
                raise ValueError(f"{p}: {im.size}, the clip is {(w, h)}")
    n = len(order)
    frac = Fraction(fps).limit_denominator(1001 * 60)
    avih = struct.pack("<14I", int(round(1e6 / fps)), 0, 0, 0x10, n, 0, 1,
                       max(len(d) for d in data), w, h, 0, 0, 0, 0)
    strh = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, frac.denominator, frac.numerator,
        0, n, max(len(d) for d in data), 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    strl = (b"strl" + _chunk_header(b"strh", len(strh)) + strh
            + _chunk_header(b"strf", len(strf)) + strf)
    hdrl = (b"hdrl" + _chunk_header(b"avih", len(avih)) + avih
            + _chunk_header(b"LIST", len(strl)) + strl)
    movi_size = 4 + sum(8 + _padded(len(data[i])) for i in order)
    idx = bytearray()
    offset = 4   # from the 'movi' fourcc
    for i in order:
        idx += struct.pack("<4sIII", b"00dc", 0x10, offset, len(data[i]))
        offset += 8 + _padded(len(data[i]))
    riff_size = (4 + 8 + len(hdrl) + 8 + movi_size + 8 + len(idx))
    if riff_size >= 1 << 32:
        raise ValueError(f"{n} frames: over a RIFF chunk's 4 GiB")
    with open(path, "wb") as f:
        f.write(_chunk_header(b"RIFF", riff_size) + b"AVI ")
        f.write(_chunk_header(b"LIST", len(hdrl)) + hdrl)
        f.write(_chunk_header(b"LIST", movi_size) + b"movi")
        for i in order:
            f.write(_chunk_header(b"00dc", len(data[i])) + data[i])
            if len(data[i]) & 1:
                f.write(b"\x00")
        f.write(_chunk_header(b"idx1", len(idx)) + bytes(idx))
    return pathlib.Path(path).stat().st_size
