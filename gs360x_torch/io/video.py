"""Video decode/encode.

The reference delegates all video work to ffmpeg subprocesses
(``cli_tools/gs360_Video2Frames.py:117-207,503-547``). Here
video IO is a backend registry:

* **ffmpeg** (used when on PATH): rawvideo pipe decode with ``-map 0:v:N``
  stream selection and fps resampling — full container/codec coverage.
* **y4m**: pure-Python YUV4MPEG2 reader/writer (C444/C420, 8-bit) — the
  always-available path for tests/benchmarks and pipeline development.
* **mjpeg-avi**: pure-Python RIFF/AVI demuxer+muxer with JPEG frames
  (PIL codecs) — compressed clips without external binaries. The demux
  hands out each frame's JPEG bytes and :func:`decode_jpeg_frame` decodes
  one, so a clip's frames may decode on several threads
  (:func:`source_frames`).

All readers yield ``(frame_index, t_seconds, HxWx3 uint8)`` and support
``fps`` resampling (pick nearest source frame per output tick, like
ffmpeg's fps filter), ``start``/``end`` trimming, and stream selection
where the container has several video streams.
"""

from __future__ import annotations

import io as _io
import pathlib
import shutil
import struct
import subprocess
import time
from dataclasses import dataclass
from fractions import Fraction
from operator import add
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from gs360x_torch.io import image as imagelib
from gs360x_torch.runtime.profiling import WindowCounter, span

Frame = Tuple[int, float, np.ndarray]


@dataclass
class VideoInfo:
    width: int
    height: int
    fps: float
    n_frames: Optional[int]
    duration: Optional[float]
    bit_depth: int = 8
    n_video_streams: int = 1
    pix_fmt: str = ""


# --------------------------------------------------------------------------
# RGB <-> YUV (BT.601 limited range, the Y4M default)
# --------------------------------------------------------------------------


def rgb_to_yuv601(rgb: np.ndarray) -> np.ndarray:
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = (b - y) / 1.772
    v = (r - y) / 1.402
    y = y * (219.0 / 255.0) + 16.0
    u = u * (224.0 / 255.0) + 128.0
    v = v * (224.0 / 255.0) + 128.0
    return np.clip(np.rint(np.stack([y, u, v], axis=-1)), 0, 255).astype(np.uint8)


def yuv601_to_rgb(yuv: np.ndarray) -> np.ndarray:
    y = (yuv[..., 0].astype(np.float32) - 16.0) * (255.0 / 219.0)
    u = (yuv[..., 1].astype(np.float32) - 128.0) * (255.0 / 224.0)
    v = (yuv[..., 2].astype(np.float32) - 128.0) * (255.0 / 224.0)
    r = y + 1.402 * v
    b = y + 1.772 * u
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return np.clip(np.rint(np.stack([r, g, b], axis=-1)), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# Y4M
# --------------------------------------------------------------------------


def write_y4m(path, frames: Sequence[np.ndarray], fps: float = 30.0,
              chroma: str = "444") -> None:
    """Write uint8 RGB frames to a YUV4MPEG2 file (C444 or C420jpeg)."""
    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    frac = Fraction(fps).limit_denominator(1001 * 60)
    header = f"YUV4MPEG2 W{w} H{h} F{frac.numerator}:{frac.denominator} Ip A1:1 C{chroma}\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        for fr in frames:
            yuv = rgb_to_yuv601(fr)
            f.write(b"FRAME\n")
            if chroma == "444":
                for c in range(3):
                    f.write(np.ascontiguousarray(yuv[..., c]).tobytes())
            elif chroma.startswith("420"):
                f.write(np.ascontiguousarray(yuv[..., 0]).tobytes())
                for c in (1, 2):
                    sub = yuv[0::2, 0::2, c].astype(np.uint16)
                    sub += yuv[0::2, 1::2, c]
                    sub += yuv[1::2, 0::2, c]
                    sub += yuv[1::2, 1::2, c]
                    f.write(((sub + 2) >> 2).astype(np.uint8).tobytes())
            else:
                raise ValueError(f"unsupported chroma {chroma}")


def _parse_y4m_header(line: bytes):
    parts = line.decode("ascii").strip().split()
    if not parts or parts[0] != "YUV4MPEG2":
        raise ValueError("not a y4m stream")
    w = h = None
    fps = 30.0
    chroma = "420jpeg"
    for p in parts[1:]:
        if p.startswith("W"):
            w = int(p[1:])
        elif p.startswith("H"):
            h = int(p[1:])
        elif p.startswith("F"):
            num, den = p[1:].split(":")
            fps = int(num) / int(den)
        elif p.startswith("C"):
            chroma = p[1:]
    if w is None or h is None:
        raise ValueError("y4m header missing W/H")
    return w, h, fps, chroma


class Y4MReader:
    def __init__(self, path):
        self.path = pathlib.Path(path)
        with open(self.path, "rb") as f:
            header = f.readline()
        self.width, self.height, self.fps, self.chroma = _parse_y4m_header(header)
        self._header_len = len(header)
        if self.chroma == "444":
            self._frame_bytes = self.width * self.height * 3
        elif self.chroma.startswith("420"):
            self._frame_bytes = self.width * self.height * 3 // 2
        else:
            raise ValueError(f"unsupported y4m chroma {self.chroma}")

    def info(self) -> VideoInfo:
        size = self.path.stat().st_size - self._header_len
        per = self._frame_bytes + len(b"FRAME\n")
        n = max(0, size // per)
        return VideoInfo(self.width, self.height, self.fps, int(n),
                         (n / self.fps) if self.fps else None,
                         pix_fmt="yuv444p" if self.chroma == "444" else "yuv420p")

    def frames(self) -> Iterator[np.ndarray]:
        w, h = self.width, self.height
        with open(self.path, "rb") as f:
            f.readline()
            while True:
                marker = f.readline()
                if not marker:
                    return
                if not marker.startswith(b"FRAME"):
                    raise ValueError("bad y4m frame marker")
                buf = f.read(self._frame_bytes)
                if len(buf) < self._frame_bytes:
                    return
                from gs360x_torch import native

                if self.chroma == "444":
                    planes = np.frombuffer(buf, np.uint8).reshape(3, h, w)
                    if native.HAS_NATIVE:
                        yield native.yuv444_to_rgb(planes)
                        continue
                    yuv = np.transpose(planes, (1, 2, 0))
                else:
                    if native.HAS_NATIVE:
                        yield native.yuv420_to_rgb(
                            np.frombuffer(buf, np.uint8), h, w)
                        continue
                    ysz = w * h
                    csz = ysz // 4
                    y = np.frombuffer(buf[:ysz], np.uint8).reshape(h, w)
                    u = np.frombuffer(buf[ysz:ysz + csz], np.uint8).reshape(h // 2, w // 2)
                    v = np.frombuffer(buf[ysz + csz:], np.uint8).reshape(h // 2, w // 2)
                    u = np.repeat(np.repeat(u, 2, 0), 2, 1)
                    v = np.repeat(np.repeat(v, 2, 0), 2, 1)
                    yuv = np.stack([y, u, v], axis=-1)
                yield yuv601_to_rgb(yuv)


# --------------------------------------------------------------------------
# MJPEG AVI
# --------------------------------------------------------------------------


def write_mjpeg_avi(path, frames: Sequence[np.ndarray], fps: float = 30.0,
                    quality: int = 95) -> None:
    """Write uint8 RGB frames as a minimal MJPEG AVI (one video stream)."""
    from PIL import Image

    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    encoded: List[bytes] = []
    for fr in frames:
        buf = _io.BytesIO()
        Image.fromarray(fr[..., :3]).save(buf, format="JPEG", quality=quality,
                                          subsampling=0)
        encoded.append(buf.getvalue())

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def list_chunk(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    us_per_frame = int(round(1_000_000 / fps))
    avih = struct.pack("<14I", us_per_frame, 0, 0, 0x10, len(encoded), 0, 1, 0,
                       w, h, 0, 0, 0, 0)
    frac = Fraction(fps).limit_denominator(1001 * 60)
    strh = (b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0,
                          frac.denominator, frac.numerator, 0, len(encoded),
                          0, 0, 0, 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    strl = list_chunk(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
    hdrl = list_chunk(b"hdrl", chunk(b"avih", avih) + strl)

    movi_payload = b"".join(chunk(b"00dc", e) for e in encoded)
    movi = list_chunk(b"movi", movi_payload)

    idx_entries = []
    offset = 4  # after 'movi' fourcc
    for e in encoded:
        idx_entries.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(e)))
        offset += 8 + len(e) + (len(e) % 2)
    idx1 = chunk(b"idx1", b"".join(idx_entries))

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


# the MJPEG-AVI opens: (start on time.perf_counter, 1, bytes read)
_OPENS = WindowCounter(opens=add, bytes=add)


def open_counts(start: Optional[float] = None,
                end: Optional[float] = None) -> dict:
    """``{"opens", "bytes"}``: the MJPEG-AVI clips this process opened
    (:class:`MJPEGAVIReader` reads the whole file into memory at each
    open) and the bytes those opens read; given ``start`` and ``end``
    (``time.perf_counter``), only the opens of the newest 65536 that
    started in [start, end)."""
    return _OPENS.read(start, end)


class MJPEGAVIReader:
    def __init__(self, path):
        from PIL import Image  # noqa: F401 (decode dependency)
        from gs360x_torch import native

        self.path = pathlib.Path(path)
        t0 = time.perf_counter()
        # the read and the index scan: a ``video_open`` span
        with span("video_open"):
            raw = self.path.read_bytes()
            _OPENS.add(t0, opens=1, bytes=len(raw))
            if raw[:4] != b"RIFF" or raw[8:12] != b"AVI ":
                raise ValueError(f"{path}: not an AVI")
            self._raw = raw
            self.fps = 30.0
            self.width = self.height = 0
            self._offsets: List[Tuple[int, int]] = []
            if native.HAS_NATIVE:
                try:
                    offs, sizes, info = native.avi_scan(raw)
                    self._offsets = list(zip(offs.tolist(), sizes.tolist()))
                    self.width, self.height = info["width"], info["height"]
                    self.fps = info["fps"] or 30.0
                    return
                except (ValueError, RuntimeError):
                    self._offsets = []
            self._scan(raw)

    def _scan(self, raw: bytes) -> None:
        pos = 12
        end = len(raw)
        while pos + 8 <= end:
            fourcc = raw[pos:pos + 4]
            size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
            body = pos + 8
            if fourcc == b"LIST":
                kind = raw[body:body + 4]
                if kind in (b"hdrl", b"movi", b"strl"):
                    self._scan_range(raw, body + 4, body + size)
                pos = body + size + (size % 2)
                continue
            pos = body + size + (size % 2)

    def _scan_range(self, raw: bytes, pos: int, end: int) -> None:
        while pos + 8 <= end:
            fourcc = raw[pos:pos + 4]
            size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
            body = pos + 8
            if fourcc == b"LIST":
                self._scan_range(raw, body + 4, body + size)
            elif fourcc == b"strh" and raw[body:body + 4] == b"vids":
                scale, rate = struct.unpack("<II", raw[body + 20:body + 28])
                if scale and rate:
                    self.fps = rate / scale
            elif fourcc == b"strf" and size >= 40 and not self.width:
                _, w, h = struct.unpack("<Iii", raw[body:body + 12])
                self.width, self.height = w, abs(h)
            elif fourcc in (b"00dc", b"00db") and size > 0:
                self._offsets.append((body, size))
            pos = body + size + (size % 2)

    def info(self) -> VideoInfo:
        n = len(self._offsets)
        return VideoInfo(self.width, self.height, self.fps, n,
                         n / self.fps if self.fps else None, pix_fmt="yuvj444p")

    def payloads(self) -> Iterator[memoryview]:
        """Each frame's JPEG bytes, in order, over the clip read at the
        open: the demux alone, nothing decoded."""
        raw = memoryview(self._raw)
        for off, size in self._offsets:
            yield raw[off:off + size]

    def frames(self) -> Iterator[np.ndarray]:
        for payload in self.payloads():
            yield decode_jpeg_frame(payload)


# the kernel library's pack where the host has a card, else False; decided
# at the first pack
_LIBRARY_PACK = None


def _pack_rgb(rgbx: np.ndarray) -> np.ndarray:
    """Pillow's (H, W, 4) RGBX block packed to a fresh (H, W, 3) u8 frame
    in one pass that runs without the GIL: the kernel library's host loop
    (``csrc/pack_rgb.cu``, called through ctypes) where the host has a card,
    else numpy's strided copy."""
    global _LIBRARY_PACK
    if _LIBRARY_PACK is None:
        import torch

        if torch.cuda.is_available():
            from gs360x_torch.kernels import _build

            _LIBRARY_PACK = _build.load().gs360x_pack_rgb
        else:
            _LIBRARY_PACK = False
    if rgbx.dtype != np.uint8 or rgbx.ndim != 3 or rgbx.shape[2] != 4 \
            or not rgbx.flags.c_contiguous:
        raise ValueError(f"not an RGBX block: {rgbx.dtype} {rgbx.shape}")
    h, w = rgbx.shape[:2]
    out = np.empty((h, w, 3), np.uint8)
    if _LIBRARY_PACK:
        _LIBRARY_PACK(rgbx.ctypes.data, out.ctypes.data, h * w)
    else:
        np.copyto(out, rgbx[..., :3])
    return out


def decode_jpeg_frame(data) -> np.ndarray:
    """One MJPEG frame's bytes decoded to a C-contiguous (H, W, 3) u8 RGB
    frame, the bytes of ``np.asarray(Image.open(...).convert("RGB"))``.
    An 8-bit RGB JPEG decodes into Pillow's own block
    (:func:`imagelib._decode_rgbx`), packed by :func:`_pack_rgb`: the GIL
    is held only to open the frame and export the block, so frames decode
    in parallel on threads. Any other JPEG, or a Pillow without the block
    allocator, goes through ``convert("RGB")``."""
    from PIL import Image

    with Image.open(_io.BytesIO(data)) as im:
        if im.mode == "RGB":
            rgbx = imagelib._decode_rgbx(im)
            if rgbx is not None:
                return _pack_rgb(rgbx)
        return np.asarray(im.convert("RGB"))


# --------------------------------------------------------------------------
# ffmpeg backend (gated)
# --------------------------------------------------------------------------


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def _ffprobe_info(path) -> VideoInfo:
    import json

    cmd = ["ffprobe", "-v", "error", "-select_streams", "v",
           "-show_entries",
           "stream=width,height,r_frame_rate,nb_frames,duration,"
           "bits_per_raw_sample,pix_fmt",
           "-of", "json", str(path)]
    out = subprocess.run(cmd, check=True, capture_output=True, text=True).stdout
    streams = json.loads(out or "{}").get("streams") or [{}]
    s = streams[0]
    num, den = (s.get("r_frame_rate") or "30/1").split("/")
    fps = float(num) / float(den) if float(den) else 30.0
    bits = s.get("bits_per_raw_sample")
    pix = s.get("pix_fmt") or ""
    depth = int(bits) if isinstance(bits, str) and bits.isdigit() and int(bits) >= 9 else (
        10 if any(t in pix for t in ("p10", "p12", "p16", "rgb48", "rgba64")) else 8)
    nb = s.get("nb_frames")
    return VideoInfo(int(s.get("width", 0)), int(s.get("height", 0)), fps,
                     int(nb) if isinstance(nb, str) and nb.isdigit() else None,
                     float(s["duration"]) if s.get("duration") else None,
                     bit_depth=depth, n_video_streams=len(streams), pix_fmt=pix)


class FFmpegReader:
    def __init__(self, path, *, stream: Optional[int] = None):
        self.path = pathlib.Path(path)
        self.stream = stream
        self._info = _ffprobe_info(path)

    def info(self) -> VideoInfo:
        return self._info

    def frames(self, fps: Optional[float] = None, start: Optional[float] = None,
               end: Optional[float] = None) -> Iterator[np.ndarray]:
        w, h = self._info.width, self._info.height
        cmd = ["ffmpeg", "-hide_banner", "-loglevel", "error"]
        if start is not None:
            cmd += ["-ss", str(max(0.0, start))]
        cmd += ["-i", str(self.path)]
        if end is not None:
            cmd += ["-to", str(max(0.0, end))]
        if self.stream is not None:
            cmd += ["-map", f"0:v:{self.stream}"]
        if fps:
            cmd += ["-vf", f"fps={fps}"]
        # bit-depth-aware decode: >8-bit sources pipe rgb48le (uint16),
        # like the reference's rgb48le TIFF chain
        # (gs360_Video2Frames.py:538-545)
        deep = self._info.bit_depth > 8
        pix, dtype = ("rgb48le", np.uint16) if deep else ("rgb24", np.uint8)
        cmd += ["-f", "rawvideo", "-pix_fmt", pix, "-"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)
        frame_bytes = w * h * 3 * (2 if deep else 1)
        try:
            while True:
                buf = proc.stdout.read(frame_bytes)
                if not buf or len(buf) < frame_bytes:
                    return
                yield np.frombuffer(buf, dtype).reshape(h, w, 3)
        finally:
            proc.stdout.close()
            proc.wait()


# --------------------------------------------------------------------------
# unified entry points
# --------------------------------------------------------------------------


def open_video(path, *, stream: Optional[int] = None):
    """Pick a reader by extension/availability."""
    p = pathlib.Path(path)
    ext = p.suffix.lower()
    if ext == ".y4m":
        return Y4MReader(p)
    if ext == ".avi":
        try:
            return MJPEGAVIReader(p)
        except ValueError:
            pass
    if have_ffmpeg():
        return FFmpegReader(p, stream=stream)
    raise RuntimeError(
        f"cannot decode {p.name}: no pure-Python reader for this container "
        "and ffmpeg is not on PATH (supported without ffmpeg: .y4m, MJPEG .avi)")


def probe_video(path) -> VideoInfo:
    return open_video(path).info()


def pick_frames(sources: Iterable, src_fps: float,
                fps: Optional[float] = None, start: Optional[float] = None,
                end: Optional[float] = None) -> Iterator[tuple]:
    """The source frames ``sources`` (in order, at ``src_fps``) as
    ffmpeg's fps filter takes them: ``(source, ticks)`` for each source
    frame that an output tick takes, ``ticks`` its ``[(output index, t
    seconds), ...]``; frames no tick takes are passed over unyielded.
    Without ``fps`` each source frame in [start, end] is one tick at its
    own time. With it, output tick k at time start + k/fps takes the most
    recent source frame, ``round(tick · src_fps)``: one source frame may
    be taken by several ticks (``fps`` above the clip's rate), once, with
    all of them, or by none (below it)."""
    t0 = start or 0.0
    k = 0
    for i, source in enumerate(sources):
        ticks = []
        if fps is None or fps <= 0:
            t = i / src_fps
            if t < t0 - 1e-9:
                continue
            if end is not None and t > end + 1e-9:
                return
            ticks.append((k, t))
            k += 1
        else:
            while True:
                tick = t0 + k / fps
                if end is not None and tick > end + 1e-9:
                    if ticks:
                        yield source, ticks
                    return
                if int(round(tick * src_fps)) > i:
                    break  # the tick belongs to a later source frame
                ticks.append((k, tick))
                k += 1
        if ticks:
            yield source, ticks


def source_frames(path, *, fps: Optional[float] = None,
                  start: Optional[float] = None, end: Optional[float] = None,
                  stream: Optional[int] = None
                  ) -> Tuple[Iterator[tuple], Optional[Callable]]:
    """Open the clip now; ``(groups, decode)``: ``groups`` yields ``(item,
    ticks)`` for each source frame that an output tick takes
    (:func:`pick_frames`; the ffmpeg pipe resamples itself, a tick a
    frame), ``decode`` turns an item into its (H, W, 3) frame. An MJPEG-AVI
    clip's items are each frame's JPEG bytes and ``decode`` is
    :func:`decode_jpeg_frame`, so frames may decode on several threads and
    a frame no tick takes is never decoded. A stream read in order (Y4M,
    the ffmpeg pipe) decodes in each ``next()`` of ``groups``: its items
    are the frames and ``decode`` is None."""
    reader = open_video(path, stream=stream)
    info = reader.info()
    if isinstance(reader, FFmpegReader):
        out_fps = fps or info.fps
        frames = reader.frames(fps=fps, start=start, end=end)
        return (((frame, [(i, (start or 0.0) + i / out_fps)])
                 for i, frame in enumerate(frames)), None)
    src_fps = info.fps or 30.0
    if isinstance(reader, MJPEGAVIReader):
        return (pick_frames(reader.payloads(), src_fps, fps, start, end),
                decode_jpeg_frame)
    return pick_frames(reader.frames(), src_fps, fps, start, end), None


def iter_frames(path, *, fps: Optional[float] = None,
                start: Optional[float] = None, end: Optional[float] = None,
                stream: Optional[int] = None) -> Iterator[Frame]:
    """Yield (output_index, t_seconds, rgb) resampled to ``fps``.

    Resampling matches ffmpeg's fps filter (:func:`pick_frames`): output
    tick k at time k/fps maps to the most recent source frame, decoded
    once however many ticks take it.
    """
    groups, decode = source_frames(path, fps=fps, start=start, end=end,
                                   stream=stream)
    for item, ticks in groups:
        frame = item if decode is None else decode(item)
        for k, t in ticks:
            yield k, t, frame
