"""Image read/write with an async writer pool.

Replaces the reference's ffmpeg still-image encodes and cv2/PIL reads.
Quality policy mirrors the reference's encoder settings
(``cli_tools/gs360_360PerspCut.py:317-347``): jpg defaults
to near-lossless 4:4:4 (mjpeg q=1 equivalent → quality 98, subsampling
off), ``jpeg_quality_95`` drops to 95. 16-bit outputs go to PNG/TIFF.

The writer pool is the device pipeline's pressure valve: device → host
arrays are handed to a bounded thread pool so JPEG encoding overlaps the next batch's
warp (the reference's analogue is one ffmpeg process per view).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import ctypes
import pathlib
import threading
import time
from operator import add
from typing import Optional

import numpy as np
from PIL import Image

from gs360x_torch.runtime.profiling import WindowCounter

IMAGE_EXTS = {".tif", ".tiff", ".jpg", ".jpeg", ".png"}


# --------------------------------------------------------------------------
# conversions
# --------------------------------------------------------------------------


def to_float01(img: np.ndarray) -> np.ndarray:
    """uint8/uint16/float image → float32 in [0,1]."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return np.clip(img.astype(np.float32), 0.0, 1.0)


def from_float01(img: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """float [0,1] → uint8 or uint16 with round-half-away like ffmpeg.

    Already-quantized arrays pass through (device pipelines quantize
    before the host fetch to shrink tunnel transfers 4x)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and bit_depth <= 8:
        return img
    if img.dtype == np.uint16 and bit_depth > 8:
        return img
    x = np.clip(img.astype(np.float32), 0.0, 1.0)
    if bit_depth > 8:
        return np.rint(x * 65535.0).astype(np.uint16)
    return np.rint(x * 255.0).astype(np.uint8)


# --------------------------------------------------------------------------
# read / write
# --------------------------------------------------------------------------


# the texels=True calls: (start on time.perf_counter, 1, served)
_TEXELS = WindowCounter(requested=add, served=add)


def texel_decode_counts(start: Optional[float] = None,
                        end: Optional[float] = None) -> dict:
    """``{"requested", "served"}``: the ``read_image(..., texels=True)``
    calls of this process, and those that returned Pillow's own RGBX;
    given ``start`` and ``end`` (``time.perf_counter``), only the calls of
    the newest 65536 that started in [start, end)."""
    return _TEXELS.read(start, end)


def is_texel_decode(arr) -> bool:
    """Whether ``arr`` is what ``read_image(..., texels=True)`` serves for
    an 8-bit RGB file: Pillow's block as (H, W, 4) u8 RGBX, X = 255 (no
    other 4-channel array is taken for texels)."""
    return isinstance(getattr(arr, "base", None), _PillowBlock)


def read_image(path, texels: bool = False) -> np.ndarray:
    """Read an image as (H, W, 3) uint8 or uint16 RGB.

    ``texels=True``: an 8-bit RGB file decodes into one memory block of
    Pillow's and comes back as that block, (H, W, 4) uint8 RGBX with X =
    255 (the texels the kernels read, without the pack to RGB); its
    ``[..., :3]`` is what ``read_image(path)`` returns. Any other file, or
    a Pillow without the block allocator or the Arrow export, returns
    what ``read_image(path)`` does."""
    t0 = time.perf_counter()
    arr = _read_image(path, texels)
    if texels:
        _TEXELS.add(t0, requested=1, served=arr.shape[-1] == 4)
    return arr


def _read_image(path, texels: bool) -> np.ndarray:
    p16 = _read_png16_rgb(path)
    if p16 is not None:
        return p16
    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            arr = np.asarray(im, dtype=np.uint16)
            return np.repeat(arr[..., None], 3, axis=-1)
        if im.mode != "RGB":
            im = im.convert("RGB")
        elif texels:
            rgbx = _decode_rgbx(im)
            if rgbx is not None:
                return rgbx
        return np.asarray(im)


class _PillowBlock:
    """Owns one decoded image's block (and its Arrow export) for as long
    as the array over it lives: that array's ``base``."""

    def __init__(self, core, capsules, ptr: int, shape: tuple):
        self._core, self._capsules = core, capsules
        self.__array_interface__ = {
            "shape": shape, "typestr": "|u1", "data": (ptr, False),
            "version": 3}


def _arrow_export(core) -> tuple:
    """The Arrow C data interface's (schema, array) capsules of ``core``
    (Pillow 11.2 on: a single-block image only)."""
    return core.__arrow_c_schema__(), core.__arrow_c_array__()


def _decode_rgbx(im) -> Optional[np.ndarray]:
    """Decode RGB ``im`` into one block and return that block as (H, W, 4)
    u8 RGBX, or None where this Pillow cannot hand its block out."""
    new_block = getattr(Image.core, "new_block", None)
    if new_block is None:
        return None
    # load() keeps an image of the right mode and size it already has
    im.im = new_block(im.mode, im.size)
    im.load()
    core = im.im
    try:
        if not core.isblock():
            return None
        capsules = _arrow_export(core)
        w, h = im.size
        ptr = _arrow_rgbx_data(*capsules, h * w)
    except (AttributeError, ValueError):
        return None
    if ptr is None:
        return None
    return np.asarray(_PillowBlock(core, capsules, ptr, (h, w, 4)))


class _ArrowSchema(ctypes.Structure):
    pass


_ArrowSchema._fields_ = [
    ("format", ctypes.c_char_p), ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_char_p), ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(ctypes.POINTER(_ArrowSchema))),
    ("dictionary", ctypes.POINTER(_ArrowSchema)),
    ("release", ctypes.c_void_p), ("private_data", ctypes.c_void_p)]


class _ArrowArray(ctypes.Structure):
    pass


_ArrowArray._fields_ = [
    ("length", ctypes.c_int64), ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64), ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(ctypes.POINTER(_ArrowArray))),
    ("dictionary", ctypes.POINTER(_ArrowArray)),
    ("release", ctypes.c_void_p), ("private_data", ctypes.c_void_p)]


_capsule = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object,
                            ctypes.c_char_p)(("PyCapsule_GetPointer",
                                              ctypes.pythonapi))


def _arrow_rgbx_data(schema, array, n_pixels: int) -> Optional[int]:
    """The address of the pixels an exported RGB image holds, if the
    export is ``n_pixels`` lists of 4 u8 (``+w:4`` over ``C``), else
    None."""
    s = _ArrowSchema.from_address(_capsule(schema, b"arrow_schema"))
    a = _ArrowArray.from_address(_capsule(array, b"arrow_array"))
    if s.format != b"+w:4" or s.n_children != 1 \
            or s.children[0].contents.format != b"C" \
            or a.length != n_pixels or a.n_children != 1:
        return None
    child = a.children[0].contents
    if child.n_buffers != 2 or not child.buffers[1] \
            or child.length < 4 * (a.offset + n_pixels):
        return None
    return child.buffers[1] + child.offset + 4 * a.offset


def _read_png16_rgb(path):
    """16-bit RGB PNG reader (PIL lacks the mode). Returns None unless the
    file is a PNG with bit depth 16 and color type 2 (truecolor)."""
    import struct
    import zlib

    path = pathlib.Path(path)
    if path.suffix.lower() != ".png":
        return None
    try:
        with open(path, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                return None
            w = h = None
            idat = bytearray()
            while True:
                head = f.read(8)
                if len(head) < 8:
                    break
                (length,), tag = struct.unpack(">I", head[:4]), head[4:]
                payload = f.read(length)
                f.read(4)  # crc
                if tag == b"IHDR":
                    w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
                    if depth != 16 or ctype != 2 \
                            or payload[10:13] != b"\x00\x00\x00":
                        return None
                elif tag == b"IDAT":
                    idat.extend(payload)
                elif tag == b"IEND":
                    break
            if w is None or not idat:
                return None
            raw = zlib.decompress(bytes(idat))
    except (OSError, zlib.error, struct.error):
        return None
    stride = w * 6
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        filt = raw[y * (stride + 1)]
        line = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1)
        if filt == 0:
            row = line.copy()
        elif filt == 2:  # Up
            row = (line.astype(np.int32) + prev).astype(np.uint8)
        else:
            # Sub/Average/Paeth need sequential decode; rare from our
            # writer (filter 0) — fall back to per-byte decoding
            row = _png_unfilter_slow(filt, line, prev, bpp=6)
        out[y] = row
        prev = row
    arr = out.reshape(h, w, 3, 2)
    return (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]


def _png_unfilter_slow(filt, line, prev, bpp):
    row = np.zeros(len(line), np.uint8)
    for i in range(len(line)):
        x = int(line[i])
        a = int(row[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        c = int(prev[i - bpp]) if i >= bpp else 0
        if filt == 1:
            x += a
        elif filt == 3:
            x += (a + b) // 2
        elif filt == 4:
            pp = a + b - c
            pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
            x += a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        row[i] = x & 0xFF
    return row


def read_image_gray(path) -> np.ndarray:
    """Read an image as (H, W) float32 luma in [0,1] (BT.601 weights, the
    same gray conversion cv2.imread+cvtColor uses in the reference)."""
    img = to_float01(read_image(path))
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def write_image(path, img: np.ndarray, *, jpeg_quality: Optional[int] = None,
                planar: bool = False) -> None:
    """Write (H, W, 3) uint8/uint16 (or (H, W) gray) to path by extension.

    ``planar=True`` accepts (3, H, W) and interleaves here, inside the
    writer thread: the device hands out planes, and the channel interleave
    belongs on the host encode path."""
    path = pathlib.Path(path)
    ext = path.suffix.lower()
    img = np.asarray(img)
    if planar:
        if img.dtype == np.float32:
            from gs360x_torch import native

            img = native.planar_f32_to_u8_hwc(img)
        elif img.dtype == np.uint8:
            from gs360x_torch import native

            img = native.interleave_u8(img)
        else:
            img = np.ascontiguousarray(np.moveaxis(img, 0, -1))
    if img.dtype == np.uint16:
        if ext in (".jpg", ".jpeg"):
            img = (img >> 8).astype(np.uint8)
        elif img.ndim == 3:
            # PIL has no 16-bit RGB; raw writers cover the reference's
            # rgb48le outputs (gs360_Video2Frames.py:540-545)
            if ext == ".png":
                _write_png16_rgb(path, img)
            else:
                _write_tiff16_rgb(path, img)
            return
    if img.ndim == 2:
        pil = Image.fromarray(img)
    else:
        pil = Image.fromarray(img[..., :3])
    if ext in (".jpg", ".jpeg"):
        # reference encode contract (gs360_Video2Frames.py:517-537):
        # top-quality mjpeg at 4:4:4 with optimal huffman tables maps to
        # PIL quality=98..100, subsampling=0, optimize=True
        q = 98 if jpeg_quality is None else int(jpeg_quality)
        pil.save(path, quality=q, subsampling=0, optimize=True)
    elif ext in (".tif", ".tiff"):
        # lossless deflate, like the reference's -compression_algo deflate
        pil.save(path, compression="tiff_deflate")
    else:
        pil.save(path)


def _write_png16_rgb(path, img: np.ndarray) -> None:
    """Minimal 16-bit RGB PNG (the reference's rgb48le PNG analogue).

    PIL cannot write 16-bit RGB PNGs; the format itself is simple:
    zlib-compressed scanlines with filter byte 0 and big-endian samples.
    """
    import struct
    import zlib

    h, w, _ = img.shape
    be = np.ascontiguousarray(img.astype(">u2"))
    raw = bytearray()
    row_bytes = be.tobytes()
    stride = w * 6
    for y in range(h):
        raw.append(0)  # filter: None
        raw.extend(row_bytes[y * stride:(y + 1) * stride])

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)  # 16-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(bytes(raw), 6)))
        f.write(chunk(b"IEND", b""))


def _write_tiff16_rgb(path, img: np.ndarray) -> None:
    """Minimal uncompressed little-endian TIFF for 16-bit RGB (the
    reference's rgb48le TIFF analogue). Single strip, no compression."""
    import struct

    h, w, _ = img.shape
    data = np.ascontiguousarray(img.astype("<u2")).tobytes()
    # header (8) + IFD later; place pixel data right after header
    data_offset = 8
    ifd_offset = data_offset + len(data)
    entries = []

    def entry(tag, typ, count, value):
        entries.append(struct.pack("<HHI4s", tag, typ, count, value))

    def long_val(v):
        return struct.pack("<I", v)

    def short_val(v):
        return struct.pack("<HH", v, 0)

    extra = b""
    extra_offset = ifd_offset + 2 + 12 * 11 + 4
    # BitsPerSample needs 3 shorts -> external
    bps_offset = extra_offset + len(extra)
    extra += struct.pack("<HHH", 16, 16, 16) + b"\x00\x00"
    entry(256, 3, 1, short_val(w))            # ImageWidth
    entry(257, 3, 1, short_val(h))            # ImageLength
    entry(258, 3, 3, long_val(bps_offset))    # BitsPerSample
    entry(259, 3, 1, short_val(1))            # Compression: none
    entry(262, 3, 1, short_val(2))            # Photometric: RGB
    entry(273, 4, 1, long_val(data_offset))   # StripOffsets
    entry(277, 3, 1, short_val(3))            # SamplesPerPixel
    entry(278, 3, 1, short_val(h))            # RowsPerStrip
    entry(279, 4, 1, long_val(len(data)))     # StripByteCounts
    entry(284, 3, 1, short_val(1))            # PlanarConfig: chunky
    entry(339, 3, 1, short_val(1))            # SampleFormat: unsigned
    ifd = struct.pack("<H", len(entries)) + b"".join(entries) + struct.pack("<I", 0)
    header = struct.pack("<2sHI", b"II", 42, ifd_offset)
    pathlib.Path(path).write_bytes(header + data + ifd + extra)


# --------------------------------------------------------------------------
# async writer pool
# --------------------------------------------------------------------------


class AsyncImageWriter:
    """Bounded thread-pool image writer with backpressure.

    ``submit`` blocks once ``max_pending`` encodes are in flight, so the
    device loop can't race ahead of the disk (the role the reference's
    adaptive memory limiter plays, ``gs360_FrameSelector.py:65-193``).
    With ``timers`` (a :class:`~gs360x_torch.runtime.profiling.StageTimers`),
    that block is a ``writer_block`` stage of the submitting thread and
    each write a stage of its writer thread, named by ``submit``'s
    ``stage`` (``encode`` unless said).
    """

    def __init__(self, workers: int = 4, max_pending: int = 32,
                 timers=None):
        self._pool = cf.ThreadPoolExecutor(max_workers=workers)
        self._sem = threading.Semaphore(max_pending)
        self._errors: list = []
        self._lock = threading.Lock()
        self._count = 0
        self._timers = timers

    def _stage(self, name: str):
        if self._timers is None:
            return contextlib.nullcontext()
        return self._timers.stage(name)

    def submit(self, path, img: np.ndarray, *, stage: str = "encode",
               **kw) -> None:
        with self._stage("writer_block"):
            self._sem.acquire()

        def task():
            try:
                with self._stage(stage):
                    write_image(path, img, **kw)
            except Exception as exc:  # surfaced on close()
                with self._lock:
                    self._errors.append((str(path), exc))
            finally:
                self._sem.release()

        with self._lock:
            self._count += 1
        self._pool.submit(task)

    def close(self) -> int:
        """Wait for completion; raise the first error; return files written."""
        self._pool.shutdown(wait=True)
        if self._errors:
            path, exc = self._errors[0]
            raise RuntimeError(f"failed writing {path}: {exc}") from exc
        return self._count

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
