"""The segmentation weights without ``flax`` or ``msgpack``.

The JAX package writes its single-file weights with
``flax.serialization.to_bytes`` (``gs360x.models.segmentation.save_weights``):
a msgpack map of maps with str keys whose leaves are msgpack ext values of
type 1, each holding a packed ``[shape, dtype name, raw little-endian
bytes]`` triple. :func:`read_msgpack` reads exactly the msgpack types
such a file of any U-Net width holds (maps of up to 65535 str keys, short
arrays, unsigned ints below 65536, bin, ext) into nested dicts of numpy
arrays, the tree ``flax.serialization.msgpack_restore`` gives, and refuses
every other type. :func:`params_from_flax` turns such a tree (or Flax's
params after ``np.asarray``) into the ``state_dict`` of the port's
:class:`~gs360x_torch.models.segmentation.UNet`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

# flax.serialization._MsgpackExtType.ndarray
_EXT_NDARRAY = 1


class _Reader:
    """A cursor over one msgpack buffer."""

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wants {n} more of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")

    def value(self):
        pos = self.pos
        tag = self.uint(1)
        if tag <= 0x7F:                               # positive fixint
            return tag
        if 0x80 <= tag <= 0x8F:                       # fixmap
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:                       # fixarray
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:                       # fixstr
            return self.str(tag & 0x1F)
        if tag in (0xCC, 0xCD):                       # uint 8/16
            return self.uint(1 << (tag - 0xCC))
        if tag == 0xD9:                               # str 8
            return self.str(self.uint(1))
        if tag == 0xDE:                               # map 16
            return self.map(self.uint(2))
        if tag in (0xC4, 0xC5, 0xC6):                 # bin 8/16/32
            return bytes(self.take(self.uint(1 << (tag - 0xC4))))
        if tag in (0xC7, 0xC8, 0xC9):                 # ext 8/16/32
            size = self.uint(1 << (tag - 0xC7))
            return self.ext(self.uint(1), size)
        raise ValueError(f"msgpack: type 0x{tag:02x} at byte {pos} is not "
                         "part of the weights format (maps of str keys, "
                         "ext type 1 array leaves)")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map key {key!r} is not a str")
            out[key] = self.value()
        return out

    def ext(self, code: int, size: int) -> np.ndarray:
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: ext type {code} is not an array "
                             f"leaf (type {_EXT_NDARRAY})")
        inner = _Reader(self.take(size))
        triple = inner.value()
        if inner.pos != size or not (
                isinstance(triple, list) and len(triple) == 3
                and isinstance(triple[0], list)
                and all(isinstance(d, int) for d in triple[0])
                and isinstance(triple[1], str)
                and isinstance(triple[2], bytes)):
            raise ValueError("msgpack: array leaf is not a [shape, dtype "
                             "name, bytes] triple")
        shape, name, raw = triple
        try:
            dtype = np.dtype(name).newbyteorder("<")
        except TypeError as exc:
            raise ValueError(f"msgpack: unknown dtype {name!r}") from exc
        return np.frombuffer(raw, dtype=dtype).reshape(shape)


def read_msgpack(data: bytes) -> Dict:
    """Decode Flax msgpack weights into nested dicts of numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - reader.pos} trailing bytes")
    if not isinstance(tree, dict):
        raise ValueError("msgpack: the weights file is not a map")
    return tree


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays) → the port's ``state_dict``.

    Module paths keep Flax's names joined by ``.`` (``ConvBlock_0.Conv_0``,
    ``Conv_2``); a conv ``kernel`` (H, W, I, O) becomes ``weight``
    (O, I, H, W), a GroupNorm ``scale`` becomes ``weight``, ``bias`` stays.
    """
    out = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            if key == "kernel":
                out[f"{prefix}weight"] = arr.permute(3, 2, 0, 1).contiguous()
            elif key == "scale":
                out[f"{prefix}weight"] = arr
            elif key == "bias":
                out[f"{prefix}bias"] = arr
            else:
                raise ValueError(f"unexpected parameter {prefix}{key}")

    walk(tree, "")
    return out


__all__ = ["read_msgpack", "params_from_flax"]
