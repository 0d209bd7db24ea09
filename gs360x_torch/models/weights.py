"""The segmentation weights without ``flax`` or ``msgpack``.

The JAX package writes its single-file weights with
``flax.serialization.to_bytes`` (``gs360x.models.segmentation.save_weights``):
a msgpack map of maps with str keys, sorted, whose leaves are msgpack ext
values of type 1, each holding a packed ``[shape, dtype name, raw
little-endian bytes]`` triple. :func:`read_msgpack` reads exactly the
msgpack types such a file of any U-Net width holds (maps of up to 65535 str
keys, short arrays, unsigned ints below 65536, bin, ext) into nested dicts
of numpy arrays, the tree ``flax.serialization.msgpack_restore`` gives, and
refuses every other type; :func:`write_msgpack` writes such a tree with the
same types, byte for byte what ``flax.serialization.to_bytes`` writes, and
refuses what needs another type.
:func:`params_from_flax` turns such a tree (or Flax's params after
``np.asarray``) into the ``state_dict`` of the port's
:class:`~gs360x_torch.models.segmentation.UNet`, and
:func:`params_to_flax` turns it back.
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


class _Writer:
    """msgpack of a weights tree, as ``msgpack.packb`` writes it: the
    smallest encoding of each value, maps with their keys sorted as
    ``jax.tree_util`` sorts them before Flax packs."""

    def __init__(self) -> None:
        self.parts = []

    def head(self, n: int, fix: int, fix_max: int, tags) -> None:
        """A length header: the fix form below ``fix_max``, else the first
        of the 8/16/32-bit forms in ``tags`` that holds ``n``."""
        if fix is not None and n < fix_max:
            self.parts.append(bytes([fix | n]))
            return
        for tag, size in tags:
            if n < 1 << (8 * size):
                self.parts.append(bytes([tag]) + n.to_bytes(size, "big"))
                return
        raise ValueError(f"msgpack: length {n} is too large")

    def value(self, x) -> None:
        if isinstance(x, Mapping):
            self.head(len(x), 0x80, 16, ((0xDE, 2),))
            for key in sorted(x):
                if not isinstance(key, str):
                    raise ValueError(f"msgpack: map key {key!r} is not a "
                                     "str")
                self.value(key)
                self.value(x[key])
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            self.head(len(raw), 0xA0, 32, ((0xD9, 1),))
            self.parts.append(raw)
        elif isinstance(x, (list, tuple)):
            self.head(len(x), 0x90, 16, ())
            for item in x:
                self.value(item)
        elif isinstance(x, int) and not isinstance(x, bool) and x >= 0:
            if x < 128:
                self.parts.append(bytes([x]))
            else:
                self.head(x, None, 0, ((0xCC, 1), (0xCD, 2)))
        elif isinstance(x, bytes):
            self.head(len(x), None, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
            self.parts.append(x)
        elif isinstance(x, np.ndarray):
            inner = _Writer()
            inner.value([list(x.shape), x.dtype.name, x.tobytes("C")])
            payload = b"".join(inner.parts)
            if len(payload) in (1, 2, 4, 8, 16):   # msgpack's fixext sizes
                raise ValueError(f"msgpack: a {x.shape} array leaf is not "
                                 "part of the weights format")
            self.head(len(payload), None, 0,
                      ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
            self.parts.append(bytes([_EXT_NDARRAY]) + payload)
        else:
            raise ValueError(f"msgpack: {type(x).__name__} is not part of "
                             "the weights format")


def write_msgpack(tree: Mapping) -> bytes:
    """Encode nested dicts of numpy arrays as Flax msgpack weights."""
    if not isinstance(tree, Mapping):
        raise ValueError("msgpack: the weights tree is not a map")
    writer = _Writer()
    writer.value(tree)
    return b"".join(writer.parts)


def params_to_flax(params: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``state_dict`` → Flax params (nested dicts of f32 numpy
    arrays), the inverse of :func:`params_from_flax`: a conv ``weight``
    (O, I, H, W) becomes ``kernel`` (H, W, I, O), a GroupNorm ``weight``
    (1-D) becomes ``scale``, ``bias`` stays."""
    out: Dict = {}
    for name, value in params.items():
        *path, key = name.split(".")
        arr = value.detach().to("cpu", torch.float32)
        if key == "weight" and arr.dim() == 4:
            key, arr = "kernel", arr.permute(2, 3, 1, 0)
        elif key == "weight" and arr.dim() == 1:
            key = "scale"
        elif key != "bias":
            raise ValueError(f"unexpected parameter {name}")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(arr.numpy())
    return out


__all__ = ["read_msgpack", "write_msgpack", "params_from_flax",
           "params_to_flax"]
