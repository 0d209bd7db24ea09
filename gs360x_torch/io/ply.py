"""Self-contained PLY codec (ascii + binary little/big endian).

Replaces the reference's ``plyfile`` dependency and its struct-based readers
(``cli_tools/gs360_PlyOptimizer.py:304-419``,
``gs360_MS360xmlToPersCams.py:782-919``). Handles arbitrary scalar vertex
properties — including 3DGS ``f_dc_*`` spherical-harmonic DC colors — and
skips list properties (faces) safely.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

SH_C0 = 0.28209479177387814  # Y_00; 3DGS stores color as (rgb-0.5)/SH_C0

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
               "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


@dataclass
class PlyElement:
    name: str
    count: int
    properties: List[Tuple[str, str]] = field(default_factory=list)  # (name, np dtype code)
    list_properties: List[Tuple[str, str, str]] = field(default_factory=list)
    data: Optional[np.ndarray] = None  # structured array (scalar props only)


@dataclass
class PlyFile:
    elements: List[PlyElement] = field(default_factory=list)
    comments: List[str] = field(default_factory=list)

    def element(self, name: str) -> Optional[PlyElement]:
        for el in self.elements:
            if el.name == name:
                return el
        return None


def read_ply(path) -> PlyFile:
    raw = pathlib.Path(path).read_bytes()
    end = raw.find(b"end_header")
    if not raw.startswith(b"ply") or end < 0:
        raise ValueError(f"{path}: not a PLY file")
    nl = raw.find(b"\n", end)
    header = raw[:nl].decode("ascii", errors="replace")
    body = raw[nl + 1:]

    fmt = None
    out = PlyFile()
    current: Optional[PlyElement] = None
    # per-element layout: list of ('scalar', name, dtype) / ('list', cdt, vdt, name)
    layouts: Dict[str, list] = {}
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        key = parts[0]
        if key == "format":
            fmt = parts[1]
        elif key == "comment":
            out.comments.append(line.strip()[8:])
        elif key == "element":
            current = PlyElement(name=parts[1], count=int(parts[2]))
            out.elements.append(current)
            layouts[current.name] = []
        elif key == "property" and current is not None:
            if parts[1] == "list":
                cdt, vdt, name = parts[2], parts[3], parts[4]
                current.list_properties.append(
                    (name, _PLY_DTYPES[cdt], _PLY_DTYPES[vdt]))
                layouts[current.name].append(("list", _PLY_DTYPES[cdt],
                                              _PLY_DTYPES[vdt], name))
            else:
                dt = _PLY_DTYPES[parts[1]]
                current.properties.append((parts[2], dt))
                layouts[current.name].append(("scalar", parts[2], dt))
    if fmt is None:
        raise ValueError(f"{path}: missing format line")

    if fmt == "ascii":
        _read_ascii_body(out, layouts, body)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        _read_binary_body(out, layouts, body, bo)
    return out


def _read_ascii_body(out: PlyFile, layouts, body: bytes) -> None:
    tokens = body.decode("ascii", errors="replace").split("\n")
    li = 0
    for el in out.elements:
        layout = layouts[el.name]
        scalar_names = [(n, dt) for kind, *rest in layout
                        for n, dt in ([tuple(rest[:2])] if kind == "scalar" else [])]
        dtype = np.dtype([(n, dt) for n, dt in scalar_names])
        data = np.zeros(el.count, dtype=dtype) if scalar_names else None
        for i in range(el.count):
            while li < len(tokens) and not tokens[li].strip():
                li += 1
            vals = tokens[li].split()
            li += 1
            vi = 0
            for item in layout:
                if item[0] == "scalar":
                    _, name, _dt = item
                    data[name][i] = float(vals[vi])
                    vi += 1
                else:
                    n = int(vals[vi])
                    vi += 1 + n
        el.data = data


def _read_binary_body(out: PlyFile, layouts, body: bytes, bo: str) -> None:
    offset = 0
    for el in out.elements:
        layout = layouts[el.name]
        if not el.list_properties:
            dtype = np.dtype([(n, bo + dt) for n, dt in el.properties])
            el.data = np.frombuffer(body, dtype=dtype, count=el.count,
                                    offset=offset).copy()
            offset += dtype.itemsize * el.count
        else:
            # variable-length rows: walk row by row (faces etc.)
            scalar_dtype = np.dtype([(n, bo + dt) for n, dt in el.properties]) \
                if el.properties else None
            rows = np.zeros(el.count, dtype=scalar_dtype) if scalar_dtype else None
            for i in range(el.count):
                for item in layout:
                    if item[0] == "scalar":
                        _, name, dt = item
                        v = np.frombuffer(body, dtype=bo + dt, count=1, offset=offset)[0]
                        rows[name][i] = v
                        offset += np.dtype(dt).itemsize
                    else:
                        _, cdt, vdt, _name = item
                        n = int(np.frombuffer(body, dtype=bo + cdt, count=1,
                                              offset=offset)[0])
                        offset += np.dtype(cdt).itemsize
                        offset += n * np.dtype(vdt).itemsize
            el.data = rows


def write_ply(path, arrays: Dict[str, np.ndarray], *, element: str = "vertex",
              binary: bool = True, comments: Optional[List[str]] = None) -> None:
    """Write one PLY element from a dict of named 1-D arrays (same length)."""
    names = list(arrays)
    n = len(arrays[names[0]])
    cols = {k: np.asarray(v) for k, v in arrays.items()}
    for k, v in cols.items():
        if len(v) != n:
            raise ValueError(f"column {k} length {len(v)} != {n}")
    dtype = np.dtype([(k, cols[k].dtype.str[1:]) for k in names])
    rec = np.zeros(n, dtype=dtype)
    for k in names:
        rec[k] = cols[k]

    lines = ["ply"]
    lines.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    for c in (comments or []):
        lines.append(f"comment {c}")
    lines.append(f"element {element} {n}")
    for k in names:
        code = np.dtype(cols[k].dtype).str[1:]
        lines.append(f"property {_INV_DTYPES[code]} {k}")
    lines.append("end_header")
    header = ("\n".join(lines) + "\n").encode("ascii")

    p = pathlib.Path(path)
    if binary:
        little = rec.astype(np.dtype([(k, "<" + cols[k].dtype.str[1:]) for k in names]))
        p.write_bytes(header + little.tobytes())
    else:
        with p.open("w") as f:
            f.write(header.decode("ascii"))
            for row in rec:
                f.write(" ".join(_fmt_ascii(row[k]) for k in names) + "\n")


def _fmt_ascii(v) -> str:
    if np.issubdtype(type(v), np.integer) or isinstance(v, (int, np.integer)):
        return str(int(v))
    return f"{float(v):.8g}"


# --------------------------------------------------------------------------
# xyz/rgb convenience layer (the PlyOptimizer contract)
# --------------------------------------------------------------------------


def _float_rgb_to_u8(values: np.ndarray) -> np.ndarray:
    """Float colors in 0..1 or 0..255 → uint8 (auto range detection, same
    policy as the reference)."""
    v = values.astype(np.float32, copy=False)
    finite = v[np.isfinite(v)]
    if finite.size == 0:
        return np.zeros(v.shape, dtype=np.uint8)
    if float(finite.max()) <= 1.0 + 1e-6:
        scaled = np.clip(v, 0.0, 1.0) * 255.0
    else:
        scaled = np.clip(v, 0.0, 255.0)
    return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)


def dc_sh_to_rgb8(dc: np.ndarray) -> np.ndarray:
    """3DGS DC spherical-harmonic coefficients → uint8 RGB."""
    rgb01 = np.clip(dc.astype(np.float32, copy=False) * SH_C0 + 0.5, 0.0, 1.0)
    return np.clip(np.rint(rgb01 * 255.0), 0, 255).astype(np.uint8)


_COLOR_TRIPLES = [
    ("red", "green", "blue"),
    ("r", "g", "b"),
    ("diffuse_red", "diffuse_green", "diffuse_blue"),
]


def load_ply_xyz_rgb(path) -> Tuple[np.ndarray, np.ndarray]:
    """Load (N,3) float32 xyz + (N,3) uint8 rgb, resolving color from plain
    RGB triples, float colors, or 3DGS ``f_dc_*`` fields (white fallback)."""
    ply = read_ply(path)
    el = ply.element("vertex")
    if el is None:
        for cand in ply.elements:
            if cand.data is not None and all(
                    k in cand.data.dtype.names for k in ("x", "y", "z")):
                el = cand
                break
    if el is None or el.data is None:
        raise ValueError(f"{path}: no vertex element with x,y,z")
    v = el.data
    names = v.dtype.names
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    rgb = None
    for r, g, b in _COLOR_TRIPLES:
        if r in names and g in names and b in names:
            stack = np.stack([v[r], v[g], v[b]], axis=1)
            rgb = (_float_rgb_to_u8(stack) if stack.dtype.kind == "f"
                   else stack.astype(np.uint8))
            break
    if rgb is None and all(f"f_dc_{i}" in names for i in range(3)):
        rgb = dc_sh_to_rgb8(np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], axis=1))
    if rgb is None:
        rgb = np.full((len(xyz), 3), 255, dtype=np.uint8)
    return xyz, rgb


def save_ply_xyz_rgb(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary little-endian x/y/z float32 + red/green/blue uchar."""
    xyz = np.asarray(xyz, dtype=np.float32)
    rgb = np.asarray(rgb, dtype=np.uint8)
    if xyz.shape[0] != rgb.shape[0]:
        raise ValueError("xyz and rgb must have the same number of rows")
    write_ply(path, {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
    })
