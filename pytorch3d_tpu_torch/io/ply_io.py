"""PLY loading and saving, ASCII and binary in both endians (port of
pytorch3d_tpu/io/ply_io.py).

The header and element readers are the JAX package's host numpy code; the
loaders make their tensors once at the end, on `device` (None: the card).
`save_ply` writes colours as uchar by `(c * 255).clip(0, 255)` cast to
uint8, which truncates, as the JAX package does.
"""

from __future__ import annotations

import contextlib
import struct as _struct
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from .utils import _device, _to_numpy

_PLY_TYPES = {
    "char": ("i1", 1), "uchar": ("u1", 1), "int8": ("i1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "ushort": ("u2", 2), "int16": ("i2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "uint": ("u4", 4), "int32": ("i4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


class _Property:
    def __init__(self, name, dtype, is_list=False, count_dtype=None):
        self.name = name
        self.dtype = dtype
        self.is_list = is_list
        self.count_dtype = count_dtype


class _Element:
    def __init__(self, name, count):
        self.name = name
        self.count = count
        self.properties: List[_Property] = []


def _ply_type(tok: str) -> Tuple[str, int]:
    """Datatype lookup with the reference's error text (ply_io.py header
    parsing: 'Invalid datatype: <tok>')."""
    if tok not in _PLY_TYPES:
        raise ValueError(f"Invalid datatype: {tok}")
    return _PLY_TYPES[tok]


def _add_property(elem: _Element, prop: _Property) -> None:
    if any(p.name == prop.name for p in elem.properties):
        raise ValueError(
            f"Cannot have two properties called {prop.name} in"
            f" {elem.name}."
        )
    elem.properties.append(prop)


def _parse_header(fh) -> Tuple[List[_Element], str]:
    line = fh.readline().strip()
    if line != b"ply":
        raise ValueError("Invalid file header.")
    fmt = None
    elements: List[_Element] = []
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("EOF in header")
        tokens = line.decode("ascii").strip().split()
        if not tokens or tokens[0] in ("comment", "obj_info"):
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            if len(tokens) != 3:
                raise ValueError(f"Invalid line: {line.decode('ascii')!r}")
            if elements and not elements[-1].properties:
                raise ValueError("Found an element with no properties.")
            try:
                count = int(tokens[2])
            except ValueError:
                raise ValueError(
                    f"Number of items for {tokens[1]} was not a number."
                ) from None
            elements.append(_Element(tokens[1], count))
        elif tokens[0] == "property":
            if not elements:
                raise ValueError("Encountered property before any element.")
            if tokens[1] == "list":
                _add_property(
                    elements[-1],
                    _Property(tokens[4], _ply_type(tokens[3])[0], True,
                              _ply_type(tokens[2])[0]),
                )
            else:
                _add_property(
                    elements[-1],
                    _Property(tokens[2], _ply_type(tokens[1])[0]),
                )
        elif tokens[0] == "end_header":
            if elements and not elements[-1].properties:
                raise ValueError("Found an element with no properties.")
            break
        else:
            raise ValueError(f"Invalid line: {line.decode('ascii').strip()!r}")
    if fmt is None:
        raise ValueError("No format line found.")
    return elements, fmt


def _read_element_ascii(fh, elem: _Element):
    rows = []
    list_data = []
    has_list = any(p.is_list for p in elem.properties)
    for _ in range(elem.count):
        line = fh.readline()
        if not line:
            raise ValueError(f"Not enough data for {elem.name}.")
        tokens = line.decode("ascii").strip().split()
        i = 0
        row = []
        lrow = []
        try:
            for prop in elem.properties:
                if prop.is_list:
                    n = int(tokens[i]); i += 1
                    if i + n > len(tokens):
                        raise ValueError(
                            f"A line of {elem.name} data did not have"
                            " the specified length."
                        )
                    lrow.append([float(t) for t in tokens[i : i + n]])
                    i += n
                else:
                    row.append(float(tokens[i])); i += 1
        except IndexError:
            raise ValueError(
                f"Inconsistent data for {elem.name}."
            ) from None
        if i != len(tokens):
            # leftover values on the line
            if has_list:
                raise ValueError(
                    f"A line of {elem.name} data did not have the"
                    " specified length."
                )
            raise ValueError(f"Inconsistent data for {elem.name}.")
        rows.append(row)
        list_data.append(lrow)
    return rows, list_data


def _read_element_binary(fh, elem: _Element, endian: str):
    has_list = any(p.is_list for p in elem.properties)
    if not has_list:
        dtype = np.dtype(
            [(p.name, endian + p.dtype) for p in elem.properties]
        )
        data = np.frombuffer(fh.read(dtype.itemsize * elem.count), dtype=dtype)
        rows = np.stack(
            [data[p.name].astype(np.float64) for p in elem.properties], axis=-1
        )
        return rows, [[] for _ in range(elem.count)]
    rows, list_data = [], []
    for _ in range(elem.count):
        row, lrow = [], []
        for p in elem.properties:
            if p.is_list:
                cnt_dt = np.dtype(endian + p.count_dtype)
                n = int(np.frombuffer(fh.read(cnt_dt.itemsize), cnt_dt)[0])
                dt = np.dtype(endian + p.dtype)
                vals = np.frombuffer(fh.read(dt.itemsize * n), dt)
                lrow.append(vals.astype(np.float64).tolist())
            else:
                dt = np.dtype(endian + p.dtype)
                row.append(float(np.frombuffer(fh.read(dt.itemsize), dt)[0]))
        rows.append(row)
        list_data.append(lrow)
    return rows, list_data


def _load_ply_raw(f):
    own = False
    if not hasattr(f, "read"):
        fh = open(str(f), "rb")
        own = True
    else:
        fh = f
    try:
        elements, fmt = _parse_header(fh)
        endian = {"ascii": None, "binary_little_endian": "<",
                  "binary_big_endian": ">"}[fmt]
        out = {}
        for elem in elements:
            if endian is None:
                rows, lists = _read_element_ascii(fh, elem)
            else:
                rows, lists = _read_element_binary(fh, elem, endian)
            out[elem.name] = (elem, np.asarray(rows, np.float64), lists)
        trailing = fh.read()
        if trailing and trailing.strip():
            raise ValueError("Extra data at end of file.")
        return out
    finally:
        if own:
            fh.close()


def load_ply(f, path_manager=None, device=None):
    """Load a .ply mesh: (verts (V, 3) float32, faces (F, 3) int32, polygons
    split into fans) on `device` (None: the card)."""
    device = _device(device)
    data = _load_ply_raw(f)
    if "vertex" not in data:
        raise ValueError("The ply file has no vertex element.")
    elem, rows, _ = data["vertex"]
    names = [p.name for p in elem.properties]
    try:
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
    except ValueError:
        raise ValueError("Invalid vertices in file.")
    verts = rows[:, [ix, iy, iz]].astype(np.float32)

    faces = np.zeros((0, 3), np.int32)
    if "face" in data:
        felem, _, lists = data["face"]
        li = [i for i, p in enumerate(felem.properties) if p.is_list]
        if li:
            tri = []
            for lrow in lists:
                poly = [int(v) for v in lrow[li[0]]]
                for k in range(len(poly) - 2):
                    tri.append((poly[0], poly[k + 1], poly[k + 2]))
            faces = np.asarray(tri, np.int32).reshape(-1, 3)
    return torch.as_tensor(verts, device=device), torch.as_tensor(faces, device=device)


def load_ply_pointcloud(f, device=None):
    """Load a .ply point cloud: (points, normals or None, colours or None)
    as float32 on `device` (None: the card); uchar colours are / 255."""
    device = _device(device)
    data = _load_ply_raw(f)
    elem, rows, _ = data["vertex"]
    names = [p.name for p in elem.properties]
    verts = rows[:, [names.index("x"), names.index("y"), names.index("z")]]
    normals = None
    if all(n in names for n in ("nx", "ny", "nz")):
        normals = rows[:, [names.index("nx"), names.index("ny"), names.index("nz")]]
    colors = None
    if all(n in names for n in ("red", "green", "blue")):
        colors = rows[:, [names.index("red"), names.index("green"), names.index("blue")]] / 255.0

    def to_t(x):
        return None if x is None else torch.as_tensor(x.astype(np.float32), device=device)

    return to_t(verts), to_t(normals), to_t(colors)


def save_ply(
    f,
    verts,
    faces=None,
    verts_normals=None,
    ascii: bool = False,
    decimal_places: Optional[int] = None,
    colors=None,
) -> None:
    """Save verts (and faces, normals, colours in [0, 1] as uchar) to .ply,
    binary in the host's byte order unless `ascii`.  `f` may be a path or
    an open binary stream."""
    verts = _to_numpy(verts).astype(np.float32)
    faces = None if faces is None else _to_numpy(faces)
    has_faces = faces is not None and faces.size > 0
    has_norm = verts_normals is not None
    has_col = colors is not None
    header = ["ply"]
    header.append(
        "format ascii 1.0" if ascii else
        ("format binary_little_endian 1.0" if sys.byteorder == "little" else "format binary_big_endian 1.0")
    )
    header.append(f"element vertex {verts.shape[0]}")
    header += ["property float x", "property float y", "property float z"]
    if has_norm:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_col:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if has_faces:
        header.append(f"element face {faces.shape[0]}")
        header.append("property list uchar int vertex_index")
    header.append("end_header")

    cols = [verts]
    if has_norm:
        cols.append(_to_numpy(verts_normals).astype(np.float32))
    vdata = np.concatenate(cols, axis=1)
    cdata = (_to_numpy(colors) * 255).clip(0, 255).astype(np.uint8) if has_col else None
    ctx = contextlib.nullcontext(f) if hasattr(f, "write") else open(str(f), "wb")
    with ctx as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if ascii:
            prec = decimal_places if decimal_places is not None else 6
            for i, row in enumerate(vdata):
                line = " ".join(f"{x:.{prec}f}" for x in row)
                if cdata is not None:
                    line += " " + " ".join(str(int(c)) for c in cdata[i])
                fh.write((line + "\n").encode("ascii"))
            if has_faces:
                for fv in faces:
                    fh.write(("3 " + " ".join(str(int(x)) for x in fv) + "\n").encode())
        else:
            endian = "<" if sys.byteorder == "little" else ">"
            if cdata is None:
                fh.write(vdata.astype(endian + "f4").tobytes())
            else:
                for i, row in enumerate(vdata):
                    fh.write(row.astype(endian + "f4").tobytes())
                    fh.write(cdata[i].tobytes())
            if has_faces:
                for fv in faces:
                    fh.write(_struct.pack(endian + "B", 3))
                    fh.write(fv.astype(endian + "i4").tobytes())
