"""Stanford PLY mesh loader (ascii + binary little/big endian).

The reference ingests meshes through assimp (include/model.hpp:25, which
handles PLY among other formats); this is the from-scratch TPU-build
counterpart for the classic scanned assets (Stanford bunny et al. —
BASELINE config 5's "green_bunny-class" scene).  Returns the same mesh-dict
shape as :mod:`pnraytracing_tpu_torch.io.obj` so `SceneBuilder.add` takes the
result directly.

PyTorch port: a copy of ``pnraytracing_tpu/io/ply.py`` (host numpy code,
the same names and return structures).
"""

from __future__ import annotations

import struct

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f):
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # [(name, count, [(prop_name, dtype, list_count_dtype|None)])]
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.decode("ascii", "replace").split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _TYPES[parts[3]], _TYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _TYPES[parts[1]], None))
        elif parts[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}")
    return fmt, elements


def _read_ascii_element(f, count, props):
    rows = []
    for _ in range(count):
        vals = f.readline().split()
        row = {}
        i = 0
        for name, dtype, list_dtype in props:
            if list_dtype is not None:
                n = int(vals[i]); i += 1
                row[name] = np.array(vals[i:i + n], dtype=dtype)
                i += n
            else:
                row[name] = np.array(vals[i], dtype=dtype); i += 1
        rows.append(row)
    return rows


def _read_binary_element(f, count, props, endian):
    # fast path: fixed-size properties only -> one structured read
    if all(ld is None for _, _, ld in props):
        dt = np.dtype([(name, endian + dtype) for name, dtype, _ in props])
        data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
        return data
    rows = []
    for _ in range(count):
        row = {}
        for name, dtype, list_dtype in props:
            if list_dtype is not None:
                ldt = np.dtype(endian + list_dtype)
                n = int(np.frombuffer(f.read(ldt.itemsize), dtype=ldt)[0])
                idt = np.dtype(endian + dtype)
                row[name] = np.frombuffer(f.read(idt.itemsize * n), dtype=idt)
            else:
                idt = np.dtype(endian + dtype)
                row[name] = np.frombuffer(f.read(idt.itemsize), dtype=idt)[0]
        rows.append(row)
    return rows


def _column(rows, name):
    if isinstance(rows, np.ndarray):  # structured fast path
        return np.asarray(rows[name])
    return np.array([r[name] for r in rows])


def load_ply(path: str) -> dict:
    """Load a PLY mesh.

    Returns {"positions" [V,3] f32, "normals" [V,3] f32 (zeros when the
    file has none — shading then falls back to geometric normals, like the
    OBJ path), "uvs" [V,2] f32, "indices" [T,3] i32} with polygon faces
    fan-triangulated (same rule as the OBJ loader / assimp's
    aiProcess_Triangulate); feed directly to ``SceneBuilder.add``."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = "<" if fmt != "binary_big_endian" else ">"
        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data[name] = (_read_ascii_element(f, count, props), props)
            else:
                data[name] = (_read_binary_element(f, count, props, endian), props)

    if "vertex" not in data:
        raise ValueError("PLY has no vertex element")
    vrows, vprops = data["vertex"]
    names = [p[0] for p in vprops]
    positions = np.stack(
        [_column(vrows, c).astype(np.float32) for c in ("x", "y", "z")], axis=-1
    )
    normals = np.zeros_like(positions)
    if all(c in names for c in ("nx", "ny", "nz")):
        normals = np.stack(
            [_column(vrows, c).astype(np.float32) for c in ("nx", "ny", "nz")],
            axis=-1,
        )
    uvs = np.zeros((len(positions), 2), np.float32)
    for ua, va in (("s", "t"), ("u", "v"), ("texture_u", "texture_v")):
        if ua in names and va in names:
            uvs = np.stack(
                [_column(vrows, ua).astype(np.float32),
                 _column(vrows, va).astype(np.float32)], axis=-1,
            )
            break

    tris = []
    if "face" in data:
        frows, fprops = data["face"]
        list_name = next(
            (p[0] for p in fprops if p[2] is not None and
             p[0] in ("vertex_indices", "vertex_index")),
            fprops[0][0],
        )
        for r in frows:
            idx = np.asarray(r[list_name], np.int64)
            for k in range(1, len(idx) - 1):  # fan triangulation
                tris.append((idx[0], idx[k], idx[k + 1]))
    indices = (
        np.asarray(tris, np.int32).reshape(-1, 3)
        if tris else np.zeros((0, 3), np.int32)
    )
    return {
        "positions": positions,
        "normals": normals,
        "uvs": uvs,
        "indices": indices,
    }
