"""Binary FBX (Kaydara 7.x) mesh loader.

The reference imports FBX through the closed assimp binary
(include/model.hpp:25, `lib/assimp-vc143-mt.lib`); this is a from-scratch
reader of the documented binary container: a tree of node records
(EndOffset/NumProperties/PropertyListLen/Name) with typed properties,
array properties optionally zlib-deflated (stdlib ``zlib``).

Scope: `Objects/Geometry` meshes — `Vertices`, `PolygonVertexIndex`
(negative index = last corner of a polygon, XOR'd with -1),
`LayerElementNormal` / `LayerElementUV` with the common mapping modes
(`ByPolygonVertex`, `ByVertice`/`ByVertex`, with `Direct` or
`IndexToDirect` referencing) — plus per-model local transforms
(the FULL pivot chain: `Lcl Translation/Rotation/Scaling`,
`PreRotation`/`PostRotation`, rotation/scaling pivots + offsets, and the
`RotationOrder` property — the FBX SDK composition assimp evaluates)
wired to geometries through the `Connections` section.  ASCII FBX files
parse through the same document model (`_parse_ascii`).  Skins,
animation and embedded media are out of scope.

Polygons are fan-triangulated like the OBJ/PLY paths (assimp's
aiProcess_Triangulate).  Returns `(mesh_dict, material_dict, None, name,
transform)` tuples compatible with `SceneBuilder.add`.

PyTorch port: a copy of ``pnraytracing_tpu/io/fbx.py`` (host numpy code,
the same names and return structures).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"Kaydara FBX Binary  \x00"

_ARRAY_TYPES = {
    b"f": np.dtype("<f4"),
    b"d": np.dtype("<f8"),
    b"l": np.dtype("<i8"),
    b"i": np.dtype("<i4"),
    b"b": np.dtype("<i1"),
}
_SCALAR_FMT = {
    b"Y": "<h", b"C": "<b", b"I": "<i", b"F": "<f", b"D": "<d", b"L": "<q",
}


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props):
        self.name = name
        self.props = props
        self.children = []

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_property(buf, off):
    code = buf[off:off + 1]
    off += 1
    if code in _SCALAR_FMT:
        fmt = _SCALAR_FMT[code]
        size = struct.calcsize(fmt)
        val = struct.unpack_from(fmt, buf, off)[0]
        return val, off + size
    if code in (b"S", b"R"):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        raw = buf[off:off + n]
        return (raw.decode("utf-8", "replace") if code == b"S" else raw), off + n
    if code in _ARRAY_TYPES:
        length, encoding, comp_len = struct.unpack_from("<III", buf, off)
        off += 12
        dt = _ARRAY_TYPES[code]
        if encoding == 0:
            raw = buf[off:off + length * dt.itemsize]
            off += length * dt.itemsize
        else:
            raw = zlib.decompress(buf[off:off + comp_len])
            off += comp_len
        return np.frombuffer(raw, dt, count=length), off
    raise ValueError(f"unknown FBX property type {code!r}")


def _read_node(buf, off, long_offsets):
    if long_offsets:
        end, n_props, _plen = struct.unpack_from("<QQQ", buf, off)
        off += 24
    else:
        end, n_props, _plen = struct.unpack_from("<III", buf, off)
        off += 12
    (name_len,) = struct.unpack_from("<B", buf, off)
    off += 1
    if end == 0 and n_props == 0 and name_len == 0:
        return None, off  # NULL terminator record
    name = buf[off:off + name_len].decode("ascii", "replace")
    off += name_len
    props = []
    for _ in range(n_props):
        val, off = _read_property(buf, off)
        props.append(val)
    node = _Node(name, props)
    while off < end:
        child, off = _read_node(buf, off, long_offsets)
        if child is None:
            break
        node.children.append(child)
    return node, max(off, end)


def _parse(buf: bytes) -> tuple[list[_Node], int]:
    if buf[: len(_MAGIC)] != _MAGIC:
        # ASCII FBX: same document model, text syntax (assimp reads
        # both; model.hpp:25)
        return _parse_ascii(buf.decode("utf-8", "replace")), 0
    (version,) = struct.unpack_from("<I", buf, 23)
    long_offsets = version >= 7500
    off = 27
    roots = []
    while off < len(buf):
        node, off = _read_node(buf, off, long_offsets)
        if node is None:
            break
        roots.append(node)
    return roots, version


_ASCII_TOKEN = None  # compiled lazily


def _ascii_tokens(text: str):
    import re

    global _ASCII_TOKEN
    if _ASCII_TOKEN is None:
        _ASCII_TOKEN = re.compile(
            r'"(?:[^"\\]|\\.)*"'      # quoted string
            r"|[A-Za-z_][A-Za-z0-9_]*\s*:"  # node/property name
            r"|\{|\}|,"
            r"|\*\d+"                  # array-length marker
            r"|[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?"  # number
            r"|[A-Za-z_][A-Za-z0-9_|]*"  # bare word (enums like Y, W)
        )
    for line in text.splitlines():
        body = line.split(";", 1)[0]  # ';' starts a comment
        for m in _ASCII_TOKEN.finditer(body):
            yield m.group(0)


def _parse_ascii(text: str) -> list[_Node]:
    """ASCII FBX (7.x) -> the same ``_Node`` tree as the binary parser.

    Grammar: ``Name: v, v, ... {  children  }``; FBX 7 arrays appear as
    ``Name: *N { a: n,n,... }`` and are collapsed to a single numpy
    array property, matching the binary form so ``_geometry_mesh`` and
    ``_props70`` work unchanged."""
    toks = list(_ascii_tokens(text))
    pos = 0

    def parse_value(tok):
        if tok.startswith('"'):
            return tok[1:-1]
        try:
            if any(c in tok for c in ".eE") and not tok.lstrip("+-")[:1].isalpha():
                return float(tok)
            return int(tok)
        except ValueError:
            return tok  # bare word (enum)

    def parse_nodes(depth=0):
        nonlocal pos
        nodes = []
        while pos < len(toks):
            tok = toks[pos]
            if tok == "}":
                pos += 1
                return nodes
            if not tok.endswith(":"):
                pos += 1  # stray token — skip defensively
                continue
            name = tok[:-1].strip()
            pos += 1
            props = []
            arr_len = None
            while pos < len(toks):
                t = toks[pos]
                if t == ",":
                    pos += 1
                    continue
                if t == "{" or t == "}" or t.endswith(":"):
                    break
                if t.startswith("*"):
                    arr_len = int(t[1:])
                    pos += 1
                    continue
                props.append(parse_value(t))
                pos += 1
            node = _Node(name, props)
            if pos < len(toks) and toks[pos] == "{":
                pos += 1
                node.children = parse_nodes(depth + 1)
            if arr_len is not None:
                # collapse the `a:` child into one array property
                a = node.first("a")
                vals = a.props if a is not None else node.props
                arr = np.asarray(vals, np.float64)
                node.props = [arr]
                node.children = []
            nodes.append(node)
        return nodes

    return parse_nodes()


def _layer_values(geom, layer_name, value_name, index_name, n_corners,
                  poly_vertex_index, width):
    """Resolve a layer element to per-corner values [n_corners, width]."""
    layer = geom.first(layer_name)
    if layer is None:
        return None
    mapping = ""
    ref = "Direct"
    values = None
    indices = None
    for c in layer.children:
        if c.name == "MappingInformationType":
            mapping = c.props[0]
        elif c.name == "ReferenceInformationType":
            ref = c.props[0]
        elif c.name == value_name:
            values = np.asarray(c.props[0], np.float64).reshape(-1, width)
        elif c.name == index_name:
            indices = np.asarray(c.props[0], np.int64)
    if values is None:
        return None
    if ref == "IndexToDirect" and indices is not None:
        values = values[np.clip(indices, 0, len(values) - 1)]
    if mapping == "ByPolygonVertex":
        if len(values) < n_corners:
            # truncated/malformed layer: surface it and fall back to
            # geometric normals / zero UVs rather than misalign downstream
            import warnings

            warnings.warn(
                f"FBX {layer_name}: {len(values)} ByPolygonVertex values "
                f"for {n_corners} corners; ignoring layer"
            )
            return None
        return values[:n_corners]
    if mapping in ("ByVertice", "ByVertex"):
        ctrl = np.where(poly_vertex_index < 0, ~poly_vertex_index,
                        poly_vertex_index)
        if len(values) <= int(ctrl.max(initial=0)):
            import warnings

            warnings.warn(
                f"FBX {layer_name}: {len(values)} ByVertex values for "
                f"control point index {int(ctrl.max(initial=0))}; "
                "ignoring layer"
            )
            return None
        return values[np.clip(ctrl, 0, len(values) - 1)]
    if mapping == "AllSame":
        return np.broadcast_to(values[0], (n_corners, width)).copy()
    return None


def _geometry_mesh(geom) -> dict | None:
    v_node = geom.first("Vertices")
    i_node = geom.first("PolygonVertexIndex")
    if v_node is None or i_node is None:
        return None
    ctrl_points = np.asarray(v_node.props[0], np.float64).reshape(-1, 3)
    pvi = np.asarray(i_node.props[0], np.int64)
    n_corners = len(pvi)
    corner_ctrl = np.where(pvi < 0, ~pvi, pvi)

    normals = _layer_values(
        geom, "LayerElementNormal", "Normals", "NormalsIndex",
        n_corners, pvi, 3,
    )
    uvs = _layer_values(
        geom, "LayerElementUV", "UV", "UVIndex", n_corners, pvi, 2
    )

    # fan-triangulate: polygons end at negative (XOR'd) indices
    tris = []
    poly_start = 0
    for k in range(n_corners):
        if pvi[k] < 0:  # last corner of this polygon
            for m in range(poly_start + 1, k):
                tris.append((poly_start, m, m + 1))
            poly_start = k + 1
    tris = np.asarray(tris, np.int64).reshape(-1, 3)

    # corners are already per-polygon-vertex: emit one vertex per corner
    positions = ctrl_points[corner_ctrl].astype(np.float32)
    mesh = dict(
        positions=positions,
        normals=(normals.astype(np.float32) if normals is not None
                 else np.zeros_like(positions)),
        uvs=(uvs.astype(np.float32) if uvs is not None
             else np.zeros((n_corners, 2), np.float32)),
        indices=tris.astype(np.int32),
    )
    return mesh


def _props70(node) -> dict:
    out = {}
    p70 = node.first("Properties70")
    if p70 is None:
        return out
    for p in p70.find("P"):
        key = p.props[0]
        out[key] = p.props[4:]
    return out


def _rot_axis(axis: int, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    r = np.eye(4)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    r[i, i] = c
    r[j, j] = c
    r[i, j] = -s if axis != 1 else s
    r[j, i] = s if axis != 1 else -s
    return r


# RotationOrder enum -> application order (first-applied first); the
# matrix product is last-applied @ ... @ first-applied
_ROT_ORDERS = {
    0: (0, 1, 2),  # eOrderXYZ (default)
    1: (0, 2, 1),  # eOrderXZY
    2: (1, 2, 0),  # eOrderYZX
    3: (1, 0, 2),  # eOrderYXZ
    4: (2, 0, 1),  # eOrderZXY
    5: (2, 1, 0),  # eOrderZYX
}


def _euler(p, key, order=(0, 1, 2)) -> np.ndarray:
    if key not in p:
        return np.eye(4)
    ang = np.radians(np.asarray(p[key], np.float64))
    m = np.eye(4)
    for axis in order:  # first-applied first -> left-multiply
        m = _rot_axis(axis, ang[axis]) @ m
    return m


def _trans(vec) -> np.ndarray:
    t = np.eye(4)
    t[:3, 3] = np.asarray(vec, np.float64)
    return t


def _model_transform(model) -> np.ndarray:
    """Full FBX local-transform chain (the FBX SDK's documented
    "Transformation" composition — what assimp evaluates for the
    reference, model.hpp:25):

      L = T * Roff * Rp * Rpre * R * Rpost^-1 * Rp^-1
            * Soff * Sp * S * Sp^-1

    with rotation/scaling PIVOTS and OFFSETS, PRE/POST rotations (both
    always XYZ order per the SDK) and the RotationOrder property for
    the Lcl Rotation itself.  Files without pivot properties reduce to
    the plain T*R*S of round 2."""
    p = _props70(model)
    order = _ROT_ORDERS.get(
        int(np.asarray(p.get("RotationOrder", [0]))[0]), (0, 1, 2)
    )

    t = _trans(p.get("Lcl Translation", (0.0, 0.0, 0.0)))
    r_off = _trans(p.get("RotationOffset", (0.0, 0.0, 0.0)))
    r_p = _trans(p.get("RotationPivot", (0.0, 0.0, 0.0)))
    r_pre = _euler(p, "PreRotation")  # always XYZ
    r = _euler(p, "Lcl Rotation", order)
    r_post_inv = np.linalg.inv(_euler(p, "PostRotation"))
    r_p_inv = np.linalg.inv(r_p)
    s_off = _trans(p.get("ScalingOffset", (0.0, 0.0, 0.0)))
    s_p = _trans(p.get("ScalingPivot", (0.0, 0.0, 0.0)))
    s = np.diag(
        list(np.asarray(p.get("Lcl Scaling", (1.0, 1.0, 1.0)),
                        np.float64)) + [1.0]
    )
    s_p_inv = np.linalg.inv(s_p)
    return (t @ r_off @ r_p @ r_pre @ r @ r_post_inv @ r_p_inv
            @ s_off @ s_p @ s @ s_p_inv)


def load_fbx(path: str):
    """Load a binary FBX file.

    Returns a list of (mesh_dict, material_dict, None, name,
    world_transform_4x4) tuples, one per geometry, with its connected
    model's local transform applied (parent chains composed)."""
    with open(path, "rb") as f:
        buf = f.read()
    roots, _version = _parse(buf)
    by_name = {n.name: n for n in roots}
    objects = by_name.get("Objects")
    if objects is None:
        return []

    geoms = {}
    models = {}
    for node in objects.children:
        if node.name == "Geometry":
            gid = int(node.props[0])
            mesh = _geometry_mesh(node)
            if mesh is not None:
                geoms[gid] = (mesh, node)
        elif node.name == "Model":
            models[int(node.props[0])] = node

    # connections: child id -> parent id
    parents: dict[int, list[int]] = {}
    conn = by_name.get("Connections")
    if conn is not None:
        for c in conn.find("C"):
            if len(c.props) >= 3 and c.props[0] == "OO":
                parents.setdefault(int(c.props[1]), []).append(int(c.props[2]))

    def world_of(model_id, depth=0):
        if depth > 64 or model_id not in models:
            return np.eye(4)
        local = _model_transform(models[model_id])
        for par in parents.get(model_id, []):
            if par in models:
                return world_of(par, depth + 1) @ local
        return local

    def clean(n):
        # binary: "name\x00\x01Class"; ascii: "Class::name"
        n = n.split("\x00")[0]
        if "::" in n:
            n = n.split("::", 1)[1]
        return n

    out = []
    for gid, (mesh, node) in geoms.items():
        name = "geometry"
        if len(node.props) >= 2 and isinstance(node.props[1], str):
            name = clean(node.props[1]) or name
        transform = np.eye(4)
        for par in parents.get(gid, []):
            if par in models:
                transform = world_of(par)
                mdl_name = models[par].props[1] if len(models[par].props) > 1 else ""
                if isinstance(mdl_name, str) and mdl_name:
                    name = clean(mdl_name) or name
                break
        out.append((mesh, {}, None, name, transform))
    return out
