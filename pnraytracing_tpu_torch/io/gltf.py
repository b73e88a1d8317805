"""glTF 2.0 loader (.gltf JSON + external/embedded buffers, and .glb).

The reference ingests models through assimp (include/model.hpp:25), which
covers glTF among other formats; this is the from-scratch counterpart.
Node transforms are composed through the scene graph and returned per
primitive, so `SceneBuilder.add(mesh, material, transform=...)` bakes them
into world space exactly like the reference's `ModelOutput`
(model.hpp:101-135).

Scope: triangle primitives (mode 4 / default), POSITION / NORMAL /
TEXCOORD_0 attributes, u8/u16/u32 indices, pbrMetallicRoughness materials
(baseColorFactor/Texture, metallic/roughness factors, emissiveFactor),
PNG/JPEG textures via PIL.  Sparse accessors, skins, morphs and animations
are out of scope (they have no counterpart in the reference either).

PyTorch port: a copy of ``pnraytracing_tpu/io/gltf.py`` (host numpy code,
the same names and return structures).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


def _load_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB container")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    off = 12
    doc = None
    bin_chunk = None
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8:off + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            doc = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # 'BIN\0'
            bin_chunk = chunk
        off += 8 + clen + ((-clen) % 4)
    if doc is None:
        raise ValueError("GLB has no JSON chunk")
    return doc, bin_chunk


def _buffer_bytes(buf: dict, base_dir: str, bin_chunk: bytes | None) -> bytes:
    uri = buf.get("uri")
    if uri is None:
        if bin_chunk is None:
            raise ValueError("buffer without uri and no GLB BIN chunk")
        return bin_chunk
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _read_accessor(doc, buffers, idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    if "sparse" in acc:
        raise ValueError("sparse accessors not supported")
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
    count = acc["count"]
    if "bufferView" not in acc:
        return np.zeros((count, n_comp), dtype)
    view = doc["bufferViews"][acc["bufferView"]]
    raw = buffers[view["buffer"]]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype.itemsize * n_comp
    if stride == dtype.itemsize * n_comp:
        out = np.frombuffer(
            raw, dtype, count=count * n_comp, offset=start
        ).reshape(count, n_comp)
    else:  # interleaved
        out = np.stack([
            np.frombuffer(
                raw, dtype, count=n_comp, offset=start + i * stride
            ) for i in range(count)
        ])
    out = np.ascontiguousarray(out)
    # Core glTF 2.0 allows normalized integer accessors (u8/u16 TEXCOORD_0,
    # COLOR_0, s8/s16 in extensions): raw counts map to [0,1] / [-1,1]
    # (spec 3.6.2.2), not to raw float casts.
    if acc.get("normalized") and out.dtype.kind in ("u", "i"):
        info = np.iinfo(out.dtype)
        if out.dtype.kind == "u":
            out = out.astype(np.float32) / np.float32(info.max)
        else:
            out = np.maximum(
                out.astype(np.float32) / np.float32(info.max), -1.0
            )
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]) @ m
    if "rotation" in node:  # quaternion (x, y, z, w)
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        rm = np.eye(4)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def _load_image(doc, buffers, base_dir, tex_index) -> np.ndarray | None:
    try:
        from PIL import Image
    except ImportError:
        return None
    import io as _io

    img_def = doc["images"][doc["textures"][tex_index]["source"]]
    if "uri" in img_def:
        uri = img_def["uri"]
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            p = os.path.join(base_dir, uri)
            if not os.path.exists(p):
                return None
            with open(p, "rb") as f:
                data = f.read()
    else:
        view = doc["bufferViews"][img_def["bufferView"]]
        raw = buffers[view["buffer"]]
        start = view.get("byteOffset", 0)
        data = raw[start:start + view["byteLength"]]
    im = Image.open(_io.BytesIO(data)).convert("RGB")
    return np.asarray(im, np.float32) / 255.0


def _material(doc, buffers, base_dir, idx):
    """glTF pbrMetallicRoughness -> Disney-parameter dict + texture."""
    if idx is None or "materials" not in doc:
        return {}, None, None
    m = doc["materials"][idx]
    pbr = m.get("pbrMetallicRoughness", {})
    out = {}
    bc = pbr.get("baseColorFactor", [1, 1, 1, 1])
    out["base_color"] = tuple(bc[:3])
    out["metallic"] = float(pbr.get("metallicFactor", 1.0))
    out["roughness"] = float(pbr.get("roughnessFactor", 1.0))
    em = m.get("emissiveFactor", [0, 0, 0])
    if any(v != 0 for v in em):
        out["emissive"] = tuple(em)
    tex = None
    tex_key = None
    if "baseColorTexture" in pbr:
        ti = pbr["baseColorTexture"]["index"]
        tex = _load_image(doc, buffers, base_dir, ti)
        tex_key = f"gltf_tex{ti}"
    return out, tex, tex_key


def load_gltf(path: str):
    """Load a .gltf/.glb file.

    Returns a list of (mesh_dict, material_dict, texture_or_None, name,
    world_transform_4x4) tuples, one per mesh primitive reachable from the
    default scene — the same group shape as :func:`io.obj.load_obj` plus
    the composed node transform.
    """
    base_dir = os.path.dirname(path)
    with open(path, "rb") as f:
        head = f.read()
    if head[:4] == b"glTF":
        doc, bin_chunk = _load_glb(head)
    else:
        doc = json.loads(head.decode("utf-8"))
        bin_chunk = None
    buffers = [
        _buffer_bytes(b, base_dir, bin_chunk) for b in doc.get("buffers", [])
    ]

    out = []
    scene_idx = doc.get("scene", 0)
    roots = (
        doc["scenes"][scene_idx]["nodes"]
        if doc.get("scenes") else range(len(doc.get("nodes", [])))
    )

    def visit(node_idx: int, parent_m: np.ndarray):
        node = doc["nodes"][node_idx]
        m = parent_m @ _node_matrix(node)
        if "mesh" in node:
            mesh_def = doc["meshes"][node["mesh"]]
            mesh_name = mesh_def.get("name", f"mesh{node['mesh']}")
            for pi, prim in enumerate(mesh_def.get("primitives", [])):
                if prim.get("mode", 4) != 4:
                    continue  # triangles only
                attrs = prim["attributes"]
                pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(
                    np.float32
                )
                nrm = (
                    _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                    if "NORMAL" in attrs else np.zeros_like(pos)
                )
                uv = (
                    _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(
                        np.float32
                    )[:, :2]
                    if "TEXCOORD_0" in attrs
                    else np.zeros((len(pos), 2), np.float32)
                )
                if "indices" in prim:
                    idx = _read_accessor(doc, buffers, prim["indices"])
                    idx = idx.reshape(-1).astype(np.int64).reshape(-1, 3)
                else:
                    idx = np.arange(len(pos), dtype=np.int64).reshape(-1, 3)
                mat, tex, tex_key = _material(
                    doc, buffers, base_dir, prim.get("material")
                )
                mesh = dict(
                    positions=pos,
                    normals=nrm,
                    uvs=uv,
                    indices=idx.astype(np.int32),
                )
                name = f"{mesh_name}:{pi}" if pi else mesh_name
                out.append((mesh, mat, tex, name, m.copy(), tex_key))
        for child in node.get("children", []):
            visit(child, m)

    for r in roots:
        visit(r, np.eye(4))
    return out


def add_gltf_to_builder(builder, path: str):
    """Convenience: load a glTF file and register every primitive on a
    :class:`SceneBuilder` with its world transform."""
    for mesh, mat, tex, name, m, tex_key in load_gltf(path):
        builder.add(mesh, mat, name=name, transform=m, texture=tex,
                    texture_key=tex_key)
    return builder
