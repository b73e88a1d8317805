"""Wavefront OBJ/MTL loading.

From-scratch replacement for the reference's assimp import path
(include/model.hpp:22-98, triangulate + uv flip + texture dedup): parses
v/vn/vt/f records (including negative indices and polygon fan
triangulation), per-``usemtl`` material groups, and .mtl files (Kd, Ke, Ns,
map_Kd).  Texture images load through PIL.  Returns mesh dicts compatible
with :class:`pnraytracing_tpu_torch.scene.build.SceneBuilder`.

PyTorch port: a copy of ``pnraytracing_tpu/io/obj.py`` (host numpy code,
the same names and return structures).
"""

from __future__ import annotations

import os

import numpy as np


def load_mtl(path: str) -> dict[str, dict]:
    """Parse a .mtl file into {name: {material fields..., 'map_Kd': path}}."""
    mats: dict[str, dict] = {}
    cur: dict | None = None
    if not os.path.exists(path):
        return mats
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for raw in f:
            parts = raw.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = mats.setdefault(parts[1], {})
            elif cur is None:
                continue
            elif key == "Kd":
                cur["base_color"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ke":
                ke = tuple(float(x) for x in parts[1:4])
                if any(v != 0 for v in ke):
                    cur["emissive"] = ke
            elif key == "Ns":
                # shininess -> rough approximation of roughness
                ns = float(parts[1])
                cur["roughness"] = float(np.clip(np.sqrt(2.0 / (ns + 2.0)), 0.03, 1.0))
            elif key == "map_Kd":
                cur["map_Kd"] = os.path.join(base, parts[-1])
    return mats


def load_texture(path: str) -> np.ndarray | None:
    """Load an LDR texture as [h, w, 3] float32 in [0, 1].

    PNGs decode through the first-party reader (io/png.py, the stb_image
    counterpart); other formats fall back to PIL when available."""
    if not os.path.exists(path):
        return None
    if path.lower().endswith(".png"):
        from pnraytracing_tpu_torch.io.png import read_png_rgb

        return read_png_rgb(path)
    try:
        from PIL import Image
    except ImportError:
        return None
    im = Image.open(path).convert("RGB")
    return np.asarray(im, np.float32) / 255.0


def load_obj(path: str, flip_v: bool = True):
    """Parse an OBJ file.

    Returns a list of (mesh_dict, material_dict, texture_or_None, name)
    groups, one per used material (or one for the whole file if no mtl).
    ``flip_v`` mirrors texture v like the reference's aiProcess_FlipUVs
    (model.hpp:25).
    """
    v_list: list[tuple] = []
    vt_list: list[tuple] = []
    vn_list: list[tuple] = []
    groups: dict[str, list] = {}
    cur_mtl = ""
    mtl_defs: dict[str, dict] = {}
    base = os.path.dirname(path)

    def vidx(tok: str, n: int) -> int:
        i = int(tok)
        return i - 1 if i > 0 else n + i

    with open(path, "r", errors="replace") as f:
        for raw in f:
            parts = raw.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                v_list.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                vt_list.append(tuple(float(x) for x in parts[1:3]))
            elif key == "vn":
                vn_list.append(tuple(float(x) for x in parts[1:4]))
            elif key == "mtllib":
                mtl_defs.update(load_mtl(os.path.join(base, parts[-1])))
            elif key == "usemtl":
                cur_mtl = parts[1]
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = vidx(sub[0], len(v_list))
                    ti = vidx(sub[1], len(vt_list)) if len(sub) > 1 and sub[1] else -1
                    ni = vidx(sub[2], len(vn_list)) if len(sub) > 2 and sub[2] else -1
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    groups.setdefault(cur_mtl, []).append(
                        (corners[0], corners[k], corners[k + 1])
                    )

    out = []
    stem = os.path.splitext(os.path.basename(path))[0]
    for mtl_name, faces in groups.items():
        remap: dict[tuple, int] = {}
        positions, normals, uvs, indices = [], [], [], []
        for tri in faces:
            idxs = []
            for corner in tri:
                if corner not in remap:
                    remap[corner] = len(positions)
                    vi, ti, ni = corner
                    positions.append(v_list[vi])
                    uv = vt_list[ti] if ti >= 0 else (0.0, 0.0)
                    if flip_v:
                        uv = (uv[0], 1.0 - uv[1])
                    uvs.append(uv)
                    normals.append(vn_list[ni] if ni >= 0 else (0.0, 0.0, 0.0))
                idxs.append(remap[corner])
            indices.append(idxs)
        mesh = dict(
            positions=np.asarray(positions, np.float32),
            normals=np.asarray(normals, np.float32),
            uvs=np.asarray(uvs, np.float32),
            indices=np.asarray(indices, np.int32),
        )
        mdef = dict(mtl_defs.get(mtl_name, {}))
        tex = None
        tex_path = mdef.pop("map_Kd", None)
        if tex_path:
            tex = load_texture(tex_path)
        name = f"{stem}:{mtl_name}" if mtl_name else stem
        out.append((mesh, mdef, tex, name))
    return out
