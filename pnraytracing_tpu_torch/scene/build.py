"""Scene assembly on the host: model flattening, BVH build, light list,
environment tables and the traversal layout.

PyTorch counterpart of ``pnraytracing_tpu/scene/build.py``
(model.hpp:101-135, BVH.hpp:16-19, main.cpp:374-383).  The arithmetic is
the JAX package's numpy code, so both packages build identical arrays;
the result lives on ``device`` as tensors.  The layout packs only what
this port's traversal reads (``accel/layout.py::TravData``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pnraytracing_tpu_torch.accel.bricks import (
    build_stream_data,
    treelet_cut_aabbs,
    treelet_index_tree,
)
from pnraytracing_tpu_torch.accel.layout import (
    MAX_PACKED_LEAF,
    MAX_PACKED_NODES,
    MAX_PACKED_TRIS,
    TravData,
    pack_nodes8,
    pack_tri12,
    pack_tri_attr16,
    pack_wide_nodes_compact,
)
from pnraytracing_tpu_torch.accel.native import bvh_builder
from pnraytracing_tpu_torch.accel.route import scene_fits_smem
from pnraytracing_tpu_torch.core.camera import resolve_device
from pnraytracing_tpu_torch.core.types import (
    BVH,
    Lights,
    Materials,
    Scene,
    TriangleMesh,
)
from pnraytracing_tpu_torch.ops.envmap import build_envmap
from pnraytracing_tpu_torch.ops.texture import build_atlas


def pack_traversal(built, positions: np.ndarray, normals: np.ndarray,
                   uvs: np.ndarray, idx_o: np.ndarray, mat_o: np.ndarray,
                   tex_o: np.ndarray, mesh: TriangleMesh, dev) -> TravData:
    """The traversal layout of a built BVH on ``dev``: ``idx_o``,
    ``mat_o``, ``tex_o`` are the triangle arrays in its leaf order,
    ``mesh`` the scene's mesh (the bricks read it).  A scene too large
    for the resident kernels (accel/route.py) also gets the
    brick-streaming layout, under the JAX package's condition.  Raises
    for a tree outside the packed layout."""
    max_count = int((built.end - built.start)[built.right_child == -1]
                    .max())
    if (max_count > MAX_PACKED_LEAF or len(built.start) > MAX_PACKED_NODES
            or len(idx_o) > MAX_PACKED_TRIS):
        raise ValueError(
            f"scene exceeds the packed traversal layout (leaf of "
            f"{max_count} triangles, {len(built.start)} nodes, "
            f"{len(idx_o)} triangles)")
    t = lambda a: torch.as_tensor(np.array(a), device=dev)
    tri9 = positions[idx_o].reshape(len(idx_o), 9)
    treelets = treelet_cut_aabbs(built)
    trav = TravData(
        tri9=t(tri9),
        tri12=t(pack_tri12(tri9)),
        nodes8=t(pack_nodes8(built)),
        nodes16c=t(pack_wide_nodes_compact(built)),
        tri_attr16=t(pack_tri_attr16(positions, normals, uvs, idx_o, mat_o,
                                     tex_o)),
        treelets=t(treelets),
        treelet_tree=t(treelet_index_tree(treelets)),
        bvh_depth=built.max_depth,
    )
    if not scene_fits_smem(trav, "binary"):
        trav.stream = build_stream_data(built, mesh, device=dev)
    return trav


@dataclasses.dataclass
class ModelEntry:
    name: str
    mesh: dict  # positions/normals/uvs/indices (numpy)
    material: dict
    transform: Optional[np.ndarray]  # 4x4 or None
    texture: Optional[np.ndarray] = None  # [h, w, 3] base color
    texture_key: Optional[str] = None  # models sharing a key share it


class SceneBuilder:
    """Accumulates models, then flattens them into one :class:`Scene`."""

    def __init__(self):
        self.entries: list[ModelEntry] = []

    def add(self, mesh: dict, material: dict, name: str | None = None,
            transform: np.ndarray | None = None,
            texture: np.ndarray | None = None,
            texture_key: str | None = None) -> "SceneBuilder":
        """Register a model (``Model(path, modelMatrix, material, name)``,
        model.hpp:22), optionally with a base-color ``texture``; models
        with the same ``texture_key`` (default: the model's name) share
        one texture of the atlas."""
        self.entries.append(ModelEntry(
            name=name or f"model{len(self.entries)}",
            mesh=mesh,
            material=dict(material),
            transform=(None if transform is None
                       else np.asarray(transform, np.float64)),
            texture=texture,
            texture_key=texture_key or (name if texture is not None
                                        else None),
        ))
        return self

    def build(self, max_leaf_size: int = 4,
              env_image: np.ndarray | None = None, env_constant=None,
              use_native_builder: bool | None = None,
              device=None) -> Scene:
        """Flatten, build the BVH, light list, environment tables, texture
        atlas and traversal layout; the result lives on ``device`` (None =
        cuda).  ``use_native_builder`` as in the JAX package: None takes
        the C++ SAH builder when g++ exists (``accel/native.py``), True
        requires it, False takes the numpy one (which may split SAH ties
        otherwise: the trees of the two packages' builders of one kind
        are equal).
        A scene too large for the resident route (accel/route.py) also
        gets the brick-streaming layout (accel/bricks.py)."""
        dev = resolve_device(device)
        positions, normals, uvs = [], [], []
        indices, mat_ids, tex_ids = [], [], []
        materials: list[dict] = []
        textures: list[np.ndarray] = []
        tex_key_to_id: dict[str, int] = {}
        v_off = 0
        for e in self.entries:
            mat_id = len(materials)
            materials.append(e.material)
            tex_id = -1
            if e.texture is not None:
                if e.texture_key not in tex_key_to_id:
                    tex_key_to_id[e.texture_key] = len(textures)
                    textures.append(np.asarray(e.texture, np.float32))
                tex_id = tex_key_to_id[e.texture_key]
            pos = np.asarray(e.mesh["positions"], np.float64)
            nrm = np.asarray(e.mesh["normals"], np.float64)
            tuv = np.asarray(e.mesh["uvs"], np.float32)
            idx = np.asarray(e.mesh["indices"], np.int64)
            if e.transform is not None:
                m = e.transform
                pos = pos @ m[:3, :3].T + m[:3, 3]
                # normal matrix = transpose(inverse(M)) (model.hpp:104-112)
                n_mat = np.linalg.inv(m[:3, :3]).T
                nz = np.any(nrm != 0, axis=1)
                nrm = nrm @ n_mat.T
                norms = np.linalg.norm(nrm, axis=1, keepdims=True)
                nrm = np.where(nz[:, None], nrm / np.maximum(norms, 1e-20),
                               0.0)
            positions.append(pos.astype(np.float32))
            normals.append(nrm.astype(np.float32))
            uvs.append(tuv)
            indices.append(idx + v_off)
            mat_ids.append(np.full(len(idx), mat_id, np.int32))
            tex_ids.append(np.full(len(idx), tex_id, np.int32))
            v_off += len(pos)

        positions = np.concatenate(positions)
        normals = np.concatenate(normals)
        uvs = np.concatenate(uvs)
        indices = np.concatenate(indices).astype(np.int32)
        mat_ids = np.concatenate(mat_ids)
        tex_ids = np.concatenate(tex_ids)

        # triangle areas (model.hpp:128)
        p = positions[indices].astype(np.float64)
        areas = 0.5 * np.linalg.norm(
            np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1)

        built = bvh_builder(use_native_builder)(
            positions, indices, max_leaf_size=max_leaf_size)
        order = built.order
        idx_o = indices[order]
        t = lambda a, dt=None: torch.as_tensor(np.array(a, dt), device=dev)
        mesh = TriangleMesh(
            positions=t(positions),
            normals=t(normals),
            tangents=t(np.zeros_like(positions)),
            bitangents=t(np.zeros_like(positions)),
            uvs=t(uvs),
            indices=t(idx_o),
            material_id=t(mat_ids[order]),
            texture_id=t(tex_ids[order]),
            area=t(areas[order], np.float32),
        )
        bvh = BVH(
            node_min=t(built.node_min), node_max=t(built.node_max),
            axis=t(built.axis), right_child=t(built.right_child),
            start=t(built.start), end=t(built.end),
        )

        # emissive light list (main.cpp:374-383)
        emissive = np.stack([
            np.asarray(m.get("emissive", (0.0, 0.0, 0.0)), np.float32)
            for m in materials])
        is_light = np.any(emissive[mat_ids[order]] != 0.0, axis=1)
        light_idx = np.nonzero(is_light)[0].astype(np.int32)
        prefix = np.cumsum(areas[order][light_idx]).astype(np.float32)
        lights = Lights(
            tri_index=t(light_idx),
            prefix_area=t(prefix),
            total_area=t(np.float32(prefix[-1] if len(prefix) else 0.0)),
        )

        trav = pack_traversal(built, positions, normals, uvs, idx_o,
                              mat_ids[order], tex_ids[order], mesh, dev)

        return Scene(
            mesh=mesh,
            materials=Materials.stack(materials, device=dev),
            bvh=bvh,
            lights=lights,
            env=(build_envmap(env_image, alias=True, device=dev)
                 if env_image is not None else None),
            textures=build_atlas(textures, device=dev),
            trav=trav,
            env_constant=(t(env_constant, np.float32)
                          if env_constant is not None else None),
            bvh_depth=built.max_depth,
        )
