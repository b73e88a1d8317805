"""Traversal layout: the rows the traversal kernels read.

PyTorch counterpart of the parts of ``pnraytracing_tpu/accel/layout.py``
that the wide walk uses.  Built on the host in numpy at scene build and
then moved to the device as tensors:

* ``tri9``       [T, 9]  f32 — the three corner positions per triangle;
* ``tri12``      [T, 12] f32 — ``tri9`` padded with three zeros to a
  16-byte aligned 48-byte row, which the resident wide kernels read as
  three ``float4`` (:func:`pack_tri12`);
* ``nodes8``     [N, 8]  f32 — one row per node of the flat BVH for the
  binary pop-test walk: min, max, enc(right*4 + axis), enc(start*16 +
  count) (:func:`pack_nodes8`);
* ``nodes16c``   [N, 16] f32 — one row per INTERNAL node: both children's
  AABBs, the encoded child infos and the split axis
  (:func:`pack_wide_nodes_compact`);
* ``tri_attr16`` [T, 16] f32 — corner shading normals, corner uvs and the
  encoded material/texture word (:func:`pack_tri_attr16`);
* ``treelets``   [K, 6]  f32 — treelet AABBs for the coherence sort key
  (accel/bricks.py::treelet_cut_aabbs); None in a scene carried over
  from one without them, which then sorts by the 'pos' key as in the
  JAX package;
* ``treelet_tree`` [2P, 8] f32 — the implicit binary tree of unions over
  the index ranges of ``treelets`` that the key kernel walks
  (accel/bricks.py::treelet_index_tree; made from ``treelets`` alone;
  None without them);
* ``stream``     the brick-streaming layout (accel/bricks.py::StreamData)
  of a scene too large for the resident route (accel/route.py), else
  None.

Topology is stored as exact small-integer floats: a child info ``>= 0``
is an internal child's row id, ``< 0`` a leaf ``-(start*16 + count) - 1``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from pnraytracing_tpu_torch.core.types import _Movable

if TYPE_CHECKING:
    from pnraytracing_tpu_torch.accel.bricks import StreamData

_COUNT_BASE = 16  # count in the low base-16 digit of enc(start, count)
_AXIS_BASE = 4  # axis in the low base-4 digit of enc(right, axis)
MAX_PACKED_LEAF = _COUNT_BASE - 1  # 15 triangles
MAX_PACKED_NODES = 1 << 22  # right*4+axis must stay < 2^24 (exact f32)
MAX_PACKED_TRIS = 1 << 20  # start*16+count must stay < 2^24 (exact f32)

# encoded material/texture word of the attribute rows: mat*4096+(tex+1),
# exact in f32 for mat < 4096 and tex < 4095 (tex -1 = untextured)
ATTR_TEX_BASE = 4096


@dataclasses.dataclass
class TravData(_Movable):
    tri9: torch.Tensor  # [T, 9] f32
    tri12: torch.Tensor  # [T, 12] f32: tri9, zero-padded
    nodes8: torch.Tensor  # [N, 8] f32
    nodes16c: torch.Tensor  # [N_internal, 16] f32
    tri_attr16: torch.Tensor  # [T, 16] f32
    treelets: torch.Tensor | None  # [K, 6] f32
    treelet_tree: torch.Tensor | None  # [2P, 8] f32 union tree over treelets
    bvh_depth: int  # max node depth (root = 1); bounds the walk's stack
    stream: StreamData | None = None


def pack_tri12(tri9: np.ndarray) -> np.ndarray:
    """[T, 12] rows ``[v0(3), v1(3), v2(3), 0, 0, 0]`` holding exactly the
    values of ``tri9`` [T, 9]."""
    tri9 = np.asarray(tri9, np.float32)
    out = np.zeros((tri9.shape[0], 12), np.float32)
    out[:, :9] = tri9
    return out


def pack_nodes8(built) -> np.ndarray:
    """[N, 8] binary node rows from the host BVHArrays, as
    ``pnraytracing_tpu/accel/layout.py::pack_traversal_data`` packs them:
    ``[min(3), max(3), enc(right*4 + axis) (-1 for a leaf),
    enc(start*16 + min(count, 15))]``."""
    right = np.asarray(built.right_child, np.int64)
    axis = np.maximum(np.asarray(built.axis, np.int64), 0)
    start = np.asarray(built.start, np.int64)
    count = np.asarray(built.end, np.int64) - start
    enc_right = np.where(right >= 0, right * _AXIS_BASE + axis, -1)
    enc_meta = start * _COUNT_BASE + np.minimum(count, MAX_PACKED_LEAF)
    return np.concatenate([
        np.asarray(built.node_min, np.float32),
        np.asarray(built.node_max, np.float32),
        enc_right.astype(np.int32).astype(np.float32)[:, None],
        enc_meta.astype(np.int32).astype(np.float32)[:, None],
    ], axis=1)


def pack_wide_nodes_compact(built) -> np.ndarray:
    """Internal-only wide rows from the host BVHArrays: per internal node
    ``[lmin(3), lmax(3), rmin(3), rmax(3), left_info, right_info, axis,
    pad]`` with internal child infos as COMPACT row ids.  A leaf root
    gets one synthetic row (left = the leaf, right = an empty leaf)."""
    right = np.asarray(built.right_child, np.int64)
    node_min = np.asarray(built.node_min, np.float32)
    node_max = np.asarray(built.node_max, np.float32)
    axis = np.asarray(built.axis, np.int64)
    start = np.asarray(built.start, np.int64)
    end = np.asarray(built.end, np.int64)
    is_leaf = right < 0
    count = end - start
    meta = start * _COUNT_BASE + np.minimum(count, MAX_PACKED_LEAF)
    leaf_info = (-meta - 1).astype(np.int64)

    if bool(is_leaf[0]):
        row = np.zeros((1, 16), np.float32)
        row[0, 0:3] = node_min[0]
        row[0, 3:6] = node_max[0]
        row[0, 6:9] = 3e38
        row[0, 9:12] = -3e38
        row[0, 12] = float(leaf_info[0])
        row[0, 13] = float(-1)  # empty leaf: meta 0
        return row

    internal = np.nonzero(~is_leaf)[0]
    row_of = np.cumsum(~is_leaf) - (~is_leaf)  # exclusive scan
    lc = internal + 1
    rc = right[internal]
    info = np.where(is_leaf, leaf_info, row_of)
    rows = np.zeros((len(internal), 16), np.float32)
    rows[:, 0:3] = node_min[lc]
    rows[:, 3:6] = node_max[lc]
    rows[:, 6:9] = node_min[rc]
    rows[:, 9:12] = node_max[rc]
    rows[:, 12] = info[lc].astype(np.float32)
    rows[:, 13] = info[rc].astype(np.float32)
    rows[:, 14] = np.maximum(axis[internal], 0).astype(np.float32)
    return rows


def pack_tri_attr16(positions: np.ndarray, normals: np.ndarray,
                    uvs: np.ndarray, indices: np.ndarray,
                    material_id: np.ndarray,
                    texture_id: np.ndarray) -> np.ndarray:
    """[T, 16] per-triangle shading attributes: corner shading normals (9;
    a triangle with any all-zero corner normal gets the geometric normal
    at every corner, mirroring make_interaction's fallback), corner uvs
    (6), enc(mat, tex) (1).  ``indices`` are in BVH leaf order."""
    t = indices.shape[0]
    p = positions[indices]  # [T, 3, 3]
    n = normals[indices]  # [T, 3, 3]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    # The JAX package bakes this table with XLA on the CPU, which
    # contracts a*b + c into an FMA; evaluating a*b + c in float64 (the
    # product of two f32 is exact there) and rounding once to f32 gives
    # the same bits, so both packages build an identical table.
    fma = lambda a, b, c: (a.astype(np.float64) * b + c).astype(np.float32)
    gn = np.stack([
        fma(e1[:, 1], e2[:, 2], -(e1[:, 2] * e2[:, 1])),
        fma(e1[:, 2], e2[:, 0], -(e1[:, 0] * e2[:, 2])),
        fma(e1[:, 0], e2[:, 1], -(e1[:, 1] * e2[:, 0])),
    ], axis=1)
    norm = np.sqrt(fma(gn[:, 2], gn[:, 2],
                       fma(gn[:, 1], gn[:, 1], gn[:, 0] * gn[:, 0])))
    gn = gn / np.maximum(norm, np.float32(1e-20))[:, None]
    any_zero = np.any(np.all(n == 0.0, axis=2), axis=1)  # [T]
    n = np.where(any_zero[:, None, None], gn[:, None, :], n)
    uv = uvs[indices].reshape(t, 6)
    enc = (material_id.astype(np.int32) * ATTR_TEX_BASE
           + texture_id.astype(np.int32) + 1)
    return np.concatenate(
        [n.reshape(t, 9), uv, enc.astype(np.float32)[:, None]], axis=1
    ).astype(np.float32)
