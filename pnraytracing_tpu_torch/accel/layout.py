"""Traversal layout: the rows the traversal kernels read.

PyTorch counterpart of ``pnraytracing_tpu/accel/layout.py``.  Built on
the host in numpy at scene build and then moved to the device as
tensors:

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
  None;
* ``w4``         the 4-wide collect-then-test layout (:class:`Wide4Data`,
  accel/wide4.py::pack_wide4) of a scene whose leaves all hold at most 4
  triangles, else None.

Topology is stored as exact small-integer floats: a child info ``>= 0``
is an internal child's row id, ``< 0`` a leaf ``-(start*16 + count) - 1``.

The JAX package's ``TravData`` also carries ``nodes16`` (one wide row per
node, leaves included: :func:`pack_wide_nodes`), which its XLA walk of
``traversal="wide"`` reads.  The port's scenes do not carry it: every
port route reads the compact rows ``nodes16c`` instead, the ``wide``
value included (kernels 3 / 2).  :func:`pack_wide_nodes`,
:func:`unpack_wide_rows`, :func:`unpack_node_rows`,
:func:`decode_leaf_info` and :func:`pack_traversal_data` are the JAX
package's functions, value for value; the plain versions of the walks
decode their rows with them.
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
class Wide4Data:
    """The 4-wide collect-then-test layout (accel/wide4.py): one
    ``nodes32`` row per wide internal node (``width`` child boxes, their
    codes, padded to a multiple of 8 floats: [N4, 32] at width 4, [N4,
    56] at width 8) and one ``leaf40`` row per leaf (4 triangles' corners,
    then their ids as floats, -1 for padding).  ``depth4`` is the wide
    tree's depth, which sizes the walk's stack."""

    nodes32: torch.Tensor  # [N4, ceil(7W/8)*8] f32
    leaf40: torch.Tensor  # [NL, 40] f32
    depth4: int = 0
    width: int = 4


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
    w4: Wide4Data | None = None  # the 4-wide layout (leaves <= 4 tris)


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


# ---- the JAX package's layout functions -------------------------------------

def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def pack_traversal_data(bvh, mesh) -> TravData:
    """The layout of a ``BVH`` and ``TriangleMesh`` (tensors, triangles
    in leaf order) on their device, as the JAX package's
    ``pack_traversal_data`` makes it in a graph: ``nodes8`` and ``tri9``
    equal to its arrays, with the port's ``tri12``, ``nodes16c`` and
    ``tri_attr16`` beside them and no treelets, stream or 4-wide
    layout (those the scene builder makes on the host)."""
    from pnraytracing_tpu_torch.accel.bvh import flat_bvh_depth

    dev = mesh.positions.device
    h = dataclasses.make_dataclass("H", ["node_min", "node_max", "axis",
                                         "right_child", "start", "end"])(
        *(_host(getattr(bvh, k)) for k in ("node_min", "node_max", "axis",
                                           "right_child", "start", "end")))
    positions, indices = _host(mesh.positions), _host(mesh.indices)
    tri9 = positions[indices].reshape(len(indices), 9)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return TravData(
        tri9=t(tri9), tri12=t(pack_tri12(tri9)), nodes8=t(pack_nodes8(h)),
        nodes16c=t(pack_wide_nodes_compact(h)),
        tri_attr16=t(pack_tri_attr16(
            positions, _host(mesh.normals), _host(mesh.uvs), indices,
            _host(mesh.material_id), _host(mesh.texture_id))),
        treelets=None, treelet_tree=None,
        bvh_depth=flat_bvh_depth(h.right_child))


def unpack_node_rows(rows: torch.Tensor):
    """[..., 8] rows -> (nmin, nmax, right_child, start, count, axis)."""
    enc_right = rows[..., 6].to(torch.int32)
    enc_meta = rows[..., 7].to(torch.int32)
    leaf = enc_right < 0
    right = torch.where(leaf, -1, torch.div(enc_right, _AXIS_BASE,
                                            rounding_mode="floor"))
    axis = torch.where(leaf, 0, torch.remainder(enc_right, _AXIS_BASE))
    start = torch.div(enc_meta, _COUNT_BASE, rounding_mode="floor")
    count = torch.remainder(enc_meta, _COUNT_BASE)
    return rows[..., 0:3], rows[..., 3:6], right, start, count, axis


def pack_wide_nodes(bvh) -> torch.Tensor:
    """[N, 16] rows of the JAX package's wide walk, one per node: per
    internal node ``[lmin(3), lmax(3), rmin(3), rmax(3), left_info,
    right_info, axis, pad]`` with internal child infos as NODE ids (a
    leaf's row holds safe dummy values; a leaf root gets a synthetic row
    whose left child is the root leaf and whose right child an empty
    leaf).  Equal to ``pnraytracing_tpu/accel/layout.py::
    pack_wide_nodes``; the port's walks read :func:`pack_wide_nodes_
    compact`'s rows instead."""
    n = bvh.right_child.shape[0]
    dev = bvh.node_min.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    is_leaf = bvh.right_child < 0
    count = (bvh.end - bvh.start).to(torch.int64)
    meta = bvh.start.to(torch.int64) * _COUNT_BASE + torch.clamp(
        count, max=MAX_PACKED_LEAF)
    leaf_info = -meta - 1
    left = torch.clamp(ids + 1, max=n - 1)
    right = torch.clamp(bvh.right_child.to(torch.int64), 0, n - 1)
    info_of = lambda ch: torch.where(is_leaf[ch], leaf_info[ch], ch)
    f = lambda x: x.to(torch.int32).to(torch.float32)
    rows = torch.cat([
        bvh.node_min[left], bvh.node_max[left],
        bvh.node_min[right], bvh.node_max[right],
        f(info_of(left))[:, None], f(info_of(right))[:, None],
        f(torch.clamp(bvh.axis, min=0))[:, None],
        torch.zeros((n, 1), dtype=torch.float32, device=dev)], dim=1)
    if bool(is_leaf[0]):
        big = torch.full((3,), 3e38, dtype=torch.float32, device=dev)
        rows[0] = torch.cat([
            bvh.node_min[0], bvh.node_max[0], big, -big,
            f(leaf_info[0:1]), torch.tensor([-1.0, 0.0, 0.0], device=dev)])
    return rows


def unpack_wide_rows(rows: torch.Tensor):
    """[..., 16] rows -> (lmin, lmax, rmin, rmax, left_info, right_info,
    axis)."""
    i = lambda k: rows[..., k].to(torch.int32)
    return (rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], rows[..., 9:12],
            i(12), i(13), i(14))


def decode_leaf_info(info: torch.Tensor):
    """Child infos -> (start, count): a negative info is a leaf
    ``-(start*16 + count) - 1``; count is 0 for an internal child."""
    meta = -info - 1
    start = torch.div(meta, _COUNT_BASE, rounding_mode="floor")
    count = torch.where(info < 0, torch.remainder(meta, _COUNT_BASE), 0)
    return start, count
