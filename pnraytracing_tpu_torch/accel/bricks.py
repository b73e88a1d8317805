"""Treelet cut and brick decomposition of the flat BVH (numpy, host side).

Copy of ``treelet_cut_aabbs``, ``StreamData``, ``build_stream_data`` and
its helpers from ``pnraytracing_tpu/accel/bricks.py``; for the same
budget both packages build the same arrays bit for bit.  The brick
layout serves the streaming kernels (accel/traverse_stream_cuda.py) for
scenes too large for the resident route (accel/route.py).

Flat-layout facts used (BVH.hpp:6-12 contract, accel/bvh.py):
* depth-first ids, left child = id+1, so a subtree is the contiguous id
  range [i, subtree_end(i));
* triangles are partitioned in build order, so a subtree's leaves cover
  the contiguous triangle range [tri_lo(i), tri_hi(i)).

Brick blob layout (f32 words, exact small ints like accel/layout.py):
  [0] tris_off  — word offset of the triangle section (= 4 + 16*n_rows)
  [1] tri_base  — global id of the brick's first triangle
  [2] n_rows    — local wide node rows
  [3] n_tris
  [4 : tris_off]            — wide rows (local ids; leaf info encodes
                              LOCAL start: -(local_start*16+count)-1)
  [tris_off : +9*n_tris]    — tri9 rows of the brick's triangles
Every blob is padded to one width, a multiple of 128 words.

Top-tree wide rows: the same wide encoding, except that a negative child
info means "brick ref": info = -(brick_id)-1 (the top tree has no real
leaves; every cut subtree, however small, becomes a brick).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnraytracing_tpu_torch.core.camera import resolve_device
from pnraytracing_tpu_torch.core.types import _Movable

_COUNT_BASE = 16

BRICK_HEADER_WORDS = 4

# The default brick budget, the JAX package's: the kernels walk the bricks
# where they lie in device memory, so no on-chip memory bounds their size
# and the default layouts of the two packages are the same arrays.
BRICK_BUDGET_BYTES = 256 << 10


@dataclasses.dataclass
class StreamData(_Movable):
    """Host-built streaming scene: the top tree and the brick blobs."""

    top16: torch.Tensor  # [Nt, 16] f32 wide rows of the top tree
    bricks: torch.Tensor  # [B, W] f32 brick blobs (uniform padded width)
    brick_words: int = 0  # W
    n_bricks: int = 0
    n_top_rows: int = 0
    # the walk's stack depth: the deeper of the top tree and any brick
    brick_stack: int = 32
    n_tris: int = 0  # total triangle count


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def treelet_cut_aabbs(bvh, n_target: int = 256, cap: int = 512
                      ) -> np.ndarray:
    """[K, 6] f32 treelet AABBs (lo.xyz, hi.xyz) from a node-count
    top-down cut of the flat BVH — the binning table for the
    ray-coherence sort (ops/compaction.py::treelet_entry_key).

    ``cap`` bounds K (the key kernel keeps the table in shared memory);
    the cut is re-run coarser until it fits."""
    right = np.asarray(bvh.right_child, np.int64)
    node_min = np.asarray(bvh.node_min, np.float32)
    node_max = np.asarray(bvh.node_max, np.float32)
    n = len(right)
    id_end = np.empty(n, np.int64)
    for i in range(n - 1, -1, -1):
        id_end[i] = i + 1 if right[i] < 0 else id_end[right[i]]
    max_nodes = max(n // n_target, 1)
    while True:
        roots = []
        stack = [0]
        while stack:
            i = stack.pop()
            if id_end[i] - i <= max_nodes or right[i] < 0:
                roots.append(i)
                continue
            stack.append(int(right[i]))
            stack.append(i + 1)
        if len(roots) <= cap or max_nodes >= n:
            break
        max_nodes *= 2
    roots = np.array(sorted(roots))
    return np.concatenate([node_min[roots], node_max[roots]],
                          axis=1).astype(np.float32)


TREELET_COORD_LIMIT = 1e30  # |box coordinate| bound of the key's tables


def _checked_treelets(treelets) -> np.ndarray:
    """``treelets`` as a [K, 6] f32 array of valid boxes (lo <= hi, finite,
    |coordinate| < 1e30 so that ``box - origin`` never overflows for a
    finite origin); raises otherwise.  The pruned key walk is exact only
    for such boxes."""
    tre = _np(treelets, np.float32)
    if tre.ndim != 2 or tre.shape[1] != 6 or not 0 < tre.shape[0] <= 512:
        raise ValueError("treelets must be [K, 6] with 0 < K <= 512")
    if not (np.all(np.abs(tre) < TREELET_COORD_LIMIT)
            and np.all(tre[:, :3] <= tre[:, 3:])):
        raise ValueError("treelet boxes must be finite with lo <= hi")
    return tre


def treelet_index_tree(treelets) -> np.ndarray:
    """[2P, 8] f32 implicit binary tree over the INDEX RANGES of the K
    treelet boxes, the table the key kernel walks (csrc/entry_key.cu).

    P is the least power of two >= K.  Row i (1 <= i < 2P, heap order:
    children 2i and 2i + 1; row 0 is unused) is ``[lo.xyz, 0, hi.xyz, 0]``,
    two ``float4``.  Leaf row P + k is box k; an inner row is the union
    (componentwise min / max) of the leaves under it, that is of a
    contiguous index range, which is tight because ``treelet_cut_aabbs``
    returns the boxes in depth-first order of the BVH (neighbours in index
    are neighbours in space).  Leaves P + k for k >= K repeat box K - 1:
    visited after it, with the same entry t, a copy can never win the
    strict ``<`` of the argmin, so the padding needs no index check (an
    inverted "empty" box would NOT do: under this slab test it is entered
    at t = 0)."""
    tre = _checked_treelets(treelets)
    k = tre.shape[0]
    p = 1
    while p < k:
        p *= 2
    lo = np.empty((2 * p, 3), np.float32)
    hi = np.empty((2 * p, 3), np.float32)
    lo[0] = hi[0] = 0.0
    lo[p:p + k], hi[p:p + k] = tre[:, :3], tre[:, 3:]
    lo[p + k:], hi[p + k:] = tre[k - 1, :3], tre[k - 1, 3:]
    for i in range(p - 1, 0, -1):
        lo[i] = np.minimum(lo[2 * i], lo[2 * i + 1])
        hi[i] = np.maximum(hi[2 * i], hi[2 * i + 1])
    out = np.zeros((2 * p, 8), np.float32)
    out[:, 0:3], out[:, 4:7] = lo, hi
    return out


def _subtree_extents(right_child: np.ndarray, start: np.ndarray,
                     end: np.ndarray):
    """Per-node (id_end, tri_lo, tri_hi) via one reverse pass (children
    have larger ids than their parent in the depth-first layout)."""
    n = len(right_child)
    id_end = np.empty(n, np.int64)
    tri_lo = np.empty(n, np.int64)
    tri_hi = np.empty(n, np.int64)
    for i in range(n - 1, -1, -1):
        r = right_child[i]
        if r < 0:  # leaf
            id_end[i] = i + 1
            tri_lo[i] = start[i]
            tri_hi[i] = end[i]
        else:
            id_end[i] = id_end[r]
            tri_lo[i] = tri_lo[i + 1]
            tri_hi[i] = tri_hi[r]
    return id_end, tri_lo, tri_hi


def _node_bytes(n_nodes, n_tris):
    return 4 * (BRICK_HEADER_WORDS + 16 * n_nodes + 9 * n_tris)


def build_stream_data(bvh, mesh, brick_budget_bytes: int = BRICK_BUDGET_BYTES,
                      device=None) -> StreamData:
    """Cut the tree into maximal <= budget subtrees and pack their blobs.

    ``bvh``/``mesh``: the flat BVH (node_min, node_max, axis, right_child,
    start, end) and the mesh (positions, indices in BVH order), as numpy
    arrays or tensors.  The result lives on ``device`` (None = cuda)."""
    node_min = _np(bvh.node_min, np.float32)
    node_max = _np(bvh.node_max, np.float32)
    axis = _np(bvh.axis, np.int64)
    right = _np(bvh.right_child, np.int64)
    start = _np(bvh.start, np.int64)
    end = _np(bvh.end, np.int64)
    pos = _np(mesh.positions, np.float32)
    idxs = _np(mesh.indices, np.int64)
    tri9_all = pos[idxs].reshape(len(idxs), 9).astype(np.float32)

    n = len(right)
    id_end, tri_lo, tri_hi = _subtree_extents(right, start, end)
    sub_bytes = _node_bytes(id_end - np.arange(n), tri_hi - tri_lo)

    if sub_bytes[0] <= brick_budget_bytes:
        raise ValueError(
            "scene fits a single brick — use the resident kernels "
            "(accel/traverse_cuda.py) instead of the streaming ones")

    # --- top-down cut: descend while the subtree exceeds the budget ----
    cut_of_node = np.full(n, -1, np.int64)  # node id -> brick id
    brick_roots: list[int] = []
    top_nodes: list[int] = []
    top_depth = 0  # max DFS depth of the top tree (phase-1 stack)
    stack = [(0, 1)]
    while stack:
        i, dep = stack.pop()
        top_depth = max(top_depth, dep)
        if sub_bytes[i] <= brick_budget_bytes:
            cut_of_node[i] = len(brick_roots)
            brick_roots.append(i)
            continue
        # over budget -> internal (a leaf is <= 15 tris, always fits)
        assert right[i] >= 0, "over-budget leaf cannot happen"
        top_nodes.append(i)
        stack.append((int(right[i]), dep + 1))
        stack.append((i + 1, dep + 1))

    top_nodes.sort()
    top_local = {g: k for k, g in enumerate(top_nodes)}

    # --- pack the top tree (wide rows; negative info = brick ref) ------
    def child_info_top(c: int) -> int:
        b = cut_of_node[c]
        if b >= 0:
            return -int(b) - 1
        return top_local[c]

    nt = len(top_nodes)
    top16 = np.zeros((nt, 16), np.float32)
    for k, g in enumerate(top_nodes):
        lc, rc = g + 1, int(right[g])
        top16[k, 0:3] = node_min[lc]
        top16[k, 3:6] = node_max[lc]
        top16[k, 6:9] = node_min[rc]
        top16[k, 9:12] = node_max[rc]
        top16[k, 12] = float(child_info_top(lc))
        top16[k, 13] = float(child_info_top(rc))
        top16[k, 14] = float(max(axis[g], 0))

    # --- pack bricks ----------------------------------------------------
    blobs = []
    max_words = 0
    max_depth = 0
    for b_root in brick_roots:
        lo_id, hi_id = b_root, int(id_end[b_root])
        t_lo, t_hi = int(tri_lo[b_root]), int(tri_hi[b_root])
        n_rows = hi_id - lo_id
        n_tris = t_hi - t_lo
        rows = np.zeros((n_rows, 16), np.float32)
        depth = _pack_brick_rows(rows, b_root, lo_id, t_lo, node_min,
                                 node_max, axis, right, start, end)
        max_depth = max(max_depth, depth)
        tris_off = BRICK_HEADER_WORDS + 16 * n_rows
        words = tris_off + 9 * n_tris
        blob = np.zeros(words, np.float32)
        blob[0] = float(tris_off)
        blob[1] = float(t_lo)
        blob[2] = float(n_rows)
        blob[3] = float(n_tris)
        blob[BRICK_HEADER_WORDS:tris_off] = rows.reshape(-1)
        blob[tris_off:words] = tri9_all[t_lo:t_hi].reshape(-1)
        blobs.append(blob)
        max_words = max(max_words, words)

    # pad to a uniform width (multiple of 128 words; 16-byte aligned rows)
    max_words = ((max_words + 127) // 128) * 128
    bricks = np.zeros((len(blobs), max_words), np.float32)
    for i, blob in enumerate(blobs):
        bricks[i, : len(blob)] = blob

    # one stack serves both the top-tree walk and the brick walks, so it
    # is sized for whichever is deeper
    assert len(idxs) < (1 << 24), (
        f"{len(idxs)} triangles: brick tri ids are exact-small-int f32 "
        "words, exact only below 2**24")
    dev = resolve_device(device)
    return StreamData(
        top16=torch.as_tensor(top16, device=dev),
        bricks=torch.as_tensor(bricks, device=dev),
        brick_words=int(max_words),
        n_bricks=len(blobs),
        n_top_rows=nt,
        brick_stack=int(max(max_depth, top_depth + 1) + 4),
        n_tris=len(idxs),
    )


def _pack_brick_rows(rows, b_root, lo_id, t_lo, node_min, node_max, axis,
                     right, start, end) -> int:
    """Wide rows for the subtree rooted at b_root, ids/tris re-based to
    the brick.  Returns the subtree's depth (stack sizing).  Row l is
    global node lo_id + l; leaf rows are dummies (never visited — parents
    resolve leaves inline).  A brick whose ROOT is a leaf gets a synthetic
    row 0 (left = the leaf itself, right = empty)."""

    def leaf_info_local(c: int) -> int:
        meta = (start[c] - t_lo) * _COUNT_BASE + min(
            end[c] - start[c], _COUNT_BASE - 1)
        return -int(meta) - 1

    def child_info(c: int) -> int:
        if right[c] < 0:
            return leaf_info_local(c)
        return c - lo_id

    if right[b_root] < 0:
        rows[0, 0:3] = node_min[b_root]
        rows[0, 3:6] = node_max[b_root]
        rows[0, 6:9] = 3e38
        rows[0, 9:12] = -3e38
        rows[0, 12] = float(leaf_info_local(b_root))
        rows[0, 13] = float(-0 - 1)  # empty leaf: local start 0, count 0
        rows[0, 14] = 0.0
        return 1

    max_depth = 0
    stack = [(b_root, 1)]
    while stack:
        g, dep = stack.pop()
        max_depth = max(max_depth, dep)
        if right[g] < 0:
            continue
        k = g - lo_id
        lc, rc = g + 1, int(right[g])
        rows[k, 0:3] = node_min[lc]
        rows[k, 3:6] = node_max[lc]
        rows[k, 6:9] = node_min[rc]
        rows[k, 9:12] = node_max[rc]
        rows[k, 12] = float(child_info(lc))
        rows[k, 13] = float(child_info(rc))
        rows[k, 14] = float(max(axis[g], 0))
        stack.append((lc, dep + 1))
        stack.append((rc, dep + 1))
    return max_depth
