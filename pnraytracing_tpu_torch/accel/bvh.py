"""Host-side SAH BVH builder (numpy).

Re-implements the builder of ``include/BVH.hpp:92-173`` — 12-bucket surface
-area-heuristic splits on the longest centroid-bound axis, depth-first flat
layout with the left child implicit at ``id + 1`` and only ``right_child``
stored, leaves marked ``right_child == -1`` with a ``[start, end)`` triangle
range — with two deliberate changes for the TPU traversal:

* **Bounded leaves.**  The reference allows up to 255 triangles per leaf
  (BVH.hpp:175) and unbounded leaves on degenerate centroid bounds
  (BVH.hpp:117-119).  The device traversal unrolls leaf triangle tests, so
  this builder guarantees ``end - start <= max_leaf_size`` by splitting
  oversized ranges at the median even when SAH prefers a leaf.
* **Iterative.**  Explicit work stack instead of recursion (same pre-order
  node numbering), so deep trees cannot overflow the Python stack.

A native C++ implementation with the same contract lives in the JAX
package (``csrc/`` + ``accel/native.py``); on the teapot it builds a
bit-identical tree, so this port keeps only the numpy builder.
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_BUCKETS = 12  # BVH.hpp:122
TRAVERSAL_COST = 1.0  # BVH.hpp:176


@dataclasses.dataclass
class BVHArrays:
    """numpy result; converted to the jnp :class:`~...core.types.BVH` by the
    scene builder."""

    node_min: np.ndarray  # [N, 3] f32
    node_max: np.ndarray  # [N, 3] f32
    axis: np.ndarray  # [N] i32
    right_child: np.ndarray  # [N] i32
    start: np.ndarray  # [N] i32
    end: np.ndarray  # [N] i32
    order: np.ndarray  # [T] i32 permutation: new triangle i = old order[i]

    @property
    def num_nodes(self) -> int:
        return len(self.axis)

    @property
    def max_depth(self) -> int:
        return flat_bvh_depth(self.right_child)


def flat_bvh_depth(right_child: np.ndarray) -> int:
    """Max node depth (root = 1) of a flat pre-order BVH.

    The device traversal's per-ray stack holds at most one deferred "far"
    child per level of the current path, so its required capacity equals
    this depth; the reference hard-codes a 128-entry stack and relies on the
    builder never exceeding it (ray_tracing.comp:431), while here the scene
    builder records the real depth so a too-shallow ``stack_depth`` raises
    instead of silently corrupting results.

    Works for both builders (numpy and csrc/bvh_builder.cpp) since they
    share the flat layout: left child at ``i + 1``, right child stored,
    ``-1`` = leaf.  Pre-order guarantees children have larger indices than
    their parent, so one forward pass suffices.
    """
    rc = np.asarray(right_child)
    n = len(rc)
    if n == 0:
        return 0
    depth = np.ones(n, dtype=np.int32)
    for i in range(n):
        r = rc[i]
        if r >= 0:
            d = depth[i] + 1
            depth[i + 1] = d
            depth[r] = d
    return int(depth.max())


def triangle_bounds(positions: np.ndarray, indices: np.ndarray):
    """Per-triangle AABB and its center (model.hpp:125-129 builds the same
    per-triangle bound/boundCenter pair)."""
    p = positions[indices].astype(np.float32)  # [T, 3, 3]
    # Exact f32 min/max of the f32 vertex data — never round a wider-precision
    # bound *inward*, or grazing rays can miss a box their triangle is in.
    tri_min = p.min(axis=1)
    tri_max = p.max(axis=1)
    centers = (0.5 * (tri_min.astype(np.float64) + tri_max)).astype(np.float32)
    return tri_min, tri_max, centers


def _surface_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(
    positions: np.ndarray,
    indices: np.ndarray,
    max_leaf_size: int = 4,
) -> BVHArrays:
    """Build the flat SAH BVH.  positions [V,3] f32, indices [T,3] i32."""
    assert max_leaf_size >= 2
    num_tris = len(indices)
    assert num_tris >= 1
    tri_min, tri_max, centers = triangle_bounds(
        np.asarray(positions), np.asarray(indices)
    )
    order = np.arange(num_tris, dtype=np.int32)

    node_min, node_max = [], []
    axis_l, right_l, start_l, end_l = [], [], [], []

    # Work stack of (lo, hi, patch_parent): LIFO; pushing the right range
    # first and the left second reproduces the pre-order numbering where the
    # left child is always parent+1 (BVH.hpp:167-172).
    stack: list[tuple[int, int, int]] = [(0, num_tris, -1)]
    while stack:
        lo, hi, patch = stack.pop()
        node_id = len(axis_l)
        if patch >= 0:
            right_l[patch] = node_id

        seg = order[lo:hi]
        b_min = tri_min[seg].min(axis=0)
        b_max = tri_max[seg].max(axis=0)
        n = hi - lo

        def emit_leaf():
            node_min.append(b_min)
            node_max.append(b_max)
            axis_l.append(-1)
            right_l.append(-1)
            start_l.append(lo)
            end_l.append(hi)

        if n <= 2:  # BVH.hpp:103
            emit_leaf()
            continue

        c = centers[seg]
        c_min = c.min(axis=0)
        c_max = c.max(axis=0)
        diag = c_max - c_min
        d = int(np.argmax(diag))  # longest centroid axis (BVH.hpp:111-115)

        def median_split():
            """Order the segment by centroid along d and split in half —
            the fallback that keeps leaves within the size cap where the
            reference would emit an oversized leaf."""
            order[lo:hi] = seg[np.argsort(c[:, d], kind="stable")]
            return n // 2

        mid_local = None
        if diag[d] <= 0.0:
            # Degenerate centroid bound: the reference emits an unbounded
            # leaf (BVH.hpp:117-119); we may only do so within the leaf cap.
            if n <= max_leaf_size:
                emit_leaf()
                continue
            mid_local = median_split()
        else:
            pos = ((c[:, d] - c_min[d]) / diag[d] * N_BUCKETS).astype(np.int64)
            np.clip(pos, 0, N_BUCKETS - 1, out=pos)

            counts = np.bincount(pos, minlength=N_BUCKETS)
            bmin_b = np.full((N_BUCKETS, 3), np.inf, np.float32)
            bmax_b = np.full((N_BUCKETS, 3), -np.inf, np.float32)
            for b in range(N_BUCKETS):
                m = pos == b
                if m.any():
                    bmin_b[b] = tri_min[seg[m]].min(axis=0)
                    bmax_b[b] = tri_max[seg[m]].max(axis=0)

            # Prefix/suffix sweep over the 11 candidate splits (BVH.hpp:133-151).
            pre_min = np.minimum.accumulate(bmin_b, axis=0)
            pre_max = np.maximum.accumulate(bmax_b, axis=0)
            suf_min = np.minimum.accumulate(bmin_b[::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(bmax_b[::-1], axis=0)[::-1]
            c0 = np.cumsum(counts)[:-1]
            c1 = n - c0
            sa0 = _surface_area(pre_min[:-1], pre_max[:-1])
            sa1 = _surface_area(suf_min[1:], suf_max[1:])
            sa_node = max(_surface_area(b_min, b_max), 1e-30)
            cost = TRAVERSAL_COST + (
                np.where(c0 > 0, sa0 * c0, 0.0) + np.where(c1 > 0, sa1 * c1, 0.0)
            ) / sa_node
            mid_bucket = int(np.argmin(cost))
            min_cost = float(cost[mid_bucket])

            left_mask = pos <= mid_bucket
            n_left = int(left_mask.sum())

            leaf_cost = float(n)  # BVH.hpp:160
            if n <= max_leaf_size and leaf_cost <= min_cost:
                emit_leaf()
                continue
            if n_left == 0 or n_left == n:
                mid_local = median_split()  # degenerate SAH split
            else:
                # stable partition: left bucket tris first, preserving order
                order[lo:hi] = np.concatenate([seg[left_mask], seg[~left_mask]])
                mid_local = n_left

        mid = lo + mid_local

        node_min.append(b_min)
        node_max.append(b_max)
        axis_l.append(d)
        right_l.append(0)  # patched when the right child is created
        start_l.append(lo)
        end_l.append(hi)
        stack.append((mid, hi, node_id))
        stack.append((lo, mid, -1))

    return BVHArrays(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        axis=np.asarray(axis_l, np.int32),
        right_child=np.asarray(right_l, np.int32),
        start=np.asarray(start_l, np.int32),
        end=np.asarray(end_l, np.int32),
        order=order,
    )


def validate_bvh(bvh: BVHArrays, tri_min: np.ndarray, tri_max: np.ndarray) -> None:
    """Structural invariants (the test-suite oracle for both the numpy and
    the native builder):

    * every triangle appears in exactly one leaf range;
    * parent bounds contain child bounds and their triangles' bounds;
    * internal node i has left child i+1 and right_child > i+1;
    * leaves are within the configured size bound.
    """
    n = bvh.num_nodes
    leaves = bvh.right_child == -1
    seen = np.zeros(len(bvh.order), np.int32)
    for i in np.nonzero(leaves)[0]:
        seen[bvh.start[i] : bvh.end[i]] += 1
    assert (seen == 1).all(), "leaf ranges must tile the triangle array"

    tmin = tri_min[bvh.order]
    tmax = tri_max[bvh.order]
    for i in range(n):
        s, e = bvh.start[i], bvh.end[i]
        assert s < e
        assert (bvh.node_min[i] <= tmin[s:e].min(axis=0) + 1e-5).all()
        assert (bvh.node_max[i] >= tmax[s:e].max(axis=0) - 1e-5).all()
        if not leaves[i]:
            rc = bvh.right_child[i]
            assert i + 1 < n and i + 1 < rc < n
            for ch in (i + 1, rc):
                assert (bvh.node_min[i] <= bvh.node_min[ch] + 1e-5).all()
                assert (bvh.node_max[i] >= bvh.node_max[ch] - 1e-5).all()
