"""The order in which a scene's emissive triangles enter its light list.

The program lists its light triangles in the leaf order of its SAH BVH
(``scene/build.py``: the triangles are renumbered by the tree, then the
emissive ones are collected in that order), and the light a sample picks
(``searchsorted`` over the prefix areas) depends on that order.  The
reference renders over the triangles in input order, so it works the
light order out again: it runs the published SAH build (12 buckets on
the longest centroid axis, stable partitions, median split when a
partition is one-sided or a leaf would be too large; depth-first, left
before right) only on the nodes whose triangle range holds a light, in
the arithmetic of the C++ builder the program uses where g++ exists
(float32 centroids and buckets, float64 surface areas, the axis chosen
with x winning ties, then z over y).  Nodes without a light do not
affect the lights' order, so they are not built.
"""

from __future__ import annotations

import numpy as np

N_BUCKETS = 12
TRAVERSAL_COST = 1.0


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(0.0, hi.astype(np.float64) - lo.astype(np.float64))
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def _axis(diag: np.ndarray) -> int:
    x, y, z = (float(v) for v in diag)
    d = 0
    if y >= x and y >= z:
        d = 1
    if z >= x and z >= y:
        d = 2
    if x >= y and x >= z:
        d = 0
    return d


def light_triangle_order(positions: np.ndarray, indices: np.ndarray,
                         is_light: np.ndarray,
                         max_leaf_size: int = 4) -> np.ndarray:
    """Input indices of the light triangles in the program's light-list
    order.  ``positions`` [V, 3] f32, ``indices`` [T, 3], ``is_light``
    [T] bool."""
    p = positions[indices].astype(np.float32)
    tri_lo = p.min(axis=1)
    tri_hi = p.max(axis=1)
    centers = (np.float32(0.5) * (tri_lo + tri_hi)).astype(np.float32)
    out: list[int] = []

    def node(seg: np.ndarray) -> None:
        # seg: the node's triangles in the builder's current order
        if not is_light[seg].any():
            return
        n = len(seg)
        if n <= 2:
            out.extend(int(t) for t in seg if is_light[t])
            return
        c = centers[seg]
        c_lo, c_hi = c.min(axis=0), c.max(axis=0)
        diag = (c_hi - c_lo).astype(np.float32)
        d = _axis(diag)

        def median_split():
            s = seg[np.argsort(c[:, d], kind="stable")]
            return s[:n // 2], s[n // 2:]

        if diag[d] <= 0.0:
            if n <= max_leaf_size:
                out.extend(int(t) for t in seg if is_light[t])
                return
            left, right = median_split()
        else:
            inv = np.float32(N_BUCKETS) / diag[d]
            scaled = ((c[:, d] - c_lo[d]) * inv).astype(np.float32)
            bucket = np.clip(np.trunc(scaled).astype(np.int64), 0,
                             N_BUCKETS - 1)
            counts = np.bincount(bucket, minlength=N_BUCKETS)
            b_lo = np.full((N_BUCKETS, 3), np.inf, np.float32)
            b_hi = np.full((N_BUCKETS, 3), -np.inf, np.float32)
            for b in range(N_BUCKETS):
                m = bucket == b
                if m.any():
                    b_lo[b] = tri_lo[seg[m]].min(axis=0)
                    b_hi[b] = tri_hi[seg[m]].max(axis=0)
            pre_lo = np.minimum.accumulate(b_lo, axis=0)
            pre_hi = np.maximum.accumulate(b_hi, axis=0)
            suf_lo = np.minimum.accumulate(b_lo[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(b_hi[::-1], axis=0)[::-1]
            sa_node = max(float(_surface_area(tri_lo[seg].min(axis=0),
                                              tri_hi[seg].max(axis=0))),
                          1e-30)
            best, mid_bucket, c0 = np.inf, 0, 0
            for m in range(N_BUCKETS - 1):
                c0 += int(counts[m])
                c1 = n - c0
                cost = TRAVERSAL_COST + (
                    (float(_surface_area(pre_lo[m], pre_hi[m])) * c0
                     if c0 > 0 else 0.0)
                    + (float(_surface_area(suf_lo[m + 1], suf_hi[m + 1]))
                       * c1 if c1 > 0 else 0.0)) / sa_node
                if cost < best:
                    best, mid_bucket = cost, m
            if n <= max_leaf_size and float(n) <= best:
                out.extend(int(t) for t in seg if is_light[t])
                return
            left_mask = bucket <= mid_bucket
            n_left = int(left_mask.sum())
            if n_left in (0, n):
                left, right = median_split()
            else:
                left, right = seg[left_mask], seg[~left_mask]
        node(left)
        node(right)

    node(np.arange(len(indices), dtype=np.int64))
    return np.asarray(out, np.int64)
