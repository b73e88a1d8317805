"""Treelet cut of the flat BVH (numpy, host side).

Copy of ``treelet_cut_aabbs`` from ``pnraytracing_tpu/accel/bricks.py``
(the only function of that module this port needs; the brick-streaming
layout is a later slice).  Flat-layout fact used: depth-first ids with
the left child at id + 1, so a subtree is the contiguous id range
[i, subtree_end(i)).
"""

from __future__ import annotations

import numpy as np


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
