"""The 4-wide BVH layout of the collect-then-test walk.

Copy of ``pnraytracing_tpu/accel/wide4.py`` (host numpy; this port keeps
its own copy and imports nothing of the JAX package), whose arrays it
equals bit for bit:

* ``nodes32`` [N4, row] f32: per wide internal node, ``width`` child
  boxes (min.xyz, max.xyz) and then ``width`` child codes (0 empty, odd
  ``2*leaf + 1`` a leaf, even ``2*(node + 1)`` an internal node), padded
  to a multiple of 8 floats (32 at width 4, 56 at width 8);
* ``leaf40`` [NL, 9L + L] f32 (L = ``max_leaf_size`` = 4: 40 floats): per
  leaf, its first L triangles' corners, then their global triangle ids as
  exact small-integer floats (-1 for padding; a padding triangle is all
  zeros and never hits).

A wide node's children are grown from the binary node by expanding the
internal child with the largest surface area until ``width`` slots are
filled (the SAH-greedy collapse); nodes are emitted breadth first.  The
boxes are the binary tree's, so a walk over this layout finds the binary
walks' hits.  ``collapse_binary`` is Python loops, as in the JAX package
(seconds for config5's 102,404 triangles; PERF.md has the figure).
The walk is accel/traverse_wide4.py.
"""

from __future__ import annotations

import numpy as np
import torch

from pnraytracing_tpu_torch.accel.layout import Wide4Data


def _row_width(width: int) -> int:
    """6 box floats + 1 child code per slot, padded up to a multiple
    of 8."""
    need = 7 * width
    return (need + 7) // 8 * 8


def collapse_binary(node_min, node_max, right_child, start, end,
                    max_leaf_size: int = 4, width: int = 4):
    """Binary flat BVH -> (nodes32 [Nw, row_width] f32, leaf_start [NL]
    i32, leaf_count [NL] i32, depth int) at branching factor ``width``."""
    node_min = np.asarray(node_min)
    node_max = np.asarray(node_max)
    right_child = np.asarray(right_child)
    start = np.asarray(start)
    end = np.asarray(end)
    pad = _row_width(width)

    def kids(b):
        """Binary children of binary node b, or None for a leaf."""
        r = right_child[b]
        if r < 0:
            return None
        return [b + 1, int(r)]

    leaf_start, leaf_count = [], []

    def add_leaf(b) -> int:
        leaf_start.append(int(start[b]))
        leaf_count.append(int(end[b] - start[b]))
        return len(leaf_start) - 1

    # the binary root may itself be a leaf
    if right_child[0] < 0:
        li = add_leaf(0)
        row = np.zeros(pad, np.float32)
        row[0:3] = node_min[0]
        row[3:6] = node_max[0]
        row[6 * width] = 2 * li + 1
        nodes32 = np.asarray([row], np.float32)
        return (nodes32, np.asarray(leaf_start, np.int32),
                np.asarray(leaf_count, np.int32), 1)

    def area(b):
        d = np.maximum(node_max[b] - node_min[b], 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def gather_children(b):
        """Up to ``width`` binary descendants: greedily expand the
        largest-area internal entry until the slots are full."""
        out = list(kids(b))
        while len(out) < width:
            best_i, best_a = -1, -1.0
            for i, c in enumerate(out):
                if kids(c) is not None and area(c) > best_a:
                    best_i, best_a = i, area(c)
            if best_i < 0:
                break
            c = out.pop(best_i)
            out.extend(kids(c))
        return out

    # breadth-first emission so child indices are assigned forward
    rows_children: list[list[int]] = []  # binary ids per wide node
    queue = [0]
    emitted = {}  # binary internal id -> wide node index
    order = []
    while queue:
        b = queue.pop(0)
        if b in emitted:
            continue
        emitted[b] = len(order)
        order.append(b)
        ch = gather_children(b)
        rows_children.append(ch)
        for c in ch:
            if kids(c) is not None:
                queue.append(c)

    n4 = len(order)
    nodes32 = np.zeros((n4, pad), np.float32)
    depth = np.ones(n4, np.int32)
    for i, b in enumerate(order):
        ch = rows_children[i]
        for k, c in enumerate(ch):
            nodes32[i, 6 * k:6 * k + 3] = node_min[c]
            nodes32[i, 6 * k + 3:6 * k + 6] = node_max[c]
            if kids(c) is None:
                li = add_leaf(c)
                nodes32[i, 6 * width + k] = 2 * li + 1
            else:
                j = emitted[c]
                nodes32[i, 6 * width + k] = 2 * (j + 1)
                depth[j] = depth[i] + 1
    return (nodes32, np.asarray(leaf_start, np.int32),
            np.asarray(leaf_count, np.int32), int(depth.max()))


def build_leaf40(tri9: np.ndarray, leaf_start: np.ndarray,
                 leaf_count: np.ndarray, max_leaf_size: int = 4):
    """[NL, 9*max_leaf + max_leaf] padded leaf rows: triangle corner
    positions, then the global triangle ids as exact small-int floats
    (-1 pad)."""
    nl = len(leaf_start)
    out = np.zeros((nl, 9 * max_leaf_size + max_leaf_size), np.float32)
    out[:, 9 * max_leaf_size:] = -1.0
    tri9 = np.asarray(tri9)
    for i in range(nl):
        s, c = int(leaf_start[i]), min(int(leaf_count[i]), max_leaf_size)
        out[i, : 9 * c] = tri9[s:s + c].reshape(-1)
        out[i, 9 * max_leaf_size: 9 * max_leaf_size + c] = np.arange(
            s, s + c, dtype=np.float32)
    return out


def pack_wide4(built, tri9_np: np.ndarray, max_leaf_size: int = 4,
               width: int = 4, device=None) -> Wide4Data:
    """The host BVHArrays and the leaf-ordered ``tri9`` rows -> the
    :class:`Wide4Data` on ``device`` (None: the CPU)."""
    nodes32, ls, lc, depth4 = collapse_binary(
        built.node_min, built.node_max, built.right_child,
        built.start, built.end, max_leaf_size, width=width)
    leaf40 = build_leaf40(tri9_np, ls, lc, max_leaf_size)
    t = lambda a: torch.as_tensor(a, device=device)
    return Wide4Data(nodes32=t(nodes32), leaf40=t(leaf40), depth4=depth4,
                     width=width)
