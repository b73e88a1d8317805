"""Live-ray compaction and the coherence sort keys.

PyTorch counterpart of ``pnraytracing_tpu/ops/compaction.py``: the prefix
scans, ``compact_indices`` (live lanes first, in order) and
``scatter_back``; ``sort_live_first`` (the permutation that packs live
rays first, in key order); the position / direction keys
``coherence_key`` and ``coherence_key_pos``; the plain
``treelet_entry_key`` (all K boxes: the definition of the key) and the
wrapper :func:`entry_key` over its hand-written CUDA kernel
(``csrc/entry_key.cu``, replacing ``treelet_entry_key_pallas``), which
walks a tree of unions over the boxes and tests a fraction of them;
:func:`entry_key_walk` is the plain version of that walk.
:func:`permute_state` moves a path state by a sort's permutation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pnraytracing_tpu_torch.accel.traverse_cuda import (
    check_rays,
    check_table,
    detached,
    ptr,
    stream_of,
)
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import never_enters, safe_inv_dir
from pnraytracing_tpu_torch.utils.profiling import launched

# Launches of the key kernel since the last reset (the caller zeroes it).
LAUNCHES = {"treelet_entry_key": 0}


def inclusive_scan(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inclusive prefix sum along ``axis``, in ``x``'s dtype (the
    operation of prefix_sum.comp:10-23).  Integers are exact; float sums
    round in another order than the JAX package's log-depth scan."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype)


def exclusive_scan(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return inclusive_scan(x, axis=axis) - x


def compact_indices(mask: torch.Tensor):
    """``(perm, count)``: the indices of the True lanes of ``mask`` in
    order, then those of the False lanes in order ([R] int64, a
    permutation, so ``x[perm]`` gathers in bounds), and the number of
    True lanes.  The JAX package's permutation, by a stable sort."""
    perm = torch.argsort((~mask).to(torch.int32), stable=True)
    return perm, mask.sum()


def scatter_back(values: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Undo ``x[perm]``: ``y`` with ``y[perm[i]] = values[i]``."""
    return torch.zeros_like(values).index_put_((perm,), values)


def _cell(x: torch.Tensor, hi: int) -> torch.Tensor:
    """``clip(uint32(x), 0, hi)`` of the JAX keys, as int64: clamped in
    float before the conversion (a negative, huge or NaN float has no
    defined integer; NaN counts as 0).  Equal to the JAX value wherever
    that is defined, which covers every live lane (x >= 0 there)."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0,
                       float(hi)).to(torch.int64)


def coherence_key(nrm: V3, pos: V3, lo: torch.Tensor,
                  inv_extent: torch.Tensor) -> torch.Tensor:
    """Direction-major key (the JAX package's ``'dir'``), int64 below
    2^15, most significant first: the 3-bit normal octant, 2 bits per
    axis of the quantized |n|, 2 bits per axis of the position cell
    within the box ``lo`` + [0, 1 / inv_extent]."""
    key = _octant(nrm.x, nrm.y, nrm.z).to(torch.int64)
    for nc in (nrm.x, nrm.y, nrm.z):
        key = key * 4 + _cell(torch.abs(nc) * 4, 3)
    for i, pc in enumerate((pos.x, pos.y, pos.z)):
        key = key * 4 + _cell((pc - lo[i]) * inv_extent[i] * 4, 3)
    return key


def coherence_key_pos(nrm: V3, pos: V3, lo: torch.Tensor,
                      inv_extent: torch.Tensor) -> torch.Tensor:
    """Position-major key (``'pos'``), int64 below 2^15: the 12-bit
    Morton code of the position cell (4 bits an axis, interleaved, most
    significant bit first) above the 3-bit normal octant."""
    qp = [_cell((pc - lo[i]) * inv_extent[i] * 16, 15)
          for i, pc in enumerate((pos.x, pos.y, pos.z))]
    morton = torch.zeros_like(qp[0])
    for bit in range(3, -1, -1):
        for ax in range(3):
            morton = morton * 2 + ((qp[ax] >> bit) & 1)
    return morton * 8 + _octant(nrm.x, nrm.y, nrm.z)


def sort_live_first(mask: torch.Tensor, key: torch.Tensor):
    """Permutation packing live lanes first, ordered by ``key`` (stable);
    ``key`` must be below 2^16."""
    composite = (~mask).to(torch.int64) * (1 << 16) + key.to(torch.int64)
    return torch.argsort(composite, stable=True), mask.sum()


# uint32 RNG words in int64 (ops/sampling.py): moved as 16-bit halves
WORDS = ("seed",)
# the dtypes float32 holds exactly (ids, slots and pixels below 2^24)
_EXACT = (torch.float32, torch.bool, torch.int32, torch.int64)


class Lanes(NamedTuple):
    """Each lane's slot in the original ray order and its pixel."""

    orig: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor


def permute_state(perm: torch.Tensor, records: tuple, dead=()) -> tuple:
    """``records`` (NamedTuples of [R] tensors, V3 of them or None) with
    every field gathered by ``perm``, in ONE [C, R] float32 stack and one
    ``index_select``; each field comes back as contiguous rows of it,
    exact: bools as 0/1, int32 and int64 ids, slots and pixels (below
    2^24) as floats, a word of :data:`WORDS` as two halves.  None fields
    stay None.  A name two records share is one field (the same tensor in
    both), moved once.  A name in ``dead`` is state no phase reads before
    writing it again (the view direction, which the tail rolls from the
    sample): it is not moved and comes back None, so a stale read fails.
    Raises on a dead name no record has, on two values under one name,
    and on a field that cannot move exactly."""
    fields = {}
    for rec in records:
        for name, x in zip(rec._fields, rec):
            if fields.setdefault(name, x) is not x:
                raise ValueError(f"permute_state: two records hold "
                                 f"different {name!r}")
    unknown = set(dead) - fields.keys()
    if unknown:
        raise ValueError(f"permute_state: no record has {sorted(unknown)}")
    moved = {n: x for n, x in fields.items()
             if x is not None and n not in dead}
    f32, i64 = torch.float32, torch.int64
    comps = lambda x: (x.x, x.y, x.z) if isinstance(x, V3) else (x,)
    cols = []
    for name, x in moved.items():
        for c in comps(x):
            if name in WORDS and c.dtype == i64:
                cols += [(c & 0xFFFF).to(f32), (c >> 16).to(f32)]
            elif name not in WORDS and c.dtype in _EXACT:
                cols.append(c.to(f32))
            else:
                raise ValueError(f"permute_state: cannot move {name!r} "
                                 f"({c.dtype}) exactly")
    rows = iter(torch.stack(cols).index_select(1, perm).unbind(0))

    def back(name, c):
        row = next(rows)
        if name in WORDS:
            return row.to(i64) | (next(rows).to(i64) << 16)
        return row > 0.5 if c.dtype == torch.bool else row.to(c.dtype)

    out = {n: V3(*(back(n, c) for c in comps(x))) if isinstance(x, V3)
           else back(n, x) for n, x in moved.items()}
    return tuple(type(rec)(*(out.get(n) for n in rec._fields))
                 for rec in records)


def _octant(dx, dy, dz):
    return ((dx > 0).to(torch.int32) * 4 + (dy > 0).to(torch.int32) * 2
            + (dz > 0).to(torch.int32))


def treelet_entry_key(o: V3, d: V3, treelets: torch.Tensor) -> torch.Tensor:
    """Plain version of the key kernel: per ray, the index k of the
    nearest treelet box its ray enters (argmin of the slab-entry t_near,
    clamped >= 0, over boxes with t_far >= t_near; first minimum wins; K
    when none), as ``k*8 + octant(d)`` (int32).  A loop over the K boxes
    with a strict ``<``, the kernel's own order."""
    ox, oy, oz = o.x, o.y, o.z
    inv = lambda c: torch.where(c >= 0, 1.0, -1.0) / torch.clamp_min(
        torch.abs(c), 1e-20)
    ix, iy, iz = inv(d.x), inv(d.y), inv(d.z)
    k_total = int(treelets.shape[0])
    best_t = torch.full_like(ox, 3e38)
    best_k = torch.full(ox.shape, k_total, dtype=torch.int32,
                        device=ox.device)
    for k in range(k_total):
        b = treelets[k]
        nx = (b[0] - ox) * ix
        ny = (b[1] - oy) * iy
        nz = (b[2] - oz) * iz
        fx = (b[3] - ox) * ix
        fy = (b[4] - oy) * iy
        fz = (b[5] - oz) * iz
        t_far = torch.minimum(
            torch.minimum(torch.maximum(fx, nx), torch.maximum(fy, ny)),
            torch.maximum(fz, nz))
        t_near = torch.maximum(
            torch.maximum(torch.minimum(fx, nx), torch.minimum(fy, ny)),
            torch.clamp_min(torch.minimum(fz, nz), 0.0))
        win = (t_far >= t_near) & (t_near < best_t)
        best_t = torch.where(win, t_near, best_t)
        best_k = torch.where(win, k, best_k)
    return best_k * 8 + _octant(d.x, d.y, d.z)


def slab_entry(rows, ox, oy, oz, ix, iy, iz):
    """(t_near clamped at 0, t_far) of rays against the boxes ``rows``
    [n, 8] (``[lo.xyz, _, hi.xyz, _]``), the expression of
    :func:`treelet_entry_key` op for op."""
    nx = (rows[:, 0] - ox) * ix
    ny = (rows[:, 1] - oy) * iy
    nz = (rows[:, 2] - oz) * iz
    fx = (rows[:, 4] - ox) * ix
    fy = (rows[:, 5] - oy) * iy
    fz = (rows[:, 6] - oz) * iz
    t_far = torch.minimum(
        torch.minimum(torch.maximum(fx, nx), torch.maximum(fy, ny)),
        torch.maximum(fz, nz))
    t_near = torch.maximum(
        torch.maximum(torch.minimum(fx, nx), torch.minimum(fy, ny)),
        torch.clamp_min(torch.minimum(fz, nz), 0.0))
    return t_near, t_far


def entry_key_walk(o: V3, d: V3, tree: torch.Tensor, k_total: int):
    """Plain version of the key kernel's walk: ``(key, counts)`` with
    ``counts`` [2, R] int32, the union (inner row) and member (leaf row)
    slab tests of each ray.

    ``tree`` is ``accel/bricks.py::treelet_index_tree`` of the K boxes.
    Every ray walks it in depth-first order, left child first, which is
    ascending box index: at a row it runs the slab test of
    :func:`treelet_entry_key`; a row the ray misses or enters no earlier
    than its best entry so far is skipped with everything under it (no
    box inside a union is entered before the union, bit for bit: the test
    is monotone in the box); an entered inner row is followed by its left
    child, an entered leaf becomes the best.  The walk ends at a best
    entry of 0 (t_near is clamped at 0 and the first minimum wins) or
    when it is back at the root.  Rays of :func:`never_enters` walk
    nothing.  The key equals :func:`treelet_entry_key`'s for every ray."""
    p = tree.shape[0] // 2
    dev = o.x.device
    r = o.x.shape[0]
    ix, iy, iz = safe_inv_dir(d.x), safe_inv_dir(d.y), safe_inv_dir(d.z)
    best_t = torch.full_like(o.x, 3e38)
    best_k = torch.full((r,), k_total, dtype=torch.int32, device=dev)
    counts = torch.zeros((2, r), dtype=torch.int32, device=dev)
    node = torch.ones(r, dtype=torch.int64, device=dev)
    live = ~never_enters(o, d)
    while True:
        idx = torch.nonzero(live).squeeze(1)
        if idx.numel() == 0:
            break
        i = node[idx]
        t_near, t_far = slab_entry(tree[i], o.x[idx], o.y[idx], o.z[idx],
                                   ix[idx], iy[idx], iz[idx])
        enter = (t_far >= t_near) & (t_near < best_t[idx])
        leaf = i >= p
        counts[0, idx] += (~leaf).to(torch.int32)
        counts[1, idx] += leaf.to(torch.int32)
        win = enter & leaf
        w = idx[win]
        best_t[w] = t_near[win]
        best_k[w] = (i[win] - p).to(torch.int32)
        # the next row in depth-first order: the left child, or past this
        # row's subtree (up while a right child, then the right sibling)
        skip = i + 1
        skip = skip >> _trailing_zeros(skip)
        nxt = torch.where(enter & ~leaf, 2 * i, skip)
        node[idx] = nxt
        live[idx] = (nxt != 1) & ~(win & (t_near == 0))
    return best_k * 8 + _octant(d.x, d.y, d.z), counts


def _trailing_zeros(x: torch.Tensor) -> torch.Tensor:
    """Count of trailing zero bits of positive int64 values below 2^31."""
    low = x & -x  # the lowest set bit, a power of two: exact in float32
    return (torch.frexp(low.to(torch.float32))[1] - 1).to(torch.int64)


def _tree_leaves(k_total: int) -> int:
    """P of ``treelet_index_tree``: the least power of two >= K."""
    return 1 << (k_total - 1).bit_length()


def entry_key(o: V3, d: V3, treelets: torch.Tensor, tree: torch.Tensor, *,
              with_stats: bool = False):
    """The treelet-entry key ``k*8 + octant(d)`` [R] int32 of
    :func:`treelet_entry_key`: the CUDA kernel on CUDA tensors, its plain
    version :func:`entry_key_walk` on CPU tensors.  Rays are contiguous
    float32 [R] components; ``tree`` is ``treelet_index_tree(treelets)``
    (``TravData.treelet_tree``), and a table of another shape than
    ``treelets`` gives is refused (on the CPU also one of other values;
    on the card the values are not read back).  Every lane is keyed.  A
    ray with a NaN component, or with an infinite origin and an infinite
    direction on one axis, enters nothing and gets ``K*8 + octant(d)``;
    any other ray, infinite components included, gets what
    :func:`treelet_entry_key` gives it.  ``with_stats`` adds a [2, R]
    int32 tensor: the union and the member slab tests of each ray.  The
    rays are detached first: a key carries no gradient."""
    o, d = detached(o, d)
    r, dev = check_rays(o, d)
    k_total = int(treelets.shape[0])
    if not (treelets.dtype == torch.float32 and treelets.dim() == 2
            and treelets.shape[1] == 6 and treelets.is_contiguous()
            and treelets.device == dev and 0 < k_total <= 512):
        raise ValueError("treelets must be a contiguous float32 [K, 6] "
                         "tensor (0 < K <= 512) on the rays' device")
    p = _tree_leaves(k_total)
    check_table("tree", tree, 8, dev, align=True)
    if tree.shape[0] != 2 * p or (dev.type == "cpu" and not (
            torch.equal(tree[p:p + k_total, 0:3], treelets[:, 0:3])
            and torch.equal(tree[p:p + k_total, 4:7], treelets[:, 3:6]))):
        raise ValueError("tree is not treelet_index_tree(treelets)")
    if dev.type == "cpu":
        key, counts = entry_key_walk(o, d, tree, k_total)
        return (key, counts) if with_stats else key
    from pnraytracing_tpu_torch.cuda_build import library

    key = torch.empty(r, dtype=torch.int32, device=dev)
    counts = (torch.empty((2, r), dtype=torch.int32, device=dev)
              if with_stats else None)
    err = library("entry_key").pnrt_entry_key(
        tree.data_ptr(), 2 * p, p, k_total, o.x.data_ptr(), o.y.data_ptr(),
        o.z.data_ptr(), d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(), r,
        key.data_ptr(), ptr(counts), stream_of(key))
    if err:
        raise RuntimeError(f"entry-key kernel launch failed: CUDA error "
                           f"{err}")
    launched(LAUNCHES, "treelet_entry_key")
    return (key, counts) if with_stats else key


def kernel_info(k_total: int = 512) -> dict:
    """Registers a thread, threads a block and the blocks an SM holds of
    the key kernel as built, with the shared memory a K-box tree takes."""
    from pnraytracing_tpu_torch.cuda_build import library

    lib = library("entry_key")
    smem = 2 * _tree_leaves(k_total) * 32
    vals = {"registers": lib.pnrt_entry_key_kernel_info(0, smem),
            "blocks_per_sm": lib.pnrt_entry_key_kernel_info(1, smem),
            "threads": lib.pnrt_entry_key_kernel_info(2, smem),
            "shared_bytes": smem}
    if min(vals.values()) < 0:
        raise RuntimeError(f"entry_key: CUDA error {-min(vals.values())} "
                           "reading the kernel's attributes")
    return vals
