"""BVH walk over a scene's plain arrays: the CUDA kernel and its plain
version.

PyTorch counterpart of ``pnraytracing_tpu/accel/traverse.py``
(``closest_hit``, ``any_hit``, ``traversal_stats``), the walk the JAX
package takes for every scene outside the packed layout (``trav=None``:
a leaf of more than 15 triangles, more than 2^22 nodes or 2^20
triangles, a flat BVH) and for ``probe_pixel``'s primary hit.  It reads
``BVH`` (``node_min`` / ``node_max`` [N, 3] f32, ``axis``,
``right_child``, ``start``, ``end`` [N] i32) and ``TriangleMesh``
(``indices`` [T, 3] i32 in leaf order, ``positions`` [V, 3] f32) as they
are.  The JAX walk is XLA, not a Pallas kernel; its port is the kernel
pair of ``csrc/traverse_bvh.cu`` (design and bound noted there).

Rays come as component tensors (``V3`` origins and directions, ``[R]``
t_max and optional ``[R]`` bool mask), as for the port's other walks.
Each entry point detaches its inputs (``traverse_cuda.detached``), checks
them, and then

* on CUDA tensors launches the kernel on the current stream and adds one
  to its entry of :data:`LAUNCHES` (a compat launch under the name with
  ``_compat`` appended); a failed build or launch raises;
* on CPU tensors runs the plain version (``plain_*``): the JAX walk
  transcribed to torch, a masked ``[R, stack_depth]`` stack from which
  each step pops one node for every ray whose stack is not empty.

Semantics are the JAX walk's, step for step: a popped node tests its box
against the best ``t`` (``t_max`` in the any-hit walk); a leaf tests at
most ``max_leaf_size`` of its triangles (``_leaf_triangles``: the JAX
cap, kept) against the leaf-entry bound, a triangle winning only if its
``t`` is below the running best; an internal node tests both children's
boxes and pushes far, then near (near by the sign of ``d[axis]``); the
any-hit walk stops at its first hit.  Masked rays pop nothing; a NaN ray
pops the root and fails its box.  The stack indices are clipped at
``stack_depth - 1`` as in the JAX walk (the integrator's guard keeps the
stack from filling).  ``with_stats`` adds an ``[3, R]`` int32 tensor of
per-ray pops, slab tests and triangle tests; :func:`traversal_stats`
returns the pops and their batch maximum, which is the JAX walk's
``iters`` (every ray starts with the root pushed).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pnraytracing_tpu_torch.accel.loops import chunked_while
from pnraytracing_tpu_torch.accel.traverse_cuda import (
    KERNEL_STACK,
    check_mask,
    check_rays,
    check_table,
    detached,
    kernel_attributes,
    launch_name,
    ptr,
    stream_of,
)
from pnraytracing_tpu_torch.core.types import BVH, TriangleMesh
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import (
    Hit,
    intersect_aabb,
    intersect_triangle,
    safe_inv_dir,
)
from pnraytracing_tpu_torch.utils.profiling import launched

_KERNELS = ("closest_hit_bvh", "any_hit_bvh")
# Launches per kernel since the last reset (the caller zeroes them)
LAUNCHES = {k + c: 0 for c in ("", "_compat") for k in _KERNELS}


def _check(bvh: BVH, mesh: TriangleMesh, o: V3, d: V3, t_max, mask,
           stack_depth: int, max_leaf_size: int):
    """The device of a checked walk; raises on anything the kernel does
    not take."""
    r, dev = check_rays(o, d, t_max)
    check_mask(mask, r, dev)
    for name, t in (("bvh.node_min", bvh.node_min),
                    ("bvh.node_max", bvh.node_max),
                    ("mesh.positions", mesh.positions)):
        check_table(name, t, 3, dev)
    n = bvh.node_min.shape[0]
    for name, t, shape in (("bvh.axis", bvh.axis, (n,)),
                           ("bvh.right_child", bvh.right_child, (n,)),
                           ("bvh.start", bvh.start, (n,)),
                           ("bvh.end", bvh.end, (n,)),
                           ("mesh.indices", mesh.indices,
                            (mesh.indices.shape[0], 3))):
        if not (t.dtype == torch.int32 and tuple(t.shape) == shape
                and t.is_contiguous() and t.device == dev):
            raise ValueError(f"{name} must be a contiguous int32 "
                             f"{list(shape)} tensor on the rays' device")
    if stack_depth < 1 or max_leaf_size < 0:
        raise ValueError("stack_depth must be >= 1 and max_leaf_size >= 0")
    if dev.type == "cuda" and stack_depth > KERNEL_STACK:
        raise ValueError(f"the CUDA walk keeps a {KERNEL_STACK}-entry "
                         f"stack; stack_depth={stack_depth} exceeds it")
    return dev


def kernel_info() -> dict:
    """Registers and local bytes a thread, threads a block and blocks an
    SM of the four instantiations, by their LAUNCHES names
    (``traverse_cuda.kernel_attributes``)."""
    from pnraytracing_tpu_torch.cuda_build import library

    query = library("traverse_bvh").pnrt_bvh_kernel_info
    return kernel_attributes(
        lambda closest, compat, what: query(0, closest, compat, what),
        ((1, "closest_hit_bvh"), (0, "any_hit_bvh")))


def _kernel(bvh, mesh, o, d, t_max, mask, closest: bool, stack_depth,
            max_leaf_size, compat, with_stats):
    from pnraytracing_tpu_torch.cuda_build import library

    r, dev = o.x.shape[0], o.x.device
    f32 = lambda: torch.empty(r, dtype=torch.float32, device=dev)
    if closest:
        t, tri, b1, b2 = (f32(), torch.empty(r, dtype=torch.int32,
                                             device=dev), f32(), f32())
        occ = None
    else:
        t = tri = b1 = b2 = None
        occ = torch.empty(r, dtype=torch.bool, device=dev)
    stats = (torch.empty((3, r), dtype=torch.int32, device=dev)
             if with_stats else None)
    err = library("traverse_bvh").pnrt_bvh_walk(
        ptr(bvh.node_min), ptr(bvh.node_max), ptr(bvh.axis),
        ptr(bvh.right_child), ptr(bvh.start), ptr(bvh.end),
        ptr(mesh.indices), ptr(mesh.positions), int(max_leaf_size),
        int(stack_depth), ptr(o.x), ptr(o.y), ptr(o.z), ptr(d.x), ptr(d.y),
        ptr(d.z), ptr(t_max), ptr(mask), r, int(closest), int(compat),
        ptr(t), ptr(tri), ptr(b1), ptr(b2), ptr(occ), ptr(stats),
        stream_of(o.x))
    name = "closest_hit_bvh" if closest else "any_hit_bvh"
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launched(LAUNCHES, launch_name(name, compat))
    out = Hit(tri=tri, t=t, b1=b1, b2=b2) if closest else occ
    return (out, stats) if with_stats else out


# ---- the plain version ----------------------------------------------------

def _push(stack, top, rows, entry, commit, cap: int):
    """The JAX walk's masked push: ``entry`` into slot min(top, cap) of
    each row where ``commit``, then top += commit."""
    t0 = top[rows]
    slot = t0.clamp(max=cap)
    stack[rows, slot] = torch.where(commit, entry, stack[rows, slot])
    top[rows] = t0 + commit


@dataclasses.dataclass
class Tree:
    """What the plain walk reads of a tree: per node its box
    (``node_min`` / ``node_max`` [N, 3]), ``right`` child (-1 at a leaf),
    split ``axis`` and leaf range ``start`` .. ``end`` ([N] integer
    tensors), and ``corners(ti)``, the [n, 3, 3] corners of triangles
    ``ti``.  :func:`plain_tree` makes it of a ``BVH`` and its mesh;
    ``accel/traverse_packed.py`` of the packed rows."""

    node_min: torch.Tensor
    node_max: torch.Tensor
    right: torch.Tensor
    axis: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    corners: Callable[[torch.Tensor], torch.Tensor]


def plain_tree(bvh: BVH, mesh: TriangleMesh) -> Tree:
    return Tree(bvh.node_min, bvh.node_max, bvh.right_child, bvh.axis,
                bvh.start, bvh.end,
                lambda ti: mesh.positions[mesh.indices[ti].long()])


def walk_tree(tree: Tree, o: V3, d: V3, t_max, mask, stack_depth: int,
              max_leaf_size: int, compat: bool, closest: bool,
              chunk: int = 1):
    """The JAX walk, plainly: ``(Hit, occlusion, [3, R] stats)``; the
    loop's condition is read every ``chunk`` steps (accel/loops.py)."""
    o_r, d_r = o.rows(), d.rows()
    inv = safe_inv_dir(d_r)
    r, dev = t_max.shape[0], t_max.device
    cap = stack_depth - 1
    stack = torch.zeros((r, stack_depth), dtype=torch.int64, device=dev)
    top = torch.ones(r, dtype=torch.int64, device=dev)
    if mask is not None:
        top = top * mask
    t_best = t_max.clone()
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros(r, dtype=torch.float32, device=dev)
    b2 = torch.zeros_like(b1)
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    stats = torch.zeros((3, r), dtype=torch.int32, device=dev)
    box = lambda nodes, rows, t_lim: intersect_aabb(
        tree.node_min[nodes], tree.node_max[nodes], o_r[rows], inv[rows],
        t_lim, compat)

    def step(_):
        idx = torch.nonzero(top > 0).squeeze(1)
        if idx.numel() == 0:
            return None
        node = stack[idx, (top[idx] - 1).clamp(max=cap)]
        top[idx] -= 1
        stats[0, idx] += 1
        stats[1, idx] += 1
        t_lim = t_best[idx] if closest else t_max[idx]
        hit = box(node, idx, t_lim)
        right = tree.right[node].long()

        leaf = hit & (right < 0)
        lrows, lnode = idx[leaf], node[leaf]
        if lrows.numel():
            s = tree.start[lnode].long()
            count = torch.minimum(tree.end[lnode].long(),
                                  s + max_leaf_size) - s
            t_leaf = t_lim[leaf]
            for k in range(int(count.max())):
                sel = count > k
                if not closest:  # the walk stops at its first hit
                    sel = sel & ~occ[lrows]
                rows = lrows[sel]
                if rows.numel() == 0:
                    continue
                ti = s[sel] + k
                p = tree.corners(ti)  # [n, 3, 3]
                stats[2, rows] += 1
                h, t, u, v = intersect_triangle(
                    p[:, 0], p[:, 1], p[:, 2], o_r[rows], d_r[rows],
                    t_leaf[sel], compat)
                if not closest:
                    occ[rows[h]] = True
                    continue
                win = h & (t < t_best[rows])
                w = rows[win]
                t_best[w] = t[win]
                tri[w] = ti[win].to(torch.int32)
                b1[w] = u[win]
                b2[w] = v[win]

        inner = hit & (right >= 0)
        irows, inode = idx[inner], node[inner]
        if irows.numel():
            ax = tree.axis[inode].long().clamp(min=0)
            neg = d_r[irows, ax] < 0
            left, rc = inode + 1, right[inner]
            near, far = torch.where(neg, rc, left), torch.where(neg, left, rc)
            tl = t_lim[inner]
            far_ok, near_ok = box(far, irows, tl), box(near, irows, tl)
            stats[1, irows] += 2
            _push(stack, top, irows, far, far_ok, cap)
            _push(stack, top, irows, near, near_ok, cap)
        if not closest:
            top[occ] = 0
        return None

    chunked_while(lambda _: bool((top > 0).any()), step, None, chunk)
    return Hit(tri=tri, t=t_best, b1=b1, b2=b2), occ, stats


def _walk_plain(bvh: BVH, mesh: TriangleMesh, o: V3, d: V3, t_max, mask,
                stack_depth: int, max_leaf_size: int, compat: bool,
                closest: bool):
    return walk_tree(plain_tree(bvh, mesh), o, d, t_max, mask, stack_depth,
                     max_leaf_size, compat, closest)


def plain_closest_hit(bvh, mesh, o, d, t_max, mask=None, *, stack_depth=64,
                      max_leaf_size=4, compat=False, with_stats=False):
    """The plain version of :func:`closest_hit` on any device (also for
    holding the kernel against it on the card); never launches one."""
    hit, _, stats = _walk_plain(bvh, mesh, o, d, t_max, mask, stack_depth,
                                max_leaf_size, compat, True)
    return (hit, stats) if with_stats else hit


def plain_any_hit(bvh, mesh, o, d, t_max, mask=None, *, stack_depth=64,
                  max_leaf_size=4, compat=False, with_stats=False):
    _, occ, stats = _walk_plain(bvh, mesh, o, d, t_max, mask, stack_depth,
                                max_leaf_size, compat, False)
    return (occ, stats) if with_stats else occ


def plain_traversal_stats(bvh, mesh, o, d, t_max, *, stack_depth=64,
                          max_leaf_size=4, compat=False):
    _, _, stats = _walk_plain(bvh, mesh, o, d, t_max, None, stack_depth,
                              max_leaf_size, compat, True)
    return stats[0], stats[0].max()


# ---- the entry points -----------------------------------------------------

def closest_hit(bvh: BVH, mesh: TriangleMesh, o: V3, d: V3,
                t_max: torch.Tensor, mask: torch.Tensor | None = None, *,
                stack_depth: int = 64, max_leaf_size: int = 4,
                compat: bool = False, with_stats: bool = False):
    """Closest hit (BVHIntersect, ray_tracing.comp:429-461): ``Hit``
    (``t_max`` and tri -1 on a miss), + stats."""
    o, d, t_max, mask = detached(o, d, t_max, mask)
    kw = dict(stack_depth=stack_depth, max_leaf_size=max_leaf_size,
              compat=compat, with_stats=with_stats)
    if _check(bvh, mesh, o, d, t_max, mask, stack_depth,
              max_leaf_size).type == "cpu":
        return plain_closest_hit(bvh, mesh, o, d, t_max, mask, **kw)
    return _kernel(bvh, mesh, o, d, t_max, mask, True, **kw)


def any_hit(bvh: BVH, mesh: TriangleMesh, o: V3, d: V3,
            t_max: torch.Tensor, mask: torch.Tensor | None = None, *,
            stack_depth: int = 64, max_leaf_size: int = 4,
            compat: bool = False, with_stats: bool = False):
    """Occlusion (BVHIntersectP, ray_tracing.comp:464-494): [R] bool, True
    where a triangle is hit within ``t_max``, + stats."""
    o, d, t_max, mask = detached(o, d, t_max, mask)
    kw = dict(stack_depth=stack_depth, max_leaf_size=max_leaf_size,
              compat=compat, with_stats=with_stats)
    if _check(bvh, mesh, o, d, t_max, mask, stack_depth,
              max_leaf_size).type == "cpu":
        return plain_any_hit(bvh, mesh, o, d, t_max, mask, **kw)
    return _kernel(bvh, mesh, o, d, t_max, mask, False, **kw)


def traversal_stats(bvh: BVH, mesh: TriangleMesh, o: V3, d: V3,
                    t_max: torch.Tensor, *, stack_depth: int = 64,
                    max_leaf_size: int = 4, compat: bool = False):
    """The instrumented closest hit: (per-ray node visits [R] int32, the
    JAX walk's lockstep iterations, a 0-d tensor: the visits' maximum).
    On the card the closest-hit kernel with its stats."""
    o, d, t_max = detached(o, d, t_max)
    if _check(bvh, mesh, o, d, t_max, None, stack_depth,
              max_leaf_size).type == "cpu":
        return plain_traversal_stats(bvh, mesh, o, d, t_max,
                                     stack_depth=stack_depth,
                                     max_leaf_size=max_leaf_size,
                                     compat=compat)
    _, stats = _kernel(bvh, mesh, o, d, t_max, None, True, stack_depth,
                       max_leaf_size, compat, True)
    return stats[0], stats[0].max()
