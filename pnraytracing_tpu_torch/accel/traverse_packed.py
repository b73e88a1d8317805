"""The walks of ``RenderConfig.traversal="packed"`` and ``"pop"``: the
CUDA kernels and their plain versions.

PyTorch counterpart of ``pnraytracing_tpu/accel/traverse_packed.py``,
whose walks are XLA while loops over the packed rows (``nodes8``,
``tri9``), not Pallas kernels:

* :func:`closest_hit_packed` / :func:`any_hit_packed` (JAX
  ``_closest_hit_flat`` / ``_any_hit_flat``): push-test.  A popped node
  tests its box against the best ``t`` (``t_max`` in the any hit); a
  leaf tests its first ``max_leaf_size`` triangles against the
  leaf-entry bound, a triangle winning only where its ``t`` is below the
  running best; an internal node tests both children's boxes and pushes
  far, then near (near by the sign of ``d[axis]``); the any hit stops at
  its first hit.  This is the walk of ``accel/traverse.py`` over other
  rows, so on the card it is that kernel (``csrc/traverse_bvh.cu``
  ``bvh_walk_kernel``) instantiated over the packed rows ``nodes8`` and
  ``tri12`` (``pnrt_packed_walk``), counted in :data:`LAUNCHES` under
  ``closest_hit_packed`` / ``any_hit_packed`` (+ ``_compat``).  The plain
  version is ``accel/traverse.py::walk_tree`` over the rows decoded by
  ``layout.unpack_node_rows``.
* :func:`closest_hit_pop` / :func:`any_hit_pop` (JAX
  ``_closest_hit_flat_pop`` / ``_any_hit_flat_pop``): pop-test, a node's
  box tested when it is popped and children pushed untested.  That is
  the walk of the binary kernels 5 / 6 (``csrc/traverse.cu``,
  ``accel/traverse_cuda.py``), which these launch with the leaf cap
  ``max_leaf_size``; they count under ``closest_hit_binary`` /
  ``any_hit_binary``.  Kernel 6 takes the near child first where JAX's
  any hit takes the left one: the occlusion does not depend on the
  order.

Rays are ``V3`` component tensors, as for every walk of the port, with
``[R]`` ``t_max`` and an optional ``[R]`` bool mask.  Each entry point
detaches its inputs (``traverse_cuda.detached``), checks them and the
tables (``nodes8``, ``tri9``, ``tri12``; ``stack_depth`` at least the
tree's depth and at most the kernels' 64-entry stack on the card), and
then launches its kernel on CUDA tensors or runs its plain version on
CPU tensors.  The plain versions run ``tile_size`` rays at a time and
read their loop condition every ``chunk`` steps, as JAX's ``_tiled``
and ``chunked_while`` do; a ray's answer depends on neither.  The
kernels walk one ray a thread and ignore both.  ``with_stats`` adds the
kernel's [3, R] int32 per-ray stats: pops, slab tests and triangle tests
(the packed walk), or pops, leaf pops and triangle tests (the pop walk).
:func:`plain` gives each entry point's plain version (those of
``traverse_packet`` and ``traverse_wide`` too), which runs on any device.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel.layout import TravData, unpack_node_rows
from pnraytracing_tpu_torch.accel.traverse import Tree, walk_tree
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import Hit
from pnraytracing_tpu_torch.utils.profiling import launched

_KERNELS = ("closest_hit_packed", "any_hit_packed")
# Launches per kernel since the last reset (the caller zeroes them)
LAUNCHES = {k + c: 0 for c in ("", "_compat") for k in _KERNELS}


def kernel_info() -> dict:
    """Registers and local bytes a thread, threads a block and blocks an
    SM of the packed walk's four instantiations, by their LAUNCHES names
    (``traverse_cuda.kernel_attributes``)."""
    from pnraytracing_tpu_torch.cuda_build import library

    query = library("traverse_bvh").pnrt_bvh_kernel_info
    return trv.kernel_attributes(
        lambda closest, compat, what: query(1, closest, compat, what),
        ((1, "closest_hit_packed"), (0, "any_hit_packed")))


def tiled(fn, o: V3, d: V3, t_max, mask, tile_size):
    """``fn(o, d, t_max, mask)`` over tiles of ``tile_size`` rays (all at
    once when None or not fewer), the results concatenated: the JAX
    package's ``_tiled``.  ``fn`` returns a ``Hit``, a tensor whose last
    axis is the rays, or a tuple of those."""
    r = t_max.shape[0]
    if tile_size is None or r <= tile_size:
        return fn(o, d, t_max, mask)
    cut = lambda a, i: None if a is None else a[i:i + tile_size]
    parts = [fn(o.map(lambda a, i=i: cut(a, i)),
                d.map(lambda a, i=i: cut(a, i)), cut(t_max, i),
                cut(mask, i)) for i in range(0, r, tile_size)]
    return _cat(parts)


def _cat(parts):
    first = parts[0]
    if isinstance(first, Hit):
        return Hit(*(torch.cat([getattr(p, k) for p in parts])
                     for k in ("tri", "t", "b1", "b2")))
    if isinstance(first, tuple):
        return tuple(_cat([p[j] for p in parts]) for j in range(len(first)))
    return torch.cat(parts, dim=-1)


def packed_tree(trav: TravData) -> Tree:
    """The tree of the packed rows, as ``accel/traverse.py::walk_tree``
    reads it: boxes and topology decoded from ``nodes8``, corners from
    ``tri9``."""
    nmin, nmax, right, start, count, axis = unpack_node_rows(trav.nodes8)
    return Tree(nmin, nmax, right, axis, start, start + count,
                lambda ti: trav.tri9[ti].view(-1, 3, 3))


def _kernel_packed(trav, o, d, t_max, mask, closest, stack_depth,
                   max_leaf_size, compat, with_stats):
    from pnraytracing_tpu_torch.cuda_build import library

    r, dev = o.x.shape[0], o.x.device
    outs, stats = trv._outputs(r, dev, closest, with_stats)
    t, tri, b1, b2 = outs if closest else (None,) * 4
    occ = None if closest else outs[0]
    err = library("traverse_bvh").pnrt_packed_walk(
        trv.ptr(trav.nodes8), trv.ptr(trav.tri12), int(max_leaf_size),
        int(stack_depth), trv.ptr(o.x), trv.ptr(o.y), trv.ptr(o.z),
        trv.ptr(d.x), trv.ptr(d.y), trv.ptr(d.z), trv.ptr(t_max),
        trv.ptr(mask), r, int(closest), int(compat), trv.ptr(t),
        trv.ptr(tri), trv.ptr(b1), trv.ptr(b2), trv.ptr(occ),
        trv.ptr(stats), trv.stream_of(o.x))
    name = "closest_hit_packed" if closest else "any_hit_packed"
    trv._raise_on(err, name)
    launched(LAUNCHES, trv.launch_name(name, compat))
    out = Hit(tri=tri, t=t, b1=b1, b2=b2) if closest else occ
    return (out, stats) if with_stats else out


def _plain_packed(trav, o, d, t_max, mask, closest, stack_depth,
                  max_leaf_size, compat, tile_size, chunk, with_stats):
    tree = packed_tree(trav)

    def run(o_, d_, tm_, m_):
        hit, occ, stats = walk_tree(tree, o_, d_, tm_, m_, stack_depth,
                                    max_leaf_size, compat, closest, chunk)
        out = hit if closest else occ
        return (out, stats) if with_stats else out

    return tiled(run, o, d, t_max, mask, tile_size)


def _plain_pop(trav, o, d, t_max, mask, closest, stack_depth, max_leaf_size,
               compat, tile_size, chunk, with_stats):
    plain = (trv.plain_closest_hit_binary if closest
             else trv.plain_any_hit_binary)
    return tiled(lambda o_, d_, tm_, m_: plain(
        trav, o_, d_, tm_, m_, stack_depth=stack_depth, with_stats=with_stats,
        compat=compat, max_leaf_size=max_leaf_size, chunk=chunk),
        o, d, t_max, mask, tile_size)


def _kernel_pop(trav, o, d, t_max, mask, closest, stack_depth, max_leaf_size,
                compat, with_stats):
    out, stats = trv._kernel_binary(trav, o, d, t_max, mask, closest,
                                    with_stats, compat, max_leaf_size)
    return (out, stats) if with_stats else out


def walk(kernel, plain, trav, o, d, t_max, mask, closest, stack_depth,
         max_leaf_size, compat, tile_size, chunk, with_stats, variant):
    """An entry point: its inputs detached and checked (the tables that
    ``variant`` reads, traverse_cuda's check), then ``kernel`` on CUDA
    tensors or ``plain`` on CPU tensors."""
    o, d, t_max, mask = trv.detached(o, d, t_max, mask)
    cap = trv._leaf_cap(max_leaf_size)
    if trv._check(trav, o, d, t_max, mask, stack_depth,
                  variant).type == "cpu":
        return plain(trav, o, d, t_max, mask, closest, stack_depth, cap,
                     compat, tile_size, chunk, with_stats)
    return kernel(trav, o, d, t_max, mask, closest, stack_depth, cap,
                  compat, with_stats)


def closest_hit_packed(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                       mask: torch.Tensor | None = None, *,
                       stack_depth: int = 64, max_leaf_size: int = 4,
                       compat: bool = False, tile_size: int | None = None,
                       chunk: int = 16, with_stats: bool = False):
    """Closest hit by the packed push-test walk: ``Hit`` (+ stats)."""
    return walk(_kernel_packed, _plain_packed, trav, o, d, t_max, mask,
                True, stack_depth, max_leaf_size, compat, tile_size, chunk,
                with_stats, "binary")


def any_hit_packed(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                   mask: torch.Tensor | None = None, *,
                   stack_depth: int = 64, max_leaf_size: int = 4,
                   compat: bool = False, tile_size: int | None = None,
                   chunk: int = 16, with_stats: bool = False):
    """Occlusion by the packed push-test walk: [R] bool (+ stats)."""
    return walk(_kernel_packed, _plain_packed, trav, o, d, t_max, mask,
                False, stack_depth, max_leaf_size, compat, tile_size, chunk,
                with_stats, "binary")


def closest_hit_pop(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                    mask: torch.Tensor | None = None, *,
                    stack_depth: int = 64, max_leaf_size: int = 4,
                    compat: bool = False, tile_size: int | None = None,
                    chunk: int = 16, with_stats: bool = False):
    """Closest hit by the pop-test walk (kernel 5): ``Hit`` (+ stats)."""
    return walk(_kernel_pop, _plain_pop, trav, o, d, t_max, mask, True,
                stack_depth, max_leaf_size, compat, tile_size, chunk,
                with_stats, "binary")


def any_hit_pop(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                mask: torch.Tensor | None = None, *,
                stack_depth: int = 64, max_leaf_size: int = 4,
                compat: bool = False, tile_size: int | None = None,
                chunk: int = 16, with_stats: bool = False):
    """Occlusion by the pop-test walk (kernel 6): [R] bool (+ stats)."""
    return walk(_kernel_pop, _plain_pop, trav, o, d, t_max, mask, False,
                stack_depth, max_leaf_size, compat, tile_size, chunk,
                with_stats, "binary")


def plain(name: str):
    """The plain version of entry point ``name`` (of this module,
    traverse_packet or traverse_wide), with its signature; it runs on
    any device (also to hold the kernel against it on the card) and
    never launches a kernel."""
    from pnraytracing_tpu_torch.accel.traverse_wide import _plain_wide

    fn = {"packed": _plain_packed, "pop": _plain_pop, "packet": _plain_pop,
          "wide": _plain_wide}[name.split("_")[-1]]
    closest = name.startswith("closest")

    def run(trav, o, d, t_max, mask=None, *, stack_depth=64,
            max_leaf_size=4, compat=False, tile_size=None, chunk=16,
            with_stats=False):
        o, d, t_max, mask = trv.detached(o, d, t_max, mask)
        return fn(trav, o, d, t_max, mask, closest, stack_depth,
                  trv._leaf_cap(max_leaf_size), compat, tile_size, chunk,
                  with_stats)

    return run
