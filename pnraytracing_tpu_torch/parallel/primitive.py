"""Primitive-sharded scene placement: traversal of a scene whose triangles
are split over the ranks, for scenes too large for one card's memory.

PyTorch counterpart of ``pnraytracing_tpu/parallel/primitive.py``.  The
triangle list is cut into ``D`` contiguous chunks; each chunk gets its
own BVH and binary layout (``nodes8`` / ``tri9`` / ``tri12``), rank ``k``
holds chunk ``k`` only, every rank walks ALL rays over its chunk, and the
per-chunk answers are combined by collectives: the closest hit is the
min-``t`` winner (ties to the lowest shard id), occlusion the OR.

The walks are the port's binary pop-test walks
(``accel/traverse_cuda.py``, ``variant="binary"``): kernels 5 and 6 on
the card (their compat forms with ``compat=True``), their plain versions
on the CPU.  The combine (:func:`combine_closest`, :func:`combine_any`)
is a function of the per-shard answers and of a ``reduce`` callable, so
the same code combines one shard a rank through ``all_reduce``
(:func:`primitive_sharded_closest_hit`, :func:`primitive_sharded_any_hit`)
or ``D`` shards walked in one process (:func:`place_all`,
:func:`shards_closest_hit`, :func:`shards_any_hit`).  The JAX
functions' ``tile_size`` and ``check_vma`` (XLA tiling of the walk,
``shard_map``'s replication check) and ``max_leaf_size`` (the unrolled
leaf loop of its XLA walk; the port's walks read each leaf's count) have
no counterpart.

Shards are built on the host in numpy by the port's own builder
(``accel/bvh.py``), as the JAX package builds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnraytracing_tpu_torch.accel.layout import (
    TravData,
    pack_nodes8,
    pack_tri12,
)
from pnraytracing_tpu_torch.accel.native import bvh_builder
from pnraytracing_tpu_torch.accel.traverse_cuda import any_hit, closest_hit
from pnraytracing_tpu_torch.core.camera import resolve_device
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import Hit
from pnraytracing_tpu_torch.parallel.distributed import all_reduce, rank_device

_BIG = 3e38


@dataclasses.dataclass
class PrimShards:
    """Per-shard binary layouts stacked on a leading shard axis, numpy on
    the host (:func:`build_primitive_shards`)."""

    nodes8: np.ndarray  # [D, Np, 8] f32; padded rows are empty leaves
    # that no child id references
    tri9: np.ndarray  # [D, Tp, 9] f32; padded rows are all-zero triangles
    tri12: np.ndarray  # [D, Tp, 12] f32: tri9 zero-padded (the kernels')
    tri_map: np.ndarray  # [D, Tp] i32 shard-local -> GLOBAL triangle id
    # (-1 on padded rows)
    n_shards: int = 1
    bvh_depth: int = 1  # the deepest shard's BVH depth

    @property
    def stack_depth(self) -> int:
        """The walks' stack: ``bvh_depth + 4``, as the JAX package sets
        it."""
        return self.bvh_depth + 4


@dataclasses.dataclass
class PlacedShard:
    """One shard on a device: its walk tables (only ``tri9``, ``tri12``,
    ``nodes8`` and ``bvh_depth`` filled, which is all the binary walks
    read) and its local -> global triangle map."""

    trav: TravData
    tri_map: torch.Tensor  # [Tp] int32
    shard: int
    n_shards: int

    @property
    def stack_depth(self) -> int:
        return self.trav.bvh_depth + 4


def shard_bounds(n_tris: int, n_shards: int) -> np.ndarray:
    """[D + 1] triangle offsets of the contiguous chunks."""
    if not 1 <= n_shards <= n_tris:
        raise ValueError(f"{n_tris} triangles cannot make {n_shards} shards")
    return np.linspace(0, n_tris, n_shards + 1).astype(np.int64)


def build_shard(positions, indices, lo: int, hi: int,
                max_leaf_size: int = 4):
    """``(nodes8, tri9, tri_map, max_depth)`` of the chunk ``indices[lo:
    hi]``: its own BVH, its triangles in leaf order and their global
    ids."""
    positions = np.asarray(positions, np.float32)
    chunk = np.asarray(indices, np.int32)[lo:hi]
    built = bvh_builder()(positions, chunk, max_leaf_size=max_leaf_size)
    order = np.asarray(built.order)
    tri9 = positions[chunk[order]].reshape(len(order), 9)
    return (pack_nodes8(built), tri9.astype(np.float32),
            (lo + order).astype(np.int32), int(built.max_depth))


def stack_shards(parts) -> PrimShards:
    """Stack the :func:`build_shard` results of every shard, in shard
    order, padded to common row counts."""
    n = len(parts)
    np_pad = max(len(p[0]) for p in parts)
    tp_pad = max(len(p[1]) for p in parts)
    nodes = np.zeros((n, np_pad, 8), np.float32)
    nodes[:, :, 0:3] = 3e38
    nodes[:, :, 3:6] = -3e38
    nodes[:, :, 6] = -1.0
    tri9 = np.zeros((n, tp_pad, 9), np.float32)
    tri_map = np.full((n, tp_pad), -1, np.int32)
    for s, (nd, tr, mp, _) in enumerate(parts):
        nodes[s, :len(nd)] = nd
        tri9[s, :len(tr)] = tr
        tri_map[s, :len(mp)] = mp
    depth = max([1] + [p[3] for p in parts])
    return PrimShards(
        nodes8=nodes, tri9=tri9,
        tri12=np.stack([pack_tri12(t) for t in tri9]), tri_map=tri_map,
        n_shards=n, bvh_depth=depth)


def build_primitive_shards(positions, indices, n_shards: int,
                           max_leaf_size: int = 4) -> PrimShards:
    """Partition the triangle list into ``n_shards`` contiguous chunks and
    build an independent BVH and binary layout for each (host side)."""
    b = shard_bounds(len(indices), n_shards)
    return stack_shards([build_shard(positions, indices, int(b[s]),
                                     int(b[s + 1]), max_leaf_size)
                         for s in range(n_shards)])


def place_shard(shards: PrimShards, k: int, device=None) -> PlacedShard:
    """Shard ``k`` of ``shards`` on ``device`` (None = the card)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    empty16 = torch.empty((0, 16), dtype=torch.float32, device=dev)
    trav = TravData(tri9=t(shards.tri9[k]), tri12=t(shards.tri12[k]),
                    nodes8=t(shards.nodes8[k]), nodes16c=empty16,
                    tri_attr16=empty16, treelets=None, treelet_tree=None,
                    bvh_depth=shards.bvh_depth)
    return PlacedShard(trav=trav, tri_map=t(shards.tri_map[k]), shard=k,
                       n_shards=shards.n_shards)


def put_shards(shards: PrimShards, mesh, device=None) -> PlacedShard:
    """This rank's shard on its device (None = the rank's card): the
    scene then occupies 1/D of each card's memory.  One shard a rank of
    the mesh."""
    if shards.n_shards != mesh.size:
        raise ValueError(f"{shards.n_shards} shards on a mesh of "
                         f"{mesh.size} ranks")
    if mesh.index < 0:
        raise ValueError("this rank is not in the mesh")
    return place_shard(shards, mesh.index, rank_device(device))


def ray_components(o: torch.Tensor, d: torch.Tensor) -> tuple[V3, V3]:
    """[R, 3] origins and directions as the walks take them: V3s of
    contiguous components."""
    return (V3.of(o).map(torch.Tensor.contiguous),
            V3.of(d).map(torch.Tensor.contiguous))


def walk_closest(placed: PlacedShard, o, d, t_max, compat: bool = False):
    """One shard's closest hit over all rays by the binary walk (kernel 5
    on the card), ``tri`` as GLOBAL ids: ``(t, tri, b1, b2)``."""
    hit = closest_hit(placed.trav, *ray_components(o, d), t_max,
                      stack_depth=placed.stack_depth, variant="binary",
                      compat=compat)
    gtri = torch.where(hit.valid,
                       placed.tri_map[torch.clamp_min(hit.tri, 0).long()],
                       torch.full_like(hit.tri, -1))
    return hit.t, gtri, hit.b1, hit.b2


def walk_any(placed: PlacedShard, o, d, t_max, compat: bool = False):
    """One shard's occlusion over all rays (kernel 6 on the card)."""
    return any_hit(placed.trav, *ray_components(o, d), t_max,
                   stack_depth=placed.stack_depth, variant="binary",
                   compat=compat)


def local_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` reduced over its leading (shard) axis, in its own dtype."""
    return x.amin(0) if op == "min" else x.sum(0, dtype=x.dtype)


def collective_reduce(group):
    """The ``reduce`` of :func:`combine_closest` for one or more shards a
    rank: the local reduction, then ``all_reduce`` over ``group``."""
    return lambda x, op: all_reduce(local_reduce(x, op), op, group)


def combine_closest(t, tri, b1, b2, shard_ids, n_shards: int, t_max,
                    reduce) -> Hit:
    """The global closest hit from per-shard answers ``[L, R]`` (``tri``
    global, -1 on a miss) of the shards ``shard_ids`` [L]; ``reduce(x,
    op)`` reduces ``x`` [L, ...] over every shard ('min' or 'sum').

    The winner's ``t`` is the min over shards; ties go to the lowest
    shard id (a min of the claiming ids); the winner's ``tri``, ``b1``
    and ``b2`` are summed with zeros from every other shard, as their
    int32 bit patterns, so the sum is exact and one collective carries
    all three.  A miss everywhere gives ``t_max``, -1 and zeros."""
    valid = tri >= 0
    tv = torch.where(valid, t, torch.full_like(t, _BIG))
    tmin = reduce(tv, "min")
    sid = torch.tensor(list(shard_ids), dtype=torch.int32,
                       device=t.device)[:, None]
    claim = torch.where(valid & (tv == tmin), sid,
                        torch.full_like(tri, n_shards))
    owner = reduce(claim, "min")
    mine = (claim == owner) & (owner < n_shards)
    words = torch.stack([tri, b1.view(torch.int32), b2.view(torch.int32)],
                        dim=1)
    words = reduce(torch.where(mine[:, None], words,
                               torch.zeros_like(words)), "sum")
    hit_any = owner < n_shards
    return Hit(tri=torch.where(hit_any, words[0], -1),
               t=torch.where(hit_any, tmin, t_max),
               b1=words[1].view(torch.float32),
               b2=words[2].view(torch.float32))


def combine_any(occ, reduce) -> torch.Tensor:
    """Occlusion from per-shard flags ``[L, R]``: the OR over every shard
    (a sum > 0)."""
    return reduce(occ.to(torch.int32), "sum") > 0


def primitive_sharded_closest_hit(placed: PlacedShard, o, d, t_max, mesh, *,
                                  compat: bool = False) -> Hit:
    """Closest hit over the partitioned scene: this rank walks its shard
    for ALL rays (``o``, ``d`` [R, 3], ``t_max`` [R], the same on every
    rank), then the global winner is combined over the mesh.  Returns
    the same Hit, with GLOBAL triangle ids, on every rank."""
    t, tri, b1, b2 = walk_closest(placed, o, d, t_max, compat)
    return combine_closest(t[None], tri[None], b1[None], b2[None],
                           [placed.shard], placed.n_shards, t_max,
                           collective_reduce(mesh.group))


def primitive_sharded_any_hit(placed: PlacedShard, o, d, t_max, mesh, *,
                              compat: bool = False) -> torch.Tensor:
    """Occlusion over the partitioned scene: this rank's any-hit, OR'd
    over the mesh."""
    occ = walk_any(placed, o, d, t_max, compat)
    return combine_any(occ[None], collective_reduce(mesh.group))


def place_all(shards: PrimShards, device=None) -> list[PlacedShard]:
    """Every shard of ``shards`` on one ``device`` (None = the card), for
    :func:`shards_closest_hit` and :func:`shards_any_hit`."""
    return [place_shard(shards, k, device) for k in range(shards.n_shards)]


def shards_closest_hit(placed: list[PlacedShard], o, d, t_max, *,
                       compat: bool = False) -> Hit:
    """The closest hit of :func:`primitive_sharded_closest_hit` with every
    shard (:func:`place_all`) walked in this one process."""
    t, tri, b1, b2 = (torch.stack(x) for x in zip(*[
        walk_closest(p, o, d, t_max, compat) for p in placed]))
    n = placed[0].n_shards
    return combine_closest(t, tri, b1, b2, [p.shard for p in placed], n,
                           t_max, local_reduce)


def shards_any_hit(placed: list[PlacedShard], o, d, t_max, *,
                   compat: bool = False) -> torch.Tensor:
    """The occlusion of :func:`primitive_sharded_any_hit`, every shard
    walked in this one process."""
    occ = torch.stack([walk_any(p, o, d, t_max, compat) for p in placed])
    return combine_any(occ, local_reduce)
