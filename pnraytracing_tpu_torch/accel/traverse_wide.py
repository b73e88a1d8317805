"""The walk of ``RenderConfig.traversal="wide"``.

PyTorch counterpart of ``pnraytracing_tpu/accel/traverse_wide.py``
(``closest_hit_wide``, ``any_hit_wide``): an XLA while loop that pops
internal nodes only, each an ``[N, 16]`` row of ``nodes16`` holding both
children's boxes and encoded infos, tests both boxes against the best
``t``, tests the first ``max_leaf_size`` triangles of each child leaf
whose box was hit in one batch, and pushes the hit internal children
far, then near.

On Hopper that is the push-test walk of the resident kernels 3 / 2
(``closest_hit_kernel<false>``, ``any_hit_kernel`` of
``csrc/traverse.cu``, ``accel/traverse_cuda.py``) over the compact rows
``nodes16c`` (the same rows with internal children as compact row ids;
the port's scenes carry no ``nodes16``, accel/layout.py), launched with
the leaf cap ``max_leaf_size`` and whatever the scene's size (the
``pallas`` route's resident budget does not apply), counted under
``closest_hit`` / ``any_hit``.  The kernel visits a hit child leaf when
it goes into it, not at its parent, so a triangle id may differ from
JAX's only on exact-``t`` ties.  The plain versions run ``tile_size``
rays at a time and read their loop condition every ``chunk`` steps; the
kernels ignore both.  ``with_stats`` adds the kernel's [3, R] int32 pops,
leaf pops and triangle tests.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel.layout import TravData
from pnraytracing_tpu_torch.accel.traverse_packed import tiled, walk
from pnraytracing_tpu_torch.core.vec import V3


def _plain_wide(trav, o, d, t_max, mask, closest, stack_depth,
                max_leaf_size, compat, tile_size, chunk, with_stats):
    plain_fn = trv.plain_closest_hit if closest else trv.plain_any_hit
    return tiled(lambda o_, d_, tm_, m_: plain_fn(
        trav, o_, d_, tm_, m_, stack_depth=stack_depth,
        with_stats=with_stats, compat=compat, max_leaf_size=max_leaf_size,
        chunk=chunk), o, d, t_max, mask, tile_size)


def _kernel_wide(trav, o, d, t_max, mask, closest, stack_depth,
                 max_leaf_size, compat, with_stats):
    if closest:
        out, _, stats = trv._kernel_closest(trav, o, d, t_max, mask, False,
                                            with_stats, compat,
                                            max_leaf_size)
    else:
        out, stats = trv._kernel_any(trav, o, d, t_max, mask, with_stats,
                                     compat, max_leaf_size)
    return (out, stats) if with_stats else out


def closest_hit_wide(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                     mask: torch.Tensor | None = None, *,
                     stack_depth: int = 64, max_leaf_size: int = 4,
                     compat: bool = False, tile_size: int | None = None,
                     chunk: int = 16, with_stats: bool = False):
    """Closest hit: ``Hit`` (+ stats), by kernel 3 on the card."""
    return walk(_kernel_wide, _plain_wide, trav, o, d, t_max, mask, True,
                stack_depth, max_leaf_size, compat, tile_size, chunk,
                with_stats, "wide")


def any_hit_wide(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                 mask: torch.Tensor | None = None, *,
                 stack_depth: int = 64, max_leaf_size: int = 4,
                 compat: bool = False, tile_size: int | None = None,
                 chunk: int = 16, with_stats: bool = False):
    """Occlusion: [R] bool (+ stats), by kernel 2 on the card."""
    return walk(_kernel_wide, _plain_wide, trav, o, d, t_max, mask, False,
                stack_depth, max_leaf_size, compat, tile_size, chunk,
                with_stats, "wide")
