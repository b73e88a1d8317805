"""The walk of ``RenderConfig.traversal="packet"``.

PyTorch counterpart of ``pnraytracing_tpu/accel/traverse_packet.py``
(``closest_hit_packet``, ``any_hit_packet``): an XLA while loop in which
a tile of ``trav_tile`` rays walks the tree behind ONE shared stack,
pop-test (a node's box tested when it is popped, both children pushed
untested in the order of the tile's summed direction), each leaf's first
``max_leaf_size`` triangles tested against every live ray.  A shared
stack is how a vector machine with scalar control flow walks a tree;
a ray's answers are those of the per-ray pop-test walk up to exact-``t``
ties, which the JAX package holds (tests/test_packet.py), and it is the
algorithm of its Pallas binary kernels.

On Hopper every thread walks its own ray, so the packet walk is the
per-ray pop-test walk: the binary kernels 5 / 6 (``csrc/traverse.cu``)
with the leaf cap ``max_leaf_size``, through
``accel/traverse_packed.py`` as ``traversal="pop"`` runs them, counted under ``closest_hit_binary`` / ``any_hit_binary``.  The
signatures, the plain versions (tiled by ``tile_size``, the loop's
condition read every ``chunk`` steps) and ``with_stats`` are those of
``closest_hit_pop`` / ``any_hit_pop``.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel.layout import TravData
from pnraytracing_tpu_torch.accel.traverse_packed import (
    _kernel_pop,
    _plain_pop,
    walk,
)
from pnraytracing_tpu_torch.core.vec import V3


def closest_hit_packet(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                       mask: torch.Tensor | None = None, *,
                       stack_depth: int = 64, max_leaf_size: int = 4,
                       compat: bool = False, tile_size: int | None = None,
                       chunk: int = 16, with_stats: bool = False):
    """Closest hit: ``Hit`` (+ stats), by kernel 5 on the card."""
    return walk(_kernel_pop, _plain_pop, trav, o, d, t_max, mask, True,
                stack_depth, max_leaf_size, compat, tile_size, chunk,
                with_stats, "binary")


def any_hit_packet(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                   mask: torch.Tensor | None = None, *,
                   stack_depth: int = 64, max_leaf_size: int = 4,
                   compat: bool = False, tile_size: int | None = None,
                   chunk: int = 16, with_stats: bool = False):
    """Occlusion: [R] bool (+ stats), by kernel 6 on the card."""
    return walk(_kernel_pop, _plain_pop, trav, o, d, t_max, mask, False,
                stack_depth, max_leaf_size, compat, tile_size, chunk,
                with_stats, "binary")
