"""The walks of a frame: each traversal route's queries, and the walk
kernels' launch tables.

:func:`route_walks` binds the two wrappers of the route that
``accel/route.py::traversal_route`` names (its docstring lists each
route's walks) to the scene's tables and ``RenderConfig``'s arguments;
every route tests at most ``max_leaf_size`` triangles of a leaf, and on
route ``wide4`` the pop-test walk answers the rays that overflow the
leaf buffer (render/integrator.py:395-440 of the JAX package).  Each
wrapper is looked up by its name here when :func:`route_walks` runs, so
a test that swaps a name here swaps the walk of every later frame.

On route ``bvh``, in an eager frame inside an open ``collect()`` (a
capture's warm-up frame), each walk also returns its per-ray stats and
hands its work to the collects: ``walk.closest.*`` and ``walk.shadow.*``
(``pops``, ``slabs``, ``tests``, the live ``queries``).  A captured walk
is launched without its stats buffer; any other frame counts nothing.

:data:`LAUNCH_TABLES` holds every walk kernel's launch counters, which
``render/program.py`` reads.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel import (traverse, traverse_cuda,
                                          traverse_packed,
                                          traverse_stream_cuda,
                                          traverse_wide4)
from pnraytracing_tpu_torch.accel.route import traversal_route
from pnraytracing_tpu_torch.accel.traverse import any_hit as any_hit_bvh
from pnraytracing_tpu_torch.accel.traverse import (
    closest_hit as closest_hit_bvh,
)
from pnraytracing_tpu_torch.accel.traverse_cuda import (any_hit, closest_hit,
                                                        closest_hit_attr)
from pnraytracing_tpu_torch.accel.traverse_packed import (
    any_hit_packed, any_hit_pop, closest_hit_packed, closest_hit_pop)
from pnraytracing_tpu_torch.accel.traverse_packet import (any_hit_packet,
                                                          closest_hit_packet)
from pnraytracing_tpu_torch.accel.traverse_stream_cuda import (
    any_hit_stream, closest_hit_stream)
from pnraytracing_tpu_torch.accel.traverse_wide import (any_hit_wide,
                                                        closest_hit_wide)
from pnraytracing_tpu_torch.accel.traverse_wide4 import (any_hit_wide4,
                                                         closest_hit_wide4)
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Scene
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.utils.profiling import (capturing, collecting,
                                                    count)

LAUNCH_TABLES = (traverse_cuda.LAUNCHES, traverse_stream_cuda.LAUNCHES,
                 traverse.LAUNCHES, traverse_packed.LAUNCHES,
                 traverse_wide4.LAUNCHES)

WALK_STATS = ("pops", "slabs", "tests")  # the rows of a walk's stats


def ray_components(o: torch.Tensor, d: torch.Tensor) -> tuple[V3, V3]:
    """[R, 3] origins and directions as the walks take them: V3s of
    contiguous components."""
    return (V3.of(o).map(torch.Tensor.contiguous),
            V3.of(d).map(torch.Tensor.contiguous))


def _count_walk(kind: str, stats: torch.Tensor, mask) -> None:
    """Hand one walk's work to the open collects: ``walk.<kind>.pops``,
    ``.slabs`` and ``.tests`` summed over its [3, R] per-ray stats (a
    masked query does none) and ``walk.<kind>.queries``, its live
    queries."""
    total = stats.sum(dim=1)
    for i, name in enumerate(WALK_STATS):
        count(f"walk.{kind}.{name}", total[i])
    count(f"walk.{kind}.queries",
          stats.shape[1] if mask is None else mask.sum())


def route_walks(scene: Scene, cfg: RenderConfig):
    """``(route, closest, occluded)``: the route ``scene`` takes under
    ``cfg`` and its two queries, ``closest(o, d, t_max, mask=None)`` (a
    ``Hit``; on route ``attr`` the attribute kernel's raw outputs,
    ``(hit, (nx, ny, nz, u, v, mat_tex))``) and ``occluded(o, d, t_max,
    mask=None)`` ([R] bool) over [R] V3 rays.  Raises if
    ``cfg.stack_depth`` is shallower than the scene's BVH or
    ``cfg.traversal`` names no walk."""
    if scene.bvh_depth is not None and cfg.stack_depth < scene.bvh_depth:
        raise ValueError(
            f"RenderConfig.stack_depth={cfg.stack_depth} is too shallow for "
            f"this scene's BVH (depth {scene.bvh_depth}); the traversal "
            "stack would silently drop nodes.  Raise stack_depth to at "
            f"least {scene.bvh_depth}.")
    trav = scene.trav
    route = traversal_route(trav, cfg.kernel_interaction, cfg.traversal)
    kw = dict(stack_depth=cfg.stack_depth, compat=cfg.compat_pnrt,
              max_leaf_size=cfg.max_leaf_size)
    tables = (trav,)
    if route == "bvh":
        closest_fn, any_fn = closest_hit_bvh, any_hit_bvh
        tables = (scene.bvh, scene.mesh)
    elif route == "stream":
        closest_fn, any_fn = closest_hit_stream, any_hit_stream
    elif route in ("attr", "wide", "binary"):
        closest_fn, any_fn = closest_hit, any_hit
        if route == "binary":
            kw["variant"] = "binary"
    else:  # the JAX package's XLA walks (traversal != 'pallas')
        kw.update(tile_size=cfg.trav_tile, chunk=cfg.trav_chunk)
        closest_fn, any_fn = {
            "packed": (closest_hit_packed, any_hit_packed),
            "pop": (closest_hit_pop, any_hit_pop),
            "packet": (closest_hit_packet, any_hit_packet),
            "wide_capped": (closest_hit_wide, any_hit_wide),
            "wide4": (closest_hit_pop, any_hit_pop),  # its fallback
        }[route]

    # the plain-BVH walks' work, counted only in an eager frame inside an
    # open collect()
    count_walks = route == "bvh" and not capturing() and collecting()

    def query(fn, kind):
        def call(o, d, t_max, mask=None):
            if not count_walks:
                return fn(*tables, o, d, t_max, mask, **kw)
            out, stats = fn(*tables, o, d, t_max, mask, **kw,
                            with_stats=True)
            _count_walk(kind, stats, mask)
            return out
        return call

    closest_q, any_q = query(closest_fn, "closest"), query(any_fn, "shadow")
    if route == "attr":
        def closest_attr(o, d, t_max, mask=None):
            return closest_hit_attr(trav, o, d, t_max, mask, **kw)

        return route, closest_attr, any_q
    if route == "wide4":
        w4 = trav.w4
        w4_kw = dict(stack_depth=max(16, (w4.width - 1) * w4.depth4 + 4),
                     max_leaf_size=cfg.max_leaf_size, compat=cfg.compat_pnrt,
                     leaf_buffer=cfg.trav_leaf_buffer, chunk=cfg.trav_chunk)

        def closest_w4(o, d, t_max, mask=None):
            return closest_hit_wide4(w4, o, d, t_max, mask, **w4_kw,
                                     fallback=closest_q)[0]

        def any_w4(o, d, t_max, mask=None):
            return any_hit_wide4(w4, o, d, t_max, mask, **w4_kw,
                                 fallback=any_q)[0]

        return route, closest_w4, any_w4
    return route, closest_q, any_q
