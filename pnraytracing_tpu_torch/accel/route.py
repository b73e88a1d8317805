"""Which traversal kernels a scene goes through.

Copy of the routing predicates of ``pnraytracing_tpu/accel/
traverse_pallas.py`` (``SMEM_SCENE_BUDGET_BYTES``, ``_scene_bytes``,
``scene_fits_smem``, ``pick_variant``) and of the choice that
``pnraytracing_tpu/render/integrator.py`` makes for each value of
``RenderConfig.traversal``.  The budget is the JAX package's: the TPU's 1 MB
of scalar memory less headroom for the stack.  The port's resident
kernels read the scene from device memory and have no such limit; the
budget is kept so that both packages choose the same route for the same
scene, and so the same scenes stream through bricks.
"""

from __future__ import annotations

from pnraytracing_tpu_torch.accel.layout import TravData
from pnraytracing_tpu_torch.core.config import TRAVERSALS

SMEM_SCENE_BUDGET_BYTES = (1 << 20) - (16 << 10)

VARIANTS = ("wide", "binary")


def _node_rows(trav: TravData, variant: str) -> int:
    if variant in ("wide", "wide_attr"):
        return int(trav.nodes16c.shape[0])
    return int(trav.nodes8.shape[0])


def _scene_bytes(trav: TravData, variant: str) -> int:
    """Bytes of the variant's packed scene: node rows + tri9 rows (+ the
    attribute rows for ``wide_attr``)."""
    n_tris = int(trav.tri9.shape[0])
    per_node = 16 if variant in ("wide", "wide_attr") else 8
    per_tri = 9 + (16 if variant == "wide_attr" else 0)
    return 4 * (per_node * _node_rows(trav, variant) + per_tri * n_tris)


def scene_fits_smem(trav: TravData, variant: str = "binary") -> bool:
    return _scene_bytes(trav, variant) <= SMEM_SCENE_BUDGET_BYTES


def pick_variant(trav: TravData, requested: str = "wide") -> str:
    """The resident kernel a ``requested`` variant runs as: ``wide`` when
    requested and it fits the budget, else ``binary``.  Where even the
    binary packing exceeds the budget the JAX package raises (its kernels
    hold the scene in scalar memory); the port's kernels do not need the
    budget, so the request stands there — the integrator sends such
    scenes to the stream kernels, or without a stream layout to the
    binary ones (:func:`traversal_route`)."""
    if requested not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{requested!r}")
    if not scene_fits_smem(trav, "binary"):
        return requested
    if requested == "wide" and scene_fits_smem(trav, "wide"):
        return "wide"
    return "binary"


def traversal_route(trav: TravData | None, kernel_interaction: bool,
                    traversal: str = "pallas") -> str:
    """The route ``render_rays`` takes for ``RenderConfig.traversal``, as
    the JAX integrator chooses its walk (render/integrator.py:340-452
    there):

    * ``"bvh"``, whatever ``traversal``: the walk over the plain BVH
      (``accel/traverse.py``) + ``make_interaction``, when the scene has
      no traversal layout (``trav`` is None: outside the packed layout);

    for ``traversal="pallas"``:

    * ``"attr"``: the resident closest-hit kernel with the interaction
      fill, when ``kernel_interaction`` is set and ``wide_attr`` fits;
    * ``"wide"``: the resident closest hit + ``make_interaction``, when
      the binary packing fits;
    * ``"stream"``: the brick-streaming kernels, when it does not and the
      scene has a stream layout;
    * ``"binary"``: otherwise (over the budget, no stream layout), the
      binary walks of ``accel/traverse_cuda.py`` (kernels 5 and 6) +
      ``make_interaction``, where the JAX package takes its XLA packet
      walk, which it holds bit-identical to the binary Pallas kernel
      (accel/traverse_pallas.py:26 there);

    for the values of the JAX package's XLA walks, each closest hit +
    ``make_interaction`` (never the attribute kernel), whatever the
    scene's size:

    * ``"packed"`` (also ``"wide4"`` on a scene without the 4-wide
      layout, JAX's fallback): ``accel/traverse_packed.py``'s packed
      walk;
    * ``"pop"`` and ``"packet"``: the pop-test walk, kernels 5 / 6 with
      the leaf cap (``accel/traverse_packed.py``,
      ``accel/traverse_packet.py``);
    * ``"wide_capped"`` for ``"wide"``: kernels 3 / 2 with the leaf cap
      (``accel/traverse_wide.py``);
    * ``"wide4"``: the 4-wide collect-then-test walk
      (``accel/traverse_wide4.py``)."""
    if traversal not in TRAVERSALS:
        raise ValueError(f"traversal must be one of {TRAVERSALS}, got "
                         f"{traversal!r}")
    if trav is None:
        return "bvh"
    if traversal == "wide":
        return "wide_capped"
    if traversal == "wide4":
        return "wide4" if trav.w4 is not None else "packed"
    if traversal != "pallas":
        return traversal
    if scene_fits_smem(trav, "binary"):
        if kernel_interaction and scene_fits_smem(trav, "wide_attr"):
            return "attr"
        return "wide"
    if trav.stream is not None:
        return "stream"
    return "binary"
