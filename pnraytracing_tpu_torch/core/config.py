"""Static render configuration.

PyTorch counterpart of ``pnraytracing_tpu/core/config.py``: the same
fields with the JAX package's defaults, but one.  ``traversal`` selects
the walk the frame's rays take over a scene with a traversal layout
(``accel/route.py::traversal_route``); every value runs a CUDA kernel on
CUDA tensors and its plain PyTorch version on CPU tensors, and gives the
answers of the JAX walk of that value:

* ``"pallas"`` (the port's default): the resident kernels of
  ``accel/traverse_cuda.py`` (the attribute, wide, binary routes) or the
  brick-streaming kernels of ``accel/traverse_stream_cuda.py``, as the
  JAX package routes ``traversal="pallas"``;
* ``"packed"``: the push-test walk of ``accel/traverse_packed.py``;
* ``"pop"`` and ``"packet"``: the pop-test walk (kernels 5 / 6);
* ``"wide"``: the push-test walk over the wide rows (kernels 3 / 2);
* ``"wide4"``: the 4-wide collect-then-test walk of
  ``accel/traverse_wide4.py``, or ``"packed"`` when the scene has no
  4-wide layout.

The JAX package defaults to ``"packed"`` because XLA on a CPU would
otherwise run its Pallas kernels under the interpreter; its production
entry points choose ``"pallas"`` on their accelerator, the route every
measurement of this port was taken on.  The images do not depend on the
value, so the port defaults to ``"pallas"``.  ``trav_tile`` and
``trav_chunk`` tune the JAX package's XLA loops; the port's plain
versions honour them and its kernels, which walk one ray a thread, do
not need them.  ``trav_leaf_buffer`` is the 4-wide walk's per-ray leaf
buffer.
"""

from __future__ import annotations

import dataclasses

TRAVERSALS = ("wide", "packed", "pop", "packet", "wide4", "pallas")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 512  # SCREEN_WIDTH (PnRT.hpp:41)
    height: int = 512  # SCREEN_HEIGHT (PnRT.hpp:42)
    max_depth: int = 4  # MAX_BOUNCE_DEPTH in converged mode (main.cpp:572)
    spp: int = 1  # samples/pixel per render() call

    # Per-ray traversal stack capacity; must cover the scene's BVH depth.
    stack_depth: int = 64

    # Every walk tests at most this many triangles of a leaf, as every
    # walk of the JAX package does (its Pallas kernels and XLA walks): a
    # larger leaf's other triangles are never tested.  That cap is the
    # reference's and is kept; the scene builder's leaves hold at most 4
    # by default, and a flat BVH (one leaf, route 'bvh',
    # accel/traverse.py) is rendered with max_leaf_size = its triangle
    # count.
    max_leaf_size: int = 4

    # Rays per render_rays call; larger frames render in sequential tiles.
    tile_pixels: int = 1 << 18

    # Rays a plain version of an XLA walk runs at once (None: all); the
    # kernels walk one ray a thread and ignore it.
    trav_tile: int | None = 4096

    # The plain versions' walk loops test their exit condition every
    # trav_chunk steps (accel/loops.py::chunked_while); the kernels have
    # no such condition.
    trav_chunk: int = 1

    # Per-ray leaf buffer of the 4-wide collect-then-test walk
    # (traversal='wide4', accel/traverse_wide4.py); a ray that collects
    # more leaves is walked again by the exact pop-test walk.
    trav_leaf_buffer: int = 32

    # The walk (see the module docstring): 'pallas', 'packed', 'pop',
    # 'packet', 'wide' or 'wide4'.  The JAX package's default is
    # 'packed'; images do not depend on the value.
    traversal: str = "pallas"

    # 'sobol' = Sobol + Cranley-Patterson for the BRDF lobe sample like the
    # reference (ray_tracing.comp:928-929); 'hash' = counter-hash streams.
    sampler: str = "sobol"
    # Sub-pixel primary jitter from a salted hash stream
    # (render/renderer.py::primary_jitter); off like the reference, which
    # casts pixel-corner rays (comp:980).
    jitter_primary: bool = False
    clamp_radiance: bool = True  # clamp color to [0,1] (comp:988)

    # Pack live rays to the front between bounces (compact_rays), ordered
    # by a coherence key (sort_rays; else in their order), for the first
    # sort_max_bounce bounces.  Pure permutations: the image does not
    # depend on them.
    compact_rays: bool = True
    sort_rays: bool = True
    sort_max_bounce: int = 2

    # The sort key (ops/compaction.py): 'entry' = the treelet the
    # continuation ray enters first, direction octant in the low bits
    # (the key kernel); 'dir' = normal octant, |n| and position cell;
    # 'pos' = Morton code of the position cell above the normal octant.
    # A scene without a treelet table falls back to 'pos'.
    sort_key: str = "entry"

    # 'unroll' and 'scan' run the same bounce loop in this port (the JAX
    # package's scan gives the unrolled loop's permutations and images).
    loop: str = "unroll"

    # Both NEE shadow batches in ONE any-hit launch (2R rays) when the
    # scene has lights and an env map, else one launch each; the same
    # queries either way.
    fuse_shadows: bool = True

    rr_start: int | None = None  # Russian roulette from this bounce on
    max_radiance: float | None = None  # per-contribution clamp

    # 'reference' = the GLSL one-sample combine (comp:937-938);
    # 'balanced' = per-strategy balance heuristic.
    mis: str = "reference"

    # Reproduce the reference's quirks (SURVEY.md section 3.3): the
    # material decode, the GTR half vector and cosine-hemisphere sample,
    # the unclamped BRDF pdf, the environment sampler's pdf and mirrored
    # row, the env shadow origin without the normal offset, and in every
    # walk kernel the t-ignoring slab test and the z-only axis permutation
    # of the watertight test.
    compat_pnrt: bool = False

    env_scale: float = 1.0  # constant-env scale when there is no HDR map

    # Take the interaction fill (shading normal, uv, material/texture id)
    # from the closest-hit kernel at triangle-test time instead of a
    # per-ray [T, 26] row gather afterwards, where the scene's attribute
    # rows fit the resident budget (accel/route.py).
    kernel_interaction: bool = True

    # Trilinear texture LOD (the reference's mipmapped samplers,
    # main.cpp:541-546); None fetches LOD 0 as the reference's compute
    # shader does.  Set to the camera's pixel angle (2*tan(fov/2)/height)
    # to enable: per-ray lod = log2(path_distance * scale * texture_size).
    texture_lod_scale: float | None = None

    def __post_init__(self):
        if self.sampler not in ("sobol", "hash"):
            raise ValueError(f"sampler must be 'sobol' or 'hash', got "
                             f"{self.sampler!r}")
        if self.mis not in ("reference", "balanced"):
            raise ValueError(f"mis must be 'reference' or 'balanced', got "
                             f"{self.mis!r}")
        if self.loop not in ("unroll", "scan"):
            raise ValueError(f"loop must be 'unroll' or 'scan', got "
                             f"{self.loop!r}")
        if self.traversal not in TRAVERSALS:
            raise ValueError(f"traversal must be one of {TRAVERSALS}, got "
                             f"{self.traversal!r}")
        if self.sort_key not in ("dir", "pos", "entry"):
            raise ValueError(f"sort_key must be 'dir', 'pos' or 'entry', "
                             f"got {self.sort_key!r}")
        if self.max_depth < 1 or self.stack_depth < 2:
            raise ValueError("max_depth must be >= 1 and stack_depth >= 2")
        if self.compat_pnrt and self.mis == "balanced":
            raise ValueError("compat_pnrt=True implies the reference "
                             "estimator (mis='reference')")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
