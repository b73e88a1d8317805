"""The wavefront path integrator, live forward path.

PyTorch counterpart of ``_render_rays`` in
``pnraytracing_tpu/render/integrator.py`` (the estimator of
ray_tracing.comp:861-992): all rays advance one bounce per step of a
Python loop, and every stage is a masked operation over the whole ray
batch.  Each bounce runs in three phases, as in the JAX package:

1. draws and weights: every RNG draw and every pdf/BRDF weight of the
   bounce (NEE area light, NEE environment, BRDF sample), in
   ``ops/shade.py``: one launch of its CUDA kernel where
   ``shade_on_card`` allows (a CUDA device, autograd recording nothing
   through the scene), else its plain version, the torch code (the CPU,
   the gradient's replay); a textured scene's base colors are overridden
   in torch first;
2. sort: with ``compact_rays``, for bounces below ``sort_max_bounce``,
   one permutation of the whole path state, live rays first, ordered by
   the ``sort_key`` of ``ops/compaction.py`` (the treelet-entry key of
   their continuation ray by default) or, without ``sort_rays``, in their
   order (``compact_indices``);
3. queries and contributions: the two NEE shadow queries in one any-hit
   launch (two with ``fuse_shadows`` off), then the continuation closest
   hit.

Each part of the frame runs inside a ``phase`` of ``utils/profiling.py``:
``camera`` (the tile's set-up and primary hit), then a bounce each
``shade`` (phase 1), ``sort`` (phase 2), ``shadow`` (the occlusion
queries and the NEE terms they gate), ``next`` (the continuation closest
hit and its interaction) and ``accumulate`` (the BRDF-sampled terms,
their MIS weights, the throughput and Russian roulette), and ``image``
(the tile's colours).  An eager frame inside an open ``collect()``
counts, at the top of each bounce, the live rays (``rays.live``) and the
rays launched (``rays.launched``), and on route ``bvh`` each walk's work
from its per-ray stats (``walk.closest.*`` and ``walk.shadow.*``:
``pops``, ``slabs``, ``tests`` and the live ``queries``); any other
frame, and a captured one, counts nothing.

``loop="scan"`` runs the same loop.  The JAX package's scan runs the
first ``min(sort_max_bounce, max_depth)`` bounces as an unrolled, sorted
prologue when ``compact_rays`` is on and scans the rest unsorted
(``render/integrator.py:979-1021`` there): exactly the unrolled loop's
permutations, and so its images.  Its replay has no prologue (``n_pro =
0``): a replay never sorts, so records traced under either loop replay
under either.

Trace and replay (the JAX package's ``_render_rays(records, record)``
modes): :func:`trace_paths` runs the live frame without gradients and
records every walk's answer, scattered back to the original ray order
through ``orig`` (:class:`TraceRecords`); :func:`render_rays_replay`
runs the same estimator with no walk and no sort, the interactions made
by ``make_interaction`` from the recorded hits, the occlusion read from
the records, and the escaped paths' environment radiance looked up once
for all bounces after the loop (one scatter into the texel grid in the
backward).  It is differentiable in the scene's tensors
(``diff/grad.py``).  Every walk entry point detaches its inputs, the
counterpart of ``_stop_gradient_trace``: a walk's answer carries no
gradient on the card or on the CPU.

A textured scene (``scene.textures``) carries each path's uv and
texture id through the loop (and through the sort's pack, as the JAX
package's ``uvtex`` columns, with the path length for
``texture_lod_scale``) and overrides the material's base color by the
texture fetch of ``ops/texture.py`` before the bounce's draws.

``compat_pnrt`` runs the reference's quirks where the JAX package does:
the compat material decode, environment sample and BRDF sample, the env
shadow ray from the surface point itself, and the compat form of every
walk (``compat=True``: the compat instantiation of each kernel).  The
RNG draws are the same in both modes.

RNG words are int64 tensors holding uint32 values (ops/sampling.py); the
frame counter is an int or a 0-d tensor (``frame_word``), so the whole
frame can run inside a captured CUDA graph (``render/program.py``).
The traversal route is the JAX package's (``accel/route.py::
traversal_route``).  For ``cfg.traversal="pallas"`` (the port's
default): the resident kernels of ``accel/traverse_cuda.py
(with the interaction fill from the kernel when ``kernel_interaction`` is
set and the attribute rows fit the budget, else the closest hit +
``make_interaction``), the brick-streaming kernels of
``accel/traverse_stream_cuda.py`` for a scene too large for the resident
route, the binary walks of ``accel/traverse_cuda.py`` for such a scene
without a stream layout, or, for a scene outside the packed layout
(``scene.trav`` None), the walk over the plain BVH of
``accel/traverse.py``.  On that last route no sort key is computed: live
rays are only compacted, as the JAX package does without a layout.
For the values of the JAX package's XLA walks (``"packed"``, ``"pop"``,
``"packet"``, ``"wide"``, ``"wide4"``) the walk of that value
(``accel/traverse_packed.py``, ``traverse_packet.py``,
``traverse_wide.py``, ``traverse_wide4.py``, the last with the pop-test
walk for the rays that overflow its leaf buffer), closest hit +
``make_interaction``; the sort key does not depend on the value.  Every
route tests at most ``cfg.max_leaf_size`` triangles of a leaf, as every
walk of the JAX package does.
Each route runs its CUDA kernels on the card and their plain versions on
the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from pnraytracing_tpu_torch.accel.layout import ATTR_TEX_BASE
from pnraytracing_tpu_torch.accel.route import traversal_route
from pnraytracing_tpu_torch.accel.traverse import any_hit as any_hit_bvh
from pnraytracing_tpu_torch.accel.traverse import (
    closest_hit as closest_hit_bvh,
)
from pnraytracing_tpu_torch.accel.traverse_cuda import (
    any_hit,
    closest_hit,
    closest_hit_attr,
)
from pnraytracing_tpu_torch.accel.traverse_packed import (
    any_hit_packed,
    any_hit_pop,
    closest_hit_packed,
    closest_hit_pop,
)
from pnraytracing_tpu_torch.accel.traverse_packet import (
    any_hit_packet,
    closest_hit_packet,
)
from pnraytracing_tpu_torch.accel.traverse_stream_cuda import (
    any_hit_stream,
    closest_hit_stream,
)
from pnraytracing_tpu_torch.accel.traverse_wide import (
    any_hit_wide,
    closest_hit_wide,
)
from pnraytracing_tpu_torch.accel.traverse_wide4 import (
    any_hit_wide4,
    closest_hit_wide4,
)
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.math import (
    FLOAT_MAX,
    SHADOW_EPS,
    absolute,
    clip,
    maximum,
    minimum,
)
from pnraytracing_tpu_torch.core.types import Scene, TriangleMesh, _Movable
from pnraytracing_tpu_torch.core.vec import (
    V3,
    vcat,
    vcross,
    vdot,
    vnormalize,
    vwhere,
)
from pnraytracing_tpu_torch.ops.brdf import apply_compat_material_decode
from pnraytracing_tpu_torch.ops.compaction import (
    coherence_key,
    coherence_key_pos,
    compact_indices,
    entry_key,
    sort_live_first,
)
from pnraytracing_tpu_torch.ops.envmap import envmap_lookup_v, envmap_pdf_v
from pnraytracing_tpu_torch.ops.gather import gather_row
from pnraytracing_tpu_torch.ops.intersect import Hit, intersect_triangle_c
from pnraytracing_tpu_torch.ops.sampling import frame_word, pixel_seed, rand01
from pnraytracing_tpu_torch.ops.shade import (
    any_zero,
    contiguous_env,
    corners,
    emissive_of,
    material_rows,
    shade_bounce,
    shade_on_card,
    shade_plain,
)
from pnraytracing_tpu_torch.ops.texture import (
    fetch_base_color,
    fetch_base_color_trilinear,
)
from pnraytracing_tpu_torch.utils.profiling import (capturing, collecting,
                                                    count, phase)

_EPS = 1e-10


@dataclasses.dataclass
class TraceRecords(_Movable):
    """Every walk answer of one frame, in the ORIGINAL ray order: the
    primary hit (a [R] ``Hit``), the NEE occlusion bits a bounce
    (``light_occ`` / ``env_occ`` [max_depth, R] bool, None when the scene
    has no area light / no environment map) and the continuation hit a
    bounce (``bounce``, a ``Hit`` of [max_depth, R] fields).  A replay is
    exact for the parameter values the trace ran with; the recorded
    quantities are the ones the live frame detaches, so gradients are
    unchanged."""

    primary: Hit
    light_occ: torch.Tensor | None
    env_occ: torch.Tensor | None
    bounce: Hit


def _unsort(a: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """Lane i of ``a`` to slot ``orig[i]`` of zeros."""
    return torch.zeros_like(a).index_put_((orig,), a)


def pack_interaction_rows(mesh: TriangleMesh) -> torch.Tensor:
    """[T, 26] per-triangle interaction table: corner positions (9),
    corner normals (9), corner uvs (6), material_id, texture_id."""
    t = mesh.indices.shape[0]
    idx = mesh.indices.long()
    ids = torch.stack([mesh.material_id.to(torch.float32),
                       mesh.texture_id.to(torch.float32)], dim=1)
    return torch.cat([mesh.positions[idx].reshape(t, 9),
                      mesh.normals[idx].reshape(t, 9),
                      mesh.uvs[idx].reshape(t, 6), ids], dim=1)


def make_interaction(hit: Hit, ray_d: V3, ray_o: V3, rows: torch.Tensor):
    """Surface attributes from (tri, barycentrics) — the Interaction fill
    of TriangleIntersect (comp:327-355) — through one row gather of the
    :func:`pack_interaction_rows` table.  The barycentrics are re-derived
    by intersecting the hit triangle again, as the JAX package does.
    Returns (pos V3, nrm V3, (u, v), mat_id, tex_id)."""
    tri = torch.clamp_min(hit.tri, 0).long()
    rr = gather_row(tri, rows)
    p0, p1, p2 = corners(rr, 0)
    n0, n1, n2 = corners(rr, 9)
    ok, _, rb1, rb2 = intersect_triangle_c(
        (p0.x, p0.y, p0.z), (p1.x, p1.y, p1.z), (p2.x, p2.y, p2.z),
        ray_o.x, ray_o.y, ray_o.z, ray_d.x, ray_d.y, ray_d.z,
        torch.full(tri.shape, FLOAT_MAX, dtype=torch.float32,
                   device=tri.device))
    b1 = torch.where(ok, rb1, hit.b1)
    b2 = torch.where(ok, rb2, hit.b2)
    b0 = 1.0 - b1 - b2
    pos = p0 * b0 + p1 * b1 + p2 * b2
    geom_n = vnormalize(vcross(p1 - p0, p2 - p0))
    n_interp = n0 * b0 + n1 * b1 + n2 * b2
    nrm = vwhere(any_zero(n0, n1, n2), geom_n, n_interp)
    # backface flip toward the incoming ray (comp:345-348)
    nrm = vnormalize(vwhere(vdot(nrm, ray_d) > 0, -nrm, nrm))
    u_hit = rr[:, 18] * b0 + rr[:, 20] * b1 + rr[:, 22] * b2
    v_hit = rr[:, 19] * b0 + rr[:, 21] * b1 + rr[:, 23] * b2
    return (pos, nrm, (u_hit, v_hit), rr[:, 24].to(torch.int32),
            rr[:, 25].to(torch.int32))


WALK_STATS = ("pops", "slabs", "tests")  # the rows of a walk's stats


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


def _comps(a: torch.Tensor) -> V3:
    """[R, 3] -> V3 of contiguous components (what the kernels take)."""
    return V3(a[:, 0].contiguous(), a[:, 1].contiguous(),
              a[:, 2].contiguous())


def _render_rays(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                 px: torch.Tensor, py: torch.Tensor, frame,
                 cfg: RenderConfig, records: TraceRecords | None,
                 record: bool):
    """One sample for a batch of primary rays: ``([R, 3] radiance,
    TraceRecords | None)``.

    o, d: [R, 3] primary rays; px, py: [R] int64 pixel coordinates in the
    reference's GL convention (x = column, y = row from the bottom), which
    seed the RNG streams (comp:977-979) and the Cranley-Patterson
    rotation; frame: the frame counter, an int or a 0-d integer tensor on
    the rays' device (both modulo 2^32).  ``records`` replays them (no
    walk, no sort); ``record`` returns the frame's records.  Nothing here
    reads a device value on the host."""
    replay = records is not None
    if scene.bvh_depth is not None and cfg.stack_depth < scene.bvh_depth:
        raise ValueError(
            f"RenderConfig.stack_depth={cfg.stack_depth} is too shallow for "
            f"this scene's BVH (depth {scene.bvh_depth}); the traversal "
            "stack would silently drop nodes.  Raise stack_depth to at "
            f"least {scene.bvh_depth}.")
    trav, mesh, materials, lights = (scene.trav, scene.mesh, scene.materials,
                                     scene.lights)
    has_env = scene.env is not None
    has_lights = lights.count > 0
    textures = scene.textures
    has_tex = textures is not None
    lod_on = has_tex and cfg.texture_lod_scale is not None
    dev = o.device
    r = o.shape[0]
    sd = cfg.stack_depth
    compat = cfg.compat_pnrt
    captured = capturing()
    route = traversal_route(trav, cfg.kernel_interaction, cfg.traversal)
    # the route's walks: (closest, any), the tables they read first, and
    # their keyword arguments
    walk_kw = dict(stack_depth=sd, compat=compat,
                   max_leaf_size=cfg.max_leaf_size)
    if route == "bvh":
        closest_fn, any_fn = closest_hit_bvh, any_hit_bvh
        tables = (scene.bvh, mesh)
    elif route in ("attr", "wide", "stream", "binary"):
        closest_fn, any_fn = ((closest_hit_stream, any_hit_stream)
                              if route == "stream" else (closest_hit, any_hit))
        tables = (trav,)
        if route == "binary":
            walk_kw["variant"] = "binary"
    else:  # the JAX package's XLA walks (traversal != 'pallas')
        walk_kw.update(tile_size=cfg.trav_tile, chunk=cfg.trav_chunk)
        closest_fn, any_fn = {
            "packed": (closest_hit_packed, any_hit_packed),
            "pop": (closest_hit_pop, any_hit_pop),
            "packet": (closest_hit_packet, any_hit_packet),
            "wide_capped": (closest_hit_wide, any_hit_wide),
            "wide4": (closest_hit_pop, any_hit_pop),  # its fallback
        }[route]
        tables = (trav,)

    def walk(fn, o_, d_, tm_, mask_):
        return fn(*tables, o_, d_, tm_, mask_, **walk_kw)

    # the plain-BVH walks' work, counted only in an eager frame inside an
    # open collect() (a capture's warm-up frame): a captured walk is
    # launched without its stats buffer
    count_walks = route == "bvh" and not captured and collecting()

    def counted(fn, kind, o_, d_, tm_, mask_):
        if not count_walks:
            return walk(fn, o_, d_, tm_, mask_)
        out, stats = fn(*tables, o_, d_, tm_, mask_, **walk_kw,
                        with_stats=True)
        _count_walk(kind, stats, mask_)
        return out

    if route == "wide4":
        # overflowed rays are walked again by the pop-test walk
        # (render/integrator.py:395-440 of the JAX package)
        w4 = trav.w4
        w4_kw = dict(stack_depth=max(16, (w4.width - 1) * w4.depth4 + 4),
                     max_leaf_size=cfg.max_leaf_size, compat=compat,
                     leaf_buffer=cfg.trav_leaf_buffer, chunk=cfg.trav_chunk)

        def closest_q(o_, d_, tm_, mask_=None):
            return closest_hit_wide4(
                w4, o_, d_, tm_, mask_, **w4_kw,
                fallback=lambda *a: walk(closest_fn, *a))[0]

        def any_q(o_, d_, tm_, mask_=None):
            return any_hit_wide4(w4, o_, d_, tm_, mask_, **w4_kw,
                                 fallback=lambda *a: walk(any_fn, *a))[0]
    else:
        def closest_q(o_, d_, tm_, mask_=None):
            return counted(closest_fn, "closest", o_, d_, tm_, mask_)

        def any_q(o_, d_, tm_, mask_=None):
            return counted(any_fn, "shadow", o_, d_, tm_, mask_)

    def closest_inter(o_: V3, d_: V3, tm_, mask_=None):
        """Closest hit + interaction fill (hit, pos, nrm, (u, v), mat id,
        tex id): from the attribute kernel (only the backface flip,
        normalize and hit position remain here) or from the route's
        closest kernel + make_interaction."""
        if route == "attr":
            hit_, (nx, ny, nz, u_, v_, mt) = closest_hit_attr(
                trav, o_, d_, tm_, mask_, **walk_kw)
            nrm_raw = V3(nx, ny, nz)
            nrm_ = vnormalize(vwhere(vdot(nrm_raw, d_) > 0, -nrm_raw,
                                     nrm_raw))
            return (hit_, o_ + d_ * hit_.t, nrm_, (u_, v_),
                    mt // ATTR_TEX_BASE, mt % ATTR_TEX_BASE - 1)
        hit_ = closest_q(o_, d_, tm_, mask_)
        return (hit_,) + make_interaction(hit_, d_, o_, irows)

    def env_radiance(dirs: V3) -> V3:
        if has_env:
            return envmap_lookup_v(scene.env, dirs)
        ones = torch.ones_like(dirs.x)
        ec = env_const * cfg.env_scale
        return V3(ec[0] * ones, ec[1] * ones, ec[2] * ones)

    def clamp_contrib(x: V3) -> V3:
        if cfg.max_radiance is not None:
            return x.map(lambda a: minimum(a, cfg.max_radiance))
        return x

    # ---- camera: the primary hit (comp:983) -----------------------------
    with phase("camera"):
        frame = frame_word(frame)
        env_const = (scene.env_constant if scene.env_constant is not None
                     else torch.zeros(3, dtype=torch.float32, device=dev))
        seed = pixel_seed(px, py, frame)
        t_max0 = torch.full((r,), FLOAT_MAX, dtype=torch.float32, device=dev)
        zero_r = torch.zeros(r, dtype=torch.float32, device=dev)
        zero_v = V3(zero_r, zero_r, zero_r)
        irows = pack_interaction_rows(mesh)
        mat_tbl = materials.sanitized()
        if compat:
            mat_tbl = apply_compat_material_decode(mat_tbl)
        # the shade phase's kernel, or its plain version (ops/shade.py)
        on_card = shade_on_card(scene, dev, o, d)
        if on_card:
            mat_rows = material_rows(mat_tbl, materials)
            card_scene = dataclasses.replace(
                scene, env=contiguous_env(scene.env))
            px, py = px.to(torch.int64).contiguous(), py.to(
                torch.int64).contiguous()
        o_v, d_v = _comps(o), _comps(d)
        if replay:
            hit = records.primary
            pos, nrm, (u_uv, v_uv), mat_id, tex_id = make_interaction(
                hit, d_v, o_v, irows)
        else:
            hit, pos, nrm, (u_uv, v_uv), mat_id, tex_id = closest_inter(
                o_v, d_v, t_max0)
        primary_hit = hit.valid
        if lod_on:  # path length, the ray cone's footprint
            path_t = torch.where(primary_hit, hit.t, 0.0)
        miss_color = env_radiance(d_v)
        primary_emissive = emissive_of(materials, mat_id)

        active = primary_hit
        v_dir = -d_v
        ones_r = torch.ones(r, dtype=torch.float32, device=dev)
        c = V3(ones_r, ones_r, ones_r)
        lo = zero_v
        orig = torch.arange(r, dtype=torch.int64, device=dev)
        px_l, py_l = px, py
        rec_occ, rec_eocc, rec_hit2 = [], [], []  # record: a bounce each
        env_terms = []  # replay: (direction, coefficient) of escaped paths

    def textured(base_rows: torch.Tensor) -> torch.Tensor:
        """[R, 3] base colors overridden by the texture fetch
        (comp:870-872) at the paths' current uv, texture id and length."""
        uv2 = torch.stack([u_uv, v_uv], dim=-1)
        if lod_on and textures.mips is not None:
            whs = textures.sizes[torch.clamp_min(tex_id, 0).long()].to(
                torch.float32)
            texdim = torch.maximum(whs[:, 0], whs[:, 1])
            lod = torch.log2(torch.clamp_min(
                path_t * cfg.texture_lod_scale * texdim, 1.0))
            return fetch_base_color_trilinear(textures, tex_id, uv2,
                                              base_rows, lod)
        return fetch_base_color(textures, tex_id, uv2, base_rows)

    texture = textured if has_tex else None

    # ---- path loop (comp:861-972) -----------------------------------------
    for bounce in range(cfg.max_depth):
        with phase("shade", bounce):
            # a captured counter would join the graph
            if not captured and collecting():
                count("rays.live", active.sum())
                count("rays.launched", r)
            state = (cfg, bounce, frame, active, pos, nrm, v_dir, mat_id,
                     seed, px_l, py_l)
            if on_card:
                cdlin = None if texture is None else texture(
                    mat_tbl.base_color.index_select(0, mat_id))
                shaded = shade_bounce(card_scene, mat_rows, irows, *state,
                                      cdlin=cdlin)
            else:
                shaded = shade_plain(scene, mat_tbl, irows, *state,
                                     texture=texture)
            (seed, l_out, weight, d_pdf, sdir, raw_pdf, l_direct_pre, en_l,
             env_pdf_raw, l_env_pre, p_b_light, p_b_env) = shaded

        with phase("sort", bounce):
            # phase 2: one live-first permutation of the whole path state, as
            # ONE gather of a [C, R] pack (each row comes out contiguous); a
            # replay never sorts
            if (cfg.compact_rays and bounce < cfg.sort_max_bounce
                    and not replay):
                if not cfg.sort_rays or trav is None:
                    perm, _ = compact_indices(active)
                elif cfg.sort_key == "entry" and trav.treelets is not None:
                    key = entry_key(pos + nrm * 1e-4, l_out, trav.treelets,
                                    trav.treelet_tree)
                    perm, _ = sort_live_first(active, key)
                else:  # 'dir' / 'pos', and 'entry' without a treelet table
                    root = trav.nodes8[0]
                    lo_b, hi_b = root[0:3], root[3:6]
                    inv_ext = 1.0 / maximum(hi_b - lo_b, 1e-6)
                    key_fn = (coherence_key if cfg.sort_key == "dir"
                              else coherence_key_pos)
                    perm, _ = sort_live_first(active,
                                              key_fn(nrm, pos, lo_b, inv_ext))
                f32 = lambda a: a.to(torch.float32)
                v3s = lambda v: [v.x, v.y, v.z]
                cols = [f32(active)] + v3s(pos) + v3s(nrm) + [f32(mat_id)]
                if has_tex:
                    cols += [u_uv, v_uv, f32(tex_id)]
                    if lod_on:
                        cols += [path_t]
                cols += (v3s(c) + v3s(lo)
                        + [f32(seed & 0xFFFF), f32(seed >> 16)]
                        + [f32(orig), f32(px_l), f32(py_l)]
                        + v3s(l_out) + v3s(weight) + [d_pdf])
                if has_lights:
                    cols += v3s(sdir) + [raw_pdf] + v3s(l_direct_pre)
                if has_env:
                    cols += v3s(en_l) + [env_pdf_raw] + v3s(l_env_pre)
                if cfg.mis == "balanced":
                    cols += ([p_b_light] if has_lights else []) + (
                        [p_b_env] if has_env else [])
                packed = torch.stack(cols).index_select(1, perm)
                rows_ = iter(packed.unbind(0))
                nxt = lambda: next(rows_)
                v3n = lambda: V3(nxt(), nxt(), nxt())
                active = nxt() > 0.5
                pos, nrm = v3n(), v3n()
                mat_id = nxt().to(torch.int32)
                if has_tex:
                    u_uv, v_uv, tex_id = nxt(), nxt(), nxt().to(torch.int32)
                    if lod_on:
                        path_t = nxt()
                c, lo = v3n(), v3n()
                seed = nxt().to(torch.int64) | (nxt().to(torch.int64) << 16)
                orig, px_l, py_l = (nxt().to(torch.int64),
                                    nxt().to(torch.int64),
                                    nxt().to(torch.int64))
                l_out, weight, d_pdf = v3n(), v3n(), nxt()
                if has_lights:
                    sdir, raw_pdf, l_direct_pre = v3n(), nxt(), v3n()
                if has_env:
                    en_l, env_pdf_raw, l_env_pre = v3n(), nxt(), v3n()
                if cfg.mis == "balanced":
                    if has_lights:
                        p_b_light = nxt()
                    if has_env:
                        p_b_env = nxt()

        with phase("shadow", bounce):
            # phase 3: occlusion queries — replayed, or both NEE classes in
            # one launch when the scene has both and fuse_shadows is on, else
            # one each
            if has_lights:
                s_origin = pos + nrm * 1e-4
                s_tmax = torch.full((r,), 1.0 - SHADOW_EPS,
                                    dtype=torch.float32, device=dev)
            if has_env:
                # the reference casts the env shadow ray from the surface
                # point itself (comp:918)
                e_origin = pos if compat else pos + nrm * 1e-4
                facing = vdot(en_l, nrm) > 0
            if replay:
                if has_lights:
                    occluded = records.light_occ[bounce]
                if has_env:
                    e_occ = records.env_occ[bounce]
            elif has_lights and has_env and cfg.fuse_shadows:
                occ2 = any_q(vcat(s_origin, e_origin), vcat(sdir, en_l),
                             torch.cat([s_tmax, t_max0]),
                             torch.cat([active, active & facing]))
                occluded, e_occ = occ2[:r], occ2[r:]
            else:
                if has_lights:
                    occluded = any_q(s_origin, sdir, s_tmax, active)
                if has_env:
                    e_occ = any_q(e_origin, en_l, t_max0, active & facing)
            if record:
                if has_lights:
                    rec_occ.append(_unsort(occluded, orig))
                if has_env:
                    rec_eocc.append(_unsort(e_occ, orig))

            # NEE contributions (masks applied to the pre-folded terms)
            light_pdf, l_direct = zero_r, zero_v
            env_pdf, l_env = zero_r, zero_v
            if has_lights:
                lit = active & ~occluded
                light_pdf = torch.where(lit, raw_pdf, 0.0)
                l_direct = vwhere(lit, l_direct_pre, zero_v)
            if has_env:
                env_pdf = torch.where(active, env_pdf_raw, 0.0)
                l_env = vwhere(active & facing & ~e_occ, l_env_pre, zero_v)

            # MIS combine of the NEE estimators
            if cfg.mis == "reference":
                # the GLSL one-sample combine (comp:937-938)
                pdf_sum = env_pdf + light_pdf + d_pdf
                inv_sum = torch.where(
                    pdf_sum > _EPS,
                    1.0 / torch.where(pdf_sum == 0, 1.0, pdf_sum), 0.0)
                nee = (l_env * env_pdf + l_direct * light_pdf) * inv_sum
            else:
                nee = zero_v
                if has_lights:
                    w_l = light_pdf / maximum(light_pdf + p_b_light, _EPS)
                    nee = nee + l_direct * w_l
                if has_env:
                    w_e = env_pdf / maximum(env_pdf + p_b_env, _EPS)
                    nee = nee + l_env * w_e
            lo = lo + clamp_contrib(vwhere(active, c * nee, zero_v))

        with phase("next", bounce):
            # continue the path (comp:950-969)
            b_origin = pos + nrm * 1e-4
            if replay:
                hit2 = Hit(*(f[bounce] for f in (
                    records.bounce.tri, records.bounce.t, records.bounce.b1,
                    records.bounce.b2)))
                pos2, nrm2, (u_uv2, v_uv2), mat_id2, tex_id2 = (
                    make_interaction(hit2, l_out, b_origin, irows))
            else:
                hit2, pos2, nrm2, (u_uv2, v_uv2), mat_id2, tex_id2 = (
                    closest_inter(b_origin, l_out, t_max0, active))
                if record:
                    rec_hit2.append(Hit(*(_unsort(f, orig) for f in (
                        hit2.tri, hit2.t, hit2.b1, hit2.b2))))

        with phase("accumulate", bounce):
            miss_now = active & ~hit2.valid
            if cfg.mis == "balanced" and has_env:
                p_e_out = envmap_pdf_v(scene.env, l_out)
                w_b_env = d_pdf / maximum(d_pdf + p_e_out, _EPS)
            else:
                w_b_env = 1.0
            if replay and has_env:
                # deferred: one batched lookup for every bounce after the loop
                env_terms.append((l_out, vwhere(miss_now, c * weight * w_b_env,
                                                zero_v)))
            else:
                lo = lo + clamp_contrib(vwhere(
                    miss_now, c * env_radiance(l_out) * weight * w_b_env,
                    zero_v))

            hit_now = active & hit2.valid
            emissive2 = emissive_of(materials, mat_id2)
            if cfg.mis == "balanced" and has_lights:
                # solid-angle pdf of the area-light NEE strategy at this hit
                cos_h = absolute(vdot(nrm2, l_out))
                p_l_hit = (hit2.t * hit2.t) / maximum(
                    cos_h * lights.total_area, 1e-12)
                is_emissive = ((emissive2.x != 0.0) | (emissive2.y != 0.0)
                               | (emissive2.z != 0.0))
                w_b_emis = torch.where(
                    is_emissive, d_pdf / maximum(d_pdf + p_l_hit, _EPS), 1.0)
            else:
                w_b_emis = 1.0
            lo = lo + clamp_contrib(vwhere(
                hit_now, c * emissive2 * weight * w_b_emis, zero_v))

            # throughput update and state roll (comp:968-969)
            c = vwhere(hit_now, c * weight, c)
            v_dir = -l_out
            pos = vwhere(hit_now, pos2, pos)
            nrm = vwhere(hit_now, nrm2, nrm)
            mat_id = torch.where(hit_now, mat_id2, mat_id)
            if has_tex:
                u_uv = torch.where(hit_now, u_uv2, u_uv)
                v_uv = torch.where(hit_now, v_uv2, v_uv)
                tex_id = torch.where(hit_now, tex_id2, tex_id)
                if lod_on:
                    path_t = torch.where(hit_now, path_t + hit2.t, path_t)
            active = hit_now

            # Russian roulette (not in the reference), from rr_start on
            if cfg.rr_start is not None and bounce >= cfg.rr_start:
                seed, u_rr = rand01(seed)
                p_survive = clip(c.max_component(), 0.05, 0.95)
                survive = u_rr < p_survive
                c = vwhere(active & survive, c / p_survive, c)
                active = active & survive

    with phase("image"):
        if env_terms:
            # the deferred escaped-path terms: ONE radiance lookup over all
            # [max_depth * R] directions, then each bounce's term summed
            nb = len(env_terms)
            stacked = lambda i, k: torch.stack([getattr(t_[i], k)
                                                for t_ in env_terms])
            li = env_radiance(V3(*(stacked(0, k).reshape(-1) for k in "xyz")))

            def deferred(k):
                x = getattr(li, k).reshape(nb, r) * stacked(1, k)
                if cfg.max_radiance is not None:
                    x = minimum(x, cfg.max_radiance)
                return x.sum(0)

            lo = lo + V3(deferred("x"), deferred("y"), deferred("z"))

        if not replay:  # restore the original ray order after the permutations
            lo = lo.map(lambda a: _unsort(a, orig))

        # compose (comp:983-988): primary emissive + path radiance on a hit,
        # the environment on a miss
        color = vwhere(primary_hit, primary_emissive + lo, miss_color)
        if cfg.clamp_radiance:
            color = color.map(lambda a: clip(a, 0.0, 1.0))
        recs = None
        if record:
            stack = lambda xs: torch.stack(xs) if xs else None
            recs = TraceRecords(
                primary=hit, light_occ=stack(rec_occ), env_occ=stack(rec_eocc),
                bounce=Hit(*(torch.stack([getattr(h, k) for h in rec_hit2])
                             for k in ("tri", "t", "b1", "b2"))))
        radiance = color.rows()
    return radiance, recs


def render_rays(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                px: torch.Tensor, py: torch.Tensor, frame,
                cfg: RenderConfig) -> torch.Tensor:
    """[R, 3] radiance for one sample of a batch of primary rays (the
    live walks); arguments as :func:`_render_rays`."""
    return _render_rays(scene, o, d, px, py, frame, cfg, None, False)[0]


def trace_paths(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                px: torch.Tensor, py: torch.Tensor, frame,
                cfg: RenderConfig) -> TraceRecords:
    """Run the frame forward and keep every walk's answer (the trace
    phase of a trace/replay gradient step): the live frame on a detached
    scene, without gradients."""
    with torch.no_grad():
        return _render_rays(scene.detach(), o.detach(), d.detach(), px, py,
                            frame, cfg, None, True)[1]


def render_rays_replay(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                       px: torch.Tensor, py: torch.Tensor, frame,
                       cfg: RenderConfig,
                       records: TraceRecords) -> torch.Tensor:
    """The frame of ``records`` again WITHOUT any walk: the live frame's
    radiance up to rounding when ``scene`` holds the values the trace
    ran with, and differentiable in the scene's tensors (the backward
    never walks the BVH)."""
    return _render_rays(scene, o, d, px, py, frame, cfg, records, False)[0]
