"""The wavefront path integrator, live forward path.

PyTorch counterpart of ``_render_rays`` in
``pnraytracing_tpu/render/integrator.py`` (the estimator of
ray_tracing.comp:861-992): all rays advance one bounce per step of a
Python loop, and every stage is a masked operation over the whole ray
batch.  Each bounce runs the JAX package's three phases (draws, sort,
queries and contributions), and each part of the frame runs inside a
``phase`` of ``utils/profiling.py``:

* ``camera``: the tile's set-up and primary hit;
* ``shade``: every RNG draw and pdf/BRDF weight of the bounce (NEE area
  light, NEE environment, BRDF sample), in ``ops/shade.py``: one launch
  of its CUDA kernel where ``shade_on_card`` allows (a CUDA device,
  autograd recording nothing through the scene), else its plain
  version, the torch code (the CPU, the gradient's replay); a textured
  scene's base colors are overridden in torch first;
* ``sort``: with ``compact_rays``, for bounces below
  ``sort_max_bounce``, one permutation of the whole path state
  (``ops/compaction.py::permute_state``), live rays first, ordered by
  the ``sort_key`` (the treelet-entry key of their continuation ray by
  default) or, without ``sort_rays``, in their order
  (``compact_indices``);
* ``shadow``: the two NEE shadow queries in one any-hit launch (two with
  ``fuse_shadows`` off);
* ``next``: the continuation closest hit and its interaction (off route
  ``attr``, ``make_interaction``'s fill: one launch of its kernel,
  ``ops/shade.py::fill_interaction``, under the same rule as ``shade``,
  else ``make_interaction`` itself; the camera phase's primary fill
  too);
* ``accumulate``: the tail of the bounce (the NEE combine, the escaped
  and emissive terms with their MIS weights, the throughput, the state
  roll and Russian roulette) in ``ops/shade.py``: one launch of its
  kernel under the same rule as ``shade``, except in a replay, else its
  plain version;
* ``image``: the tile's colours.

An eager frame inside an open ``collect()``
counts, at the top of each bounce, the live rays (``rays.live``) and the
rays launched (``rays.launched``), and on route ``bvh`` each walk's work
(``accel/walks.py``); any other frame, and a captured one, counts
nothing.

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
texture id through the loop (and through the sort, as the JAX package's
``uvtex`` columns, with the path length for ``texture_lod_scale``) and
overrides the material's base color by the texture fetch of
``ops/texture.py`` before the bounce's draws.

``compat_pnrt`` runs the reference's quirks where the JAX package does:
the compat material decode, environment sample and BRDF sample, the env
shadow ray from the surface point itself, and the compat form of every
walk (``compat=True``: the compat instantiation of each kernel).  The
RNG draws are the same in both modes.

RNG words are int64 tensors holding uint32 values (ops/sampling.py); the
frame counter is an int or a 0-d tensor (``frame_word``), so the whole
frame can run inside a captured CUDA graph (``render/program.py``).
The walks are the route's (``accel/walks.py``), the JAX package's
choice for each scene and ``traversal`` value: each runs its CUDA
kernels on the card and their plain versions on the CPU.  On route
``bvh`` (a scene outside the packed layout) no sort key is computed:
live rays are only compacted, as the JAX package does without a layout.
"""

from __future__ import annotations

import dataclasses

import torch

from pnraytracing_tpu_torch.accel.layout import ATTR_TEX_BASE
from pnraytracing_tpu_torch.accel.walks import ray_components, route_walks
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.math import (
    FLOAT_MAX,
    SHADOW_EPS,
    clip,
    maximum,
    minimum,
)
from pnraytracing_tpu_torch.core.types import (Scene, TriangleMesh, _map,
                                               _Movable)
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
    Lanes,
    coherence_key,
    coherence_key_pos,
    compact_indices,
    entry_key,
    permute_state,
    scatter_back,
    sort_live_first,
)
from pnraytracing_tpu_torch.ops.gather import gather_row
from pnraytracing_tpu_torch.ops.intersect import Hit, intersect_triangle_c
from pnraytracing_tpu_torch.ops.sampling import frame_word, pixel_seed
from pnraytracing_tpu_torch.ops.shade import (
    Nee,
    Path,
    accumulate_bounce,
    accumulate_plain,
    any_zero,
    contiguous_env,
    corners,
    emissive_of,
    env_radiance,
    fill_interaction,
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
    route, closest_q, any_q = route_walks(scene, cfg)
    trav, mesh, materials, lights = (scene.trav, scene.mesh, scene.materials,
                                     scene.lights)
    has_env = scene.env is not None
    has_lights = lights.count > 0
    textures = scene.textures
    has_tex = textures is not None
    lod_on = has_tex and cfg.texture_lod_scale is not None
    dev = o.device
    r = o.shape[0]
    compat = cfg.compat_pnrt
    captured = capturing()

    def closest_inter(o_: V3, d_: V3, tm_, mask_=None):
        """Closest hit + interaction fill (hit, pos, nrm, (u, v), mat id,
        tex id): from the attribute kernel (only the backface flip,
        normalize and hit position remain here) or from the route's
        closest hit + the fill (its kernel on the card, else
        make_interaction)."""
        if route == "attr":
            hit_, (nx, ny, nz, u_, v_, mt) = closest_q(o_, d_, tm_, mask_)
            nrm_raw = V3(nx, ny, nz)
            nrm_ = vnormalize(vwhere(vdot(nrm_raw, d_) > 0, -nrm_raw,
                                     nrm_raw))
            return (hit_, o_ + d_ * hit_.t, nrm_, (u_, v_),
                    mt // ATTR_TEX_BASE, mt % ATTR_TEX_BASE - 1)
        hit_ = closest_q(o_, d_, tm_, mask_)
        fill = fill_interaction if on_card else make_interaction
        return (hit_,) + fill(hit_, d_, o_, irows)

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
        # the shade phase's, the tail's and the fill's kernels, or their
        # plain versions (ops/shade.py)
        on_card = shade_on_card(scene, dev, o, d)
        if on_card:
            mat_rows = material_rows(mat_tbl, materials)
            card_scene = dataclasses.replace(
                scene, env=contiguous_env(scene.env))
            px, py = px.to(torch.int64).contiguous(), py.to(
                torch.int64).contiguous()
        o_v, d_v = ray_components(o, d)
        if replay:
            hit = records.primary
            pos, nrm, (u_uv, v_uv), mat_id, tex_id = make_interaction(
                hit, d_v, o_v, irows)
        else:
            hit, pos, nrm, (u_uv, v_uv), mat_id, tex_id = closest_inter(
                o_v, d_v, t_max0)
        primary_hit = hit.valid
        path_t = None
        if lod_on:  # path length, the ray cone's footprint
            path_t = torch.where(primary_hit, hit.t, 0.0)
        miss_color = env_radiance(scene, env_const, cfg.env_scale, d_v)
        primary_emissive = emissive_of(materials, mat_id)

        v_dir = -d_v
        ones_r = torch.ones(r, dtype=torch.float32, device=dev)
        if not has_tex:  # the uv and texture id only a textured scene reads
            u_uv = v_uv = tex_id = None
        path = Path(zero_v, V3(ones_r, ones_r, ones_r), v_dir, pos, nrm,
                    mat_id, u_uv, v_uv, tex_id, path_t, primary_hit, seed)
        lanes = Lanes(torch.arange(r, dtype=torch.int64, device=dev), px, py)
        rec_occ, rec_eocc, rec_hit2 = [], [], []  # record: a bounce each
        env_terms = []  # replay: (direction, coefficient) of escaped paths

    def textured(base_rows: torch.Tensor) -> torch.Tensor:
        """[R, 3] base colors overridden by the texture fetch
        (comp:870-872) at the paths' current uv, texture id and length."""
        uv2 = torch.stack([path.u, path.v], dim=-1)
        if lod_on and textures.mips is not None:
            whs = textures.sizes[torch.clamp_min(path.tex_id, 0).long()].to(
                torch.float32)
            texdim = torch.maximum(whs[:, 0], whs[:, 1])
            lod = torch.log2(torch.clamp_min(
                path.path_t * cfg.texture_lod_scale * texdim, 1.0))
            return fetch_base_color_trilinear(textures, path.tex_id, uv2,
                                              base_rows, lod)
        return fetch_base_color(textures, path.tex_id, uv2, base_rows)

    texture = textured if has_tex else None

    # ---- path loop (comp:861-972) -----------------------------------------
    for bounce in range(cfg.max_depth):
        with phase("shade", bounce):
            # a captured counter would join the graph
            if not captured and collecting():
                count("rays.live", path.active.sum())
                count("rays.launched", r)
            state = (cfg, bounce, frame, path.active, path.pos, path.nrm,
                     path.v_dir, path.mat_id, path.seed, lanes.px, lanes.py)
            if on_card:
                cdlin = None if texture is None else texture(
                    mat_tbl.base_color.index_select(0, path.mat_id))
                shaded = shade_bounce(card_scene, mat_rows, irows, *state,
                                      cdlin=cdlin)
            else:
                shaded = shade_plain(scene, mat_tbl, irows, *state,
                                     texture=texture)
            path = path._replace(seed=shaded.seed)

        with phase("sort", bounce):
            # phase 2: one live-first permutation of the whole path state
            # (ops/compaction.py::permute_state); a replay never sorts
            if (cfg.compact_rays and bounce < cfg.sort_max_bounce
                    and not replay):
                active, pos, nrm = path.active, path.pos, path.nrm
                if not cfg.sort_rays or trav is None:
                    perm, _ = compact_indices(active)
                elif cfg.sort_key == "entry" and trav.treelets is not None:
                    key = entry_key(pos + nrm * 1e-4, shaded.l_out,
                                    trav.treelets, trav.treelet_tree)
                    perm, _ = sort_live_first(active, key)
                else:  # 'dir' / 'pos', and 'entry' without a treelet table
                    root = trav.nodes8[0]
                    lo_b, hi_b = root[0:3], root[3:6]
                    inv_ext = 1.0 / maximum(hi_b - lo_b, 1e-6)
                    key_fn = (coherence_key if cfg.sort_key == "dir"
                              else coherence_key_pos)
                    perm, _ = sort_live_first(active,
                                              key_fn(nrm, pos, lo_b, inv_ext))
                # the view direction is dead here: the tail rolls it from
                # the sample
                path, shaded, lanes = permute_state(
                    perm, (path, shaded, lanes), dead=("v_dir",))

        with phase("shadow", bounce):
            # phase 3: occlusion queries — replayed, or both NEE classes in
            # one launch when the scene has both and fuse_shadows is on, else
            # one each
            pos, nrm, active = path.pos, path.nrm, path.active
            occluded = facing = e_occ = None
            if has_lights:
                s_origin = pos + nrm * 1e-4
                s_tmax = torch.full((r,), 1.0 - SHADOW_EPS,
                                    dtype=torch.float32, device=dev)
            if has_env:
                # the reference casts the env shadow ray from the surface
                # point itself (comp:918)
                e_origin = pos if compat else pos + nrm * 1e-4
                facing = vdot(shaded.en_l, nrm) > 0
            if replay:
                if has_lights:
                    occluded = records.light_occ[bounce]
                if has_env:
                    e_occ = records.env_occ[bounce]
            elif has_lights and has_env and cfg.fuse_shadows:
                occ2 = any_q(vcat(s_origin, e_origin),
                             vcat(shaded.sdir, shaded.en_l),
                             torch.cat([s_tmax, t_max0]),
                             torch.cat([active, active & facing]))
                occluded, e_occ = occ2[:r], occ2[r:]
            else:
                if has_lights:
                    occluded = any_q(s_origin, shaded.sdir, s_tmax, active)
                if has_env:
                    e_occ = any_q(e_origin, shaded.en_l, t_max0,
                                  active & facing)
            if record:
                if has_lights:
                    rec_occ.append(scatter_back(occluded, lanes.orig))
                if has_env:
                    rec_eocc.append(scatter_back(e_occ, lanes.orig))

        with phase("next", bounce):
            # continue the path (comp:950-969)
            b_origin = pos + nrm * 1e-4
            if replay:
                hit2 = _map(records.bounce, lambda f: f[bounce])
                cont = (hit2,) + make_interaction(hit2, shaded.l_out,
                                                  b_origin, irows)
            else:
                cont = closest_inter(b_origin, shaded.l_out, t_max0, active)
                if record:
                    rec_hit2.append(_map(
                        cont[0], lambda f: scatter_back(f, lanes.orig)))

        with phase("accumulate", bounce):
            # the tail: the NEE terms the queries gate, then the escaped and
            # emissive terms, the throughput and the state roll; a replay
            # defers its escaped terms to the image phase (plain version)
            nee = Nee(occluded, shaded.raw_pdf, shaded.l_direct_pre, facing,
                      e_occ, shaded.env_pdf_raw, shaded.l_env_pre,
                      shaded.p_b_light, shaded.p_b_env)
            sample = (shaded.l_out, shaded.weight, shaded.d_pdf)
            if on_card and not replay:
                path = accumulate_bounce(card_scene, mat_rows, cfg, bounce,
                                         env_const, path, *sample, nee, cont)
            else:
                path = accumulate_plain(
                    scene, cfg, bounce, env_const, path, *sample, nee, cont,
                    deferred=env_terms if replay and has_env else None)

    with phase("image"):
        lo = path.lo
        if env_terms:
            # the deferred escaped-path terms: ONE radiance lookup over all
            # [max_depth * R] directions, then each bounce's term summed
            nb = len(env_terms)
            stacked = lambda i, k: torch.stack([getattr(t_[i], k)
                                                for t_ in env_terms])
            li = env_radiance(scene, env_const, cfg.env_scale,
                              V3(*(stacked(0, k).reshape(-1) for k in "xyz")))

            def deferred(k):
                x = getattr(li, k).reshape(nb, r) * stacked(1, k)
                if cfg.max_radiance is not None:
                    x = minimum(x, cfg.max_radiance)
                return x.sum(0)

            lo = lo + V3(deferred("x"), deferred("y"), deferred("z"))

        if not replay:  # restore the original ray order after the permutations
            lo = lo.map(lambda a: scatter_back(a, lanes.orig))

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
