"""The shade phase of one bounce: every draw and weight of phase 1 of
``render/integrator.py::_render_rays`` (comp:870-934), as one CUDA kernel
and its plain version.

Per ray: the material gather, the tangent frame, the NEE area-light draw
and its BRDF value, the NEE environment draw (alias rows or CDFs) and its
BRDF value, the BRDF sample (Sobol + Cranley-Patterson or two hash
draws) with its own BRDF value, and under ``mis="balanced"`` the BRDF
pdfs of both NEE directions.  Both versions return what the later
phases read, a :class:`Shade`.

* :func:`shade_plain` is the integrator's own torch code: the CPU, and
  autograd through the scene (the op graph its backward needs).
* :func:`shade_bounce` launches ``csrc/shade.cu`` on the current stream,
  one thread a ray, and counts the launch in :data:`LAUNCHES`.  It takes
  only CUDA tensors and raises on anything else.  A live lane's outputs
  equal the plain version's bit for bit (built with --fmad=false, each
  operation in the torch code's order); a lane with ``active`` false
  gets zeros and its seed unchanged, which no later phase reads (its
  walks are masked, its terms selected away, and the sort puts it after
  every live lane whatever its key).  It takes every form the torch code
  takes: ``compat_pnrt``, and an environment map with its fat alias rows,
  with its two alias tables only, or with neither (CDF inversion).
* :func:`shade_on_card` is the integrator's choice between them: the
  kernel on a CUDA device when autograd would record nothing through the
  scene.

The tail of the bounce, after its walks (the NEE combine, the escaped
and emissive terms with their MIS weights, the throughput update, the
state roll and Russian roulette), has the same pair: the plain version
:func:`accumulate_plain` and the kernel :func:`accumulate_bounce`
(``csrc/shade.cu``'s ``accumulate_bounce_kernel``), both returning the
rolled :class:`Path`.  Every lane of the kernel equals the plain
version bit for bit, a dead one too: its radiance gains the three zero
terms and the rest of its state passes through (the image reads the
radiance of every lane).

The interaction fill after a closest hit (``render/integrator.py::
make_interaction``, the plain version) has its kernel too,
:func:`fill_interaction` (``csrc/shade.cu``'s ``interaction_kernel``):
every lane of it, a missed one too, equals the plain version bit for
bit (the re-test of the hit triangle is the walks' own,
``csrc/intersect.cuh``).

No TPU kernel stands behind these: XLA fuses the same chains in the JAX
package.  On the card the torch versions are ~1,400, ~215 and ~260
elementwise kernels a call, each reading and writing [R] vectors
(csrc/shade.cu has the bounds and the figures).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.math import (
    FLOAT_MAX,
    absolute,
    clip,
    maximum,
    minimum,
)
from pnraytracing_tpu_torch.core.types import (
    EnvMap,
    Materials,
    Scene,
    tensors,
)
from pnraytracing_tpu_torch.core.vec import (
    V3,
    build_tangent_space_v,
    vcross,
    vdot,
    vnormalize,
    vwhere,
)
from pnraytracing_tpu_torch.ops.brdf import (
    disney_eval_v,
    disney_pdf_v,
    disney_sample_v,
)
from pnraytracing_tpu_torch.ops.envmap import (
    envmap_lookup_v,
    envmap_pdf_v,
    sample_envmap_v,
)
from pnraytracing_tpu_torch.ops.gather import gather_row
from pnraytracing_tpu_torch.ops.sampling import (
    SOBOL_DIMS,
    _sobol_device_table,
    cranley_patterson_rotation_c,
    pick_light,
    rand01,
    sample_uniform_triangle,
    sobol_vec2,
    u32_to_unit,
    wang_hash,
)
from pnraytracing_tpu_torch.utils.profiling import launched

_EPS = 1e-10

# Launches of the three kernels since the last reset (the caller zeroes
# it).  Deliberately not one of render/program.py's launch tables: those
# list the route's walk kernels, which the benchmark's route check
# compares.
LAUNCHES = {"shade": 0, "accumulate": 0, "interaction": 0}


class Shade(NamedTuple):
    """A bounce's draws and weights, what its later phases read (None
    where the scene or the MIS mode has no such term)."""

    seed: torch.Tensor
    l_out: V3
    weight: V3
    d_pdf: torch.Tensor
    sdir: V3 | None
    raw_pdf: torch.Tensor | None
    l_direct_pre: V3 | None
    en_l: V3 | None
    env_pdf_raw: torch.Tensor | None
    l_env_pre: V3 | None
    p_b_light: torch.Tensor | None
    p_b_env: torch.Tensor | None


OUTPUTS = Shade._fields

# the columns of material_rows: the 12 scalars, base color, emissive
_SCALARS = ("subsurface", "metallic", "specular", "specular_tint",
            "roughness", "anisotropic", "sheen", "sheen_tint", "clearcoat",
            "clearcoat_gloss", "ior", "transmission")
MATERIAL_COLUMNS = 18


def corners(rr: torch.Tensor, base: int) -> tuple[V3, V3, V3]:
    """The three corners of columns ``base`` .. ``base + 8`` of rows
    ``rr`` of the interaction table."""
    c = lambda k: rr[:, base + k]
    return (V3(c(0), c(1), c(2)), V3(c(3), c(4), c(5)),
            V3(c(6), c(7), c(8)))


def any_zero(n0: V3, n1: V3, n2: V3) -> torch.Tensor:
    """Whether any of three corner normals is the zero vector (no vertex
    normal: the geometric normal stands in)."""
    zero3 = lambda a: (a.x == 0) & (a.y == 0) & (a.z == 0)
    return zero3(n0) | zero3(n1) | zero3(n2)


def emissive_of(materials, mat_id: torch.Tensor) -> V3:
    # every gather from a table that can carry a gradient goes through
    # ops/gather.py: a backward that sums in a fixed order
    return V3.of(gather_row(mat_id, materials.emissive))


def safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1/x, 0 where |x| <= 1e-10."""
    return torch.where(torch.abs(x) > _EPS,
                       1.0 / torch.where(x == 0, 1.0, x), 0.0)


def sample_light_point(tri: torch.Tensor, u1, u2, rows: torch.Tensor):
    """Uniform point + normal on light triangles (TriangleSample,
    comp:604-624).  Returns (pos V3, nrm V3)."""
    b0, b1 = sample_uniform_triangle(u1, u2)
    rr = gather_row(tri, rows)
    p0, p1, p2 = corners(rr, 0)
    n0, n1, n2 = corners(rr, 9)
    b2 = 1.0 - b0 - b1
    pos = p0 * b0 + p1 * b1 + p2 * b2
    geom_n = vnormalize(vcross(p1 - p0, p2 - p0))
    n_interp = n0 * b0 + n1 * b1 + n2 * b2
    return pos, vnormalize(vwhere(any_zero(n0, n1, n2), geom_n, n_interp))


def shade_on_card(scene: Scene, device, *inputs) -> bool:
    """Whether a bounce's shade phase takes the kernel: the rays lie on a
    CUDA device and autograd would record nothing through the scene's
    tensors or ``inputs`` (grad mode off, or none of them requires grad).
    The kernel takes every configuration and environment map.  Reads only
    what the call can see; allocates nothing."""
    if torch.device(device).type != "cuda":
        return False
    return not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (*tensors(scene), *inputs)))


def shade_plain(scene: Scene, mat_tbl: Materials, irows: torch.Tensor,
                cfg: RenderConfig, bounce: int, frame, active, pos: V3,
                nrm: V3, v_dir: V3, mat_id: torch.Tensor, seed: torch.Tensor,
                px: torch.Tensor, py: torch.Tensor, texture=None):
    """The plain version: the integrator's torch code of phase 1.
    ``mat_tbl`` is the sanitized (or compat-decoded) material table,
    ``irows`` the interaction table (``pack_interaction_rows``),
    ``frame`` the frame word (an int or a 0-d tensor), ``px``/``py`` the
    rays' pixels; ``texture`` (None: untextured) maps the gathered [R, 3]
    base colors to the textured ones.  ``active`` is not read: every lane
    is computed.  Returns a :class:`Shade`."""
    materials, lights = scene.materials, scene.lights
    has_env = scene.env is not None
    has_lights = lights.count > 0
    compat = cfg.compat_pnrt
    sdir = raw_pdf = l_direct_pre = en_l = env_pdf_raw = l_env_pre = None
    p_b_light = p_b_env = None

    mat, cdlin, _ = mat_tbl.gather_components(mat_id)
    if texture is not None:  # the texture overrides the base color
        cdlin = V3.of(texture(cdlin.rows()))
    t_tan, b_tan = build_tangent_space_v(nrm)

    # phase 1a: NEE area-light draws (comp:878-909)
    seed, u_light = rand01(seed)
    if has_lights:
        slot = pick_light(lights.prefix_area, lights.total_area, u_light)
        light_tri = lights.tri_index[slot.long()]
        seed, u1 = rand01(seed)
        seed, u2 = rand01(seed)
        lp, ln = sample_light_point(light_tri, u1, u2, irows)
        sdir = lp - pos  # unnormalized segment (comp:887)
        dis2 = vdot(sdir, sdir)
        lnorm = vnormalize(sdir)
        cos_l = absolute(vdot(ln, -lnorm))
        raw_pdf = dis2 / maximum(cos_l * lights.total_area, 1e-12)
        lmat = irows[lights.tri_index.long(), 24].to(torch.int32)[
            slot.long()]
        li = emissive_of(materials, lmat)
        light_f = disney_eval_v(v_dir, nrm, lnorm, t_tan, b_tan, mat, cdlin)
        nl = absolute(vdot(nrm, lnorm))
        l_direct_pre = light_f * li * (nl * safe_inv(raw_pdf))

    # phase 1b: NEE environment draws (comp:911-926)
    if has_env:
        seed, r1e = rand01(seed)
        seed, r2e = rand01(seed)
        en_l, en_li, env_pdf_raw = sample_envmap_v(scene.env, r1e, r2e,
                                                   compat)
        env_f = disney_eval_v(v_dir, nrm, en_l, t_tan, b_tan, mat, cdlin)
        l_env_pre = env_f * en_li * (vdot(en_l, nrm)
                                     * safe_inv(env_pdf_raw))

    # phase 1c: BRDF sample (comp:928-934)
    if cfg.sampler == "sobol":
        su, sv = sobol_vec2(frame + 1, bounce)
        r1, r2 = cranley_patterson_rotation_c(
            su, sv, px, py, cfg.width, cfg.height,
            salt=(2 * bounce) // SOBOL_DIMS)
    else:
        seed, r1 = rand01(seed)
        seed, r2 = rand01(seed)
    seed, r_lobe = rand01(seed)
    # diffuse-lobe draws leave the stream only when that lobe is taken
    s1 = wang_hash(seed)
    s2 = wang_hash(s1)
    l_out, d_pdf, lobe = disney_sample_v(
        v_dir, nrm, t_tan, b_tan, mat, r_lobe, r1, r2, u32_to_unit(s1),
        u32_to_unit(s2), compat)
    seed = torch.where(lobe == 0, s2, seed)

    d_f = disney_eval_v(v_dir, nrm, l_out, t_tan, b_tan, mat, cdlin)
    weight = d_f * (absolute(vdot(nrm, l_out)) * safe_inv(d_pdf))
    if cfg.mis == "balanced":
        if has_lights:
            p_b_light = maximum(disney_pdf_v(v_dir, nrm, lnorm, mat), 0.0)
        if has_env:
            p_b_env = maximum(disney_pdf_v(v_dir, nrm, en_l, mat), 0.0)
    return Shade(seed, l_out, weight, d_pdf, sdir, raw_pdf, l_direct_pre,
                 en_l, env_pdf_raw, l_env_pre, p_b_light, p_b_env)


# how the kernel's environment draw picks its cell (csrc/shade.cu)
ENV_FAT, ENV_ALIAS, ENV_CDF = 1, 2, 3


def env_mode(env: EnvMap, compat: bool) -> int:
    """The environment draw :func:`sample_envmap_v` makes: from the fat
    alias rows, from the two alias tables, or by the CDFs (a map without
    alias tables, and every compat draw)."""
    if compat or env.alias_x is None:
        return ENV_CDF
    return ENV_ALIAS if env.alias_fat is None else ENV_FAT


def contiguous_env(env):
    """``env`` (or None) with every table contiguous, as the kernel reads
    them; a baked map's tables already are (the same tensors come back),
    those built in the graph (``ops/envmap.py::envmap_in_graph``) may not
    be."""
    if env is None:
        return None
    return dataclasses.replace(env, **{
        f.name: getattr(env, f.name).contiguous()
        for f in dataclasses.fields(env) if getattr(env, f.name) is not None})


def material_rows(mat_tbl: Materials, materials: Materials) -> torch.Tensor:
    """[M, 18] rows the kernel gathers by material id: the 12 scalars of
    the sanitized table ``mat_tbl`` (in ``_SCALARS`` order), its base
    color, and the emission of ``materials`` as the light draw reads it
    (unclamped, as the plain version's ``emissive_of``)."""
    return torch.cat([torch.stack([getattr(mat_tbl, k) for k in _SCALARS],
                                  dim=1),
                      mat_tbl.base_color, materials.emissive], dim=1)


def _check(name: str, t, dtype, shape, dev, kernel="shade"):
    if not (isinstance(t, torch.Tensor) and t.dtype == dtype
            and tuple(t.shape) == tuple(shape) and t.is_contiguous()
            and t.device == dev):
        raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)} on {dev}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def shade_bounce(scene: Scene, mat_rows: torch.Tensor, irows: torch.Tensor,
                 cfg: RenderConfig, bounce: int, frame, active, pos: V3,
                 nrm: V3, v_dir: V3, mat_id: torch.Tensor, seed: torch.Tensor,
                 px: torch.Tensor, py: torch.Tensor, cdlin=None):
    """The kernel: :func:`shade_plain`'s outputs for the live lanes
    (zeros and the seed unchanged for the others) in one launch.
    ``mat_rows`` is :func:`material_rows` of the tables the plain version
    reads (compat-decoded under ``compat_pnrt``), ``cdlin`` (None: the
    table's) the textured [R, 3] base colors.  The environment's tables
    the draw reads (:func:`env_mode`) must be contiguous
    (:func:`contiguous_env`).
    Every input lies on one CUDA device, contiguous: ``active`` bool,
    ``pos``/``nrm``/``v_dir`` float32 components, ``mat_id`` int32,
    ``seed``/``px``/``py`` int64 [R]; ``frame`` an int, a 0-d int64
    tensor there (read by the kernel, so a captured graph draws each
    replay's frame) or a 0-d tensor in host memory.  Raises on anything
    else, and if the launch fails."""
    from pnraytracing_tpu_torch.cuda_build import library

    dev = seed.device
    if dev.type != "cuda":
        raise ValueError(f"shade: the kernel runs on a CUDA device, not "
                         f"{dev}; the CPU takes shade_plain")
    r = int(seed.shape[0])
    f32, i64 = torch.float32, torch.int64
    for name, t in (("pos", pos), ("nrm", nrm), ("v_dir", v_dir)):
        for k in "xyz":
            _check(f"{name}.{k}", getattr(t, k), f32, (r,), dev)
    _check("active", active, torch.bool, (r,), dev)
    _check("mat_id", mat_id, torch.int32, (r,), dev)
    for name, t in (("seed", seed), ("px", px), ("py", py)):
        _check(name, t, i64, (r,), dev)
    _check("mat_rows", mat_rows, f32, (mat_rows.shape[0], MATERIAL_COLUMNS),
           dev)
    _check("irows", irows, f32, (irows.shape[0], 26), dev)
    if cdlin is not None:
        _check("cdlin", cdlin, f32, (r, 3), dev)
    lights, env = scene.lights, scene.env
    has_lights, has_env = lights.count > 0, env is not None
    n_lights = int(lights.count)
    if has_lights:
        _check("lights.tri_index", lights.tri_index, torch.int32,
               (n_lights,), dev)
        _check("lights.prefix_area", lights.prefix_area, f32, (n_lights,),
               dev)
        _check("lights.total_area", lights.total_area, f32, (), dev)
    compat = bool(cfg.compat_pnrt)
    env_w = env_h = mode = 0
    tables = dict.fromkeys(("alias_x", "alias_y", "alias_fat", "image",
                            "pdf_xy", "cdf_marginal_x", "cdf_y_given_x"))
    if has_env:
        env_w, env_h = env.width, env.height
        mode = env_mode(env, compat)
        shapes = dict(alias_x=(env_w, 2), alias_y=(env_w, env_h, 2),
                      alias_fat=(env_w * env_h, 10),
                      image=(env_h, env_w, 3), pdf_xy=(env_w, env_h),
                      cdf_marginal_x=(env_w,),
                      cdf_y_given_x=(env_w, env_h))
        read = {ENV_FAT: ("alias_x", "alias_fat"),
                ENV_ALIAS: ("alias_x", "alias_y", "pdf_xy", "image"),
                ENV_CDF: ("cdf_marginal_x", "cdf_y_given_x", "pdf_xy",
                          "image")}[mode]
        for k in read:
            tables[k] = getattr(env, k)
            _check(f"env.{k}", tables[k], f32, shapes[k], dev)
    sobol = cfg.sampler == "sobol"
    balanced = cfg.mis == "balanced"
    frame_t, frame_host = None, 0
    if isinstance(frame, torch.Tensor) and frame.device.type == "cuda":
        _check("frame", frame, i64, (), dev)
        frame_t = frame
    else:  # an int, or a tensor in host memory: read here
        frame_host = int(frame) & 0xFFFFFFFF
    dirs = _sobol_device_table(dev)[0] if sobol else None

    rows = 7 + 7 * has_lights + 7 * has_env + balanced * (has_lights
                                                          + has_env)
    out = torch.empty((rows, r), dtype=f32, device=dev)
    seed_out = torch.empty(r, dtype=i64, device=dev)
    flags = has_lights | has_env << 1 | sobol << 2 | balanced << 3
    err = library("shade").pnrt_shade(
        flags, r, bounce, cfg.width, cfg.height, n_lights, env_w, env_h,
        mode, int(compat), frame_host, _ptr(frame_t), _ptr(active),
        _ptr(pos.x), _ptr(pos.y), _ptr(pos.z), _ptr(nrm.x), _ptr(nrm.y), _ptr(nrm.z),
        _ptr(v_dir.x), _ptr(v_dir.y), _ptr(v_dir.z), _ptr(mat_id),
        _ptr(seed), _ptr(px), _ptr(py), _ptr(cdlin), _ptr(mat_rows),
        _ptr(irows), _ptr(lights.tri_index if has_lights else None),
        _ptr(lights.prefix_area if has_lights else None),
        _ptr(lights.total_area if has_lights else None),
        *(_ptr(t) for t in tables.values()), _ptr(dirs),
        _ptr(seed_out), _ptr(out),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"shade kernel launch failed: CUDA error {err}")
    launched(LAUNCHES, "shade")

    it = iter(out.unbind(0))
    v3 = lambda: V3(next(it), next(it), next(it))
    l_out, weight, d_pdf = v3(), v3(), next(it)
    sdir = raw_pdf = l_direct_pre = en_l = env_pdf_raw = l_env_pre = None
    p_b_light = p_b_env = None
    if has_lights:
        sdir, raw_pdf, l_direct_pre = v3(), next(it), v3()
    if has_env:
        en_l, env_pdf_raw, l_env_pre = v3(), next(it), v3()
    if balanced:
        p_b_light = next(it) if has_lights else None
        p_b_env = next(it) if has_env else None
    return Shade(seed_out, l_out, weight, d_pdf, sdir, raw_pdf,
                 l_direct_pre, en_l, env_pdf_raw, l_env_pre, p_b_light,
                 p_b_env)


def kernel_info(has_lights=True, has_env=True, sobol=True,
                balanced=False) -> dict:
    """Registers and local (spilled) bytes a thread, threads a block and
    blocks an SM of the kernel's instantiation for these flags, as the
    card reports them; raises if it refuses to say."""
    flags = (int(has_lights) | int(has_env) << 1 | int(sobol) << 2
             | int(balanced) << 3)
    return _attributes("shade", flags)


def _attributes(kernel: str, flags: int) -> dict:
    from pnraytracing_tpu_torch.cuda_build import library

    q = getattr(library("shade"), f"pnrt_{kernel}_kernel_info")
    out = {k: q(flags, what) for what, k in enumerate(
        ("registers", "blocks_per_sm", "threads", "local_bytes"))}
    if min(out.values()) < 0:
        raise RuntimeError(f"{kernel}: CUDA error {-min(out.values())} "
                           "reading the kernel's attributes")
    return out


# ---- the tail of a bounce -------------------------------------------------

class Nee(NamedTuple):
    """A bounce's NEE terms as its tail combines them: the light query's
    occlusion and the shade phase's light terms, the environment
    direction's facing flag, its occlusion and terms, and under balanced
    MIS the BRDF pdfs of both directions (None where the scene has no
    area light / no environment map, or the MIS mode reads none)."""

    occluded: torch.Tensor | None
    raw_pdf: torch.Tensor | None
    l_direct_pre: V3 | None
    facing: torch.Tensor | None
    e_occ: torch.Tensor | None
    env_pdf_raw: torch.Tensor | None
    l_env_pre: V3 | None
    p_b_light: torch.Tensor | None
    p_b_env: torch.Tensor | None


class Path(NamedTuple):
    """A path's state between bounces, what the tail reads and rolls: its
    radiance ``lo``, throughput ``c``, view direction, surface (position,
    normal, material id; the uv and texture id only in a textured scene,
    and the length ``path_t`` only with texture LOD, else None), live
    flag and RNG word."""

    lo: V3
    c: V3
    v_dir: V3
    pos: V3
    nrm: V3
    mat_id: torch.Tensor
    u: torch.Tensor | None
    v: torch.Tensor | None
    tex_id: torch.Tensor | None
    path_t: torch.Tensor | None
    active: torch.Tensor
    seed: torch.Tensor


def env_radiance(scene: Scene, env_const: torch.Tensor, env_scale: float,
                 dirs: V3) -> V3:
    """Radiance along ``dirs``: the map's bilinear lookup, or the
    constant environment ``env_const * env_scale``."""
    if scene.env is not None:
        return envmap_lookup_v(scene.env, dirs)
    ones = torch.ones_like(dirs.x)
    ec = env_const * env_scale
    return V3(ec[0] * ones, ec[1] * ones, ec[2] * ones)


def clamp_contrib(x: V3, max_radiance: float | None) -> V3:
    """A path's contribution clamped at ``max_radiance`` (None: none)."""
    if max_radiance is not None:
        return x.map(lambda a: minimum(a, max_radiance))
    return x


def accumulate_plain(scene: Scene, cfg: RenderConfig, bounce: int,
                     env_const: torch.Tensor, path: Path, l_out: V3,
                     weight: V3, d_pdf: torch.Tensor, nee: Nee, cont,
                     deferred: list | None = None) -> Path:
    """The plain version of the tail of bounce ``bounce``: the
    integrator's torch code of the NEE combine and the accumulate phase.
    ``env_const`` is the constant environment ([3], zeros where the scene
    has none), ``l_out``/``weight``/``d_pdf`` the shade phase's sample,
    ``cont`` the continuation hit and its interaction (``(hit, pos, nrm,
    (u, v), mat_id, tex_id)``).  With ``deferred`` (a replay of a scene
    with an environment map) each escaped path's direction and
    coefficient are appended there instead of adding its radiance.
    Returns the rolled :class:`Path`."""
    materials, lights = scene.materials, scene.lights
    has_env = scene.env is not None
    has_lights = lights.count > 0
    has_tex = scene.textures is not None
    lod_on = has_tex and cfg.texture_lod_scale is not None
    (lo, c, _, pos, nrm, mat_id, u_uv, v_uv, tex_id, path_t, active,
     seed) = path
    hit2, pos2, nrm2, (u_uv2, v_uv2), mat_id2, tex_id2 = cont
    zero_r = torch.zeros_like(d_pdf)
    zero_v = V3(zero_r, zero_r, zero_r)
    clamp = lambda x: clamp_contrib(x, cfg.max_radiance)

    # NEE contributions (masks applied to the pre-folded terms)
    light_pdf, l_direct = zero_r, zero_v
    env_pdf, l_env = zero_r, zero_v
    if has_lights:
        lit = active & ~nee.occluded
        light_pdf = torch.where(lit, nee.raw_pdf, 0.0)
        l_direct = vwhere(lit, nee.l_direct_pre, zero_v)
    if has_env:
        env_pdf = torch.where(active, nee.env_pdf_raw, 0.0)
        l_env = vwhere(active & nee.facing & ~nee.e_occ, nee.l_env_pre,
                       zero_v)

    # MIS combine of the NEE estimators
    if cfg.mis == "reference":
        # the GLSL one-sample combine (comp:937-938)
        pdf_sum = env_pdf + light_pdf + d_pdf
        inv_sum = torch.where(
            pdf_sum > _EPS,
            1.0 / torch.where(pdf_sum == 0, 1.0, pdf_sum), 0.0)
        nee_v = (l_env * env_pdf + l_direct * light_pdf) * inv_sum
    else:
        nee_v = zero_v
        if has_lights:
            w_l = light_pdf / maximum(light_pdf + nee.p_b_light, _EPS)
            nee_v = nee_v + l_direct * w_l
        if has_env:
            w_e = env_pdf / maximum(env_pdf + nee.p_b_env, _EPS)
            nee_v = nee_v + l_env * w_e
    lo = lo + clamp(vwhere(active, c * nee_v, zero_v))

    # the BRDF-sampled continuation: escaped paths (comp:950-969)
    miss_now = active & ~hit2.valid
    if cfg.mis == "balanced" and has_env:
        p_e_out = envmap_pdf_v(scene.env, l_out)
        w_b_env = d_pdf / maximum(d_pdf + p_e_out, _EPS)
    else:
        w_b_env = 1.0
    if deferred is not None:
        # one batched lookup for every bounce after the loop
        deferred.append((l_out, vwhere(miss_now, c * weight * w_b_env,
                                       zero_v)))
    else:
        lo = lo + clamp(vwhere(
            miss_now,
            c * env_radiance(scene, env_const, cfg.env_scale, l_out)
            * weight * w_b_env, zero_v))

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
    lo = lo + clamp(vwhere(
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
    return Path(lo, c, v_dir, pos, nrm, mat_id, u_uv, v_uv, tex_id, path_t,
                active, seed)


class _TailForm(NamedTuple):
    """The form of a bounce's tail, from what the scene holds and the
    configuration says (the kernel's template flags and uniforms)."""

    lights: bool
    env: bool
    balanced: bool
    textured: bool
    lod: bool  # the path length rolls (texture LOD)
    rr: bool  # Russian roulette at this bounce
    quad: bool  # the map's quad rows (else its image)

    @classmethod
    def of(cls, scene: Scene, cfg: RenderConfig, bounce: int):
        env, textured = scene.env, scene.textures is not None
        return cls(scene.lights.count > 0, env is not None,
                   cfg.mis == "balanced", textured,
                   textured and cfg.texture_lod_scale is not None,
                   cfg.rr_start is not None and bounce >= cfg.rr_start,
                   env is not None and env.quad12 is not None)


def tail_inputs(scene: Scene, mat_rows: torch.Tensor, cfg: RenderConfig,
                bounce: int, env_const: torch.Tensor, path: Path, l_out: V3,
                weight: V3, d_pdf: torch.Tensor, nee: Nee, cont) -> list:
    """What :func:`accumulate_bounce` hands its kernel, checked: a tensor
    (or None where the flags read none) each of csrc/shade.cu's ``TailIn``
    pointers, in order.  Raises where a tensor the kernel reads is
    missing or has another dtype, shape or device, or is not
    contiguous."""
    dev = d_pdf.device
    r = int(d_pdf.shape[0])
    lights, env = scene.lights, scene.env
    (has_lights, has_env, balanced, has_tex, lod, rr,
     quad) = _TailForm.of(scene, cfg, bounce)
    hit2, pos2, nrm2, (u2, v2), mat_id2, tex_id2 = cont
    f32, i32, flag = torch.float32, torch.int32, torch.bool
    env_hw = (env.height, env.width) if has_env else (0, 0)
    lane = lambda name, t, dtype, read: [(name, t, dtype, (r,), read)]
    v3 = lambda name, v, read: [
        (f"{name}.{k}", getattr(v, k) if read else None, f32, (r,), read)
        for k in "xyz"]
    # (name, tensor, dtype, shape, read) in TailIn's order
    inputs = [*lane("active", path.active, flag, True),
              *v3("c", path.c, True), *v3("lo", path.lo, True),
              *v3("l_out", l_out, True), *v3("weight", weight, True),
              *lane("d_pdf", d_pdf, f32, True),
              *lane("seed", path.seed, torch.int64, rr),
              *lane("occluded", nee.occluded, flag, has_lights),
              *lane("raw_pdf", nee.raw_pdf, f32, has_lights),
              *v3("l_direct_pre", nee.l_direct_pre, has_lights),
              *lane("facing", nee.facing, flag, has_env),
              *lane("e_occ", nee.e_occ, flag, has_env),
              *lane("env_pdf_raw", nee.env_pdf_raw, f32, has_env),
              *v3("l_env_pre", nee.l_env_pre, has_env),
              *lane("p_b_light", nee.p_b_light, f32, balanced and has_lights),
              *lane("p_b_env", nee.p_b_env, f32, balanced and has_env),
              *lane("hit.tri", hit2.tri, i32, True),
              *lane("hit.t", hit2.t, f32, True),
              *v3("pos2", pos2, True), *v3("nrm2", nrm2, True),
              *lane("mat_id2", mat_id2, i32, True),
              *lane("u2", u2, f32, has_tex), *lane("v2", v2, f32, has_tex),
              *lane("tex_id2", tex_id2, i32, has_tex),
              *v3("pos", path.pos, True), *v3("nrm", path.nrm, True),
              *lane("mat_id", path.mat_id, i32, True),
              *lane("u", path.u, f32, has_tex),
              *lane("v", path.v, f32, has_tex),
              *lane("tex_id", path.tex_id, i32, has_tex),
              *lane("path_t", path.path_t, f32, lod),
              ("mat_rows", mat_rows, f32,
               (mat_rows.shape[0], MATERIAL_COLUMNS), True),
              ("lights.total_area", lights.total_area, f32, (),
               balanced and has_lights),
              ("env_const", env_const, f32, (3,), True),
              ("env.quad12", env.quad12 if quad else None, f32,
               (*env_hw, 12), quad),
              ("env.image", env.image if has_env and not quad else None,
               f32, (*env_hw, 3), has_env and not quad),
              ("env.pdf_xy", env.pdf_xy if balanced and has_env else None,
               f32, env_hw[::-1], balanced and has_env)]
    for name, t, dtype, shape, read in inputs:
        if read:
            _check(name, t, dtype, shape, dev, kernel="accumulate")
    return [t if read else None for _, t, _, _, read in inputs]


def accumulate_bounce(scene: Scene, mat_rows: torch.Tensor,
                      cfg: RenderConfig, bounce: int,
                      env_const: torch.Tensor, path: Path, l_out: V3,
                      weight: V3, d_pdf: torch.Tensor, nee: Nee,
                      cont) -> Path:
    """The kernel: :func:`accumulate_plain`'s :class:`Path` (never
    deferring) in one launch, out of place (the inputs may be rows of the
    sort's pack).  ``mat_rows`` is :func:`material_rows` (the emission in
    columns 15-17); the map's tables it reads (its quad rows, or its
    image where it has none, and its pdf under balanced MIS) must be
    contiguous (:func:`contiguous_env`).  Every tensor read lies on one
    CUDA device, contiguous, [R] unless said: bools ``active`` and the
    NEE flags, float32 components and scalars, int32 triangle, material
    and texture ids, int64 ``seed``; ``env_const`` float32 [3],
    ``lights.total_area`` a 0-d float32 (:func:`tail_inputs`).  Raises on
    anything else, and if the launch fails."""
    from pnraytracing_tpu_torch.cuda_build import library

    dev = d_pdf.device
    if dev.type != "cuda":
        raise ValueError(f"accumulate: the kernel runs on a CUDA device, not "
                         f"{dev}; the CPU takes accumulate_plain")
    inputs = tail_inputs(scene, mat_rows, cfg, bounce, env_const, path,
                         l_out, weight, d_pdf, nee, cont)
    lib = library("shade")
    if lib.pnrt_accumulate_inputs() != len(inputs):
        raise RuntimeError(f"accumulate: the kernel reads "
                           f"{lib.pnrt_accumulate_inputs()} inputs, the "
                           f"wrapper hands it {len(inputs)}")
    ptrs = (ctypes.c_void_p * len(inputs))(*map(_ptr, inputs))
    r = int(d_pdf.shape[0])
    env = scene.env
    form = _TailForm.of(scene, cfg, bounce)
    out = torch.empty((15 + 2 * form.textured + form.lod, r),
                      dtype=torch.float32, device=dev)
    ids = torch.empty((1 + form.textured, r), dtype=torch.int32, device=dev)
    active = torch.empty(r, dtype=torch.bool, device=dev)
    seed = (torch.empty(r, dtype=torch.int64, device=dev) if form.rr
            else path.seed)
    flags = (form.lights | form.env << 1 | form.balanced << 2
             | form.textured << 3)
    err = lib.pnrt_accumulate(
        flags, r, env.width if form.env else 0, env.height if form.env else 0,
        int(form.quad), int(form.lod), int(form.rr),
        int(cfg.max_radiance is not None), float(cfg.max_radiance or 0.0),
        float(cfg.env_scale), ctypes.addressof(ptrs), _ptr(out), _ptr(ids),
        _ptr(active), _ptr(seed) if form.rr else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"accumulate kernel launch failed: CUDA error "
                           f"{err}")
    launched(LAUNCHES, "accumulate")

    rows = out.unbind(0)
    v3 = lambda k: V3(rows[k], rows[k + 1], rows[k + 2])
    u, v, tex_id, path_t = path.u, path.v, path.tex_id, path.path_t
    if form.textured:
        u, v, tex_id = rows[15], rows[16], ids[1]
        if form.lod:
            path_t = rows[17]
    return Path(v3(0), v3(3), v3(6), v3(9), v3(12), ids[0], u, v, tex_id,
                path_t, active, seed)


def accumulate_kernel_info(has_lights=True, has_env=True, balanced=False,
                           textured=False) -> dict:
    """As :func:`kernel_info`, of the tail kernel's instantiation for
    these flags."""
    flags = (int(has_lights) | int(has_env) << 1 | int(balanced) << 2
             | int(textured) << 3)
    return _attributes("accumulate", flags)


# ---- the interaction fill after a closest hit -----------------------------

def fill_inputs(hit, ray_d: V3, ray_o: V3, rows: torch.Tensor) -> list:
    """What :func:`fill_interaction` hands its kernel, checked: the hit's
    triangle (int32) and barycentrics, the ray's origin and direction
    components (float32, [R] each), the [T, 26] float32 interaction
    table, in the order of csrc/shade.cu's ``pnrt_interaction``.  Raises
    where one has another dtype, shape or device, or is not
    contiguous."""
    dev = hit.tri.device
    r = int(hit.tri.shape[0])
    f32 = torch.float32
    inputs = [("hit.tri", hit.tri, torch.int32, (r,)),
              ("hit.b1", hit.b1, f32, (r,)), ("hit.b2", hit.b2, f32, (r,)),
              *((f"ray_o.{k}", getattr(ray_o, k), f32, (r,)) for k in "xyz"),
              *((f"ray_d.{k}", getattr(ray_d, k), f32, (r,)) for k in "xyz"),
              ("rows", rows, f32, (rows.shape[0], 26))]
    for name, t, dtype, shape in inputs:
        _check(name, t, dtype, shape, dev, kernel="interaction")
    return [t for _, t, _, _ in inputs]


def fill_interaction(hit, ray_d: V3, ray_o: V3, rows: torch.Tensor):
    """The kernel: ``render/integrator.py::make_interaction``'s
    ``(pos V3, nrm V3, (u, v), mat_id, tex_id)`` in one launch, every
    lane bit for bit (missed lanes read row 0, as there).  ``rows`` is
    the interaction table (``pack_interaction_rows``); every input lies
    on one CUDA device, contiguous (:func:`fill_inputs`).  Raises on
    anything else, and if the launch fails."""
    from pnraytracing_tpu_torch.cuda_build import library

    dev = hit.tri.device
    if dev.type != "cuda":
        raise ValueError(f"interaction: the kernel runs on a CUDA device, "
                         f"not {dev}; the CPU takes make_interaction")
    inputs = fill_inputs(hit, ray_d, ray_o, rows)
    r = int(hit.tri.shape[0])
    out = torch.empty((8, r), dtype=torch.float32, device=dev)
    ids = torch.empty((2, r), dtype=torch.int32, device=dev)
    err = library("shade").pnrt_interaction(
        r, float(FLOAT_MAX), *map(_ptr, inputs), _ptr(out), _ptr(ids),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"interaction kernel launch failed: CUDA error "
                           f"{err}")
    launched(LAUNCHES, "interaction")
    rows_ = out.unbind(0)
    return (V3(*rows_[0:3]), V3(*rows_[3:6]), (rows_[6], rows_[7]), ids[0],
            ids[1])


def interaction_kernel_info() -> dict:
    """As :func:`kernel_info`, of the fill kernel."""
    return _attributes("interaction", 0)
