"""The shade phase of a bounce and its tail (``ops/shade.py``) on the
CPU: the plain versions against the integrator's torch code as it stood
before it moved there, the integrator's choice between the kernels and
the plain versions, and the wiring of the kernels' path, run through the
plain versions.  The kernels themselves run on the card only
(``tests/test_torch_shade_card.py``, ``tests/test_torch_accumulate_card.py``).

* ``shade_plain`` returns, output by output and bit for bit, what the
  integrator computed in its shade phase before the move (the code kept
  below as ``_phase1_before_move``), at every bounce of a 32x32 depth-4
  frame of ``scenes.teapot_scene`` with a lamp and a sky, under each
  sampler and MIS mode.
* ``shade_on_card`` picks the plain version on the CPU and under
  autograd with a scene tensor that requires grad; it picks the kernel
  otherwise for a CUDA device handed in (environment maps without alias
  rows included; it reads no configuration), without touching CUDA.
* With the kernel's branch forced and the launch replaced by the plain
  version, the integrator hands the kernel the same state and gets the
  same image (a textured scene too: the overridden base colors as its
  ``cdlin``; compat frames: the decoded material table; maps without
  fat rows or without alias tables, and one built in the graph: every
  table contiguous); ``material_rows`` holds the sanitized table's
  columns in the kernel's order, and ``env_mode`` names the draw
  ``sample_envmap_v`` makes.
* The wrapper raises on CPU tensors, before it loads any library.
* The tail: ``accumulate_plain`` returns, bit for bit, what the
  integrator's NEE combine and accumulate phase computed before the move
  (``_tail_before_move``), every bounce, under each MIS mode, Russian
  roulette with ``max_radiance``, one class of NEE light only, texture
  LOD, and in a replay (its deferred escaped terms too).  The integrator
  takes the tail kernel exactly where it takes the shade kernel and the
  frame is no replay: never on the CPU or under autograd, not in a
  replay; the kernel's branch hands it a state ``tail_inputs`` accepts
  (every tensor the kernel reads, of its dtype, shape and device,
  contiguous), and its wrapper raises on CPU tensors.
* The interaction fill: off route ``attr`` the integrator takes the fill
  kernel (``fill_interaction``) exactly where it takes the shade kernel,
  in the camera and ``next`` phases; ``make_interaction`` on the CPU,
  under autograd and in ``render_rays_replay``; on route ``attr``
  neither is reached from a walk (the attribute kernel fills).  The
  kernel's branch hands it a hit, rays and table ``fill_inputs``
  accepts, and its wrapper raises on CPU tensors.
"""

import dataclasses

import pytest
import torch

from pnraytracing_tpu_torch.accel.walks import route_walks
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.math import absolute, clip, maximum, minimum
from pnraytracing_tpu_torch.core.types import Lights
from pnraytracing_tpu_torch.core.vec import V3, build_tangent_space_v, vdot
from pnraytracing_tpu_torch.core.vec import vnormalize, vwhere
from pnraytracing_tpu_torch.io.hdr import procedural_sky
from pnraytracing_tpu_torch.ops import shade
from pnraytracing_tpu_torch.ops.brdf import (
    apply_compat_material_decode,
    disney_eval_v,
    disney_pdf_v,
    disney_sample_v,
)
from pnraytracing_tpu_torch.ops.envmap import (
    envmap_in_graph,
    envmap_lookup_v,
    envmap_pdf_v,
    sample_envmap_v,
)
from pnraytracing_tpu_torch.ops.sampling import (
    SOBOL_DIMS,
    cranley_patterson_rotation_c,
    pick_light,
    rand01,
    sobol_vec2,
    u32_to_unit,
    wang_hash,
)
from pnraytracing_tpu_torch.render import integrator
from pnraytracing_tpu_torch.render.renderer import pixel_coords, render_frame
from pnraytracing_tpu_torch.scene import scenes, shapes
from pnraytracing_tpu_torch.scene.transform import compose, rotate, translate
from tests.test_torch_scene import _torch_threads  # noqa: F401

SIZE, DEPTH, FRAME = 32, 4, 9
_make_interaction = integrator.make_interaction  # unpatched


@pytest.fixture(scope="module")
def lit_teapot():
    """``scenes.teapot_scene`` with a lamp and a sky, on the CPU."""
    b, cam = scenes.teapot_scene()
    b.add(shapes.quad(half=1.0), dict(emissive=(30.0, 28.0, 24.0)),
          name="lamp",
          transform=compose(translate(-2.5, 5, 0), rotate(180, (0, 0, 1))))
    scene = b.build(env_image=procedural_sky(16, 32), device="cpu")
    return scene, cam.basis(device="cpu")


def _phase1_before_move(scene, mat_tbl, irows, cfg, bounce, frame, active,
                        pos, nrm, v_dir, mat_id, seed, px_l, py_l,
                        texture=None):
    """The shade phase of ``render/integrator.py::_render_rays`` as it was
    written before it moved to ``ops/shade.py`` (its textures aside)."""
    materials, lights = scene.materials, scene.lights
    has_env, has_lights = scene.env is not None, lights.count > 0
    compat = cfg.compat_pnrt
    sdir = raw_pdf = l_direct_pre = en_l = env_pdf_raw = l_env_pre = None
    p_b_light = p_b_env = None
    mat, cdlin, _ = mat_tbl.gather_components(mat_id)
    t_tan, b_tan = build_tangent_space_v(nrm)
    seed, u_light = rand01(seed)
    if has_lights:
        slot = pick_light(lights.prefix_area, lights.total_area, u_light)
        light_tri = lights.tri_index[slot.long()]
        seed, u1 = rand01(seed)
        seed, u2 = rand01(seed)
        lp, ln = shade.sample_light_point(light_tri, u1, u2, irows)
        sdir = lp - pos
        dis2 = vdot(sdir, sdir)
        lnorm = vnormalize(sdir)
        cos_l = absolute(vdot(ln, -lnorm))
        raw_pdf = dis2 / maximum(cos_l * lights.total_area, 1e-12)
        lmat = irows[lights.tri_index.long(), 24].to(torch.int32)[
            slot.long()]
        li = V3.of(materials.emissive[lmat])
        light_f = disney_eval_v(v_dir, nrm, lnorm, t_tan, b_tan, mat, cdlin)
        nl = absolute(vdot(nrm, lnorm))
        l_direct_pre = light_f * li * (nl * shade.safe_inv(raw_pdf))
    if has_env:
        seed, r1e = rand01(seed)
        seed, r2e = rand01(seed)
        en_l, en_li, env_pdf_raw = sample_envmap_v(scene.env, r1e, r2e,
                                                   compat)
        env_f = disney_eval_v(v_dir, nrm, en_l, t_tan, b_tan, mat, cdlin)
        l_env_pre = env_f * en_li * (vdot(en_l, nrm)
                                     * shade.safe_inv(env_pdf_raw))
    if cfg.sampler == "sobol":
        su, sv = sobol_vec2(frame + 1, bounce)
        r1, r2 = cranley_patterson_rotation_c(
            su, sv, px_l, py_l, cfg.width, cfg.height,
            salt=(2 * bounce) // SOBOL_DIMS)
    else:
        seed, r1 = rand01(seed)
        seed, r2 = rand01(seed)
    seed, r_lobe = rand01(seed)
    s1 = wang_hash(seed)
    s2 = wang_hash(s1)
    l_out, d_pdf, lobe = disney_sample_v(
        v_dir, nrm, t_tan, b_tan, mat, r_lobe, r1, r2, u32_to_unit(s1),
        u32_to_unit(s2), compat)
    seed = torch.where(lobe == 0, s2, seed)
    d_f = disney_eval_v(v_dir, nrm, l_out, t_tan, b_tan, mat, cdlin)
    weight = d_f * (absolute(vdot(nrm, l_out)) * shade.safe_inv(d_pdf))
    if cfg.mis == "balanced":
        if has_lights:
            p_b_light = maximum(disney_pdf_v(v_dir, nrm, lnorm, mat), 0.0)
        if has_env:
            p_b_env = maximum(disney_pdf_v(v_dir, nrm, en_l, mat), 0.0)
    return (seed, l_out, weight, d_pdf, sdir, raw_pdf, l_direct_pre, en_l,
            env_pdf_raw, l_env_pre, p_b_light, p_b_env)


def _flat(x):
    return [x.x, x.y, x.z] if isinstance(x, V3) else [x]


def _assert_same(got, want, label):
    for name, g, w in zip(shade.OUTPUTS, got, want):
        assert (g is None) == (w is None), (label, name)
        if g is None:
            continue
        for gc, wc in zip(_flat(g), _flat(w)):
            assert gc.dtype == wc.dtype and torch.equal(gc, wc), (label,
                                                                  name)


@pytest.mark.parametrize("changes", [
    {}, dict(mis="balanced"), dict(sampler="hash"),
    dict(compat_pnrt=True)], ids=["reference", "balanced", "hash", "compat"])
def test_plain_version_is_the_integrators_code(lit_teapot, monkeypatch,
                                               changes):
    scene, cam = lit_teapot
    cfg = RenderConfig(width=SIZE, height=SIZE, max_depth=DEPTH, **changes)
    calls = []
    real = shade.shade_plain

    def both(*args, **kw):
        got = real(*args, **kw)
        calls.append(args[4])
        _assert_same(got, _phase1_before_move(*args, **kw),
                     f"bounce {args[4]}")
        return got

    monkeypatch.setattr(integrator, "shade_plain", both)
    img = render_frame(scene, cam, cfg, FRAME, device="cpu")
    assert calls == list(range(DEPTH))
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01


def _with_grad(scene):
    mats = scene.materials
    return dataclasses.replace(scene, materials=dataclasses.replace(
        mats, roughness=mats.roughness.clone().requires_grad_()))


def _no_alias(scene, fat_only=False):
    """The scene with its map's fat alias rows dropped (as
    ``diff/grad.py::apply_params`` drops them), or every alias table."""
    drop = dict(alias_fat=None) if fat_only else dict(
        alias_x=None, alias_y=None, alias_fat=None)
    return dataclasses.replace(scene, env=dataclasses.replace(scene.env,
                                                              **drop))


def _no_env(scene):
    """The scene without its map: a constant environment."""
    return dataclasses.replace(scene, env=None,
                               env_constant=torch.tensor([0.3, 0.4, 0.5]))


def _no_quads(scene):
    """The scene's map without its quad rows (the lookup reads the
    image)."""
    return dataclasses.replace(scene, env=dataclasses.replace(
        scene.env, quad12=None))


def _no_lights(scene):
    return dataclasses.replace(scene, lights=Lights(
        tri_index=torch.zeros(0, dtype=torch.int32),
        prefix_area=torch.zeros(0), total_area=torch.zeros(())))


def _marry():
    """The textured config 4 stand-in, on the CPU."""
    scene, cam = scenes.config4_marry(device="cpu")
    return scene, cam.basis(device="cpu")


def _in_graph(scene):
    """The scene with its map's tables built in the graph
    (``ops/envmap.py::envmap_in_graph``: no alias tables, and transposed,
    non-contiguous CDFs)."""
    return dataclasses.replace(scene, env=envmap_in_graph(scene.env.image))


def test_env_mode_names_the_draw(lit_teapot):
    scene, _ = lit_teapot
    env = scene.env
    assert shade.env_mode(env, False) == shade.ENV_FAT
    assert shade.env_mode(_no_alias(scene, fat_only=True).env,
                          False) == shade.ENV_ALIAS
    assert shade.env_mode(_no_alias(scene).env, False) == shade.ENV_CDF
    assert shade.env_mode(env, True) == shade.ENV_CDF  # compat: the CDFs
    assert shade.contiguous_env(None) is None
    same = shade.contiguous_env(env)  # a baked map: the same tensors
    for f in dataclasses.fields(env):
        assert getattr(same, f.name) is getattr(env, f.name), f.name
    built = _in_graph(scene).env
    assert not built.pdf_xy.is_contiguous()
    made = shade.contiguous_env(built)
    for f in dataclasses.fields(env):
        t = getattr(made, f.name)
        if t is not None:
            assert t.is_contiguous() and torch.equal(
                t, getattr(built, f.name)), f.name


def test_dispatch_picks_the_plain_version(lit_teapot):
    scene, _ = lit_teapot
    cuda = torch.device("cuda")
    assert not shade.shade_on_card(scene, torch.device("cpu"))
    assert not shade.shade_on_card(scene, "cpu")
    assert not shade.shade_on_card(_no_alias(scene), "cpu")
    assert not shade.shade_on_card(_with_grad(scene), cuda)
    assert not shade.shade_on_card(_with_grad(_no_alias(scene)), cuda)
    ray = torch.zeros(4, 3, requires_grad=True)
    assert not shade.shade_on_card(scene, cuda, ray)


def test_dispatch_picks_the_kernel(lit_teapot):
    """Every form the kernel takes (the configuration is not read, so
    compat frames and every sampler and MIS mode take it too): any map,
    none, and a scene that requires grad under no_grad."""
    scene, _ = lit_teapot
    cuda = torch.device("cuda")
    assert shade.shade_on_card(scene, cuda)
    assert shade.shade_on_card(scene, "cuda:0")
    assert shade.shade_on_card(dataclasses.replace(scene, env=None), cuda)
    assert shade.shade_on_card(_no_alias(scene), cuda)
    assert shade.shade_on_card(_no_alias(scene, fat_only=True), cuda)
    assert shade.shade_on_card(_in_graph(scene), cuda)
    with torch.no_grad():  # autograd records nothing under no_grad
        assert shade.shade_on_card(_with_grad(scene), cuda)
    assert not torch.cuda.is_initialized()


def test_material_rows_columns(lit_teapot):
    scene, _ = lit_teapot
    tbl = scene.materials.sanitized()
    rows = shade.material_rows(tbl, scene.materials)
    m = tbl.base_color.shape[0]
    assert rows.shape == (m, shade.MATERIAL_COLUMNS) and rows.is_contiguous()
    for k, name in enumerate(shade._SCALARS):
        assert torch.equal(rows[:, k], getattr(tbl, name)), name
    assert torch.equal(rows[:, 12:15], tbl.base_color)
    assert torch.equal(rows[:, 15:18], scene.materials.emissive)


def _kernel_branch_through_plain(monkeypatch, seen, tails=None,
                                 on_card=lambda *a: True, fills=None):
    """Force the kernels' branch (or decide it by ``on_card``) and stand
    the plain versions in for the launches, checking what the integrator
    hands the kernels (the tail's bounces noted in ``tails``, the fill's
    calls in ``fills``)."""
    def fake(scene, mat_rows, irows, cfg, bounce, frame, active, pos, nrm,
             v_dir, mat_id, seed, px, py, cdlin=None):
        tbl = scene.materials.sanitized()
        if cfg.compat_pnrt:
            tbl = apply_compat_material_decode(tbl)
        assert torch.equal(mat_rows, shade.material_rows(tbl,
                                                         scene.materials))
        if scene.env is not None:
            for f in dataclasses.fields(scene.env):
                t = getattr(scene.env, f.name)
                assert t is None or t.is_contiguous(), f.name
        for t in (px, py, seed):
            assert t.dtype == torch.int64 and t.is_contiguous()
        assert mat_id.dtype == torch.int32 and active.dtype == torch.bool
        seen.append((bounce, cdlin is not None))
        return shade.shade_plain(
            scene, tbl, irows, cfg, bounce, frame, active, pos, nrm, v_dir,
            mat_id, seed, px, py,
            texture=None if cdlin is None else (lambda _: cdlin))

    def fake_tail(scene, mat_rows, cfg, bounce, env_const, *rest):
        tbl = scene.materials.sanitized()
        if cfg.compat_pnrt:
            tbl = apply_compat_material_decode(tbl)
        assert torch.equal(mat_rows, shade.material_rows(tbl,
                                                         scene.materials))
        shade.tail_inputs(scene, mat_rows, cfg, bounce, env_const, *rest)
        if tails is not None:
            tails.append(bounce)
        return shade.accumulate_plain(scene, cfg, bounce, env_const, *rest)

    def fake_fill(hit, ray_d, ray_o, rows):
        shade.fill_inputs(hit, ray_d, ray_o, rows)
        if fills is not None:
            fills.append(int(hit.tri.shape[0]))
        return _make_interaction(hit, ray_d, ray_o, rows)

    monkeypatch.setattr(integrator, "shade_on_card", on_card)
    monkeypatch.setattr(integrator, "fill_interaction", fake_fill)
    monkeypatch.setattr(integrator, "shade_bounce", fake)
    monkeypatch.setattr(integrator, "accumulate_bounce", fake_tail)


@pytest.mark.parametrize("which", ["lit_teapot", "textured", "compat",
                                   "alias_tables", "cdf", "in_graph",
                                   "rr_max_radiance", "no_env", "no_quad12",
                                   "textured_lod"])
def test_kernel_branch_hands_over_the_state(lit_teapot, monkeypatch, which):
    if which == "textured":
        scene = scenes.config1_triangle(device="cpu")
        scene, cam = scene if isinstance(scene, tuple) else (scene, None)
        cam = cam.basis(device="cpu")
        cfg = RenderConfig(width=16, height=16, max_depth=2)
    elif which == "textured_lod":
        scene, cam = _marry()
        cfg = RenderConfig(width=16, height=16, max_depth=3,
                           texture_lod_scale=0.01, mis="balanced",
                           rr_start=1)
    else:
        scene, cam = lit_teapot
        cfg = RenderConfig(width=SIZE, height=SIZE, max_depth=DEPTH,
                           mis="balanced")
        if which == "compat":
            cfg = dataclasses.replace(cfg, compat_pnrt=True, mis="reference")
        if which == "rr_max_radiance":
            cfg = dataclasses.replace(cfg, rr_start=1, max_radiance=0.5)
        edit = dict(alias_tables=lambda s: _no_alias(s, fat_only=True),
                    cdf=_no_alias, in_graph=_in_graph, no_env=_no_env,
                    no_quad12=_no_quads).get(which)
        scene = edit(scene) if edit else scene
    want = render_frame(scene, cam, cfg, FRAME, device="cpu")
    seen, tails = [], []
    _kernel_branch_through_plain(monkeypatch, seen, tails)
    got = render_frame(scene, cam, cfg, FRAME, device="cpu")
    textured = which.startswith("textured")
    assert seen == [(b, textured) for b in range(cfg.max_depth)]
    assert tails == list(range(cfg.max_depth))
    assert torch.equal(got, want)


def test_wrapper_raises_on_cpu_tensors(lit_teapot, monkeypatch):
    """No fallback inside the wrapper: CPU tensors raise before any
    library is loaded or any launch counted."""
    from pnraytracing_tpu_torch import cuda_build

    scene, _ = lit_teapot
    cfg = RenderConfig(width=4, height=1)
    r = 4
    f = lambda: torch.zeros(r)
    v = V3(f(), f(), f())
    i64 = torch.zeros(r, dtype=torch.int64)

    def no_library(name):
        raise AssertionError(f"library {name!r} loaded")

    monkeypatch.setattr(cuda_build, "library", no_library)
    before = dict(shade.LAUNCHES)
    tbl = scene.materials.sanitized()
    with pytest.raises(ValueError, match="CUDA device"):
        shade.shade_bounce(
            scene, shade.material_rows(tbl, scene.materials),
            integrator.pack_interaction_rows(scene.mesh), cfg, 0, 0,
            torch.ones(r, dtype=torch.bool), v, v, v,
            torch.zeros(r, dtype=torch.int32), i64, i64, i64)
    assert shade.LAUNCHES == before


# ---- the tail of a bounce ---------------------------------------------------

def _tail_before_move(scene, cfg, bounce, env_const, path, l_out, weight,
                      d_pdf, nee, cont, deferred=None):
    """The NEE combine (the end of the shadow phase) and the accumulate
    phase of ``render/integrator.py::_render_rays`` as they were written
    before they moved to ``ops/shade.py``, over the same state."""
    _EPS = 1e-10
    materials, lights = scene.materials, scene.lights
    has_env, has_lights = scene.env is not None, lights.count > 0
    has_tex = scene.textures is not None
    lod_on = has_tex and cfg.texture_lod_scale is not None
    replay = deferred is not None
    env_terms = deferred
    (lo, c, _, pos, nrm, mat_id, u_uv, v_uv, tex_id, path_t, active,
     seed) = path
    hit2, pos2, nrm2, (u_uv2, v_uv2), mat_id2, tex_id2 = cont
    occluded, e_occ, facing = nee.occluded, nee.e_occ, nee.facing
    zero_r = torch.zeros(d_pdf.shape[0], dtype=torch.float32)
    zero_v = V3(zero_r, zero_r, zero_r)

    def env_radiance(dirs):
        if has_env:
            return envmap_lookup_v(scene.env, dirs)
        ones = torch.ones_like(dirs.x)
        ec = env_const * cfg.env_scale
        return V3(ec[0] * ones, ec[1] * ones, ec[2] * ones)

    def clamp_contrib(x):
        if cfg.max_radiance is not None:
            return x.map(lambda a: minimum(a, cfg.max_radiance))
        return x

    light_pdf, l_direct = zero_r, zero_v
    env_pdf, l_env = zero_r, zero_v
    if has_lights:
        lit = active & ~occluded
        light_pdf = torch.where(lit, nee.raw_pdf, 0.0)
        l_direct = vwhere(lit, nee.l_direct_pre, zero_v)
    if has_env:
        env_pdf = torch.where(active, nee.env_pdf_raw, 0.0)
        l_env = vwhere(active & facing & ~e_occ, nee.l_env_pre, zero_v)
    if cfg.mis == "reference":
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
    lo = lo + clamp_contrib(vwhere(active, c * nee_v, zero_v))

    miss_now = active & ~hit2.valid
    if cfg.mis == "balanced" and has_env:
        p_e_out = envmap_pdf_v(scene.env, l_out)
        w_b_env = d_pdf / maximum(d_pdf + p_e_out, _EPS)
    else:
        w_b_env = 1.0
    if replay and has_env:
        env_terms.append((l_out, vwhere(miss_now, c * weight * w_b_env,
                                        zero_v)))
    else:
        lo = lo + clamp_contrib(vwhere(
            miss_now, c * env_radiance(l_out) * weight * w_b_env, zero_v))
    hit_now = active & hit2.valid
    emissive2 = shade.emissive_of(materials, mat_id2)
    if cfg.mis == "balanced" and has_lights:
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
    if cfg.rr_start is not None and bounce >= cfg.rr_start:
        seed, u_rr = rand01(seed)
        p_survive = clip(c.max_component(), 0.05, 0.95)
        survive = u_rr < p_survive
        c = vwhere(active & survive, c / p_survive, c)
        active = active & survive
    return (lo, c, v_dir, pos, nrm, mat_id, u_uv, v_uv, tex_id, path_t,
            active, seed)


def _assert_same_path(got, want, label):
    for name, g, w in zip(shade.Path._fields, got, want):
        assert (g is None) == (w is None), (label, name)
        if g is None:
            continue
        for gc, wc in zip(_flat(g), _flat(w)):
            assert gc.dtype == wc.dtype and torch.equal(gc, wc), (label,
                                                                  name)


TAIL_CASES = {
    "reference": (None, {}),
    "balanced": (None, dict(mis="balanced")),
    "rr_max_radiance": (None, dict(rr_start=1, max_radiance=0.5)),
    "env_only": (_no_lights, dict(mis="balanced")),
    "lights_only": (_no_env, dict(mis="balanced", env_scale=1.5)),
    "textured_lod": ("marry", dict(texture_lod_scale=0.01, mis="balanced",
                                   rr_start=1)),
    "replay": (None, dict(mis="balanced", kernel_interaction=False)),
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_plain_version_is_the_integrators_code(lit_teapot, monkeypatch,
                                                    case):
    edit, changes = TAIL_CASES[case]
    if edit == "marry":
        scene, cam = _marry()
    else:
        scene, cam = lit_teapot
        scene = edit(scene) if edit else scene
    cfg = RenderConfig(width=SIZE, height=SIZE, max_depth=DEPTH, **changes)
    calls = []
    real = shade.accumulate_plain

    def both(*args, deferred=None):
        before = None if deferred is None else []
        got = real(*args, deferred=deferred)
        want = _tail_before_move(*args, deferred=before)
        calls.append(args[2])
        _assert_same_path(got, want, f"bounce {args[2]}")
        if deferred is not None:
            (d_got, c_got), (d_want, c_want) = deferred[-1], before[-1]
            assert d_got is d_want
            for gc, wc in zip(_flat(c_got), _flat(c_want)):
                assert torch.equal(gc, wc)
        return got

    monkeypatch.setattr(integrator, "accumulate_plain", both)
    if case == "replay":
        px, py = pixel_coords(cfg, "cpu")
        o, d, _ = _camera_rays(cam, cfg)
        recs = integrator.trace_paths(scene, o, d, px, py, FRAME, cfg)
        calls.clear()
        img = integrator.render_rays_replay(scene, o, d, px, py, FRAME, cfg,
                                            recs)
    else:
        img = render_frame(scene, cam, cfg, FRAME, device="cpu")
    assert calls == list(range(DEPTH))
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01


def _camera_rays(cam, cfg):
    from pnraytracing_tpu_torch.core.camera import camera_rays

    return camera_rays(cam, cfg.width, cfg.height)


def _pretend_card(monkeypatch):
    """The integrator's dispatch rule as on a CUDA device (the rays stay on
    the CPU); returns the kernels' calls, each through its plain
    version."""
    kernels = []
    _kernel_branch_through_plain(
        monkeypatch, [], kernels,
        on_card=lambda scene, dev, *t: shade.shade_on_card(scene, "cuda", *t))
    return kernels


@pytest.mark.parametrize("where", ["cpu", "autograd", "replay", "card"])
def test_tail_dispatch(lit_teapot, monkeypatch, where):
    """The tail kernel is taken exactly where the shade kernel is and the
    frame is no replay: never on the CPU, under autograd through the
    scene, or in a replay."""
    scene, cam = lit_teapot
    cfg = RenderConfig(width=16, height=16, max_depth=DEPTH)
    plain = []
    real = shade.accumulate_plain

    def counted(*args, **kw):
        plain.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(integrator, "accumulate_plain", counted)
    kernels = [] if where == "cpu" else _pretend_card(monkeypatch)
    if where == "replay":
        px, py = pixel_coords(cfg, "cpu")
        o, d, _ = _camera_rays(cam, cfg)
        recs = integrator.trace_paths(scene, o, d, px, py, FRAME, cfg)
        assert kernels == list(range(DEPTH)) and not plain  # the trace
        kernels.clear()
        integrator.render_rays_replay(scene, o, d, px, py, FRAME, cfg, recs)
    elif where == "autograd":
        assert torch.is_grad_enabled()
        img = render_frame(_with_grad(scene), cam, cfg, FRAME, device="cpu")
        assert img.requires_grad
    else:
        render_frame(scene, cam, cfg, FRAME, device="cpu")
    on_card = where == "card"
    assert kernels == (list(range(DEPTH)) if on_card else [])
    assert plain == ([] if on_card else list(range(DEPTH)))


def test_tail_wrapper_raises_on_cpu_tensors(lit_teapot, monkeypatch):
    """No fallback inside the wrapper: CPU tensors raise before any
    library is loaded or any launch counted; ``tail_inputs`` names a
    tensor of the wrong dtype."""
    from pnraytracing_tpu_torch import cuda_build
    from pnraytracing_tpu_torch.ops.intersect import Hit

    scene, _ = lit_teapot
    cfg = RenderConfig(width=4, height=1)
    r = 4
    f = lambda: torch.zeros(r)
    v = V3(f(), f(), f())
    i32 = torch.zeros(r, dtype=torch.int32)
    flag = torch.zeros(r, dtype=torch.bool)
    path = shade.Path(v, v, v, v, v, i32, f(), f(), i32, None, flag,
                      torch.zeros(r, dtype=torch.int64))
    nee = shade.Nee(flag, f(), v, flag, flag, f(), v, None, None)
    cont = (Hit(i32, f(), f(), f()), v, v, (f(), f()), i32, i32)
    tbl = scene.materials.sanitized()
    rows = shade.material_rows(tbl, scene.materials)
    args = (scene, rows, cfg, 0, torch.zeros(3), path, v, v, f(), nee, cont)

    def no_library(name):
        raise AssertionError(f"library {name!r} loaded")

    monkeypatch.setattr(cuda_build, "library", no_library)
    before = dict(shade.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        shade.accumulate_bounce(*args)
    assert shade.LAUNCHES == before
    assert len(shade.tail_inputs(*args)) > 0  # a CPU state passes the checks
    bad = path._replace(mat_id=torch.zeros(r, dtype=torch.int64))
    with pytest.raises(ValueError, match="accumulate: mat_id must be"):
        shade.tail_inputs(*args[:5], bad, *args[6:])


# ---- the interaction fill ---------------------------------------------------

def _count_plain_fills(monkeypatch):
    """The calls of ``make_interaction`` (the plain fill), as the number
    of rays of each."""
    plain = []

    def counted(hit, *rest):
        plain.append(int(hit.tri.shape[0]))
        return _make_interaction(hit, *rest)

    monkeypatch.setattr(integrator, "make_interaction", counted)
    return plain


@pytest.mark.parametrize("where", ["cpu", "autograd", "replay", "card"])
def test_fill_dispatch(lit_teapot, monkeypatch, where):
    """Off route ``attr`` the fill kernel is taken exactly where the
    shade kernel is, once in the camera phase and once a bounce; the
    plain version on the CPU, under autograd through the scene, and in
    a replay (the trace before it takes the kernel)."""
    scene, cam = lit_teapot
    cfg = RenderConfig(width=16, height=16, max_depth=DEPTH,
                       kernel_interaction=False)
    assert route_walks(scene, cfg)[0] == "wide"
    r = cfg.width * cfg.height
    want = render_frame(scene, cam, cfg, FRAME, device="cpu")
    plain = _count_plain_fills(monkeypatch)
    fills = []
    if where != "cpu":
        _kernel_branch_through_plain(
            monkeypatch, [], fills=fills,
            on_card=lambda scene, dev, *t: shade.shade_on_card(
                scene, "cuda", *t))
    if where == "replay":
        px, py = pixel_coords(cfg, "cpu")
        o, d, _ = _camera_rays(cam, cfg)
        recs = integrator.trace_paths(scene, o, d, px, py, FRAME, cfg)
        assert fills == [r] * (1 + DEPTH) and not plain  # the trace
        fills.clear()
        integrator.render_rays_replay(scene, o, d, px, py, FRAME, cfg, recs)
    elif where == "autograd":
        assert torch.is_grad_enabled()
        img = render_frame(_with_grad(scene), cam, cfg, FRAME, device="cpu")
        assert img.requires_grad
    else:
        img = render_frame(scene, cam, cfg, FRAME, device="cpu")
        assert torch.equal(img, want)
    on_card = where == "card"
    assert fills == ([r] * (1 + DEPTH) if on_card else [])
    assert plain == ([] if on_card else [r] * (1 + DEPTH))


def test_attr_route_reaches_no_fill(lit_teapot, monkeypatch):
    """On route ``attr`` the attribute kernel fills the interaction: the
    walks reach neither the fill kernel nor ``make_interaction``, on the
    card's branch and off it."""
    scene, cam = lit_teapot
    cfg = RenderConfig(width=16, height=16, max_depth=DEPTH)
    assert route_walks(scene, cfg)[0] == "attr"
    plain = _count_plain_fills(monkeypatch)
    want = render_frame(scene, cam, cfg, FRAME, device="cpu")
    fills = []
    _kernel_branch_through_plain(monkeypatch, [], fills=fills)
    got = render_frame(scene, cam, cfg, FRAME, device="cpu")
    assert not fills and not plain
    assert torch.equal(got, want)


def test_fill_wrapper_raises_on_cpu_tensors(lit_teapot, monkeypatch):
    """No fallback inside the wrapper: CPU tensors raise before any
    library is loaded or any launch counted; ``fill_inputs`` names a
    tensor of the wrong dtype or shape, or one not contiguous."""
    from pnraytracing_tpu_torch import cuda_build
    from pnraytracing_tpu_torch.ops.intersect import Hit

    scene, _ = lit_teapot
    r = 4
    f = lambda: torch.zeros(r)
    v = V3(f(), f(), f())
    hit = Hit(torch.zeros(r, dtype=torch.int32), f(), f(), f())
    rows = integrator.pack_interaction_rows(scene.mesh)

    def no_library(name):
        raise AssertionError(f"library {name!r} loaded")

    monkeypatch.setattr(cuda_build, "library", no_library)
    before = dict(shade.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        shade.fill_interaction(hit, v, v, rows)
    assert shade.LAUNCHES == before
    assert len(shade.fill_inputs(hit, v, v, rows)) == 10
    with pytest.raises(ValueError, match="interaction: hit.tri must be"):
        shade.fill_inputs(dataclasses.replace(
            hit, tri=torch.zeros(r, dtype=torch.int64)), v, v, rows)
    with pytest.raises(ValueError, match="interaction: ray_d.y must be"):
        shade.fill_inputs(hit, V3(f(), torch.zeros(r + 1), f()), v, rows)
    with pytest.raises(ValueError, match="interaction: rows must be"):
        shade.fill_inputs(hit, v, v, rows[:, :25])
    with pytest.raises(ValueError, match="interaction: hit.b1 must be"):
        shade.fill_inputs(dataclasses.replace(
            hit, b1=torch.zeros(r, 2)[:, 0]), v, v, rows)
