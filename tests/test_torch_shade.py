"""The shade phase of a bounce (``ops/shade.py``) on the CPU: the plain
version against the integrator's torch code as it stood before it moved
there, the integrator's choice between the kernel and the plain version,
and the wiring of the kernel's path, run through the plain version.  The
kernel itself runs on the card only (``tests/test_torch_shade_card.py``).

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
"""

import dataclasses

import pytest
import torch

from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.math import absolute, maximum
from pnraytracing_tpu_torch.core.vec import V3, build_tangent_space_v, vdot
from pnraytracing_tpu_torch.core.vec import vnormalize
from pnraytracing_tpu_torch.io.hdr import procedural_sky
from pnraytracing_tpu_torch.ops import shade
from pnraytracing_tpu_torch.ops.brdf import (
    apply_compat_material_decode,
    disney_eval_v,
    disney_pdf_v,
    disney_sample_v,
)
from pnraytracing_tpu_torch.ops.envmap import envmap_in_graph, sample_envmap_v
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
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.scene import scenes, shapes
from pnraytracing_tpu_torch.scene.transform import compose, rotate, translate
from tests.test_torch_scene import _torch_threads  # noqa: F401

SIZE, DEPTH, FRAME = 32, 4, 9


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


def _kernel_branch_through_plain(monkeypatch, seen):
    """Force the kernel's branch and stand the plain version in for the
    launch, checking what the integrator hands the kernel."""
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

    monkeypatch.setattr(integrator, "shade_on_card", lambda *a: True)
    monkeypatch.setattr(integrator, "shade_bounce", fake)


@pytest.mark.parametrize("which", ["lit_teapot", "textured", "compat",
                                   "alias_tables", "cdf", "in_graph"])
def test_kernel_branch_hands_over_the_state(lit_teapot, monkeypatch, which):
    if which == "textured":
        scene = scenes.config1_triangle(device="cpu")
        scene, cam = scene if isinstance(scene, tuple) else (scene, None)
        cam = cam.basis(device="cpu")
        cfg = RenderConfig(width=16, height=16, max_depth=2)
    else:
        scene, cam = lit_teapot
        cfg = RenderConfig(width=SIZE, height=SIZE, max_depth=DEPTH,
                           mis="balanced")
        if which == "compat":
            cfg = dataclasses.replace(cfg, compat_pnrt=True, mis="reference")
        edit = dict(alias_tables=lambda s: _no_alias(s, fat_only=True),
                    cdf=_no_alias, in_graph=_in_graph).get(which)
        scene = edit(scene) if edit else scene
    want = render_frame(scene, cam, cfg, FRAME, device="cpu")
    seen = []
    _kernel_branch_through_plain(monkeypatch, seen)
    got = render_frame(scene, cam, cfg, FRAME, device="cpu")
    textured = which == "textured"
    assert seen == [(b, textured) for b in range(cfg.max_depth)]
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
