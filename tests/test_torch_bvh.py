"""Scenes outside the packed layout: the port's walk over the plain BVH
(``accel/traverse.py``, whose CUDA kernel is ``csrc/traverse_bvh.cu``),
the array-form intersection tests and oracles (``ops/intersect.py``), the
``trav=None`` scene (``SceneBuilder.build(flat_bvh=True)``,
``config2_teapot(flat_bvh=True)``, ``convert.py``), routes ``"bvh"`` and
``"binary"`` of ``accel/route.py`` and ``probe_pixel``, on the CPU against
the JAX package.

Inputs are made with numpy from seeds; the scenes are the JAX package's
``tests/test_render.py::small_scene`` (cube, floor, light; 16 triangles)
in its SAH and flat forms.

Bounds.  The plain walk is held against the JAX package's XLA walk
(``pnraytracing_tpu/accel/traverse.py``, jitted on the CPU).  XLA
contracts the watertight test's products and sums into FMAs where the
port (and its kernel, built with ``--fmad=false``) rounds every
operation, so ``t`` moves:

* default form: triangle ids exact outside rim rays (``t`` beyond rtol
  1e-6, the rule of tests/test_torch_parallel.py::rim_pixels: a ray
  through a triangle's rim, or a grazing one; at most 2% of the rays,
  none on these), ``t`` within 2 ulp on at least 97% of the rays and
  within rtol 1e-6 on all others (measured on seeds 0-7: 1-6 of ~230
  hits beyond 2 ulp, the worst 13 ulp), occlusion exact.  Per-ray pops
  (``traversal_stats``) on all but 10% of the rays, their sum within 1%
  and the lockstep iteration count exactly (measured on seeds 0-7: 13-19
  of 256 rays differ by a pop or two, sums 0.1-0.4% apart): every face
  of this scene is axis-aligned, so a hit's ``t`` ties the entry of its
  leaf's box, and where a running best ``t`` moved by an ulp one package
  prunes a box that the other visits.  In the flat form, pops are exact;
* compat form: the sheared test without the axis permutation is ill
  conditioned and XLA's contraction moves ``t`` by up to 3.5e5 ulp
  (ROADMAP.md, faults: "compat frames depend on the arithmetic's
  contraction"), so triangle ids are held on all but 1% of the rays,
  occlusion and pops exactly (the compat slab test reads no ``t``), and
  ``t`` against the port's own brute-force oracle, bit for bit.

Frames: atol 3e-5 against the JAX frame (tests/test_golden.py), atol 2e-5
between the flat and the packed route
(tests/test_render.py::test_bvh_and_flat_oracle_agree).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.accel import traverse as jax_traverse
from pnraytracing_tpu.accel import traverse_pallas as jax_traverse_pallas
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.ops import intersect as jax_intersect
from pnraytracing_tpu.render.debug import probe_pixel as jax_probe_pixel
from pnraytracing_tpu.render.renderer import render_frame as jax_render_frame
from pnraytracing_tpu_torch.accel import route as port_route
from pnraytracing_tpu_torch.accel import traverse as bvh_walk
from pnraytracing_tpu_torch.accel import walks
from pnraytracing_tpu_torch.convert import scene_from_arrays, scene_to_arrays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.math import FLOAT_MAX
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops import intersect
from pnraytracing_tpu_torch.render import integrator
from pnraytracing_tpu_torch.render.debug import probe_pixel
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.scene.transform import compose, rotate, translate
from tests.test_render import small_scene
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import port_camera

T_ULPS = 2
R = 256
SIZE = dict(width=16, height=16, max_depth=2)


def _port_small_scene(flat_bvh):
    """``small_scene`` built by the port's own SceneBuilder."""
    b = SceneBuilder()
    b.add(shapes.cube(0.8), dict(base_color=(0.7, 0.3, 0.3), roughness=0.5),
          name="cube", transform=translate(0, 0.8, 0))
    b.add(shapes.quad(6.0), dict(base_color=(0.7, 0.7, 0.7), roughness=0.9),
          name="floor")
    b.add(shapes.quad(1.0), dict(emissive=(15.0, 15.0, 15.0)),
          name="light",
          transform=compose(translate(0, 5.0, 0), rotate(180, (0, 0, 1))))
    return b.build(flat_bvh=flat_bvh, env_constant=(0.2, 0.25, 0.3),
                   device="cpu")


_SCENES = {}


def scene_pair(form):
    """(JAX scene, port scene converted from it, camera) of
    ``small_scene`` in its 'sah' or 'flat' form, made once."""
    if form not in _SCENES:
        js, cam = small_scene(flat_bvh=form == "flat")
        _SCENES[form] = (js, scene_from_arrays(scene_to_arrays(js),
                                               device="cpu"), cam)
    return _SCENES[form]


def _rays(seed, n=R):
    """(o, d, t_max, mask) as numpy: origins above the floor aimed at the
    cube and the floor around it, a third with a short t_max."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 4, n)
    aim = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    aim[:, 1] = rng.uniform(0, 1.6, n)
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(n, FLOAT_MAX, np.float32)
    t_max[::3] = rng.uniform(0.5, 5, len(t_max[::3]))
    return o, d, t_max, rng.uniform(size=n) < 0.9


def _v3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                for k in range(3)))


def _ulps(a, b):
    """|a - b| in float32 ulps (as integer steps between the bit
    patterns; both non-negative here)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert (a >= 0).all() and (b >= 0).all()
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _assert_hits_match(got, want, compat=False):
    """The module docstring's bounds on a closest hit against the JAX
    one."""
    t, t_j = got.t.numpy(), np.asarray(want.t)
    tri, tri_j = got.tri.numpy(), np.asarray(want.tri)
    assert (tri >= 0).sum() > len(t) // 2  # most rays hit
    if compat:
        assert (tri != tri_j).sum() <= 0.01 * len(t)
        return
    rim = np.abs(t - t_j) > 1e-6 * np.abs(t_j)
    assert rim.sum() <= 0.02 * len(t)
    np.testing.assert_array_equal(tri[~rim], tri_j[~rim])
    assert (_ulps(t[~rim], t_j[~rim]) > T_ULPS).sum() <= 0.03 * len(t)
    for k in ("b1", "b2"):
        np.testing.assert_allclose(getattr(got, k).numpy()[~rim],
                                   np.asarray(getattr(want, k))[~rim],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("form", ["sah", "flat"])
def test_plain_walks_match_jax(form, compat):
    """``plain_closest_hit`` / ``plain_any_hit`` / ``plain_traversal_stats``
    against the JAX walk's ``closest_hit`` / ``any_hit`` /
    ``traversal_stats`` on 256 seeded rays with a mask (the flat form
    with max_leaf_size = its 16 triangles)."""
    js, ps, _ = scene_pair(form)
    o, d, t_max, mask = _rays(1)
    mls = int(js.mesh.indices.shape[0]) if form == "flat" else 4
    kw = dict(max_leaf_size=mls, compat=compat)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    pargs = (_v3(o), _v3(d), torch.from_numpy(t_max))
    jmask, pmask = jnp.asarray(mask), torch.from_numpy(mask)

    want = jax_traverse.closest_hit(js.bvh, js.mesh, *jargs, jmask, **kw)
    got = bvh_walk.plain_closest_hit(ps.bvh, ps.mesh, *pargs, pmask, **kw)
    _assert_hits_match(got, want, compat)
    assert not got.valid[~pmask].any()
    assert torch.equal(got.t[~pmask], pargs[2][~pmask])
    oracle = intersect.brute_force_closest_hit(
        ps.mesh.positions, ps.mesh.indices, torch.from_numpy(o),
        torch.from_numpy(d), pargs[2], compat=compat)
    same = (got.tri == oracle.tri) & pmask
    assert int(same.sum()) >= 0.99 * int(pmask.sum())
    assert torch.equal(got.t[same], oracle.t[same])

    occ = bvh_walk.plain_any_hit(ps.bvh, ps.mesh, *pargs, pmask, **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(
        jax_traverse.any_hit(js.bvh, js.mesh, *jargs, jmask, **kw)))
    assert 0 < int(occ.sum()) < int(pmask.sum())

    visits, iters = bvh_walk.plain_traversal_stats(ps.bvh, ps.mesh, *pargs,
                                                   **kw)
    jvisits, jiters = jax_traverse.traversal_stats(js.bvh, js.mesh, *jargs,
                                                   **kw)
    visits, jvisits = visits.numpy(), np.asarray(jvisits)
    if compat or form == "flat":
        np.testing.assert_array_equal(visits, jvisits)
    else:
        assert (visits != jvisits).sum() <= 0.1 * R
        assert abs(int(visits.sum()) - int(jvisits.sum())) <= (
            0.01 * jvisits.sum())
    assert int(iters) == int(jiters) == int(visits.max())
    if form == "flat":  # one leaf: every ray pops the root alone
        assert bool((visits == 1).all())


def test_plain_walk_stats_and_masks():
    """The [3, R] stats of the plain walks: masked rays walk nothing; a
    NaN ray pops the root and fails its box (one pop, one slab test), as
    the JAX walk's reductions keep the NaN; pops equal
    ``plain_traversal_stats`` without a mask; the any-hit walk tests no
    triangle after its first hit."""
    _, ps, _ = scene_pair("sah")
    o, d, t_max, mask = _rays(2, 64)
    o[0, 1], d[1, 2] = np.nan, np.nan
    o[2, 0], d[2, 0] = np.inf, np.inf
    mask[:3] = True
    args = (ps.bvh, ps.mesh, _v3(o), _v3(d), torch.from_numpy(t_max))
    hit, st = bvh_walk.plain_closest_hit(*args, torch.from_numpy(mask),
                                         with_stats=True)
    occ, ast = bvh_walk.plain_any_hit(*args, torch.from_numpy(mask),
                                      with_stats=True)
    assert st.shape == (3, 64) and st.dtype == torch.int32
    for s in (st, ast):
        assert not s[:, torch.from_numpy(~mask)].any()
        assert s[:2, :3].tolist() == [[1, 1, 1], [1, 1, 1]]
        assert not s[2, :3].any()
    assert not hit.valid[:3].any() and not occ[:3].any()
    visits, _ = bvh_walk.plain_traversal_stats(*args)
    assert torch.equal(visits[torch.from_numpy(mask)],
                       st[0][torch.from_numpy(mask)])
    assert bool((st[2] >= ast[2]).all()) and bool((st[1] >= 3).any())


def test_oracles_and_array_forms_match_jax():
    """``intersect_triangle`` / ``intersect_aabb`` (array forms, both
    modes) and the brute-force oracles against the JAX functions on
    seeded inputs; the array-form triangle test equals the component
    form bit for bit, and the BVH walks equal the oracles on the flat
    scene."""
    rng = np.random.default_rng(3)
    n = 4096
    p = rng.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    aim = p.mean(axis=0) + rng.normal(scale=0.3, size=(n, 3))
    d = (aim - o).astype(np.float32)  # about half of them hit
    d[:64, 2] = 0.0  # the compat swap
    t_max = rng.uniform(0.5, 4, n).astype(np.float32)
    tp = [torch.from_numpy(a) for a in (*p, o, d, t_max)]
    jp = [jnp.asarray(a) for a in (*p, o, d, t_max)]
    for compat in (False, True):
        got = intersect.intersect_triangle(*tp, compat=compat)
        want = jax_intersect.intersect_triangle(*jp, compat=compat)
        hit, whit = got[0].numpy(), np.asarray(want[0])
        assert (hit != whit).sum() <= 0.001 * n and hit.sum() > 0.2 * n
        both = hit & whit
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy()[both], np.asarray(w)[both],
                                       rtol=1e-5, atol=1e-6)
        comp = intersect.intersect_triangle_c(
            *[tuple(t.unbind(-1)) for t in tp[:3]], *tp[3].unbind(-1),
            *tp[4].unbind(-1), tp[5], compat=compat)
        for a, b in zip(got, comp):
            assert torch.equal(a, b)
        lo, hi = np.minimum(p[0], p[1]), np.maximum(p[0], p[1])
        inv = intersect.safe_inv_dir(tp[4])
        np.testing.assert_array_equal(
            intersect.intersect_aabb(torch.from_numpy(lo),
                                     torch.from_numpy(hi), tp[3], inv,
                                     tp[5], compat).numpy(),
            np.asarray(jax_intersect.intersect_aabb(
                jnp.asarray(lo), jnp.asarray(hi), jp[3],
                jax_intersect.safe_inv_dir(jp[4]), jp[5], compat)))

    js, ps, _ = scene_pair("flat")
    o, d, t_max, _ = _rays(4)
    pos, idx = ps.mesh.positions, ps.mesh.indices
    for compat in (False, True):
        got = intersect.brute_force_closest_hit(
            pos, idx, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max), compat=compat, chunk=5)
        want = jax_intersect.brute_force_closest_hit(
            js.mesh.positions, js.mesh.indices, jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(t_max), compat=compat, chunk=5)
        _assert_hits_match(got, want, compat)
        occ = intersect.brute_force_any_hit(
            pos, idx, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max), compat=compat, chunk=5)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(
            jax_intersect.brute_force_any_hit(
                js.mesh.positions, js.mesh.indices, jnp.asarray(o),
                jnp.asarray(d), jnp.asarray(t_max), compat=compat,
                chunk=5)))
        walk = bvh_walk.plain_closest_hit(
            ps.bvh, ps.mesh, _v3(o), _v3(d), torch.from_numpy(t_max),
            max_leaf_size=int(idx.shape[0]), compat=compat)
        assert torch.equal(walk.t, got.t) and torch.equal(walk.tri, got.tri)
        assert torch.equal(bvh_walk.plain_any_hit(
            ps.bvh, ps.mesh, _v3(o), _v3(d), torch.from_numpy(t_max),
            max_leaf_size=int(idx.shape[0]), compat=compat), occ)


def test_flat_scene_builds_outside_the_packed_layout():
    """The port's flat scene: trav None, route 'bvh', one leaf, arrays
    equal to the JAX package's flat scene and to its conversion; the SAH
    form keeps its layout; a converted JAX trav=None scene has trav None
    and round-trips."""
    js, ps, _ = scene_pair("flat")
    own = _port_small_scene(True)
    assert js.trav is None and ps.trav is None and own.trav is None
    assert own.bvh_depth == ps.bvh_depth == 1
    assert port_route.traversal_route(own.trav, True) == "bvh"
    want = scene_to_arrays(js)
    for leaves in (scene_to_arrays(own), scene_to_arrays(ps)):
        assert set(leaves) == set(want)
        assert not any(k.startswith(("trav.", "stream.")) for k in leaves)
        for k, v in want.items():
            np.testing.assert_array_equal(leaves[k], v, err_msg=k)
    back = scene_from_arrays(scene_to_arrays(own), device="cpu")
    assert back.trav is None
    sah = _port_small_scene(False)
    assert sah.trav is not None and port_route.traversal_route(
        sah.trav, True) == "attr"
    np.testing.assert_array_equal(scene_to_arrays(sah)["bvh.start"],
                                  scene_to_arrays(scene_pair("sah")[1])[
                                      "bvh.start"])


@pytest.mark.parametrize("leaf", ["all", "4"])
def test_flat_frame_matches_jax(leaf):
    """A 16x16 depth-2 frame of the flat scene through route 'bvh':
    against the JAX frame (atol 3e-5) with max_leaf_size = T and with the
    default 4 (both packages then test the leaf's first 4 triangles
    alone); with T also against the port's packed-route frame of the SAH
    scene (atol 2e-5), which the default 4 misses."""
    js, ps, cam = scene_pair("flat")
    mls = int(js.mesh.indices.shape[0]) if leaf == "all" else 4
    want = np.asarray(jax_render_frame(
        js, cam, JaxRenderConfig(max_leaf_size=mls, **SIZE), 0))
    got = render_frame(ps, port_camera(cam), RenderConfig(
        max_leaf_size=mls, **SIZE), 0, device="cpu").numpy()
    assert_frame_close(got, want)
    packed = render_frame(scene_pair("sah")[1], port_camera(cam),
                          RenderConfig(**SIZE), 0, device="cpu").numpy()
    off = np.abs(got - packed).max(axis=-1) > 2e-5
    if leaf == "all":
        assert_frame_close(got, packed, atol=2e-5)
    else:
        assert off.sum() > 0.1 * off.size
    assert want.mean() > 0.05


def test_bvh_route_trace_and_replay():
    """Route 'bvh' on the trace / replay path: the records of
    ``trace_paths`` replayed by ``render_rays_replay`` give the live
    frame's radiance; no sort key is computed, rays are only compacted;
    a too shallow stack raises as on every route."""
    _, ps, cam = scene_pair("flat")
    cfg = RenderConfig(max_leaf_size=int(ps.mesh.indices.shape[0]), **SIZE)
    from pnraytracing_tpu_torch.core.camera import camera_rays
    from pnraytracing_tpu_torch.render.renderer import pixel_coords

    o, d, _ = camera_rays(port_camera(cam), 16, 16)
    px, py = pixel_coords(cfg, "cpu")
    called = []
    keyed = integrator.entry_key
    integrator.entry_key = lambda *a: called.append(a) or keyed(*a)
    try:
        live = integrator.render_rays(ps, o, d, px, py, 3, cfg)
        recs = integrator.trace_paths(ps, o, d, px, py, 3, cfg)
    finally:
        integrator.entry_key = keyed
    assert not called
    replay = integrator.render_rays_replay(ps, o, d, px, py, 3, cfg, recs)
    np.testing.assert_allclose(replay.numpy(), live.numpy(), atol=1e-5)
    assert int((recs.primary.tri >= 0).sum()) > 100
    _, sah, _ = scene_pair("sah")
    no_layout = dataclasses.replace(sah, trav=None)
    with pytest.raises(ValueError, match="too shallow"):
        integrator.render_rays(no_layout, o, d, px, py, 0, RenderConfig(
            stack_depth=4, **SIZE))


def test_probe_pixel_flat_matches_jax():
    """``probe_pixel`` on the flat scene (its primary hit from the walk
    over the plain BVH in both packages) against the JAX ``probe_pixel``,
    and its colour against its pixel of the port's frame, bit for bit."""
    js, ps, cam = scene_pair("flat")
    mls = int(js.mesh.indices.shape[0])
    cfg = RenderConfig(max_leaf_size=mls, **SIZE)
    jcfg = JaxRenderConfig(max_leaf_size=mls, **SIZE)
    frame = render_frame(ps, port_camera(cam), cfg, 2, device="cpu")
    for x, y in ((8, 8), (4, 3)):
        got = probe_pixel(ps, port_camera(cam), cfg, x, y, frame=2,
                          device="cpu")
        want = jax_probe_pixel(js, cam, jcfg, x, y, frame=2)
        assert set(got) == set(want)
        assert int(got["primary_tri"]) == int(want["primary_tri"]) >= 0
        np.testing.assert_allclose(got["primary_t"].numpy(),
                                   np.asarray(want["primary_t"]), rtol=1e-6)
        for k in ("primary_bary", "ray_origin", "ray_dir", "color"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=3e-5, err_msg=k)
        assert torch.equal(got["color"], frame[16 - 1 - y, x])


def test_binary_route_matches_jax(monkeypatch):
    """A scene over the resident budget without a stream layout (the
    budget lowered to 0 in both packages): the port routes it to the
    binary walks (kernels 5 / 6 on the card), the JAX package to its XLA
    packet walk; the frames agree within atol 3e-5."""
    js, ps, cam = scene_pair("sah")
    monkeypatch.setattr(jax_traverse_pallas, "SMEM_SCENE_BUDGET_BYTES", 0)
    monkeypatch.setattr(port_route, "SMEM_SCENE_BUDGET_BYTES", 0)
    assert ps.trav.stream is None
    assert port_route.traversal_route(ps.trav, True) == "binary"
    size = dict(width=12, height=12, max_depth=2)  # no other test's shape
    jax.clear_caches()  # the JAX frame is traced under the lowered budget
    try:
        want = np.asarray(jax_render_frame(js, cam, JaxRenderConfig(**size),
                                           0))
    finally:
        jax.clear_caches()
    calls = []
    walk = walks.closest_hit
    monkeypatch.setattr(walks, "closest_hit", lambda *a, **kw: (
        calls.append(kw.get("variant")) or walk(*a, **kw)))
    got = render_frame(ps, port_camera(cam), RenderConfig(**size), 0,
                       device="cpu").numpy()
    assert calls and set(calls) == {"binary"}
    assert_frame_close(got, want)
    assert want.mean() > 0.05

