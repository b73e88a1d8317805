"""Compat mode (``RenderConfig(compat_pnrt=True)``, the reference's
quirks) of the port against the JAX package, on the CPU.

* the compat ray setup, triangle test and slab test against
  ``pnraytracing_tpu.ops.intersect`` on rays with ``d.z == +-0`` and
  ``|d.z| < 1e-30`` (the watertight test's shears then overflow and its
  edge functions are NaN), and the box behind the ray of
  tests/test_intersect.py (a hit in compat only).  A subnormal ``d.z``
  (``1 / d.z`` is inf) is held against the port's own rule only: XLA:CPU
  flushes subnormal inputs to zero, so the JAX package takes such a ray
  for a ``d.z == 0`` ray, where the port and its kernels (built without
  ``-ftz``) keep kz = 2;
* the compat plain walks (wide, binary, stream) against the JAX walks
  with ``compat=True`` (``closest_hit_pallas`` / ``any_hit_pallas`` /
  the stream kernel, run by the Pallas interpreter): hits equal but on
  exact-t ties (at most 2), occlusion exact, ``t`` within 8 ulp.  The
  interpreted kernels run XLA's fused (jitted) form of the test, which
  contracts products into FMAs; in compat the test shears by 1 / d.z of
  a component that need not be the largest, which amplifies that
  rounding (more than the default test's 2 ulp).
  So every ray's closest hit is also held against the JAX package's
  compat test run op by op (eagerly, no contraction) over every
  triangle: the same ``t`` bit for bit.  The rays with
  ``0 < |d.z| < 1e-30`` are held only against that op-by-op form: their
  shears reach ~1e31, and the fused form hits other triangles than the
  op-by-op one there (an FMA keeps what the separate operations
  overflow).  A compat walk visits every node its default walk visits;
* the compat BRDF, cosine hemisphere, material decode and environment
  sample, value by value, with the bounds of tests/test_torch_shading.py;
* the CDF bisection (``_bisect_rows``) equal to the JAX function and to
  ``np.searchsorted(side='left')`` at the table's own values, and
  ``build_envmap(alias=False)`` sampled against the JAX package, carried
  both ways by ``convert.py``;
* compat frames of ``config3_teapot_night`` and ``cornell_box`` (32x32,
  depth 2, both samplers): the port's frame against the JAX package's
  compat estimator run on the port's walk answers
  (``render_rays_replay`` on ``TraceRecords`` recorded from the port's
  walks), at most 2 pixels outside atol 3e-5
  (tests/test_torch_render.py).  The live frames of the two packages are
  not compared pixel by pixel: in compat the environment shadow ray
  leaves from the surface point itself, so its own triangle is hit or
  missed at t ~ 0 by the sign of a rounding error, and the sheared test
  flips shadow rays with a small d.z; the answers then depend on how a
  compiler contracts the arithmetic: the JAX package's own compat
  frames differ between its packet and its Pallas walks in such pixels.
  The port's walks agree with the op-by-op form (above);
* ``probe_pixel`` against the JAX ``probe_pixel`` (the primary hit and
  the ray) and its colour against the pixel of the port's own frame.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.accel.traverse_pallas import (
    any_hit_pallas,
    closest_hit_pallas,
)
from pnraytracing_tpu.accel.traverse_stream import (
    any_hit_stream as jax_any_hit_stream,
)
from pnraytracing_tpu.accel.traverse_stream import (
    closest_hit_stream as jax_closest_hit_stream,
)
from pnraytracing_tpu.core.camera import camera_rays as jax_camera_rays
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.core.vec import build_tangent_space_v as jax_tangents
from pnraytracing_tpu.io.hdr import procedural_sky
from pnraytracing_tpu.ops import brdf as jbrdf
from pnraytracing_tpu.ops import envmap as jenv
from pnraytracing_tpu.ops import intersect as jint
from pnraytracing_tpu.ops import sampling as jsampling
from pnraytracing_tpu.ops.intersect import Hit as JaxHit
from pnraytracing_tpu.render.debug import probe_pixel as jax_probe_pixel
from pnraytracing_tpu.render.integrator import (
    TraceRecords as JaxTraceRecords,
)
from pnraytracing_tpu.render.integrator import render_rays_replay
from pnraytracing_tpu.render.renderer import pixel_coords as jax_pixel_coords
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel import traverse_stream_cuda as trs
from pnraytracing_tpu_torch.convert import scene_from_arrays, scene_to_arrays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Materials
from pnraytracing_tpu_torch.core.vec import V3, build_tangent_space_v
from pnraytracing_tpu_torch.ops import brdf, envmap, sampling
from pnraytracing_tpu_torch.ops.intersect import (
    intersect_aabb_c,
    intersect_triangle_c,
    safe_inv_dir,
    triangle_setup_c,
)
from pnraytracing_tpu_torch.render.debug import probe_pixel
from pnraytracing_tpu_torch.render.renderer import render_frame
from tests.test_torch_catalog import jax_scene as jax_catalog_scene
from tests.test_torch_catalog import port_scene_of
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    _torch_threads,
    jax_teapot_night,
    port_camera,
    port_scene,
)
from tests.test_torch_shading import (
    COND_FACTOR,
    EPS32,
    LOBES,
    N,
    SINE_ULPS,
    _assert_within,
    _close,
    _hold_both,
    _jax_stacked,
    _reference,
    _shading_inputs,
    _stacked,
    _tmap,
)
from tests.test_torch_stream import small_stream_scenes
from tests.test_torch_traverse import PALLAS, _t, _v3, soup


def _compat_rays(n, seed, subnormal=False):
    """``n`` rays (a multiple of 8) from inside a soup's box, random
    directions, of which one eighth each has d.z = +0, d.z = -0,
    d.z = 1e-31 and d.z = -3e-35 (or, with ``subnormal``, -1e-39: 1 / d.z
    is then inf)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    m = n // 8
    for k, dz in enumerate((0.0, -0.0, 1e-31,
                            -1e-39 if subnormal else -3e-35)):
        sl = slice(k * m, (k + 1) * m)
        d[sl, 2] = 0.0
        d[sl] /= np.linalg.norm(d[sl], axis=-1, keepdims=True)
        d[sl, 2] = np.float32(dz)
    return o, d.astype(np.float32)


def _assert_t_ulps(got, want, same, ulps=8):
    g, w = got.numpy()[same], np.asarray(want)[same]
    gap = np.abs(g.astype(np.float64) - w) / np.spacing(np.abs(w))
    assert gap.max(initial=0.0) <= ulps, f"t differs by {gap.max()} ulp"


def _assert_hits(got, want, n, rows=slice(None)):
    """Hits of rays ``rows`` equal off exact-t ties (at most 2), t within
    2 ulp, b within the bounds of tests/test_torch_traverse.py."""
    g = lambda a: a.numpy()[rows]
    w = lambda a: np.asarray(a)[rows]
    same = g(got.tri) == w(want.tri)
    assert same.sum() >= n - 2, f"{(~same).sum()} tri mismatches"
    _assert_t_ulps(torch.from_numpy(g(got.t)), w(want.t), same)
    for a, b in ((got.b1, want.b1), (got.b2, want.b2)):
        np.testing.assert_allclose(g(a)[same], w(b)[same], rtol=1e-5,
                                   atol=1e-6)


def _jax_brute_force(tri9, o, d, t_max):
    """([R, T] t of every hit, inf elsewhere; [R] occluded within t_max)
    of the JAX package's compat triangle test run op by op (eagerly) over
    every triangle."""
    tri = np.asarray(tri9)
    hit, t, _, _ = jint.intersect_triangle_c(
        *((tri[:, 3 * c], tri[:, 3 * c + 1], tri[:, 3 * c + 2])
          for c in range(3)),
        *(jnp.asarray(o[:, k:k + 1]) for k in range(3)),
        *(jnp.asarray(d[:, k:k + 1]) for k in range(3)),
        jnp.float32(1e7), compat=True)
    hit, t = np.asarray(hit), np.asarray(t)
    t = np.where(hit, t, np.inf)
    return t, (t <= t_max[:, None]).any(1)


def _assert_brute_force(got, t_all):
    """The closest hits are the op-by-op test's: a ray misses where it
    hits nothing, else its triangle is hit at the least t of all, bit for
    bit (on an exact-t tie another triangle may share that t)."""
    tri, t = got.tri.numpy(), got.t.numpy()
    best = t_all.min(1)
    hit = tri >= 0
    np.testing.assert_array_equal(hit, np.isfinite(best))
    np.testing.assert_array_equal(t[hit], best[hit])
    np.testing.assert_array_equal(t_all[hit, tri[hit]], best[hit])


# ---- the tests ---------------------------------------------------------


def test_compat_setup_and_tests_match_jax():
    """The ray setup (permutation exact, shears bit for bit, NaN and inf
    included), the triangle test (hits exact, t within 2 ulp) and the
    slab test (exact) of both packages in compat mode."""
    o, d = _compat_rays(512, 0)
    rng = np.random.default_rng(1)
    tri = rng.uniform(-6, 6, size=(1, 64, 9)).astype(np.float32)
    box = np.sort(rng.uniform(-4, 4, size=(512, 2, 3)), axis=1).astype(
        np.float32)
    t_max = rng.uniform(1.0, 20.0, 512).astype(np.float32)
    pt = [torch.from_numpy(np.ascontiguousarray(a)) for a in
          (*o.T, *d.T, t_max)]
    jt = [jnp.asarray(np.ascontiguousarray(a)) for a in (*o.T, *d.T, t_max)]
    col = lambda ts: [t[:, None] for t in ts]  # rays x the 64 triangles

    for a, b in zip(triangle_setup_c(*pt[3:6], compat=True),
                    jint.triangle_setup_c(*jt[3:6], compat=True)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    setup = triangle_setup_c(*pt[3:6], compat=True)
    assert (setup[2].numpy()[:128] != 2).all()  # d.z == +-0: swapped
    assert (setup[2].numpy()[128:] == 2).all()

    corners = lambda m, c: tuple(
        m(np.ascontiguousarray(tri[..., 3 * c + k])) for k in range(3))
    got = intersect_triangle_c(*(corners(torch.from_numpy, c)
                                 for c in range(3)), *col(pt), compat=True)
    want = jint.intersect_triangle_c(*(corners(jnp.asarray, c)
                                       for c in range(3)), *col(jt),
                                     compat=True)
    hit = got[0].numpy()
    np.testing.assert_array_equal(hit, np.asarray(want[0]))
    assert 200 < hit.sum() < 20000 and hit[:256].any()
    _assert_t_ulps(got[1], want[1], hit)
    assert np.isnan(got[1].numpy()[128:256]).any()  # overflowing shears
    # the default setup of the same rays is another test
    default = intersect_triangle_c(*(corners(torch.from_numpy, c)
                                     for c in range(3)), *col(pt))
    assert not np.array_equal(default[1].numpy()[hit], got[1].numpy()[hit])

    lo = lambda m: tuple(m(np.ascontiguousarray(box[:, 0, k]))
                         for k in range(3))
    hi = lambda m: tuple(m(np.ascontiguousarray(box[:, 1, k]))
                         for k in range(3))
    inv = [safe_inv_dir(c) for c in pt[3:6]]
    jinv = [jint.safe_inv_dir(c) for c in jt[3:6]]
    for compat in (False, True):
        got = intersect_aabb_c(lo(torch.from_numpy), hi(torch.from_numpy),
                               *pt[:3], *inv, pt[6], compat=compat)
        want = jint.intersect_aabb_c(lo(jnp.asarray), hi(jnp.asarray),
                                     *jt[:3], *jinv, jt[6], compat=compat)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the box behind the ray (tests/test_intersect.py): compat hits it
    one = lambda v: torch.tensor([v], dtype=torch.float32)
    behind = [intersect_aabb_c((one(-1),) * 3, (one(1),) * 3, one(0), one(0),
                               one(5), *(safe_inv_dir(one(c))
                                         for c in (0.0, 0.0, 1.0)),
                               one(100), compat=c) for c in (False, True)]
    assert [bool(b) for b in behind] == [False, True]

    # a subnormal d.z: kz stays 2, 1 / d.z is inf, and nothing is hit
    _, ds = _compat_rays(512, 0, subnormal=True)
    sub = [torch.from_numpy(np.ascontiguousarray(a)) for a in ds.T]
    setup = triangle_setup_c(*sub, compat=True)
    assert (setup[2][192:256] == 2).all()
    assert torch.isinf(setup[5][192:256]).all()
    got = intersect_triangle_c(*(corners(torch.from_numpy, c)
                                 for c in range(3)),
                               *col([*pt[:3], *sub, pt[6]]), compat=True)
    assert not got[0][192:256].any()


@pytest.mark.parametrize("variant", ["wide", "binary"])
def test_compat_walks_match_pallas(variant):
    """The compat plain walks against the Pallas kernels with
    ``compat=True`` on a soup and on the compat ray set; every node the
    default walk visits, the compat walk visits too."""
    jtrav, ptrav, *_ = soup(seed=5)
    o, d = _compat_rays(256, 2)
    tiny = (d[:, 2] != 0) & (np.abs(d[:, 2]) < 1e-30)
    t_max = np.full((256,), 1e7, np.float32)
    want = closest_hit_pallas(jtrav, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), variant=variant,
                              compat=True, **PALLAS)
    got, st = trv.closest_hit(ptrav, _v3(o), _v3(d), _t(t_max),
                              variant=variant, compat=True, with_stats=True)
    _assert_hits(got, want, 192, ~tiny)
    assert (got.tri.numpy() >= 0).sum() >= 10
    brute_t, brute_occ = _jax_brute_force(jtrav.tri9, o, d,
                                          np.full(256, 3.0, np.float32))
    _assert_brute_force(got, brute_t)
    _, st0 = trv.closest_hit(ptrav, _v3(o), _v3(d), _t(t_max),
                             variant=variant, with_stats=True)
    assert (st[0] >= st0[0]).all() and int(st[0].sum()) > int(st0[0].sum())

    short = np.full((256,), 3.0, np.float32)
    mask = np.arange(256) % 5 != 0
    want = any_hit_pallas(jtrav, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(short), jnp.asarray(mask),
                          variant=variant, compat=True, **PALLAS)
    occ = trv.any_hit(ptrav, _v3(o), _v3(d), _t(short),
                      torch.from_numpy(mask), variant=variant, compat=True)
    np.testing.assert_array_equal(occ.numpy()[~tiny],
                                  np.asarray(want)[~tiny])
    np.testing.assert_array_equal(occ.numpy()[tiny],
                                  (brute_occ & mask)[tiny])
    assert occ.numpy().any() and not occ.numpy()[~mask].any()
    if variant == "wide":
        attr_hit, _ = trv.closest_hit_attr(ptrav, _v3(o), _v3(d),
                                           _t(t_max), compat=True)
        np.testing.assert_array_equal(attr_hit.tri.numpy(),
                                      got.tri.numpy())


def test_compat_stream_walks_match_pallas():
    """The compat plain stream walks against the JAX stream kernel with
    ``compat=True`` (8 KB bricks), closest and any hit; the compat walk
    enters at least the bricks the default walk enters."""
    js, ps = small_stream_scenes()
    from tests.test_torch_stream import _rays

    o, d = _rays(16)
    r = o.shape[0]
    t_max = np.full((r,), 1e7, np.float32)
    want = jax_closest_hit_stream(js.trav, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(t_max), None, compat=True,
                                  **PALLAS)
    got, st = trs.closest_hit_stream(ps.trav, _v3(o), _v3(d), _t(t_max),
                                     compat=True, with_stats=True)
    _assert_hits(got, want, r)
    assert got.valid.numpy().sum() >= 50
    _assert_brute_force(got, _jax_brute_force(js.trav.tri9, o, d,
                                              t_max)[0])
    _, st0 = trs.closest_hit_stream(ps.trav, _v3(o), _v3(d), _t(t_max),
                                    with_stats=True)
    assert (st[3] >= st0[3]).all() and int(st[3].sum()) > int(st0[3].sum())
    rng = np.random.default_rng(2)
    t_short = rng.uniform(0.5, 8.0, r).astype(np.float32)
    mask = np.arange(r) % 3 != 0
    want = jax_any_hit_stream(js.trav, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_short), jnp.asarray(mask),
                              compat=True, **PALLAS)
    occ = trs.any_hit_stream(ps.trav, _v3(o), _v3(d), _t(t_short),
                             torch.from_numpy(mask), compat=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want))
    assert occ.numpy().any()


@pytest.mark.parametrize("lobe", sorted(LOBES))
def test_compat_brdf_matches_jax(lobe):
    """The unclamped compat pdf (negative values included) and the compat
    sample (the decoded materials, the GTR half vector without square
    roots, the cosine lobe that reads u1 as an angle) of both packages
    against the port's float64 evaluation, with the bound of
    tests/test_torch_shading.py."""
    rng, (pn, pv, pl, _, pm), (jn, jv, jl, _, jm) = _shading_inputs(4, lobe)
    pm = brdf.apply_compat_material_decode(pm)
    jm = jbrdf.apply_compat_material_decode(jm)
    pdf = functools.partial(brdf.disney_pdf_v, compat=True)
    _hold_both("compat pdf", pdf, (pv, pn, pl, pm),
               jbrdf.disney_pdf_v(jv, jn, jl, jm, compat=True))

    pt, pb = build_tangent_space_v(pn)
    jt, jb = jax_tangents(jn)
    us = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(5)]
    args = (pv, pn, pt, pb, pm, *map(torch.from_numpy, us))
    sample = functools.partial(brdf.disney_sample_v, compat=True)
    l, pd, picked = sample(*args)
    jl, jpd, jpicked = jbrdf.disney_sample_v(jv, jn, jt, jb, jm,
                                             *map(jnp.asarray, us),
                                             compat=True)
    np.testing.assert_array_equal(picked.numpy(), np.asarray(jpicked))
    assert set(np.unique(picked.numpy())) == {0, 1, 2}
    (l_ref, _, _), (l_cond, _, _) = _reference(sample, args)
    # what amplifies: n.l of the cosine lobe, the half vector's sine
    n64 = _stacked(_tmap(pn, torch.Tensor.double))[0]
    cos_l = (l_ref * n64).sum(0).abs()
    extra = SINE_ULPS * EPS32 / cos_l.clamp_min(1e-3)
    jl_t, jpd_t, _ = _jax_stacked((jl, jpd, jpicked))
    _assert_within("compat l port", _stacked(l)[0], l_ref, l_cond, extra)
    _assert_within("compat l jax", jl_t, l_ref, l_cond, extra)
    # each package's pdf against the float64 pdf at its own direction.
    # The compat half vector is not a unit vector, so many directions land
    # on the steep flanks of the GTR peaks, where the amplification term
    # makes the bound wide: the values are held, the bound's tightness
    # is not asserted here (it is for the pdf and the directions above)
    for name, ll, pp in (("port", l, pd),
                         ("jax", V3(*jl_t.unbind(0)), jpd_t)):
        (ref,), (cond,) = _reference(pdf, (pv, pn, ll, pm))
        tol = 1e-6 + 1e-5 * ref.abs() + COND_FACTOR * cond
        share = float(((pp.double() - ref).abs() / tol).max())
        assert share <= 1.0, f"compat sample pdf {name}: {share:.3g}"
    assert float(pd.min()) < 0.0  # the pdf is not clamped


def test_compat_decode_and_hemisphere_match_jax():
    """The material decode moves three parameters and writes nothing into
    its input; the [R, 3] cosine-hemisphere sample of both packages in
    both modes, within rtol 1e-5 / atol 1e-6."""
    m = Materials.stack([{"sheen": 0.3, "sheen_tint": 0.6, "clearcoat": 0.9,
                          "clearcoat_gloss": 0.1, "ior": 1.5}],
                        device="cpu")
    before = {f.name: getattr(m, f.name).clone()
              for f in dataclasses.fields(m)}
    dec = brdf.apply_compat_material_decode(m)
    assert [float(getattr(dec, k)) for k in
            ("clearcoat_gloss", "ior", "transmission")] == [
        float(m.sheen), float(m.sheen_tint), float(m.clearcoat)]
    for name, v in before.items():
        assert torch.equal(getattr(m, name), v)
    rng = np.random.default_rng(6)
    u1, u2 = (rng.uniform(0, 1, N).astype(np.float32) for _ in range(2))
    for compat in (False, True):
        got = sampling.sample_cosine_hemisphere_local(
            torch.from_numpy(u1), torch.from_numpy(u2), compat)
        want = jsampling.sample_cosine_hemisphere_local(
            jnp.asarray(u1), jnp.asarray(u2), compat)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_bisect_rows_equals_searchsorted():
    """``_bisect_rows`` equals the JAX function and a row-by-row
    ``np.searchsorted(side='left')`` on uniforms, on every value of the
    table itself (ties go left), below its first and above its last."""
    rng = np.random.default_rng(7)
    table = np.cumsum(rng.uniform(0, 1, (6, 37)), axis=1).astype(np.float32)
    table[2, 5:9] = table[2, 4]  # a run of equal values
    table /= table[:, -1:]
    x = np.repeat(np.arange(6), 40)
    u = np.concatenate([rng.uniform(0, 1, 6 * 20).astype(np.float32),
                        table[np.arange(6).repeat(16),
                              np.tile(np.arange(0, 37, 37 // 15)[:16], 6)],
                        np.tile(np.float32([0.0, -1.0, 1.0, 2.0]), 6 * 1)])
    x = x[:u.shape[0]]
    got = envmap._bisect_rows(torch.from_numpy(table), torch.from_numpy(x),
                              torch.from_numpy(u))
    want = jenv._bisect_rows(jnp.asarray(table), jnp.asarray(x),
                             jnp.asarray(u))
    ref = np.array([np.searchsorted(table[i], v, side="left")
                    for i, v in zip(x, u)])
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(np.asarray(want), ref)
    assert ref.max() == 37 and ref.min() == 0


@pytest.mark.parametrize("compat", [False, True])
def test_alias_free_envmap_sampling_matches_jax(compat):
    """``build_envmap(alias=False)`` equals the JAX tables and samples
    like the JAX package (the CDF inversion, and in compat its pdf and
    mirrored-row radiance), within rtol 1e-5 / atol 1e-6; ``convert.py``
    carries the map without alias tables both ways; an alias map in
    compat mode samples the same as the alias-free one."""
    sky = procedural_sky(16, 32)
    pe = envmap.build_envmap(sky, device="cpu")
    je = jenv.build_envmap(jnp.asarray(sky))
    assert pe.alias_x is None and pe.alias_fat is None
    for f in ("image", "pdf_xy", "cdf_marginal_x", "cdf_y_given_x",
              "quad12"):
        np.testing.assert_array_equal(getattr(pe, f).numpy(),
                                      np.asarray(getattr(je, f)), err_msg=f)
    rng = np.random.default_rng(8)
    u1, u2 = (rng.uniform(0, 1, N).astype(np.float32) for _ in range(2))
    u1[:3], u2[:3] = 0.0, 1.0
    got = envmap.sample_envmap_v(pe, torch.from_numpy(u1),
                                 torch.from_numpy(u2), compat)
    want = jenv.sample_envmap_v(je, jnp.asarray(u1), jnp.asarray(u2), compat)
    for g, w in zip(got, want):
        _close(g, w)
    alias = envmap.build_envmap(sky, alias=True, device="cpu")
    again = envmap.sample_envmap_v(alias, torch.from_numpy(u1),
                                   torch.from_numpy(u2), compat)
    assert torch.equal(again[2], got[2]) == compat

    js, _ = jax_teapot_night()
    js = js.replace(env=je)
    ps = port_scene(js)
    assert ps.env.alias_fat is None
    leaves = scene_to_arrays(ps)
    assert not any(k.startswith("env.alias") for k in leaves)
    back = scene_to_arrays(scene_from_arrays(leaves, device="cpu"))
    assert sorted(back) == sorted(leaves)


def _record_walks(ps, cam, cfg, monkeypatch):
    """(port frame [H, W, 3], the JAX package's ``TraceRecords`` of its
    walks): the port's frame under ``cfg`` with ``compact_rays=False``,
    so every query's rays are in pixel order, and
    ``kernel_interaction=False``, so the interaction is re-derived from
    each hit as the JAX replay does; each answer its walks give
    (primary hit, per bounce the light and environment occlusion and
    the continuation hit) recorded."""
    from pnraytracing_tpu_torch.accel import walks

    closest, shadows = [], []
    orig_c, orig_a = walks.closest_hit, walks.any_hit

    def rec_closest(*args, **kw):
        hit = orig_c(*args, **kw)
        closest.append(hit)
        return hit

    def rec_any(*args, **kw):
        occ = orig_a(*args, **kw)
        shadows.append(occ)
        return occ

    monkeypatch.setattr(walks, "closest_hit", rec_closest)
    monkeypatch.setattr(walks, "any_hit", rec_any)
    img = render_frame(ps, cam, dataclasses.replace(
        cfg, compact_rays=False, kernel_interaction=False), 1, device="cpu")
    monkeypatch.undo()
    p = cfg.width * cfg.height
    j = lambda hits, f: jnp.asarray(np.stack([getattr(h, f).numpy()
                                              for h in hits]))
    jhit = lambda hits: JaxHit(tri=j(hits, "tri"), t=j(hits, "t"),
                               b1=j(hits, "b1"), b2=j(hits, "b2"))
    occ = np.stack([o.numpy() for o in shadows])  # [depth, 2P] fused
    has_lights, has_env = ps.lights.count > 0, ps.env is not None
    light = occ[:, :p] if has_lights else None
    env = (occ[:, -p:] if has_env else None)
    records = JaxTraceRecords(
        primary=jax.tree_util.tree_map(lambda a: a[0], jhit(closest[:1])),
        light_occ=None if light is None else jnp.asarray(light),
        env_occ=None if env is None else jnp.asarray(env),
        bounce=jhit(closest[1:]))
    return img.numpy(), records


@pytest.mark.parametrize("sampler", ["sobol", "hash"])
@pytest.mark.parametrize("name", ["teapot_night", "cornell_teapot"])
def test_compat_frame_matches_jax(name, sampler, monkeypatch):
    """A compat frame of the port (plain walks in their compat form, the
    compat shading and, on the teapot's night sky, the bisection sampler)
    against the JAX package's compat estimator replaying the port's walk
    answers (``render_rays_replay``); and it is not the default frame."""
    if name == "teapot_night":
        js, jcam = jax_teapot_night()
        ps = port_scene(js)
    else:
        js, jcam = jax_catalog_scene(name)
        ps, _ = port_scene_of(name)
    size = dict(width=32, height=32, max_depth=2, sampler=sampler)
    cfg = RenderConfig(compat_pnrt=True, **size)
    cam = port_camera(jcam.basis())
    got, records = _record_walks(ps, cam, cfg, monkeypatch)
    jcfg = JaxRenderConfig(traversal="packet", compat_pnrt=True, **size)
    px, py = jax_pixel_coords(jcfg)
    o, d, _ = jax_camera_rays(jcam.basis(), 32, 32)
    want = np.asarray(render_rays_replay(js, o, d, px, py, jnp.uint32(1),
                                         jcfg, records)).reshape(32, 32, 3)
    assert_frame_close(got.reshape(32, 32, 3), want)
    assert want.mean() > 0.02
    # the recorded frame is the one rendered with compaction (a pure
    # permutation), bit for bit
    live = render_frame(ps, cam, dataclasses.replace(
        cfg, kernel_interaction=False), 1, device="cpu").numpy()
    np.testing.assert_array_equal(live, got)
    default = render_frame(ps, cam, RenderConfig(**size), 1,
                           device="cpu").numpy()
    assert np.abs(default - live).max() > 1e-3


def test_probe_pixel_matches_jax():
    """``probe_pixel`` in compat mode against the JAX ``probe_pixel``
    (its primary hit from the JAX package's BVH walk, the ray) and its
    colour against the pixel of the port's own frame, bit for bit (the
    frame's colours are held against the JAX package above)."""
    js, jcam = jax_teapot_night()
    ps = port_scene(js)
    cam = port_camera(jcam.basis())
    cfg = RenderConfig(width=16, height=16, max_depth=2, compat_pnrt=True)
    jcfg = JaxRenderConfig(traversal="packet", width=16, height=16,
                           max_depth=2, compat_pnrt=True)
    frame = render_frame(ps, cam, cfg, 2, device="cpu")
    for x, y in ((8, 8), (3, 12)):
        got = probe_pixel(ps, cam, cfg, x, y, frame=2, device="cpu")
        want = jax_probe_pixel(js, jcam.basis(), jcfg, x, y, frame=2)
        assert set(got) == set(want)
        assert int(got["primary_tri"]) == int(want["primary_tri"]) >= 0
        _assert_t_ulps(got["primary_t"][None], np.asarray(
            want["primary_t"])[None], np.ones(1, bool))
        for k in ("primary_bary", "ray_origin", "ray_dir"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=3e-5, err_msg=k)
        assert torch.equal(got["color"], frame[16 - 1 - y, x])
