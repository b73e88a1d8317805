"""The array-form functions (``[..., 3]`` tensors) of modules already
ported, against the JAX package's functions of the same names on seeded
numpy inputs:

* ``core/math.py``: ``dot``, ``cross``, ``length``, ``normalize``,
  ``reflect``, ``luminance``, ``hdr_luminance``, ``mon2lin``,
  ``spherical_uv``, ``build_tangent_space``, ``tangent_to_world``;
* ``core/vec.py``: ``vlength``, ``select_small``;
* ``ops/sampling.py``: ``gray_code``, ``cranley_patterson_rotation``,
  ``sample_uniform_hemisphere_local``;
* ``ops/envmap.py``: ``envmap_lookup``, ``envmap_pdf``,
  ``bilinear_lookup_quads``, ``bilinear_lookup_quads_v``;
* ``ops/brdf.py``: ``disney_eval``, ``disney_pdf``, ``disney_sample``,
  ``sample_gtr1_dir``, ``sample_gtr2_dir``.

Integers (``gray_code``, the sampled lobe) exactly; floats within rtol /
atol 1e-6, except where the frameworks' libm (sin, cos, pow, rsqrt)
differs and the formula amplifies the last bits: the BRDF functions are
held, both packages value by value, against the port's formula in
float64 with the bound of tests/test_torch_shading.py (whose helpers
they use), and the array forms equal the port's component forms bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.core import math as jmath
from pnraytracing_tpu.core import vec as jvec
from pnraytracing_tpu.io.hdr import procedural_sky
from pnraytracing_tpu.ops import brdf as jbrdf
from pnraytracing_tpu.ops import envmap as jenv
from pnraytracing_tpu.ops import sampling as jsampling
from pnraytracing_tpu_torch.core import math as pmath
from pnraytracing_tpu_torch.core import vec as pvec
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops import brdf, envmap, sampling
from tests.test_torch_shading import (  # noqa: F401
    EPS32,
    LOBES,
    SINE_ULPS,
    _assert_within,
    _hold_both,
    _materials,
    _reference,
    _torch_threads,
    _unit,
)

N = 2048
TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(a):
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a)


def _close(got, want, **tol):
    pairs = (zip(got, want) if isinstance(got, tuple) else [(got, want)])
    for g, w in pairs:
        if isinstance(g, V3):
            g, w = g.rows(), jnp.stack([w.x, w.y, w.z], axis=-1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **(tol or TOL))


def _vectors(seed, k=3, unit=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        a = rng.normal(size=(N, 3)).astype(np.float32)
        if unit:
            a /= np.linalg.norm(a, axis=1, keepdims=True)
        out.append(_pair(a.astype(np.float32)))
    return rng, out


def _math_case(name):
    rng, ((a, ja), (b, jb), (c, jc)) = _vectors(10, unit=name in (
        "build_tangent_space", "spherical_uv", "tangent_to_world"))
    if name == "build_tangent_space":
        a[:16] = torch.tensor([0.0, 0.0, 1.0])  # the +x branch
        a[16:32] = torch.tensor([0.0, 0.0, -1.0])
        ja = jnp.asarray(a.numpy())
        return (pmath.build_tangent_space(a),
                jmath.build_tangent_space(ja))
    if name == "tangent_to_world":
        t, bt = pmath.build_tangent_space(a)
        jt, jbt = jmath.build_tangent_space(ja)
        return (pmath.tangent_to_world(t, bt, a, b),
                jmath.tangent_to_world(jt, jbt, ja, jb))
    if name in ("luminance", "hdr_luminance", "mon2lin"):
        x = rng.uniform(-0.2, 3.0, (N, 3)).astype(np.float32)
        (p, j) = _pair(x)
        return getattr(pmath, name)(p), getattr(jmath, name)(j)
    if name in ("dot", "cross", "reflect"):
        return getattr(pmath, name)(a, b), getattr(jmath, name)(ja, jb)
    if name == "normalize":
        a[:4] = 0.0  # the clamp
        ja = jnp.asarray(a.numpy())
    return getattr(pmath, name)(a), getattr(jmath, name)(ja)


MATH = ["dot", "cross", "length", "normalize", "reflect", "luminance",
        "hdr_luminance", "mon2lin", "spherical_uv", "build_tangent_space",
        "tangent_to_world"]


@pytest.mark.parametrize("name", MATH)
def test_core_math_array_forms(name):
    got, want = _math_case(name)
    _close(got, want)
    # the component forms of core/vec.py give the same bits
    _, ((a, _), (b, _), _) = _vectors(10, unit=True)
    if name == "build_tangent_space":
        t, bt = pvec.build_tangent_space_v(V3.of(a))
        ta, ba = pmath.build_tangent_space(a)
        assert torch.equal(t.rows(), ta) and torch.equal(bt.rows(), ba)
    elif name == "reflect":
        assert torch.equal(pvec.vreflect(V3.of(a), V3.of(b)).rows(),
                           pmath.reflect(a, b))
    elif name == "spherical_uv":
        u, v = pvec.spherical_uv_v(V3.of(a))
        assert torch.equal(torch.stack([u, v], -1), pmath.spherical_uv(a))


@pytest.mark.parametrize("name", ["vlength", "select_small"])
def test_core_vec_array_forms(name):
    rng, ((a, ja),) = _vectors(11, 1)
    if name == "vlength":
        a[:4] = 0.0
        ja = jnp.asarray(a.numpy())
        _close(pvec.vlength(V3.of(a)), jvec.vlength(jvec.V3.of(ja)))
        return
    table = rng.uniform(-1, 1, 5).astype(np.float32)
    idx = rng.integers(0, 5, N).astype(np.int32)
    got = pvec.select_small(torch.from_numpy(table), torch.from_numpy(idx))
    want = jvec.select_small(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("name", ["gray_code", "cranley_patterson_rotation",
                                  "sample_uniform_hemisphere_local"])
def test_sampling_array_forms(name):
    rng = np.random.default_rng(12)
    if name == "gray_code":
        i = rng.integers(0, 2**32, N, dtype=np.uint64)
        i[:3] = (0, 1, 2**32 - 1)
        got = sampling.gray_code(torch.from_numpy(i.astype(np.int64)))
        want = jsampling.gray_code(jnp.asarray(i.astype(np.uint32)))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
        assert sampling.gray_code(int(i[5])) == int(np.asarray(want)[5])
        return
    if name == "cranley_patterson_rotation":
        p = rng.uniform(0, 1, (N, 2)).astype(np.float32)
        px = rng.integers(0, 512, N)
        py = rng.integers(0, 384, N)
        got = sampling.cranley_patterson_rotation(
            torch.from_numpy(p), torch.from_numpy(px), torch.from_numpy(py),
            512, 384)
        want = jsampling.cranley_patterson_rotation(
            jnp.asarray(p), jnp.asarray(px.astype(np.uint32)),
            jnp.asarray(py.astype(np.uint32)), 512, 384)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got.max()) <= 1.0 and float(got.min()) >= 0.0
        return
    u1, u2 = (rng.uniform(0, 1, N).astype(np.float32) for _ in range(2))
    got = sampling.sample_uniform_hemisphere_local(torch.from_numpy(u1),
                                                   torch.from_numpy(u2))
    _close(got, jsampling.sample_uniform_hemisphere_local(jnp.asarray(u1),
                                                          jnp.asarray(u2)))


def _envs():
    sky = procedural_sky(32, 64)
    return (envmap.build_envmap(sky, alias=True, device="cpu"),
            jenv.build_envmap(jnp.asarray(sky), alias=True))


@pytest.mark.parametrize("name", ["envmap_lookup", "envmap_pdf",
                                  "bilinear_lookup_quads",
                                  "bilinear_lookup_quads_v"])
def test_envmap_array_forms(name):
    pe, je = _envs()
    rng = np.random.default_rng(13)
    dirs = _unit(rng, N)
    dirs[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
                [0, 0, -1], [-1, 0, 1e-7], [-1, 0, -1e-7]]  # poles, seam
    p, j = _pair(dirs.astype(np.float32))
    if name in ("envmap_lookup", "envmap_pdf"):
        got = getattr(envmap, name)(pe, p)
        _close(got, getattr(jenv, name)(je, j))
        comp = (envmap.envmap_lookup_v(pe, V3.of(p)).rows()
                if name == "envmap_lookup" else
                envmap.envmap_pdf_v(pe, V3.of(p)))
        assert torch.equal(got, comp)
        return
    u = rng.uniform(-0.2, 1.2, N).astype(np.float32)  # the wrap, the clamp
    v = rng.uniform(-0.2, 1.2, N).astype(np.float32)
    (pu, ju), (pv, jv) = _pair(u), _pair(v)
    got = getattr(envmap, name)(pe.quad12, pu, pv)
    _close(got, getattr(jenv, name)(je.quad12, ju, jv))
    rows = envmap.bilinear_lookup_quads(pe.quad12, pu, pv)
    np.testing.assert_allclose(rows.numpy(), envmap.bilinear_lookup(
        pe.image, pu, pv).numpy(), rtol=1e-5, atol=1e-6)


def _shading_rows(seed, lobe):
    """[N, 3] inputs of the BRDF functions for both packages: normal, view,
    light directions, the tangent frame, per-ray materials with a random
    base color."""
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    v = _unit(rng, N, upper=n)
    l = _unit(rng, N, upper=n)
    pm, jm = _materials(rng, N, *LOBES[lobe])
    cd = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    pm.base_color, jm = torch.from_numpy(cd), jm.replace(
        base_color=jnp.asarray(cd))
    (pn, jn), (pv, jv), (pl, jl) = _pair(n), _pair(v), _pair(l)
    pt, pb = pmath.build_tangent_space(pn)
    jt, jb = jmath.build_tangent_space(jn)
    return rng, (pn, pv, pl, pt, pb, pm), (jn, jv, jl, jt, jb, jm)


def _direction_extra(l_ref, v_ref, n_ref):
    """The float64 bound's allowance for a sampled direction [N, 3]: 4 ulp
    over the sine sqrt(1 - (h.n)^2) whose cancellation built it."""
    h = l_ref + v_ref
    cos_h = (h / h.norm(dim=-1, keepdim=True) * n_ref).sum(-1)
    sine = (1.0 - cos_h * cos_h).clamp_min(0.0).sqrt()
    return (SINE_ULPS * EPS32 / sine.clamp_min(1e-3))[:, None]


@pytest.mark.parametrize("lobe", sorted(LOBES))
@pytest.mark.parametrize("name", ["disney_eval", "disney_pdf",
                                  "sample_gtr1_dir", "sample_gtr2_dir",
                                  "disney_sample"])
def test_brdf_array_forms(name, lobe):
    rng, (pn, pv, pl, pt, pb, pm), (jn, jv, jl, jt, jb, jm) = _shading_rows(
        20, lobe)
    if name in ("disney_eval", "disney_pdf"):
        args = ((pv, pn, pl, pt, pb, pm) if name == "disney_eval"
                else (pv, pn, pl, pm))
        jargs = ((jv, jn, jl, jt, jb, jm) if name == "disney_eval"
                 else (jv, jn, jl, jm))
        got = getattr(brdf, name)(*args)
        _hold_both(name, getattr(brdf, name), args,
                   getattr(jbrdf, name)(*jargs))
        comp = (brdf.disney_eval_v(*map(V3.of, (pv, pn, pl, pt, pb)), pm,
                                   V3.of(pm.base_color)).rows()
                if name == "disney_eval" else
                brdf.disney_pdf_v(*map(V3.of, (pv, pn, pl)), pm))
        assert torch.equal(got, comp)
        return
    us = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(5)]
    pu = [torch.from_numpy(u) for u in us]
    ju = [jnp.asarray(u) for u in us]
    f64 = lambda a: a.double()
    if name != "disney_sample":
        alpha = rng.uniform(0.05, 0.9, N).astype(np.float32)
        args = (pn, pt, pb, pv, pu[0], pu[1], torch.from_numpy(alpha))
        got = getattr(brdf, name)(*args)
        want = np.array(getattr(jbrdf, name)(jn, jt, jb, jv, ju[0], ju[1],
                                               jnp.asarray(alpha)))
        (ref,), (cond,) = _reference(getattr(brdf, name), args)
        extra = _direction_extra(ref, f64(pv), f64(pn))
        _assert_within(name + " port", got, ref, cond, extra)
        _assert_within(name + " jax", torch.from_numpy(want), ref, cond,
                       extra)
        return
    args = (pv, pn, pt, pb, pm, *pu)
    l, pdf, lobe_id = brdf.disney_sample(*args)
    jl_, jpdf, jlobe = jbrdf.disney_sample(jv, jn, jt, jb, jm, *ju)
    np.testing.assert_array_equal(lobe_id.numpy(), np.asarray(jlobe))
    assert set(np.unique(lobe_id.numpy())) == {0, 1, 2}
    (l_ref, _, lobe_ref), (l_cond, _, _) = _reference(brdf.disney_sample,
                                                      args)
    assert torch.equal(lobe_id, lobe_ref)
    extra = torch.where((lobe_ref == 0)[:, None],
                        SINE_ULPS * EPS32 / (l_ref * f64(pn)).sum(-1,
                            keepdim=True).clamp_min(1e-3),
                        _direction_extra(l_ref, f64(pv), f64(pn)))
    jl_t = torch.from_numpy(np.array(jl_))
    _assert_within("l port", l, l_ref, l_cond, extra)
    _assert_within("l jax", jl_t, l_ref, l_cond, extra)
    for label, ll, pp in (("port", l, pdf),
                          ("jax", jl_t, torch.from_numpy(np.array(jpdf)))):
        (ref,), (cond,) = _reference(brdf.disney_pdf, (pv, pn, ll, pm))
        _assert_within("sample pdf " + label, pp, ref, cond)
    comp = brdf.disney_sample_v(*map(V3.of, (pv, pn, pt, pb)), pm, *pu)
    assert torch.equal(comp[0].rows(), l) and torch.equal(comp[1], pdf)
