"""Shading ops — the Disney BRDF and the environment map — against the JAX
package on random inputs made with numpy.

Tolerance: the two frameworks' sin, cos, log, pow and rsqrt differ in
the last bits, and the GTR lobe peaks scale a last-bit change of n.h by
about 4/alpha^2 (clearcoat alpha reaches 0.001).  So for roughness
>= 0.5 and clearcoat gloss <= 0.5, at least 99% of the values must agree
within rtol 1e-5 / atol 1e-6 and every value within rtol 1e-2; for
glossy lobes the median relative difference must stay below 1e-5 and
every value within rtol 0.2.  A wrong formula moves most values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.types import Materials as JaxMaterials
from pnraytracing_tpu.core.vec import V3 as JV3
from pnraytracing_tpu.core.vec import build_tangent_space_v as jax_tangents
from pnraytracing_tpu.io.hdr import procedural_sky
from pnraytracing_tpu.ops import brdf as jbrdf
from pnraytracing_tpu.ops import envmap as jenv
from pnraytracing_tpu_torch.core.types import Materials
from pnraytracing_tpu_torch.core.vec import V3, build_tangent_space_v
from pnraytracing_tpu_torch.ops import brdf, envmap
from tests.test_torch_scene import _torch_threads  # noqa: F401

N = 2048
TOL = dict(rtol=1e-5, atol=1e-6)


def _unit(rng, n, upper=None):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if upper is not None:  # flip into the hemisphere around `upper`
        d = np.where(((d * upper).sum(1) < 0)[:, None], -d, d)
    return d.astype(np.float32)


def _both_v3(a):
    return (V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                 for k in range(3))),
            JV3(*(jnp.asarray(a[:, k]) for k in range(3))))


def _close(got, want, glossy=None):
    """``glossy=None``: every value within TOL; else the lobe rule of the
    module docstring."""
    pairs = (zip((got.x, got.y, got.z), (want.x, want.y, want.z))
             if isinstance(got, V3) else [(got, want)])
    for g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        if glossy is None:
            np.testing.assert_allclose(g, w, **TOL)
            continue
        if glossy:
            rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-6)
            assert np.median(rel) <= 1e-5, np.median(rel)
        else:
            off = ~np.isclose(g, w, **TOL)
            assert off.mean() <= 0.01, f"{off.sum()} of {off.size} off"
        np.testing.assert_allclose(g, w, rtol=0.2 if glossy else 1e-2,
                                   atol=1e-6)


# (roughness range, clearcoat-gloss range) of each lobe class
LOBES = {"rough": ((0.5, 1.0), (0.0, 0.5)),
         "glossy": ((0.2, 0.5), (0.5, 1.0))}


def _materials(rng, n, rough, gloss):
    """Per-ray material records ([R] leaves) for both packages."""
    vals = dict(
        subsurface=rng.uniform(0, 1, n), metallic=rng.uniform(0, 1, n),
        specular=rng.uniform(0, 1, n), specular_tint=rng.uniform(0, 1, n),
        roughness=rng.uniform(*rough, n), anisotropic=rng.uniform(0, 0.8, n),
        sheen=rng.uniform(0, 1, n), sheen_tint=rng.uniform(0, 1, n),
        clearcoat=rng.uniform(0, 1, n),
        clearcoat_gloss=rng.uniform(*gloss, n), ior=rng.uniform(1, 2, n),
        transmission=np.zeros(n))
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    zero = np.zeros(n, np.float32)
    port = Materials(emissive=torch.from_numpy(zero),
                     base_color=torch.from_numpy(zero),
                     **{k: torch.from_numpy(v) for k, v in vals.items()})
    jax_m = JaxMaterials(emissive=jnp.asarray(zero),
                         base_color=jnp.asarray(zero),
                         **{k: jnp.asarray(v) for k, v in vals.items()})
    return port, jax_m


def _shading_inputs(seed, lobe):
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    v = _unit(rng, N, upper=n)
    l = _unit(rng, N, upper=n)
    (pn, jn), (pv, jv), (pl, jl) = _both_v3(n), _both_v3(v), _both_v3(l)
    cd = rng.uniform(0, 1, size=(N, 3)).astype(np.float32)
    pcd, jcd = _both_v3(cd)
    pm, jm = _materials(rng, N, *LOBES[lobe])
    return rng, (pn, pv, pl, pcd, pm), (jn, jv, jl, jcd, jm)


@pytest.mark.parametrize("lobe", sorted(LOBES))
@pytest.mark.parametrize("seed", [0, 1])
def test_disney_eval_and_pdf(seed, lobe):
    _, (pn, pv, pl, pcd, pm), (jn, jv, jl, jcd, jm) = _shading_inputs(
        seed, lobe)
    pt, pb = build_tangent_space_v(pn)
    jt, jb = jax_tangents(jn)
    _close(pt, jt)
    _close(pb, jb)
    _close(brdf.disney_eval_v(pv, pn, pl, pt, pb, pm, pcd),
           jbrdf.disney_eval_v(jv, jn, jl, jt, jb, jm, jcd),
           lobe == "glossy")
    _close(brdf.disney_pdf_v(pv, pn, pl, pm),
           jbrdf.disney_pdf_v(jv, jn, jl, jm), lobe == "glossy")


@pytest.mark.parametrize("lobe", sorted(LOBES))
@pytest.mark.parametrize("seed", [2, 3])
def test_disney_sample(seed, lobe):
    rng, (pn, pv, _, _, pm), (jn, jv, _, _, jm) = _shading_inputs(
        seed, lobe)
    pt, pb = build_tangent_space_v(pn)
    jt, jb = jax_tangents(jn)
    us = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(5)]
    l, pdf, picked = brdf.disney_sample_v(pv, pn, pt, pb, pm,
                                          *map(torch.from_numpy, us))
    jl, jpdf, jpicked = jbrdf.disney_sample_v(jv, jn, jt, jb, jm,
                                              *map(jnp.asarray, us))
    np.testing.assert_array_equal(picked.numpy(), np.asarray(jpicked))
    assert set(np.unique(picked.numpy())) == {0, 1, 2}
    _close(l, jl, lobe == "glossy")
    _close(pdf, jpdf, lobe == "glossy")


def _envs():
    sky = procedural_sky(32, 64)
    return envmap.build_envmap(sky, device="cpu"), jenv.build_envmap(
        jnp.asarray(sky), alias=True)


def test_envmap_tables_exact():
    pe, je = _envs()
    for f in ("image", "pdf_xy", "cdf_marginal_x", "cdf_y_given_x",
              "alias_x", "alias_y", "alias_fat", "quad12"):
        np.testing.assert_array_equal(getattr(pe, f).numpy(),
                                      np.asarray(getattr(je, f)), err_msg=f)


def test_envmap_sample_lookup_pdf():
    pe, je = _envs()
    rng = np.random.default_rng(5)
    u1 = rng.uniform(0, 1, N).astype(np.float32)
    u2 = rng.uniform(0, 1, N).astype(np.float32)
    d, li, pdf = envmap.sample_envmap_v(pe, torch.from_numpy(u1),
                                        torch.from_numpy(u2))
    jd, jli, jpdf = jenv.sample_envmap_v(je, jnp.asarray(u1),
                                         jnp.asarray(u2))
    _close(d, jd)
    _close(li, jli)
    _close(pdf, jpdf)
    dirs = _unit(rng, N)
    dirs[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
                [0, 0, -1], [-1, 0, 1e-7], [-1, 0, -1e-7]]  # poles, seam
    pd, jd = _both_v3(dirs.astype(np.float32))
    _close(envmap.envmap_lookup_v(pe, pd), jenv.envmap_lookup_v(je, jd))
    _close(envmap.envmap_pdf_v(pe, pd), jenv.envmap_pdf_v(je, jd))
