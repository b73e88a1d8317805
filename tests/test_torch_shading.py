"""Shading ops — the Disney BRDF and the environment map — against the JAX
package on random inputs made with numpy.

Tolerance of the BRDF tests.  The two frameworks' sin, cos, log, pow and
rsqrt differ in the last bits, and the formulas amplify a last-bit
change: a GTR peak scales a change of n.h by about 4/alpha^2 (clearcoat
alpha reaches 0.001, and the combined pdf carries the clearcoat term
whichever lobe was picked), 1/(4 l.h) grows at grazing angles, and
sqrt(1 - c^2) loses the bits of c near 1.  How many values land outside
a fixed rtol therefore depends on the machine's libm and CPU, so no count
of such values is tested.  Instead both packages are held, value by
value, against the port's own formula evaluated in float64 on the same
float32 inputs, within

    atol 1e-6 + rtol 1e-5 * |ref| + 4 * cond

where ``cond`` is what amplifies: the largest change of the float64
result over six copies of the inputs with every component moved by 2
float32 ulps at random.  Sampled directions add 4 ulps over the sine
whose cancellation built them (sin(theta_h) of the GTR lobes, n.l of the
cosine lobe).  A sampled direction's pdf is held against the float64 pdf
at that direction.  Measured on an AMD EPYC host (XLA:CPU against
torch's CPU kernels) on seeds 0-5, the worst value of either package
uses 0.66 of that bound (the JAX package's pdf; the port's 0.19), 0.54
on a sampled direction's pdf, 0.38 on a sampled direction and 0.11 on
the BRDF value.  The bound stays tight: its median is below 1.5e-4 of
the value (asserted; measured 2.5e-5 to 9.8e-5), so a wrong formula
fails in either package: ``test_wrong_constant_trips_the_check`` moves
one constant of the port by 0.1-0.2% and expects the check of the pdf,
of the BRDF value and of the sampled direction and its pdf to trip, on
both lobe classes.  The
tangent frames and the environment map are held within rtol 1e-5 / atol
1e-6 outright.
"""

import dataclasses

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
EPS32 = float(np.finfo(np.float32).eps)
COND_FACTOR = 4.0  # the bound's multiple of the measured amplification
SINE_ULPS = 4.0  # of a sampled direction, over the sine that built it
PERTURB_ULPS, PERTURB_COPIES = 2.0, 6


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


def _close(got, want):
    """Every value within TOL."""
    pairs = (zip((got.x, got.y, got.z), (want.x, want.y, want.z))
             if isinstance(got, V3) else [(got, want)])
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _tmap(obj, f):
    """``f`` over the float tensors of a tensor, V3 or Materials."""
    if isinstance(obj, torch.Tensor):
        return f(obj) if obj.is_floating_point() else obj
    if isinstance(obj, V3):
        return V3(f(obj.x), f(obj.y), f(obj.z))
    return dataclasses.replace(obj, **{
        fl.name: f(getattr(obj, fl.name)) for fl in dataclasses.fields(obj)
        if isinstance(getattr(obj, fl.name), torch.Tensor)})


def _stacked(out):
    """A function's outputs as a list of tensors (a V3 as [3, N])."""
    outs = out if isinstance(out, tuple) else (out,)
    return [torch.stack([o.x, o.y, o.z]) if isinstance(o, V3) else o
            for o in outs]


def _jax_stacked(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [torch.from_numpy(np.stack([np.array(c) for c in (o.x, o.y, o.z)])
                             if isinstance(o, JV3) else np.array(o))
            for o in outs]


def _reference(fn, args):
    """(ref, cond): ``fn`` of the port in float64 on ``args``, and the
    largest change of each output over PERTURB_COPIES copies of the
    inputs with every float moved by +-PERTURB_ULPS float32 ulps."""
    gen = torch.Generator().manual_seed(0)
    args64 = [_tmap(a, torch.Tensor.double) for a in args]
    ref = _stacked(fn(*args64))
    cond = [torch.zeros_like(r, dtype=torch.float64) for r in ref]

    def moved(t):
        sign = torch.randint(0, 2, t.shape, generator=gen) * 2 - 1
        return t * (1.0 + PERTURB_ULPS * EPS32 * sign)

    for _ in range(PERTURB_COPIES):
        out = _stacked(fn(*[_tmap(a, moved) for a in args64]))
        cond = [torch.maximum(c, (o.double() - r.double()).abs())
                for c, o, r in zip(cond, out, ref)]
    return ref, cond


def _assert_within(name, got, ref, cond, extra=0.0):
    """The module docstring's bound on one float output; returns the
    share of the bound the worst value uses."""
    tol = 1e-6 + 1e-5 * ref.abs() + COND_FACTOR * cond + extra
    share = (got.double() - ref).abs() / tol
    worst = int(share.argmax())
    assert float(share.max()) <= 1.0, (
        f"{name}: value {worst} is {float(share.flatten()[worst]):.3g} "
        f"times its bound ({int((share > 1).sum())} of {share.numel()} "
        "outside)")
    tight = float((tol / ref.abs().clamp_min(1e-6)).median())
    assert tight <= 1.5e-4, f"{name}: the bound is loose (median {tight:.3g})"
    return float(share.max())


def _hold_both(name, fn, args, jax_out):
    """Both packages' ``fn`` against its float64 reference, output by
    output; integer outputs exact."""
    ref, cond = _reference(fn, args)
    for k, (r, c, g, j) in enumerate(zip(ref, cond, _stacked(fn(*args)),
                                         _jax_stacked(jax_out))):
        if not r.is_floating_point():
            assert torch.equal(g, r) and torch.equal(j.to(r.dtype), r)
            continue
        _assert_within(f"{name}[{k}] port", g, r, c)
        _assert_within(f"{name}[{k}] jax", j, r, c)


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


def _hold_eval_and_pdf(seed, lobe, checks=("frames", "eval", "pdf")):
    _, (pn, pv, pl, pcd, pm), (jn, jv, jl, jcd, jm) = _shading_inputs(
        seed, lobe)
    pt, pb = build_tangent_space_v(pn)
    jt, jb = jax_tangents(jn)
    if "frames" in checks:
        _close(pt, jt)
        _close(pb, jb)
    if "eval" in checks:
        _hold_both("eval", brdf.disney_eval_v, (pv, pn, pl, pt, pb, pm, pcd),
                   jbrdf.disney_eval_v(jv, jn, jl, jt, jb, jm, jcd))
    if "pdf" in checks:
        _hold_both("pdf", brdf.disney_pdf_v, (pv, pn, pl, pm),
                   jbrdf.disney_pdf_v(jv, jn, jl, jm))


def _hold_sample(seed, lobe):
    rng, (pn, pv, _, _, pm), (jn, jv, _, _, jm) = _shading_inputs(
        seed, lobe)
    pt, pb = build_tangent_space_v(pn)
    jt, jb = jax_tangents(jn)
    us = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(5)]
    args = (pv, pn, pt, pb, pm, *map(torch.from_numpy, us))
    l, pdf, picked = brdf.disney_sample_v(*args)
    jl, jpdf, jpicked = jbrdf.disney_sample_v(jv, jn, jt, jb, jm,
                                              *map(jnp.asarray, us))
    np.testing.assert_array_equal(picked.numpy(), np.asarray(jpicked))
    assert set(np.unique(picked.numpy())) == {0, 1, 2}

    # the direction: what amplifies is the sine built as sqrt(1 - c^2)
    (l_ref, _, picked_ref), (l_cond, _, _) = _reference(
        brdf.disney_sample_v, args)
    assert torch.equal(picked, picked_ref)
    v64, n64 = (_stacked(_tmap(a, torch.Tensor.double))[0] for a in (pv, pn))
    h = l_ref + v64
    cos_h = (h / h.norm(dim=0) * n64).sum(0)
    sine = torch.where(picked_ref == 0, (l_ref * n64).sum(0),
                       (1.0 - cos_h * cos_h).clamp_min(0.0).sqrt())
    extra = SINE_ULPS * EPS32 / sine.clamp_min(1e-3)
    jl_t, jpdf_t, _ = _jax_stacked((jl, jpdf, jpicked))
    _assert_within("l port", _stacked(l)[0], l_ref, l_cond, extra)
    _assert_within("l jax", jl_t, l_ref, l_cond, extra)

    # each package's pdf against the float64 pdf at its own direction
    for name, ll, pp in (("port", l, pdf),
                         ("jax", V3(*jl_t.unbind(0)), jpdf_t)):
        (ref,), (cond,) = _reference(brdf.disney_pdf_v, (pv, pn, ll, pm))
        _assert_within("sample pdf " + name, pp, ref, cond)


@pytest.mark.parametrize("lobe", sorted(LOBES))
@pytest.mark.parametrize("seed", [0, 1])
def test_disney_eval_and_pdf(seed, lobe):
    _hold_eval_and_pdf(seed, lobe)


@pytest.mark.parametrize("lobe", sorted(LOBES))
@pytest.mark.parametrize("seed", [2, 3])
def test_disney_sample(seed, lobe):
    _hold_sample(seed, lobe)


# one constant of the port's formulas moved by 0.1-0.2% each
MOVED_CONSTANTS = {
    "inv_pi": ("INV_PI", brdf.INV_PI * 1.001),
    "clearcoat_alpha": ("clearcoat_alpha", lambda m: brdf.mix(
        0.1002, 0.001, m.clearcoat_gloss)),
    "specular_alpha": ("specular_alpha", lambda m: torch.clamp_min(
        brdf.sqr(m.roughness) * 1.002, 0.001)),
}
CHECKS = {"pdf": lambda lobe: _hold_eval_and_pdf(0, lobe, ("pdf",)),
          "eval": lambda lobe: _hold_eval_and_pdf(0, lobe, ("eval",)),
          "sample": lambda lobe: _hold_sample(2, lobe)}


@pytest.mark.parametrize("lobe", sorted(LOBES))
@pytest.mark.parametrize("check,constant", [
    ("pdf", "inv_pi"), ("pdf", "clearcoat_alpha"), ("pdf", "specular_alpha"),
    ("eval", "inv_pi"), ("eval", "clearcoat_alpha"),
    ("sample", "inv_pi"), ("sample", "clearcoat_alpha"),
    ("sample", "specular_alpha")])
def test_wrong_constant_trips_the_check(check, constant, lobe, monkeypatch):
    """The bound is no blanket: with one constant of the port's formula
    off by 0.1-0.2%, the JAX package no longer meets the (now wrong)
    float64 reference and the check fails: the pdf, the BRDF value (which
    does not read specular_alpha) and the sampled direction with its pdf,
    on both lobe classes."""
    CHECKS[check](lobe)
    monkeypatch.setattr(brdf, *MOVED_CONSTANTS[constant])
    with pytest.raises(AssertionError, match="jax: value .* times its bound"):
        CHECKS[check](lobe)


def _envs():
    sky = procedural_sky(32, 64)
    return (envmap.build_envmap(sky, alias=True, device="cpu"),
            jenv.build_envmap(jnp.asarray(sky), alias=True))


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
