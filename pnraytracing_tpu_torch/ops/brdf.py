"""Disney principled BRDF: evaluation, lobe sampling, pdf.

PyTorch counterpart of the component forms of
``pnraytracing_tpu/ops/brdf.py`` (ray_tracing.comp:649-849) over per-ray
material records whose scalar fields are [R] tensors
(``Materials.gather_components``), and their ``[..., 3]`` forms
(``disney_eval``, ``disney_pdf``, ``disney_sample``, ``sample_gtr1_dir``,
``sample_gtr2_dir``), as the JAX package wraps them.  ``compat=True``
reproduces the reference's quirks as the JAX package does: the material
decode, the unclamped pdf, the GTR half vector without its square roots
and the cosine-hemisphere sample that reads u1 as an angle.
"""

from __future__ import annotations

import dataclasses

import torch

from pnraytracing_tpu_torch.core.math import (
    INV_PI,
    PI,
    TWO_PI,
    clip,
    maximum,
    mix,
    safe_sqrt,
    sqr,
)
from pnraytracing_tpu_torch.core.types import Materials
from pnraytracing_tpu_torch.core.vec import (
    V3,
    tangent_to_world_v,
    vdot,
    vluminance,
    vmix,
    vnormalize,
    vreflect,
    vwhere,
)

_EPS = 1e-10


def schlick_fresnel(u):
    m = clip(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def gtr1(ndoth, a):
    a2 = sqr(a)
    t = 1.0 + (a2 - 1.0) * sqr(ndoth)
    val = (a2 - 1.0) / (PI * torch.log(maximum(a2, _EPS))
                        * maximum(t, _EPS))
    return torch.where(a >= 1.0, INV_PI, val)


def gtr2(ndoth, a):
    a2 = sqr(a)
    t = 1.0 + (a2 - 1.0) * sqr(ndoth)
    return a2 / (PI * maximum(sqr(t), _EPS))


def gtr2_aniso(ndoth, hdotx, hdoty, ax, ay):
    denom = PI * ax * ay * sqr(sqr(hdotx / ax) + sqr(hdoty / ay) + sqr(ndoth))
    return 1.0 / maximum(denom, _EPS)


def smith_g_ggx(ndotv, alpha_g: float):
    a = sqr(alpha_g)
    b = sqr(ndotv)
    return 1.0 / maximum(ndotv + safe_sqrt(a + b - a * b), _EPS)


def smith_g_ggx_aniso(ndotv, vdotx, vdoty, ax, ay):
    denom = ndotv + safe_sqrt(sqr(vdotx * ax) + sqr(vdoty * ay) + sqr(ndotv))
    return 1.0 / maximum(denom, _EPS)


def clearcoat_alpha(m: Materials):
    return mix(0.1, 0.001, m.clearcoat_gloss)


def specular_alpha(m: Materials):
    return maximum(sqr(m.roughness), 0.001)


def apply_compat_material_decode(m: Materials) -> Materials:
    """The reference's buffer decode reads param row 3 where row 4 was
    meant (ray_tracing.comp:139-142): clearcoat_gloss = sheen, ior =
    sheen_tint, transmission = clearcoat.  A new record over the same
    tensors; nothing is written into ``m``."""
    return dataclasses.replace(m, clearcoat_gloss=m.sheen, ior=m.sheen_tint,
                               transmission=m.clearcoat)


def disney_eval_v(v: V3, n: V3, l: V3, x: V3, y: V3, m: Materials,
                  cdlin: V3) -> V3:
    """f(V, L) — DisneyBRDF (comp:788-849).  ``cdlin`` is the base color."""
    ndotl = vdot(n, l)
    ndotv = vdot(n, v)
    valid = (ndotl >= 0) & (ndotv >= 0)

    h = vnormalize(l + v)
    ndoth = vdot(n, h)
    ldoth = vdot(l, h)

    cdlum = vluminance(cdlin)
    safe_lum = maximum(cdlum, _EPS)
    ones = torch.ones_like(cdlum)
    one = V3(ones, ones, ones)
    ctint = vwhere(cdlum > 0, cdlin / safe_lum, one)
    cspec = vmix(one, ctint, m.specular_tint) * m.specular
    cspec0 = vmix(cspec * 0.08, cdlin, m.metallic)
    csheen = vmix(one, ctint, m.sheen_tint)

    # diffuse retro-reflection
    fd90 = 0.5 + 2.0 * sqr(ldoth) * m.roughness
    fl = schlick_fresnel(ndotl)
    fv = schlick_fresnel(ndotv)
    fd = mix(1.0, fd90, fl) * mix(1.0, fd90, fv)

    # Hanrahan-Krueger subsurface approximation
    fss90 = sqr(ldoth) * m.roughness
    fss = mix(1.0, fss90, fl) * mix(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / maximum(ndotl + ndotv, _EPS) - 0.5)
                 + 0.5)

    # anisotropic specular
    aspect = safe_sqrt(1.0 - m.anisotropic * 0.9)
    ax = maximum(sqr(m.roughness) / maximum(aspect, _EPS),
                         0.001)
    ay = maximum(sqr(m.roughness) * aspect, 0.001)
    ds = gtr2_aniso(ndoth, vdot(h, x), vdot(h, y), ax, ay)
    fh = schlick_fresnel(ldoth)
    fs = vmix(cspec0, one, fh)
    gs = smith_g_ggx_aniso(ndotl, vdot(l, x), vdot(l, y), ax, ay)
    gs = gs * smith_g_ggx_aniso(ndotv, vdot(v, x), vdot(v, y), ax, ay)

    # clearcoat
    dr = gtr1(ndoth, clearcoat_alpha(m))
    fr = mix(0.04, 1.0, fh)
    gr = smith_g_ggx(ndotl, 0.25) * smith_g_ggx(ndotv, 0.25)

    fsheen = csheen * (fh * m.sheen)

    diffuse = cdlin * (INV_PI * mix(fd, ss, m.subsurface)) + fsheen
    specular = fs * (gs * ds)
    clearcoat = one * (0.25 * gr * fr * dr * m.clearcoat)

    out = diffuse * (1.0 - m.metallic) + specular + clearcoat
    zero = torch.zeros_like(ndotl)
    return vwhere(valid, out, V3(zero, zero, zero))


def disney_eval(v: torch.Tensor, n: torch.Tensor, l: torch.Tensor,
                x: torch.Tensor, y: torch.Tensor,
                m: Materials) -> torch.Tensor:
    """[..., 3] form of :func:`disney_eval_v`, the base color taken from
    ``m.base_color``."""
    return disney_eval_v(V3.of(v), V3.of(n), V3.of(l), V3.of(x), V3.of(y),
                         m, V3.of(m.base_color)).rows()


def lobe_probs(m: Materials):
    """Lobe selection probabilities (comp:748-755)."""
    r_diffuse = 1.0 - m.metallic
    r_specular = torch.ones_like(m.metallic)
    r_clearcoat = 0.25 * m.clearcoat
    inv = 1.0 / (r_diffuse + r_specular + r_clearcoat)
    return r_diffuse * inv, r_specular * inv, r_clearcoat * inv


def disney_pdf_v(v: V3, n: V3, l: V3, m: Materials,
                 compat: bool = False) -> torch.Tensor:
    """Combined lobe pdf of direction l (comp:710-738), clamped >= 0
    (unclamped with ``compat``, as in the reference)."""
    p_diff, p_spec, p_cc = lobe_probs(m)
    a_gtr1 = clearcoat_alpha(m)
    a_gtr2 = specular_alpha(m)

    h = vnormalize(l + v)
    ldoth = vdot(l, h)
    ndoth = vdot(n, h)
    ndotl = vdot(n, l)

    pdf_diffuse = ndotl * INV_PI
    denom = 4.0 * ldoth
    safe = torch.where(torch.abs(denom) < _EPS, _EPS, denom)
    pdf_spec = gtr2(ndoth, a_gtr2) * ndoth / safe
    pdf_cc = gtr1(ndoth, a_gtr1) * ndoth / safe

    pdf = p_diff * pdf_diffuse + p_spec * pdf_spec + p_cc * pdf_cc
    return pdf if compat else maximum(pdf, 0.0)


def disney_pdf(v: torch.Tensor, n: torch.Tensor, l: torch.Tensor,
               m: Materials, compat: bool = False) -> torch.Tensor:
    """[..., 3] form of :func:`disney_pdf_v`."""
    return disney_pdf_v(V3.of(v), V3.of(n), V3.of(l), m, compat)


def _sample_h_local_v(r1, cos_theta_h, compat: bool = False) -> V3:
    """Half-vector construction of the GTR lobes (comp:688-692); with
    ``compat`` the reference's sin_theta = 1 - cos^2 and cos_phi = 1 -
    sin^2, without the square roots."""
    phi_h = TWO_PI * r1
    sin_phi_h = torch.sin(phi_h)
    if compat:
        sin_theta_h = maximum(1.0 - sqr(cos_theta_h), 0.0)
        cos_phi_h = 1.0 - sqr(sin_phi_h)
    else:
        sin_theta_h = safe_sqrt(1.0 - sqr(cos_theta_h))
        cos_phi_h = torch.cos(phi_h)
    return V3(sin_theta_h * cos_phi_h, sin_theta_h * sin_phi_h, cos_theta_h)


def sample_gtr2_dir_v(n, t, b, v, r1, r2, alpha, compat: bool = False) -> V3:
    """Specular lobe direction (SampleGTR2, comp:687-695)."""
    cos_theta_h = safe_sqrt(
        (1.0 - r2) / maximum(1.0 + (sqr(alpha) - 1.0) * r2, _EPS))
    h = tangent_to_world_v(t, b, n, _sample_h_local_v(r1, cos_theta_h,
                                                      compat))
    return vreflect(v, h)


def sample_gtr1_dir_v(n, t, b, v, r1, r2, alpha, compat: bool = False) -> V3:
    """Clearcoat lobe direction (SampleGTR1, comp:698-707)."""
    a2 = sqr(alpha)
    cos_theta_h = safe_sqrt(
        (1.0 - torch.pow(a2, 1.0 - r2)) / maximum(1.0 - a2, _EPS))
    h = tangent_to_world_v(t, b, n, _sample_h_local_v(r1, cos_theta_h,
                                                      compat))
    return vreflect(v, h)


def sample_gtr2_dir(n, t, b, v, r1, r2, alpha,
                    compat: bool = False) -> torch.Tensor:
    """[..., 3] form of :func:`sample_gtr2_dir_v`."""
    return sample_gtr2_dir_v(V3.of(n), V3.of(t), V3.of(b), V3.of(v), r1, r2,
                             alpha, compat).rows()


def sample_gtr1_dir(n, t, b, v, r1, r2, alpha,
                    compat: bool = False) -> torch.Tensor:
    """[..., 3] form of :func:`sample_gtr1_dir_v`."""
    return sample_gtr1_dir_v(V3.of(n), V3.of(t), V3.of(b), V3.of(v), r1, r2,
                             alpha, compat).rows()


def sample_cosine_hemisphere_local_v(u1, u2, compat: bool = False) -> V3:
    """Cosine-weighted hemisphere sample (local frame); with ``compat``
    the reference's SampleCosineHemisphere (comp:642-647), which reads u1
    as an angle in radians and u2 as the radius."""
    if compat:
        x = u2 * torch.sin(u1)
        y = u2 * torch.cos(u1)
    else:
        rr = safe_sqrt(u1)
        phi = TWO_PI * u2
        x = rr * torch.cos(phi)
        y = rr * torch.sin(phi)
    return V3(x, y, safe_sqrt(1.0 - x * x - y * y))


def disney_sample_v(v: V3, n: V3, t: V3, b: V3, m: Materials, r_lobe, r1,
                    r2, u_diff1, u_diff2, compat: bool = False):
    """Sample an outgoing direction and its pdf (SampleDisneyBRDF,
    comp:742-786): ``r_lobe`` picks diffuse / specular / clearcoat,
    ``(r1, r2)`` drive the GTR half-vector lobes, ``(u_diff1, u_diff2)``
    the diffuse hemisphere; ``compat`` the reference's forms of each.
    Returns (l V3, pdf, lobe int32)."""
    p_diff, p_spec, _ = lobe_probs(m)
    a_gtr1 = clearcoat_alpha(m)
    a_gtr2 = specular_alpha(m)

    l_diff = tangent_to_world_v(
        t, b, n, sample_cosine_hemisphere_local_v(u_diff1, u_diff2, compat))
    l_spec = sample_gtr2_dir_v(n, t, b, v, r1, r2, a_gtr2, compat)
    l_cc = sample_gtr1_dir_v(n, t, b, v, r1, r2, a_gtr1, compat)

    take_diff = r_lobe <= p_diff
    take_spec = (~take_diff) & (r_lobe <= p_diff + p_spec)
    l = vwhere(take_diff, l_diff, vwhere(take_spec, l_spec, l_cc))
    pdf = disney_pdf_v(v, n, l, m, compat)
    lobe = torch.where(take_diff, 0, torch.where(take_spec, 1, 2)).to(
        torch.int32)
    return l, pdf, lobe


def disney_sample(v: torch.Tensor, n: torch.Tensor, t: torch.Tensor,
                  b: torch.Tensor, m: Materials, r_lobe, r1, r2, u_diff1,
                  u_diff2, compat: bool = False):
    """[..., 3] form of :func:`disney_sample_v`: (l [..., 3], pdf, lobe)."""
    l, pdf, lobe = disney_sample_v(V3.of(v), V3.of(n), V3.of(t), V3.of(b), m,
                                   r_lobe, r1, r2, u_diff1, u_diff2, compat)
    return l.rows(), pdf, lobe
