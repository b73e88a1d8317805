"""A plain PyTorch path tracer: the estimator the program computes, for
any set of pixels, written out once without kernels, sorting, tiling or
captured programs.

It follows the upstream compute shader (``ray_tracing.comp``) as the
program's configuration runs it: one pinhole ray through each pixel's
corner, the Disney principled BRDF, next-event estimation of one
area-light point (picked in proportion to area) and one environment
texel (Walker alias tables), the one-sample MIS combine of the shader,
the BRDF lobe sample with a Sobol pair and a per-pixel Cranley-Patterson
rotation, the wang-hash streams seeded by pixel and frame, and the
radiance clamped to [0, 1] per sample.  Surfaces take their position,
normal and material from the hit triangle by its barycentrics, derived
again by intersecting that one triangle (differentiably, so gradients
reach the materials and the environment texels as they do in the
program's replay); the environment is fetched bilinearly.  Every float
is held in ``scene.dtype``, so the same code is the lower-precision
control.  It covers the settings the benchmark's configurations state:
the ``sobol`` sampler, ``mis="reference"``, no textures, no Russian
roulette, no per-contribution clamp, no compat quirks.
"""

from __future__ import annotations

import numpy as np
import torch

from pnrt_bench.reference import accel

PI = 3.14159265358979323846
INV_PI = 0.31830988618379067154
TWO_PI = 2.0 * PI
FLOAT_MAX = 1.0e7
SHADOW_EPS = 1.0e-4
OFFSET = 1e-4
EPS = 1e-10
POLE_EPS = 1e-6
M32 = 0xFFFFFFFF
SOBOL_DIMS = 8

# ---- elementwise math with JAX's derivatives at the kinks -------------


def maximum(x, c):
    return torch.maximum(x, x.new_full((), c))


def minimum(x, c):
    return torch.minimum(x, x.new_full((), c))


def clip(x, lo, hi):
    return minimum(maximum(x, lo), hi)


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def absolute(x):
    return _Abs.apply(x) if x.requires_grad else torch.abs(x)


def safe_sqrt(x, eps=1e-12):
    return torch.sqrt(maximum(x, eps))


def sqr(x):
    return x * x


def mix(a, b, t):
    return a + (b - a) * t


def fast_atan(t):
    s = t * t
    p = torch.full_like(s, -0.0117212)
    for c in (0.05265332, -0.11643287, 0.19354346, -0.33262347, 0.99997726):
        p = p * s + c
    return t * p


def fast_atan2(y, x):
    ax, ay = absolute(x), absolute(y)
    big = torch.maximum(ax, ay)
    r = fast_atan(torch.minimum(ax, ay) / maximum(big, 1e-30))
    r = torch.where(ay > ax, 0.5 * PI - r, r)
    r = torch.where(x < 0, PI - r, r)
    return torch.where(y < 0, -r, r)


def fast_asin(v):
    v = clip(v, -1.0, 1.0)
    return fast_atan2(v, torch.sqrt(maximum(1.0 - v * v, 0.0)))


# ---- 3-vectors as (x, y, z) tuples of [R] tensors ---------------------


def add(a, b):
    return tuple(p + q for p, q in zip(a, b))


def sub(a, b):
    return tuple(p - q for p, q in zip(a, b))


def mul(a, b):
    return tuple(p * q for p, q in zip(a, b))


def scl(a, s):
    return tuple(p * s for p in a)


def neg(a):
    return tuple(-p for p in a)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def normalize(a):
    return scl(a, torch.rsqrt(maximum(dot(a, a), 1e-20)))


def where(m, a, b):
    return tuple(torch.where(m, p, q) for p, q in zip(a, b))


def vmix(a, b, t):
    return add(a, scl(sub(b, a), t))


def cols(a: torch.Tensor):
    return a[..., 0], a[..., 1], a[..., 2]


# ---- random numbers ------------------------------------------------------


def wang_hash(s):
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & M32
    return s ^ (s >> 15)


def unit(word, dtype):
    return word.to(dtype) * (1.0 / 4294967296.0)


def rand01(s, dtype):
    s = wang_hash(s)
    return s, unit(s, dtype)


_JOE_KUO = [(1, 0, [1]), (2, 1, [1, 3]), (3, 1, [1, 3, 1]), (3, 2, [1, 1, 1]),
            (4, 1, [1, 1, 3, 3]), (4, 4, [1, 3, 5, 13]),
            (5, 2, [1, 1, 5, 5, 17])]


def _sobol_table() -> np.ndarray:
    table = np.zeros((SOBOL_DIMS, 32), np.uint64)
    for k in range(1, 33):
        table[0, k - 1] = 1 << (32 - k)
    for dim, (s, a, m) in enumerate(_JOE_KUO, start=1):
        v = [0] * 33
        for k in range(1, s + 1):
            v[k] = m[k - 1] << (32 - k)
        for k in range(s + 1, 33):
            acc = v[k - s] ^ (v[k - s] >> s)
            for i in range(1, s):
                if (a >> (s - 1 - i)) & 1:
                    acc ^= v[k - i]
            v[k] = acc & M32
        table[dim] = v[1:]
    return table


SOBOL = _sobol_table()


def sobol_pair(frame_index: int, bounce: int):
    """The Sobol pair of a bounce at index ``frame + 1`` (gray-coded), as
    float32 values: dimensions (2b, 2b + 1) mod 8."""
    d0 = (2 * bounce) % SOBOL_DIMS
    i = (frame_index + 1) & M32
    g = i ^ (i >> 1)
    out = []
    for d in (d0, d0 + 1):
        w = 0
        for bit in range(32):
            if (g >> bit) & 1:
                w ^= int(SOBOL[d, bit])
        out.append(float(np.float32(w) * np.float32(1.0 / 0xFFFFFFFF)))
    return out


def rotation(su, sv, px, py, width, height, salt, dtype):
    s = (px * ((width * 1973) & M32) + py * ((height * 9277) & M32)
         + (114514 // 1919) * 26699 + ((int(salt) * 0x9E3779B9) & M32))
    s = (s & M32) | 1
    s, u = rand01(s, dtype)
    _, v = rand01(s, dtype)
    a, b = su + u, sv + v
    return torch.where(a > 1.0, a - 1.0, a), torch.where(b > 1.0, b - 1.0, b)


# ---- camera ---------------------------------------------------------------


def camera_basis(cam: dict, device, dtype):
    """(eye, lower_left, horizontal, vertical) of a pinhole camera: the
    screen plane at distance 1 along -w, half-extent tan(fov / 2) times
    (aspect, 1)."""
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32),
                                  device=device).to(dtype)
    eye, center, up = f(cam["eye"]), f(cam["center"]), f(cam["up"])
    half_h = torch.tan(torch.deg2rad(f(cam["fov_deg"])) * 0.5)
    half_w = f(cam["aspect"]) * half_h
    nrm = lambda a: a * torch.rsqrt(torch.clamp_min(
        a[0:1] * a[0:1] + a[1:2] * a[1:2] + a[2:3] * a[2:3], 1e-20))
    w = nrm(eye - center)
    u = nrm(torch.linalg.cross(up, w))
    v = torch.linalg.cross(w, u)
    lower_left = eye - half_w * u - half_h * v - w
    return eye, lower_left, 2.0 * half_w * u, 2.0 * half_h * v


def primary_rays(basis, px, py, width, height, dtype):
    """Rays through the pixel corners (px / W, py / H), py counted from
    the bottom row."""
    eye, ll, hor, ver = basis
    s = px.to(dtype) / float(width)
    t = py.to(dtype) / float(height)
    d = (ll[None, :] + s[:, None] * hor[None, :] + t[:, None] * ver[None, :]
         - eye[None, :])
    d = d * torch.rsqrt(torch.clamp_min(d[..., 0:1] * d[..., 0:1]
                                        + d[..., 1:2] * d[..., 1:2]
                                        + d[..., 2:3] * d[..., 2:3], 1e-20))
    return eye[None, :].expand(d.shape).contiguous(), d


# ---- Disney BRDF ------------------------------------------------------------


def _schlick(u):
    m = clip(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _gtr1(ndoth, a):
    a2 = sqr(a)
    t = 1.0 + (a2 - 1.0) * sqr(ndoth)
    val = (a2 - 1.0) / (PI * torch.log(maximum(a2, EPS)) * maximum(t, EPS))
    return torch.where(a >= 1.0, INV_PI, val)


def _gtr2(ndoth, a):
    a2 = sqr(a)
    t = 1.0 + (a2 - 1.0) * sqr(ndoth)
    return a2 / (PI * maximum(sqr(t), EPS))


def _gtr2_aniso(ndoth, hx, hy, ax, ay):
    return 1.0 / maximum(PI * ax * ay * sqr(sqr(hx / ax) + sqr(hy / ay)
                                            + sqr(ndoth)), EPS)


def _smith(ndotv, alpha_g):
    a, b = sqr(alpha_g), sqr(ndotv)
    return 1.0 / maximum(ndotv + safe_sqrt(a + b - a * b), EPS)


def _smith_aniso(ndotv, vx, vy, ax, ay):
    return 1.0 / maximum(ndotv + safe_sqrt(sqr(vx * ax) + sqr(vy * ay)
                                           + sqr(ndotv)), EPS)


def brdf_eval(v, n, l, x, y, m, cdlin):
    ndotl, ndotv = dot(n, l), dot(n, v)
    valid = (ndotl >= 0) & (ndotv >= 0)
    h = normalize(add(l, v))
    ndoth, ldoth = dot(n, h), dot(l, h)
    cdlum = 0.3 * cdlin[0] + 0.6 * cdlin[1] + 0.1 * cdlin[2]
    ones = torch.ones_like(cdlum)
    one = (ones, ones, ones)
    ctint = where(cdlum > 0, tuple(c / maximum(cdlum, EPS) for c in cdlin),
                  one)
    cspec = scl(vmix(one, ctint, m["specular_tint"]), m["specular"])
    cspec0 = vmix(scl(cspec, 0.08), cdlin, m["metallic"])
    csheen = vmix(one, ctint, m["sheen_tint"])
    fd90 = 0.5 + 2.0 * sqr(ldoth) * m["roughness"]
    fl, fv = _schlick(ndotl), _schlick(ndotv)
    fd = mix(1.0, fd90, fl) * mix(1.0, fd90, fv)
    fss90 = sqr(ldoth) * m["roughness"]
    fss = mix(1.0, fss90, fl) * mix(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / maximum(ndotl + ndotv, EPS) - 0.5) + 0.5)
    aspect = safe_sqrt(1.0 - m["anisotropic"] * 0.9)
    ax = maximum(sqr(m["roughness"]) / maximum(aspect, EPS), 0.001)
    ay = maximum(sqr(m["roughness"]) * aspect, 0.001)
    ds = _gtr2_aniso(ndoth, dot(h, x), dot(h, y), ax, ay)
    fh = _schlick(ldoth)
    fs = vmix(cspec0, one, fh)
    gs = _smith_aniso(ndotl, dot(l, x), dot(l, y), ax, ay)
    gs = gs * _smith_aniso(ndotv, dot(v, x), dot(v, y), ax, ay)
    dr = _gtr1(ndoth, mix(0.1, 0.001, m["clearcoat_gloss"]))
    fr = mix(0.04, 1.0, fh)
    gr = _smith(ndotl, 0.25) * _smith(ndotv, 0.25)
    fsheen = scl(csheen, fh * m["sheen"])
    diffuse = add(scl(cdlin, INV_PI * mix(fd, ss, m["subsurface"])), fsheen)
    specular = scl(fs, gs * ds)
    clearcoat = scl(one, 0.25 * gr * fr * dr * m["clearcoat"])
    out = add(add(scl(diffuse, 1.0 - m["metallic"]), specular), clearcoat)
    zero = torch.zeros_like(ndotl)
    return where(valid, out, (zero, zero, zero))


def _lobe_probs(m):
    r_d = 1.0 - m["metallic"]
    r_s = torch.ones_like(m["metallic"])
    r_c = 0.25 * m["clearcoat"]
    inv = 1.0 / (r_d + r_s + r_c)
    return r_d * inv, r_s * inv, r_c * inv


def brdf_pdf(v, n, l, m):
    p_d, p_s, p_c = _lobe_probs(m)
    a1 = mix(0.1, 0.001, m["clearcoat_gloss"])
    a2 = maximum(sqr(m["roughness"]), 0.001)
    h = normalize(add(l, v))
    ldoth, ndoth, ndotl = dot(l, h), dot(n, h), dot(n, l)
    denom = 4.0 * ldoth
    safe = torch.where(torch.abs(denom) < EPS, EPS, denom)
    pdf = (p_d * (ndotl * INV_PI) + p_s * (_gtr2(ndoth, a2) * ndoth / safe)
           + p_c * (_gtr1(ndoth, a1) * ndoth / safe))
    return maximum(pdf, 0.0)


def _to_world(t, b, n, v):
    return add(add(scl(t, v[0]), scl(b, v[1])), scl(n, v[2]))


def _half(r1, cos_h):
    phi = TWO_PI * r1
    sin_phi = torch.sin(phi)
    sin_h = safe_sqrt(1.0 - sqr(cos_h))
    return (sin_h * torch.cos(phi), sin_h * sin_phi, cos_h)


def _reflect(v, h):
    return sub(scl(h, 2.0 * dot(v, h)), v)


def brdf_sample(v, n, t, b, m, r_lobe, r1, r2, ud1, ud2):
    p_d, p_s, _ = _lobe_probs(m)
    a1 = mix(0.1, 0.001, m["clearcoat_gloss"])
    a2 = maximum(sqr(m["roughness"]), 0.001)
    rr = safe_sqrt(ud1)
    phi = TWO_PI * ud2
    dx, dy = rr * torch.cos(phi), rr * torch.sin(phi)
    l_diff = _to_world(t, b, n, (dx, dy, safe_sqrt(1.0 - dx * dx - dy * dy)))
    cos2 = safe_sqrt((1.0 - r2) / maximum(1.0 + (sqr(a2) - 1.0) * r2, EPS))
    l_spec = _reflect(v, _to_world(t, b, n, _half(r1, cos2)))
    a1s = sqr(a1)
    cos1 = safe_sqrt((1.0 - torch.pow(a1s, 1.0 - r2)) / maximum(1.0 - a1s,
                                                                EPS))
    l_cc = _reflect(v, _to_world(t, b, n, _half(r1, cos1)))
    take_d = r_lobe <= p_d
    take_s = (~take_d) & (r_lobe <= p_d + p_s)
    l = where(take_d, l_diff, where(take_s, l_spec, l_cc))
    return l, brdf_pdf(v, n, l, m), take_d


def tangent_frame(n):
    near_z = torch.abs(n[2]) > 0.9999995
    zero = torch.zeros_like(n[0])
    tg = normalize(cross(n, (zero, zero, zero + 1.0)))
    one = torch.ones_like(n[0])
    tg = where(near_z, (one, zero, zero), tg)
    return tg, cross(n, tg)


# ---- environment -------------------------------------------------------------


def env_lookup(image, dirs):
    """Bilinear radiance at directions (u wraps, v clamps)."""
    u = fast_atan2(dirs[2], dirs[0]) * (0.5 * INV_PI) + 0.5
    v = 1.0 - (fast_asin(dirs[1]) * INV_PI + 0.5)
    h, w = image.shape[0], image.shape[1]
    fx, fy = u * w - 0.5, v * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00, c10 = image[y0i, x0i], image[y0i, x1i]
    c01, c11 = image[y1i, x0i], image[y1i, x1i]
    out = []
    for k in range(3):
        top = c00[:, k] * (1 - tx) + c10[:, k] * tx
        bot = c01[:, k] * (1 - tx) + c11[:, k] * tx
        out.append(top * (1 - ty) + bot * ty)
    return tuple(out)


def env_sample(scene, image, u1, u2):
    """(direction, radiance, solid-angle pdf) of one texel drawn by the
    alias tables: p_xy W H / (2 pi^2 cos(elevation))."""
    env = scene.env
    w, h = env.pdf_xy.shape
    j1 = torch.clamp((u1 * w).to(torch.int64), 0, w - 1)
    f1 = u1 * w - j1.to(u1.dtype)
    x = torch.where(f1 < env.prob_x[j1], j1, env.alias_x[j1])
    j2 = torch.clamp((u2 * h).to(torch.int64), 0, h - 1)
    f2 = u2 * h - j2.to(u2.dtype)
    y = torch.where(f2 < env.prob_y[x, j2], j2, env.alias_y[x, j2])
    p2d = env.pdf_xy[x, y]
    u = (x.to(u1.dtype) + 0.5) / w
    v = (y.to(u1.dtype) + 0.5) / h
    phi = TWO_PI * (u - 0.5)
    theta = PI * (0.5 - v)
    cos_t = torch.cos(theta)
    dirs = (cos_t * torch.cos(phi), torch.sin(theta), cos_t * torch.sin(phi))
    rad = image.reshape(-1, 3)[y * w + x]
    pdf = p2d * (w * h) / (2.0 * PI * PI * maximum(cos_t, POLE_EPS))
    return dirs, cols(rad), pdf


# ---- the estimator -------------------------------------------------------------


def surface(scene, tri, o, d):
    """(position, shading normal facing the ray, material id) at the hit
    triangle ``tri`` (>= 0) of rays ``o + t d``: the barycentrics of one
    watertight test of that triangle, the test the query chose it by,
    here with the gradient of the ray."""
    t_safe = torch.clamp_min(tri, 0)
    v = scene.p[t_safe]
    nv = scene.n[t_safe]
    _, _, b1, b2 = accel.watertight(
        v[:, 0], v[:, 1], v[:, 2], torch.stack(o, -1),
        accel.setup(torch.stack(d, -1)),
        torch.full(tri.shape, FLOAT_MAX, dtype=scene.dtype,
                   device=tri.device))
    b0 = 1.0 - b1 - b2
    p0, p1, p2 = cols(v[:, 0]), cols(v[:, 1]), cols(v[:, 2])
    n0, n1, n2 = cols(nv[:, 0]), cols(nv[:, 1]), cols(nv[:, 2])
    pos = add(add(scl(p0, b0), scl(p1, b1)), scl(p2, b2))
    geom = normalize(cross(sub(p1, p0), sub(p2, p0)))
    interp = add(add(scl(n0, b0), scl(n1, b1)), scl(n2, b2))
    zero3 = lambda a: (a[0] == 0) & (a[1] == 0) & (a[2] == 0)
    nrm = where(zero3(n0) | zero3(n1) | zero3(n2), geom, interp)
    nrm = normalize(where(dot(nrm, d) > 0, neg(nrm), nrm))
    return pos, nrm, scene.mat[t_safe]


def sanitized(mats: dict) -> dict:
    out = {k: clip(v, 0.0, 1.0) for k, v in mats.items()}
    out["emissive"] = maximum(mats["emissive"], 0.0)
    out["ior"] = maximum(mats["ior"], 1.0)
    return out


def radiance(scene, materials, image, px, py, frame: int, cfg: dict):
    """[R, 3] radiance of one sample (frame ``frame``) through pixels
    ``px`` (column), ``py`` (row from the bottom), int64 tensors;
    ``materials`` a dict of [M] / [M, 3] tensors and ``image`` the
    environment radiance (either may require grad)."""
    dt, dev = scene.dtype, px.device
    width, height, depth = cfg["width"], cfg["height"], cfg["max_depth"]
    frame = int(frame) & M32
    r = px.shape[0]
    o, d = primary_rays(cfg["basis"], px, py, width, height, dt)
    o, d = cols(o), cols(d)
    seed = ((px * 1973 + py * 9277 + frame * 26699) & M32) | 1
    zero = torch.zeros(r, dtype=dt, device=dev)
    zero3 = (zero, zero, zero)
    fmax = torch.full((r,), FLOAT_MAX, dtype=dt, device=dev)
    mats = sanitized(materials)
    emis = materials["emissive"]
    gm = lambda idx: {k: (v[idx] if v.dim() == 1 else None)
                      for k, v in mats.items()}

    tri = accel.closest(scene, torch.stack(o, -1), torch.stack(d, -1), fmax,
                        torch.ones(r, dtype=torch.bool, device=dev))
    primary_hit = tri >= 0
    pos, nrm, mat_id = surface(scene, tri, o, d)
    miss_color = env_lookup(image, d)
    primary_em = cols(emis[mat_id])
    active = primary_hit
    v_dir = neg(d)
    c = (zero + 1.0, zero + 1.0, zero + 1.0)
    lo = zero3
    lights_mat = scene.mat[scene.light_tri]
    w_env, h_env = scene.env.pdf_xy.shape
    for bounce in range(depth):
        m = gm(mat_id)
        cdlin = cols(mats["base_color"][mat_id])
        t_tan, b_tan = tangent_frame(nrm)
        seed, u_light = rand01(seed, dt)
        slot = torch.clamp(torch.searchsorted(
            scene.prefix_area, (u_light * scene.total_area).contiguous(),
            side="left"), 0, scene.prefix_area.shape[0] - 1)
        ltri = scene.light_tri[slot]
        seed, u1 = rand01(seed, dt)
        seed, u2 = rand01(seed, dt)
        su = safe_sqrt(u1)
        lb0, lb1 = 1.0 - su, u2 * su
        lb2 = 1.0 - lb0 - lb1
        lv, ln_ = scene.p[ltri], scene.n[ltri]
        q0, q1, q2 = cols(lv[:, 0]), cols(lv[:, 1]), cols(lv[:, 2])
        k0, k1, k2 = cols(ln_[:, 0]), cols(ln_[:, 1]), cols(ln_[:, 2])
        lp = add(add(scl(q0, lb0), scl(q1, lb1)), scl(q2, lb2))
        lgeom = normalize(cross(sub(q1, q0), sub(q2, q0)))
        linterp = add(add(scl(k0, lb0), scl(k1, lb1)), scl(k2, lb2))
        zr = lambda a: (a[0] == 0) & (a[1] == 0) & (a[2] == 0)
        lnrm = normalize(where(zr(k0) | zr(k1) | zr(k2), lgeom, linterp))
        sdir = sub(lp, pos)
        dis2 = dot(sdir, sdir)
        lnorm = normalize(sdir)
        cos_l = absolute(dot(lnrm, neg(lnorm)))
        raw_pdf = dis2 / maximum(cos_l * scene.total_area, 1e-12)
        li = cols(emis[lights_mat[slot]])
        light_f = brdf_eval(v_dir, nrm, lnorm, t_tan, b_tan, m, cdlin)
        nl = absolute(dot(nrm, lnorm))
        inv_pdf = torch.where(torch.abs(raw_pdf) > EPS, 1.0 / torch.where(
            raw_pdf == 0, 1.0, raw_pdf), 0.0)
        l_direct_pre = scl(mul(light_f, li), nl * inv_pdf)

        seed, r1e = rand01(seed, dt)
        seed, r2e = rand01(seed, dt)
        en_l, en_li, env_pdf_raw = env_sample(scene, image, r1e, r2e)
        env_f = brdf_eval(v_dir, nrm, en_l, t_tan, b_tan, m, cdlin)
        inv_e = torch.where(torch.abs(env_pdf_raw) > EPS, 1.0 / torch.where(
            env_pdf_raw == 0, 1.0, env_pdf_raw), 0.0)
        l_env_pre = scl(mul(env_f, en_li), dot(en_l, nrm) * inv_e)

        sx, sy = sobol_pair(frame, bounce)
        r1, r2 = rotation(sx, sy, px, py, width, height,
                          (2 * bounce) // SOBOL_DIMS, dt)
        seed, r_lobe = rand01(seed, dt)
        s1 = wang_hash(seed)
        s2 = wang_hash(s1)
        l_out, d_pdf, diffuse = brdf_sample(v_dir, nrm, t_tan, b_tan, m,
                                            r_lobe, r1, r2, unit(s1, dt),
                                            unit(s2, dt))
        seed = torch.where(diffuse, s2, seed)
        d_f = brdf_eval(v_dir, nrm, l_out, t_tan, b_tan, m, cdlin)
        inv_d = torch.where(torch.abs(d_pdf) > EPS, 1.0 / torch.where(
            d_pdf == 0, 1.0, d_pdf), 0.0)
        weight = scl(d_f, absolute(dot(nrm, l_out)) * inv_d)

        s_origin = add(pos, scl(nrm, OFFSET))
        occl = accel.occluded(
            scene, torch.stack(s_origin, -1), torch.stack(sdir, -1),
            torch.full((r,), 1.0 - SHADOW_EPS, dtype=dt, device=dev), active)
        facing = dot(en_l, nrm) > 0
        e_occ = accel.occluded(scene, torch.stack(s_origin, -1),
                               torch.stack(en_l, -1), fmax, active & facing)
        lit = active & ~occl
        light_pdf = torch.where(lit, raw_pdf, 0.0)
        l_direct = where(lit, l_direct_pre, zero3)
        env_pdf = torch.where(active, env_pdf_raw, 0.0)
        l_env = where(active & facing & ~e_occ, l_env_pre, zero3)
        pdf_sum = env_pdf + light_pdf + d_pdf
        inv_sum = torch.where(pdf_sum > EPS, 1.0 / torch.where(
            pdf_sum == 0, 1.0, pdf_sum), 0.0)
        nee = scl(add(scl(l_env, env_pdf), scl(l_direct, light_pdf)), inv_sum)
        lo = add(lo, where(active, mul(c, nee), zero3))

        b_origin = add(pos, scl(nrm, OFFSET))
        tri2 = accel.closest(scene, torch.stack(b_origin, -1),
                             torch.stack(l_out, -1), fmax, active)
        pos2, nrm2, mat2 = surface(scene, tri2, b_origin, l_out)
        miss_now = active & (tri2 < 0)
        lo = add(lo, where(miss_now, mul(mul(c, env_lookup(image, l_out)),
                                         weight), zero3))
        hit_now = active & (tri2 >= 0)
        em2 = cols(emis[mat2])
        lo = add(lo, where(hit_now, mul(mul(c, em2), weight), zero3))
        c = where(hit_now, mul(c, weight), c)
        v_dir = neg(l_out)
        pos = where(hit_now, pos2, pos)
        nrm = where(hit_now, nrm2, nrm)
        mat_id = torch.where(hit_now, mat2, mat_id)
        active = hit_now
    color = where(primary_hit, add(primary_em, lo), miss_color)
    return torch.stack([clip(x, 0.0, 1.0) for x in color], -1)


def render_pixels(scene, cam: dict, cfg: dict, px, py, frames,
                  materials=None, image=None, block: int = 1 << 16):
    """Mean over ``frames`` of each pixel's sample, [P, 3], in blocks of
    ``block`` pixels; ``materials`` / ``image`` default to the scene's."""
    cfg = dict(cfg, basis=camera_basis(cam, px.device, scene.dtype))
    materials = scene.materials if materials is None else materials
    image = scene.env_image if image is None else image
    out = []
    for s in range(0, px.shape[0], block):
        acc = None
        for f in frames:
            x = radiance(scene, materials, image, px[s:s + block],
                         py[s:s + block], f, cfg)
            acc = x if acc is None else acc + x
        out.append(acc / float(len(frames)))
    return torch.cat(out)


def pixel_grid(width: int, height: int, device):
    """(px, py) of every pixel, row-major from the top row."""
    ys = torch.arange(height, device=device)
    xs = torch.arange(width, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx.reshape(-1), (height - 1 - gy).reshape(-1)


def pixel_rows(idx: torch.Tensor, width: int, height: int):
    """(px, py) of flat row-major image indices."""
    row, col = idx // width, idx % width
    return col, height - 1 - row
