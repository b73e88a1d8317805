"""Equirectangular HDR environment: table bake, lookup, importance sampling.

PyTorch counterpart of ``pnraytracing_tpu/ops/envmap.py`` (LoadHDRImage,
shader.hpp:126-225; SampleHDRImage, ray_tracing.comp:560-576).  The bake
is the JAX package's host (numpy) branch, copied so that the tables come
out bit-exact.  Sampling takes the Walker alias path with the fat rows
(one row gather per sample) when the map has alias tables
(``build_envmap(alias=True)``, what the scene builder bakes), else the
CDF inversion: ``searchsorted`` over the marginal and an unrolled
bisection of the conditional row (:func:`_bisect_rows`).  Conventions:
``image[0]`` is the top row (+y); u = atan2(z, x)/2pi + 0.5,
v = 0.5 - asin(y)/pi.

Compat quirks (``compat=True``, the JAX package's): the sample's pdf
converts with the *elevation* sine, ``(W*H/2) / (2 pi^2 sin(elev))``
clamped at 1e-10 (comp:572-574), and its radiance comes from the
vertically mirrored row (comp:563, 575); compat always inverts the CDFs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pnraytracing_tpu_torch.core.math import PI, TWO_PI, maximum
from pnraytracing_tpu_torch.core.types import EnvMap
from pnraytracing_tpu_torch.core.vec import V3, spherical_uv_v
from pnraytracing_tpu_torch.ops.gather import gather_row

_POLE_EPS = 1e-6


def _alias_table(p: np.ndarray):
    """Walker alias table for a probability vector (Vose's stable
    construction): sample j = floor(u*n); keep j if the fraction is below
    prob[j], else take alias[j].  The distribution is exactly p."""
    n = len(p)
    p = np.asarray(p, np.float64)
    s = p.sum()
    p = p / s if s > 0 else np.full(n, 1.0 / n)
    prob = np.zeros(n)
    alias = np.arange(n, dtype=np.int64)
    scaled = p * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = (scaled[l_i] + scaled[s_i]) - 1.0
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for i in large + small:  # numerical leftovers sample themselves
        prob[i] = 1.0
    return prob.astype(np.float32), alias


def _pack_quads(image):
    """[H, W, 3] -> [H, W, 12] of 2x2 bilinear quads (u wraps, v clamps):
    numpy for a host array, rolls and concatenations (differentiable)
    for a tensor."""
    if isinstance(image, torch.Tensor):
        xp = torch.roll(image, -1, dims=1)
        dn = torch.cat([image[1:], image[-1:]], dim=0)
        return torch.cat([image, xp, dn, torch.roll(dn, -1, dims=1)],
                         dim=-1)
    xp = np.roll(image, -1, axis=1)
    dn = np.concatenate([image[1:], image[-1:]], axis=0)
    dnxp = np.roll(dn, -1, axis=1)
    return np.concatenate([image, xp, dn, dnxp], axis=-1)


def envmap_in_graph(image: torch.Tensor) -> EnvMap:
    """The traced branch of the JAX package's ``build_envmap``: the
    luminance pdf and the marginal/conditional CDFs as torch ops on the
    image's device, differentiable in the image."""
    lum = 0.2 * image[..., 0] + 0.7 * image[..., 1] + 0.1 * image[..., 2]
    pdf_xy = lum.T  # [W, H], the reference's pdf[x][y]
    pdf_xy = pdf_xy / maximum(pdf_xy.sum(), 1e-20)
    pdf_marginal_x = pdf_xy.sum(dim=1)
    cond = pdf_xy / maximum(pdf_marginal_x[:, None], 1e-20)
    return EnvMap(image=image, pdf_xy=pdf_xy,
                  cdf_marginal_x=torch.cumsum(pdf_marginal_x, 0),
                  cdf_y_given_x=torch.cumsum(cond, dim=1),
                  quad12=_pack_quads(image))


def build_envmap(image, alias: bool = False, device=None) -> EnvMap:
    """Sampling tables of an [H, W, 3] radiance image (shader.hpp:145-181):
    luminance pdf and marginal/conditional CDFs; with ``alias`` also the
    Walker alias tables and the fat alias rows [prob, alias, rgb(keep),
    rgb(alias), pdf(keep), pdf(alias)].  Baked on the host, except for
    an image tensor that requires grad (an optimized environment,
    ``diff/grad.py::apply_params``): its tables are built in the graph,
    on its own device, and have no alias form."""
    if isinstance(image, torch.Tensor) and image.requires_grad:
        if alias:
            raise ValueError("alias tables cannot be built in the graph; "
                             "call with alias=False for an image that "
                             "requires grad")
        return envmap_in_graph(image.to(torch.float32))
    img_np = np.asarray(image, np.float32)
    lum = (0.2 * img_np[..., 0] + 0.7 * img_np[..., 1]
           + 0.1 * img_np[..., 2])
    pdf_xy = lum.T.copy()
    pdf_xy /= max(pdf_xy.sum(), 1e-20)
    pdf_marginal_x = pdf_xy.sum(axis=1)
    cdf_marginal_x = np.cumsum(pdf_marginal_x)
    cond = pdf_xy / np.maximum(pdf_marginal_x[:, None], 1e-20)
    cdf_y_given_x = np.cumsum(cond, axis=1)

    dev = torch.device("cuda" if device is None else device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    env = EnvMap(image=t(img_np), pdf_xy=t(pdf_xy),
                 cdf_marginal_x=t(cdf_marginal_x),
                 cdf_y_given_x=t(cdf_y_given_x),
                 quad12=t(_pack_quads(img_np)))
    if not alias:
        return env
    w, h = int(pdf_xy.shape[0]), int(pdf_xy.shape[1])
    prob_x, al_x = _alias_table(pdf_marginal_x)
    alias_x = np.stack([prob_x, al_x.astype(np.float32)], axis=1)
    prob_y = np.zeros((w, h), np.float32)
    al_y = np.zeros((w, h), np.float32)
    for xcol in range(w):
        pcol, acol = _alias_table(pdf_xy[xcol])
        prob_y[xcol] = pcol
        al_y[xcol] = acol.astype(np.float32)
    alias_y = np.stack([prob_y, al_y], axis=-1)
    al_int = al_y.astype(np.int64)
    img_t = img_np.transpose(1, 0, 2)  # [w, h, 3]
    rgb_alias = np.take_along_axis(img_t, al_int[..., None], axis=1)
    pdf_keep = pdf_xy.astype(np.float32)
    pdf_alias = np.take_along_axis(pdf_xy, al_int, axis=1).astype(np.float32)
    alias_fat = np.concatenate(
        [prob_y[..., None], al_y[..., None], img_t, rgb_alias,
         pdf_keep[..., None], pdf_alias[..., None]], axis=-1,
    ).reshape(w * h, 10).astype(np.float32)
    env.alias_x, env.alias_y, env.alias_fat = (t(alias_x), t(alias_y),
                                               t(alias_fat))
    return env


def _bisect_rows(table: torch.Tensor, x: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """Per-ray ``searchsorted(table[x], u, side='left')`` without
    gathering whole rows: ceil(log2(H + 1)) halvings, each one gather of
    one element a ray.  The loop count is a host int (the table's
    shape), so the function reads nothing on the host and captures in a
    CUDA graph."""
    h = int(table.shape[1])
    lo = torch.zeros_like(x)
    hi = torch.full_like(x, h)
    for _ in range(max(1, math.ceil(math.log2(h + 1)))):
        active = lo < hi
        mid = torch.clamp_max(torch.div(lo + hi, 2, rounding_mode="floor"),
                              h - 1)
        right = active & (table[x, mid] < u)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def _grid_direction(u: torch.Tensor, v: torch.Tensor):
    """(u, v) in [0, 1]^2 -> ([R, 3] unit direction, elevation)
    (comp:566-568)."""
    phi = TWO_PI * (u - 0.5)
    theta = PI * (0.5 - v)  # elevation; v = 0 -> +pi/2 (up)
    cos_t = torch.cos(theta)
    return torch.stack([cos_t * torch.cos(phi), torch.sin(theta),
                        cos_t * torch.sin(phi)], dim=-1), theta


def bilinear_lookup(image: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """[R, 3] bilinear fetch of ``image`` [H, W, 3] at normalized (u, v):
    u wraps (the azimuth seam), v clamps."""
    h, w = image.shape[0], image.shape[1]
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    top = image[y0i, x0i] * (1 - tx) + image[y0i, x1i] * tx
    bot = image[y1i, x0i] * (1 - tx) + image[y1i, x1i] * tx
    return top * (1 - ty) + bot * ty


def _quad_rows(quad12: torch.Tensor, u, v):
    """(the [..., 12] quad rows at normalized (u, v), tx, ty): u wraps, v
    clamps; one row gather."""
    h, w = quad12.shape[0], quad12.shape[1]
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    idx = y0i * w + x0i
    q = gather_row(idx.reshape(-1), quad12.reshape(h * w, 12))
    return q.reshape(*idx.shape, 12), fx - x0, fy - y0


def _lerp2(c00, c10, c01, c11, tx, ty):
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def bilinear_lookup_quads(quad12: torch.Tensor, u, v) -> torch.Tensor:
    """[..., 3] bilinear fetch through the pre-packed quad rows of
    ``quad12`` [H, W, 12] (texels (x, y), (x+1, y), (x, y+1), (x+1, y+1)):
    one row gather."""
    q, tx, ty = _quad_rows(quad12, u, v)
    tx, ty = tx[..., None], ty[..., None]
    return _lerp2(q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12], tx,
                  ty)


def bilinear_lookup_quads_v(quad12: torch.Tensor, u, v) -> V3:
    """Component form of :func:`bilinear_lookup_quads`."""
    q, tx, ty = _quad_rows(quad12, u, v)
    return V3(*(_lerp2(q[..., k], q[..., 3 + k], q[..., 6 + k],
                       q[..., 9 + k], tx, ty) for k in range(3)))


def envmap_lookup_v(env: EnvMap, dirs: V3) -> V3:
    """Bilinear radiance along escaped rays (GetHDRImageColor,
    comp:190-193) through the packed quad rows (the image itself where a
    map has none): u wraps, v clamps."""
    u, v = spherical_uv_v(dirs)
    if env.quad12 is not None:
        return bilinear_lookup_quads_v(env.quad12, u, v)
    return V3.of(bilinear_lookup(env.image, u, v))


def envmap_lookup(env: EnvMap, dirs: torch.Tensor) -> torch.Tensor:
    """[R, 3] form of :func:`envmap_lookup_v`."""
    return envmap_lookup_v(env, V3.of(dirs)).rows()


def sample_envmap(env: EnvMap, u1: torch.Tensor, u2: torch.Tensor,
                  compat: bool = False):
    """Importance-sample the environment (SampleHDRImage, comp:560-576):
    ``([R, 3] dir, [R, 3] radiance, [R] pdf)``.  The cell (x, y) comes
    from the alias tables where the map has them and ``compat`` is off,
    else from the CDFs (``searchsorted`` over the marginal, the bisection
    of the conditional row).  Default: the texel's radiance and the pdf
    of the sampling procedure, p_xy * W * H / (2 pi^2 cos(elevation));
    compat: the reference's pdf and mirrored-row radiance (module
    docstring)."""
    w, h = env.width, env.height
    if env.alias_x is not None and not compat:
        j1 = torch.clamp((u1 * w).to(torch.int64), 0, w - 1)
        frac1 = u1 * w - j1.to(torch.float32)
        rowx = env.alias_x[j1]
        x = torch.where(frac1 < rowx[:, 0], j1, rowx[:, 1].to(torch.int64))
        j2 = torch.clamp((u2 * h).to(torch.int64), 0, h - 1)
        frac2 = u2 * h - j2.to(torch.float32)
        rowy = env.alias_y[x, j2]
        y = torch.where(frac2 < rowy[:, 0], j2, rowy[:, 1].to(torch.int64))
    else:
        x = torch.clamp(torch.searchsorted(env.cdf_marginal_x, u1,
                                           side="left"), 0, w - 1)
        y = torch.clamp(_bisect_rows(env.cdf_y_given_x, x, u2), 0, h - 1)

    p2d = env.pdf_xy[x, y]
    if compat:
        u = x.to(torch.float32) / w
        v = y.to(torch.float32) / h
        d, theta = _grid_direction(u, v)
        sin_theta = maximum(torch.sin(theta), 1e-10)
        pdf = p2d * (float((w * h) // 2) / (2.0 * PI * PI * sin_theta))
        radiance = bilinear_lookup(env.image, u, 1.0 - v)
    else:
        u = (x.to(torch.float32) + 0.5) / w
        v = (y.to(torch.float32) + 0.5) / h
        d, theta = _grid_direction(u, v)
        cos_theta = maximum(torch.cos(theta), _POLE_EPS)
        pdf = p2d * (w * h) / (2.0 * PI * PI * cos_theta)
        radiance = gather_row(y * w + x, env.image.reshape(-1, 3))
    return d, radiance, pdf


def sample_envmap_v(env: EnvMap, u1: torch.Tensor, u2: torch.Tensor,
                    compat: bool = False):
    """Component form of :func:`sample_envmap`: ``(dir V3, radiance V3,
    pdf [R])``.  With the fat alias rows (and ``compat`` off) one row
    gather resolves the sample; the values are those of
    :func:`sample_envmap`'s alias path."""
    if env.alias_fat is None or compat:
        d, radiance, pdf = sample_envmap(env, u1, u2, compat)
        return V3.of(d), V3.of(radiance), pdf
    w, h = env.width, env.height
    j1 = torch.clamp((u1 * w).to(torch.int64), 0, w - 1)
    frac1 = u1 * w - j1.to(torch.float32)
    rowx = env.alias_x[j1]
    x = torch.where(frac1 < rowx[:, 0], j1, rowx[:, 1].to(torch.int64))
    j2 = torch.clamp((u2 * h).to(torch.int64), 0, h - 1)
    frac2 = u2 * h - j2.to(torch.float32)
    fat = env.alias_fat[x * h + j2]  # the one env gather
    take = frac2 < fat[:, 0]
    y = torch.where(take, j2, fat[:, 1].to(torch.int64))
    radiance = V3(torch.where(take, fat[:, 2], fat[:, 5]),
                  torch.where(take, fat[:, 3], fat[:, 6]),
                  torch.where(take, fat[:, 4], fat[:, 7]))
    p2d = torch.where(take, fat[:, 8], fat[:, 9])
    u = (x.to(torch.float32) + 0.5) / w
    v = (y.to(torch.float32) + 0.5) / h
    phi = TWO_PI * (u - 0.5)
    theta = PI * (0.5 - v)
    cos_t = torch.cos(theta)
    dirs = V3(cos_t * torch.cos(phi), torch.sin(theta), cos_t * torch.sin(phi))
    pdf = p2d * (w * h) / (2.0 * PI * PI * maximum(cos_t, _POLE_EPS))
    return dirs, radiance, pdf


def envmap_pdf_v(env: EnvMap, dirs: V3) -> torch.Tensor:
    """Solid-angle pdf of the NEE sampler at arbitrary directions."""
    w, h = env.width, env.height
    u, v = spherical_uv_v(dirs)
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    theta = PI * (0.5 - v)
    cos_theta = maximum(torch.cos(theta), _POLE_EPS)
    return env.pdf_xy[x, y] * (w * h) / (2.0 * PI * PI * cos_theta)


def envmap_pdf(env: EnvMap, dirs: torch.Tensor) -> torch.Tensor:
    """[R, 3] form of :func:`envmap_pdf_v`."""
    return envmap_pdf_v(env, V3.of(dirs))
