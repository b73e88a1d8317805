"""The reference's own intersection: the watertight ray-triangle test of
PBRT-3 (the upstream's ``triangle.hpp``) over every (ray, triangle) pair
that a coarse cull leaves.

Triangles are grouped into clusters of :data:`CLUSTER` consecutive
triangles along a Morton curve of their centroids, each with the box of
its corners.  A query tests every ray against every cluster box (the
slab test, clipped to the ray's segment), then every triangle of each
cluster a ray enters, in blocks of pairs.  The closest hit is the least
``t`` with ``t <= t_max``; among triangles at one ``t`` the lowest input
index wins.  A ray with a NaN component, or an infinite origin and
direction on one axis, hits nothing.  No gradient flows through a query:
the hit's barycentrics are derived again, differentiably, by the
tracer.
"""

from __future__ import annotations

import numpy as np
import torch

CLUSTER = 64
PAIR_BLOCK = 1 << 16  # (ray, cluster) pairs tested at once


def _morton(c: np.ndarray) -> np.ndarray:
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for k in range(3):
            code |= ((q[:, k] >> bit) & 1) << (3 * bit + k)
    return code


class Clusters:
    def __init__(self, p: torch.Tensor):
        """``p``: [T, 3, 3] corners (input order)."""
        t = p.shape[0]
        pn = p.detach().float().cpu().numpy()
        order = np.argsort(_morton(pn.mean(axis=1)), kind="stable")
        k = -(-t // CLUSTER)
        pad = np.concatenate([order, np.full(k * CLUSTER - t, -1)])
        self.members = torch.as_tensor(pad.reshape(k, CLUSTER),
                                       device=p.device)  # -1 = empty slot
        safe = np.where(pad >= 0, pad, order[0]).reshape(k, CLUSTER)
        box = pn[safe]  # [K, C, 3, 3]
        self.lo = torch.as_tensor(box.min(axis=(1, 2)), device=p.device)
        self.hi = torch.as_tensor(box.max(axis=(1, 2)), device=p.device)


def setup(d: torch.Tensor):
    """The ray-constant part of the watertight test for rays ``d`` [R, 3]:
    the axis permutation (kz = argmax |d|, first among maxima) and the
    shears."""
    ad = torch.abs(d)
    kz = torch.where(ad[:, 0] >= ad[:, 1],
                     torch.where(ad[:, 0] >= ad[:, 2], 0, 2),
                     torch.where(ad[:, 1] >= ad[:, 2], 1, 2))
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    take = lambda v, k: torch.gather(v, -1, k[:, None]).squeeze(-1)
    inv_dz = 1.0 / take(d, kz)
    return kx, ky, kz, take(d, kx) * inv_dz, take(d, ky) * inv_dz, inv_dz


def watertight(v0, v1, v2, o, su, t_max):
    """(hit, t, b1, b2) of triangles ``v0, v1, v2`` [N, 3] against rays
    with origins ``o`` [N, 3] and setup ``su`` (each field [N]);
    x = (1 - b1 - b2) v0 + b1 v1 + b2 v2."""
    kx, ky, kz, sx, sy, inv_dz = su
    take = lambda v, k: torch.gather(v, -1, k[:, None]).squeeze(-1)

    def perm(v):
        r = v - o
        return take(r, kx), take(r, ky), take(r, kz)

    a0, a1, a2 = perm(v0)
    b0, b1, b2 = perm(v1)
    c0, c1, c2 = perm(v2)
    ax, ay, az = a0 - a2 * sx, a1 - a2 * sy, a2 * inv_dz
    bx, by, bz = b0 - b2 * sx, b1 - b2 * sy, b2 * inv_dz
    cx, cy, cz = c0 - c2 * sx, c1 - c2 * sy, c2 * inv_dz
    e0 = bx * cy - by * cx
    e1 = cx * ay - cy * ax
    e2 = ax * by - ay * bx
    mixed = (((e0 < 0) | (e1 < 0) | (e2 < 0))
             & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    t_scaled = e0 * az + e1 * bz + e2 * cz
    ok_pos = (det > 0) & (t_scaled > 0) & (t_scaled <= t_max * det)
    ok_neg = (det < 0) & (t_scaled < 0) & (t_scaled >= t_max * det)
    hit = (~mixed) & (det != 0) & (ok_pos | ok_neg)
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    return hit, t_scaled * inv_det, e1 * inv_det, e2 * inv_det


def _pairs(acc: Clusters, o, d, t_max, mask):
    """(ray, cluster) pairs whose box the ray's segment [0, t_max]
    enters, rays in ``mask`` only."""
    inv = torch.where(d >= 0, 1.0, -1.0).to(d.dtype) / torch.clamp_min(
        torch.abs(d), 1e-20)
    out_r, out_c = [], []
    block = max(1, PAIR_BLOCK * 16 // max(1, acc.lo.shape[0]))
    lo_b, hi_b = acc.lo.to(d.dtype), acc.hi.to(d.dtype)
    for s in range(0, o.shape[0], block):
        oo, ii, tm = o[s:s + block, None], inv[s:s + block, None], \
            t_max[s:s + block, None]
        f = (hi_b[None] - oo) * ii
        n = (lo_b[None] - oo) * ii
        t1 = torch.amin(torch.maximum(f, n), dim=-1)
        t0 = torch.amax(torch.minimum(f, n), dim=-1)
        ok = (t1 >= torch.clamp_min(t0, 0.0)) & (t0 <= tm)
        ok &= mask[s:s + block, None]
        r, c = torch.nonzero(ok, as_tuple=True)
        out_r.append(r + s)
        out_c.append(c)
    return torch.cat(out_r), torch.cat(out_c)


def _tests(scene, o, d, su, t_max, mask):
    """Yield (ray, triangle, hit, t) over every culled pair, in blocks."""
    acc = scene.accel
    rr, cc = _pairs(acc, o, d, t_max, mask)
    c = acc.members.shape[1]
    for s in range(0, rr.shape[0], PAIR_BLOCK):
        r = rr[s:s + PAIR_BLOCK].repeat_interleave(c)
        tri = acc.members[cc[s:s + PAIR_BLOCK]].reshape(-1)
        keep = tri >= 0
        r, tri = r[keep], tri[keep]
        v = scene.p[tri]
        hit, t, _, _ = watertight(v[:, 0], v[:, 1], v[:, 2], o[r],
                                  tuple(x[r] for x in su), t_max[r])
        yield r, tri, hit, t


def closest(scene, o, d, t_max, mask):
    """([R] triangle index, -1 = none) of the closest hit within
    ``t_max`` of each ray in ``mask``."""
    with torch.no_grad():
        o, d, t_max = o.detach(), d.detach(), t_max.detach()
        su = setup(d)
        n = o.shape[0]
        inf = torch.tensor(float("inf"), dtype=o.dtype, device=o.device)
        best = torch.full((n,), float("inf"), dtype=o.dtype, device=o.device)
        found = []
        for r, tri, hit, t in _tests(scene, o, d, su, t_max, mask):
            t = torch.where(hit, t, inf)
            best.scatter_reduce_(0, r, t, reduce="amin")
            found.append((r[hit], tri[hit], t[hit]))
        big = scene.p.shape[0]
        pick = torch.full((n,), big, dtype=torch.int64, device=o.device)
        for r, tri, t in found:
            at_best = t == best[r]
            pick.scatter_reduce_(0, r[at_best], tri[at_best], reduce="amin")
        return torch.where(pick < big, pick, -1)


def occluded(scene, o, d, t_max, mask):
    """[R] bool: any triangle hit within ``t_max``, rays in ``mask``."""
    with torch.no_grad():
        o, d, t_max = o.detach(), d.detach(), t_max.detach()
        su = setup(d)
        out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for r, _tri, hit, _t in _tests(scene, o, d, su, t_max, mask):
            out[r[hit]] = True
        return out
