"""Ray-triangle and ray-AABB tests in component form.

PyTorch counterpart of the component forms of
``pnraytracing_tpu/ops/intersect.py`` (``triangle_setup_c``,
``intersect_triangle_c``, ``intersect_aabb_c``, ``safe_inv_dir``): the
watertight test of PBRT-3 (triangle.hpp:15-181, ray_tracing.comp:254-427)
and the clipped slab test (bound.hpp:31-47).  The plain traversal in
``accel/traverse_cuda.py`` is built from these, and the CUDA kernels in
``csrc/traverse.cu`` repeat them op for op.

``compat=True`` gives the reference's forms, as in the JAX package: the
watertight setup permutes its axes only when ``d.z == 0``
(triangle.hpp:34-47), and the slab test is the interval-free
``t1 >= t0`` (bound.hpp:31-47, ray_tracing.comp:213-228), which ignores
the ray's segment.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Hit:
    """Closest-hit record over a ray batch."""

    tri: torch.Tensor  # [R] i32 triangle index, -1 = miss
    t: torch.Tensor  # [R] f32 ray parameter
    b1: torch.Tensor  # [R] f32 barycentric weight of vertex 1
    b2: torch.Tensor  # [R] f32 barycentric weight of vertex 2

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


def safe_inv_dir(d: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """1/d with zero components nudged to +-eps (no 0*inf in the slab
    test)."""
    return torch.where(d >= 0, 1.0, -1.0) / torch.clamp_min(torch.abs(d), eps)


def triangle_setup_c(dx, dy, dz, compat: bool = False):
    """Ray-constant part of the watertight test: the axis permutation
    (kz = argmax |d|, first index among maxima; with ``compat`` the
    identity unless d.z == 0, then the x/z or y/z swap) and the shear
    constants.  Returns the tuple :func:`intersect_triangle_c` accepts as
    ``setup``."""
    adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    if compat:
        zx = adx > ady
        z_zero = dz == 0.0
        kx = torch.where(z_zero, torch.where(zx, 2, 0), 0)
        ky = torch.where(z_zero, torch.where(zx, 1, 2), 1)
        kz = torch.where(z_zero, torch.where(zx, 0, 1), 2)
    else:
        kz = torch.where(adx >= ady,
                         torch.where(adx >= adz, 0, 2),
                         torch.where(ady >= adz, 1, 2))
        kx = (kz + 1) % 3
        ky = (kx + 1) % 3

    def sel(k, x, y, z):
        return torch.where(k == 0, x, torch.where(k == 1, y, z))

    dpx = sel(kx, dx, dy, dz)
    dpy = sel(ky, dx, dy, dz)
    dpz = sel(kz, dx, dy, dz)
    inv_dz = 1.0 / dpz
    return kx, ky, kz, dpx * inv_dz, dpy * inv_dz, inv_dz


def intersect_triangle_c(v0, v1, v2, ox, oy, oz, dx, dy, dz, t_max,
                         compat: bool = False, setup=None):
    """Watertight ray-triangle test.  ``v0/v1/v2`` are 3-tuples of vertex
    components (tensors broadcasting against the rays).  Returns
    (hit, t, b1, b2) with x = b0*p0 + b1*p1 + b2*p2, b0 = 1-b1-b2.
    ``compat`` selects the setup when none is given."""
    if setup is None:
        setup = triangle_setup_c(dx, dy, dz, compat=compat)
    kx, ky, kz, sx, sy, inv_dz = setup

    def sel(k, x, y, z):
        return torch.where(k == 0, x, torch.where(k == 1, y, z))

    def perm(x, y, z):
        return sel(kx, x, y, z), sel(ky, x, y, z), sel(kz, x, y, z)

    a0, a1, a2 = perm(v0[0] - ox, v0[1] - oy, v0[2] - oz)
    b0, b1, b2v = perm(v1[0] - ox, v1[1] - oy, v1[2] - oz)
    c0, c1, c2 = perm(v2[0] - ox, v2[1] - oy, v2[2] - oz)
    ax = a0 - a2 * sx
    ay = a1 - a2 * sy
    az = a2 * inv_dz
    bx = b0 - b2v * sx
    by = b1 - b2v * sy
    bz = b2v * inv_dz
    cx = c0 - c2 * sx
    cy = c1 - c2 * sy
    cz = c2 * inv_dz

    e0 = bx * cy - by * cx
    e1 = cx * ay - cy * ax
    e2 = ax * by - ay * bx

    any_neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    any_pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    mixed = any_neg & any_pos

    det = e0 + e1 + e2
    t_scaled = e0 * az + e1 * bz + e2 * cz
    ok_pos = (det > 0) & (t_scaled > 0) & (t_scaled <= t_max * det)
    ok_neg = (det < 0) & (t_scaled < 0) & (t_scaled >= t_max * det)
    hit = (~mixed) & (det != 0) & (ok_pos | ok_neg)

    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    return hit, t_scaled * inv_det, e1 * inv_det, e2 * inv_det


def intersect_aabb_c(bmin, bmax, ox, oy, oz, inv_dx, inv_dy, inv_dz, t_max,
                     compat: bool = False):
    """Slab test clipped to the live segment [0, t_max]; with ``compat``
    the reference's ``t1 >= t0``, which reads no ``t_max``."""
    fx = (bmax[0] - ox) * inv_dx
    nx = (bmin[0] - ox) * inv_dx
    fy = (bmax[1] - oy) * inv_dy
    ny = (bmin[1] - oy) * inv_dy
    fz = (bmax[2] - oz) * inv_dz
    nz = (bmin[2] - oz) * inv_dz
    t1 = torch.minimum(
        torch.minimum(torch.maximum(fx, nx), torch.maximum(fy, ny)),
        torch.maximum(fz, nz))
    t0 = torch.maximum(
        torch.maximum(torch.minimum(fx, nx), torch.minimum(fy, ny)),
        torch.minimum(fz, nz))
    if compat:
        return t1 >= t0
    return (t1 >= torch.clamp_min(t0, 0.0)) & (t0 <= t_max)


def never_enters(o, d) -> torch.Tensor:
    """[R] bool: rays for which every slab test (:func:`intersect_aabb_c`,
    the treelet-entry key's) yields a NaN, whatever the (finite) box: a
    NaN component of the origin or the direction, or an axis on which
    both are infinite (``(box - o) * (1 / d)`` is then ``inf * 0``).  No
    other ray produces a NaN anywhere in the slab test.  Such a ray hits
    no triangle either (its watertight test is NaN and every comparison
    of it fails).  The CUDA kernels' ``fminf`` / ``fmaxf`` drop a NaN where
    ``torch.minimum`` / ``maximum`` keep it, so the rule of every walk,
    kernel and plain version alike: such a ray walks nothing (a miss, no
    occlusion, zero stats), and its treelet-entry key is
    ``K*8 + octant(d)``."""
    bad = torch.zeros_like(o.x, dtype=torch.bool)
    for oc, dc in ((o.x, d.x), (o.y, d.y), (o.z, d.z)):
        bad |= torch.isnan(oc) | torch.isnan(dc) | (torch.isinf(oc)
                                                    & torch.isinf(dc))
    return bad
