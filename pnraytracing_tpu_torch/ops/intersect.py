"""Ray-triangle and ray-AABB tests.

PyTorch counterpart of ``pnraytracing_tpu/ops/intersect.py``: the
watertight test of PBRT-3 (triangle.hpp:15-181, ray_tracing.comp:254-427)
and the clipped slab test (bound.hpp:31-47), in component form
(``triangle_setup_c``, ``intersect_triangle_c``, ``intersect_aabb_c``,
``safe_inv_dir``) and in array form over ``[..., 3]`` tensors
(``intersect_triangle``, ``intersect_aabb``), with the all-pairs oracles
``brute_force_closest_hit`` / ``brute_force_any_hit``.  The plain walks
of ``accel/traverse_cuda.py`` are built from the component forms and
that of ``accel/traverse.py`` from the array forms; the CUDA kernels in
``csrc/`` repeat them op for op (``csrc/intersect.cuh``).

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


def triangle_setup_static(ax: int, dx, dy, dz):
    """The setup of rays that ALL have dominant axis ``ax`` (a Python
    int): the permutation is three ints, so :func:`intersect_triangle_c`
    picks components instead of selecting per ray.  Only valid when every
    ray's argmax |d| (first index among maxima) is ``ax``; it then equals
    :func:`triangle_setup_c`'s setup value for value."""
    comps = (dx, dy, dz)
    kz = ax
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    inv_dz = 1.0 / comps[kz]
    return kx, ky, kz, comps[kx] * inv_dz, comps[ky] * inv_dz, inv_dz


def intersect_triangle_c(v0, v1, v2, ox, oy, oz, dx, dy, dz, t_max,
                         compat: bool = False, setup=None):
    """Watertight ray-triangle test.  ``v0/v1/v2`` are 3-tuples of vertex
    components (tensors broadcasting against the rays).  Returns
    (hit, t, b1, b2) with x = b0*p0 + b1*p1 + b2*p2, b0 = 1-b1-b2.
    ``compat`` selects the setup when none is given; a setup of
    :func:`triangle_setup_static` carries its permutation as ints."""
    if setup is None:
        setup = triangle_setup_c(dx, dy, dz, compat=compat)
    kx, ky, kz, sx, sy, inv_dz = setup

    def sel(k, x, y, z):
        if isinstance(k, int):  # static permutation
            return (x, y, z)[k]
        return torch.where(k == 0, x, torch.where(k == 1, y, z))

    def perm(x, y, z):
        return sel(kx, x, y, z), sel(ky, x, y, z), sel(kz, x, y, z)

    return _watertight(perm(v0[0] - ox, v0[1] - oy, v0[2] - oz),
                       perm(v1[0] - ox, v1[1] - oy, v1[2] - oz),
                       perm(v2[0] - ox, v2[1] - oy, v2[2] - oz),
                       sx, sy, inv_dz, t_max)


def _watertight(a, b, c, sx, sy, inv_dz, t_max):
    """The watertight test of the triangle whose corners, relative to
    the ray origin and permuted by the ray's setup, are ``a``, ``b``,
    ``c`` (3-tuples), with the setup's shears ``sx``, ``sy``, ``inv_dz``:
    (hit, t, b1, b2)."""
    a0, a1, a2 = a
    b0, b1, b2v = b
    c0, c1, c2 = c
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


# ---- array forms ------------------------------------------------------------

def _axis_permutation(d: torch.Tensor, compat: bool):
    """(kx, ky, kz) per ray of ``d`` [..., 3]: kz = argmax |d| (first index
    among maxima); with ``compat`` the identity unless d.z == 0, then the
    reference's x/z or y/z swap (triangle.hpp:34-47)."""
    if compat:
        ad = torch.abs(d)
        zx = ad[..., 0] > ad[..., 1]
        z_zero = d[..., 2] == 0.0
        kx = torch.where(z_zero, torch.where(zx, 2, 0), 0)
        ky = torch.where(z_zero, torch.where(zx, 1, 2), 1)
        kz = torch.where(z_zero, torch.where(zx, 0, 1), 2)
    else:
        kz = torch.argmax(torch.abs(d), dim=-1)
        kx = (kz + 1) % 3
        ky = (kx + 1) % 3
    return kx, ky, kz


def _take3(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """v[..., k] with a per-element k."""
    return torch.gather(v, -1, k.unsqueeze(-1).long()).squeeze(-1)


def intersect_triangle(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                       o: torch.Tensor, d: torch.Tensor, t_max,
                       compat: bool = False):
    """Watertight ray-triangle test over ``[..., 3]`` arrays that
    broadcast (the JAX package's ``intersect_triangle``): returns (hit,
    t, b1, b2) of the broadcast shape, x = b0*p0 + b1*p1 + b2*p2 with b0 =
    1-b1-b2.  The same arithmetic as :func:`intersect_triangle_c` (the
    permutation is pure selection), so the two give the same bits."""
    shape = torch.broadcast_shapes(p0.shape, p1.shape, p2.shape, o.shape,
                                   d.shape)
    d = d.expand(shape)
    kx, ky, kz = _axis_permutation(d, compat)

    def perm(v):
        v = v.expand(shape)
        return _take3(v, kx), _take3(v, ky), _take3(v, kz)

    dpx, dpy, dpz = perm(d)
    inv_dz = 1.0 / dpz
    return _watertight(perm(p0 - o), perm(p1 - o), perm(p2 - o),
                       dpx * inv_dz, dpy * inv_dz, inv_dz, t_max)


def intersect_aabb(p_min: torch.Tensor, p_max: torch.Tensor,
                   o: torch.Tensor, inv_d: torch.Tensor, t_max,
                   compat: bool = False) -> torch.Tensor:
    """Slab test over ``[..., 3]`` boxes and rays (the JAX package's
    ``intersect_aabb``): clipped to the live segment [0, t_max]; with
    ``compat`` the reference's ``t1 >= t0``.  A NaN anywhere in the slab
    arithmetic (a NaN ray, an infinite origin and direction on one axis)
    fails the test, since the reductions keep it."""
    f = (p_max - o) * inv_d
    n = (p_min - o) * inv_d
    t1 = torch.amin(torch.maximum(f, n), dim=-1)
    t0 = torch.amax(torch.minimum(f, n), dim=-1)
    if compat:
        return t1 >= t0
    return (t1 >= torch.clamp_min(t0, 0.0)) & (t0 <= t_max)


def brute_force_closest_hit(positions: torch.Tensor, indices: torch.Tensor,
                            o: torch.Tensor, d: torch.Tensor, t_max,
                            compat: bool = False, chunk: int = 4096) -> Hit:
    """All-pairs closest hit, the oracle of the BVH walks: positions
    [V, 3], indices [T, 3], rays o, d [R, 3], t_max [R]; triangles are
    tested in fixed chunks (R * chunk tests at a time), each chunk's
    first nearest hit replacing the best where it is strictly nearer."""
    num_tris = int(indices.shape[0])
    r, dev = o.shape[0], o.device
    best = Hit(tri=torch.full((r,), -1, dtype=torch.int32, device=dev),
               t=torch.as_tensor(t_max, dtype=torch.float32,
                                 device=dev).expand(r).clone(),
               b1=torch.zeros(r, dtype=torch.float32, device=dev),
               b2=torch.zeros(r, dtype=torch.float32, device=dev))
    rr = torch.arange(r, device=dev)
    for lo in range(0, num_tris, chunk):
        p = positions[indices[lo:lo + chunk].long()]  # [C, 3, 3]
        hit, t, b1, b2 = intersect_triangle(
            p[None, :, 0], p[None, :, 1], p[None, :, 2], o[:, None],
            d[:, None], best.t[:, None], compat=compat)  # [R, C]
        t = torch.where(hit, t, torch.inf)
        j = torch.argmin(t, dim=1)
        closer = hit[rr, j] & (t[rr, j] < best.t)
        best = Hit(tri=torch.where(closer, (lo + j).to(torch.int32),
                                   best.tri),
                   t=torch.where(closer, t[rr, j], best.t),
                   b1=torch.where(closer, b1[rr, j], best.b1),
                   b2=torch.where(closer, b2[rr, j], best.b2))
    return best


def brute_force_any_hit(positions: torch.Tensor, indices: torch.Tensor,
                        o: torch.Tensor, d: torch.Tensor, t_max,
                        compat: bool = False,
                        chunk: int = 4096) -> torch.Tensor:
    """Occlusion oracle: [R] bool, any triangle hit within ``t_max``."""
    r, dev = o.shape[0], o.device
    t_lim = torch.as_tensor(t_max, dtype=torch.float32,
                            device=dev).expand(r)[:, None]
    occluded = torch.zeros(r, dtype=torch.bool, device=dev)
    for lo in range(0, int(indices.shape[0]), chunk):
        p = positions[indices[lo:lo + chunk].long()]
        hit, _, _, _ = intersect_triangle(
            p[None, :, 0], p[None, :, 1], p[None, :, 2], o[:, None],
            d[:, None], t_lim, compat=compat)
        occluded = occluded | hit.any(dim=1)
    return occluded
