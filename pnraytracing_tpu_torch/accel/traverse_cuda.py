"""BVH traversal: the hand-written CUDA kernels and their plain versions.

PyTorch/CUDA counterpart of ``pnraytracing_tpu/accel/traverse_pallas.py``
(kernels ``_closest_kernel_wide_attr``, ``_closest_kernel_wide`` and
``_any_kernel_wide``).  The kernels live in ``csrc/traverse.cu``; see the
note there for their design and bound.

Each wrapper (:func:`closest_hit_attr`, :func:`closest_hit`,
:func:`any_hit`) takes rays as component tensors (``V3`` origins and
directions, ``[R]`` t_max, optional ``[R]`` bool mask), checks them,
and then

* on CUDA tensors launches its kernel on the current stream and adds one
  to its entry of :data:`LAUNCHES`;
* on CPU tensors runs the plain PyTorch version of the same walk
  (``plain_*``, over :func:`_walk_plain`), which visits nodes in the
  kernel's order.

Results: the closest ``t`` (``t_max`` on a miss), ``tri`` (-1 on a miss)
and barycentrics; the attribute variant also the raw interpolated shading
normal ((0, 0, 1) on a miss), ``u``, ``v`` and the encoded
material/texture word (layout.py::ATTR_TEX_BASE; 0 on a miss); the any
hit an occlusion flag.  Masked rays report a miss.  ``with_stats`` adds
an ``[3, R]`` int32 tensor of per-ray pops, leaf pops and triangle tests.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel.layout import TravData
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import (
    Hit,
    intersect_aabb_c,
    intersect_triangle_c,
    safe_inv_dir,
    triangle_setup_c,
)

# Launches per kernel since the last reset (the caller zeroes them).
LAUNCHES = {"closest_hit_attr": 0, "closest_hit": 0, "any_hit": 0}

KERNEL_STACK = 64  # KSTACK of csrc/traverse.cu


def check_rays(o: V3, d: V3, *more: torch.Tensor):
    """(R, device) of rays given as contiguous float32 [R] component
    tensors on one device (``more``: further such tensors); raises on
    anything else, including a device that is neither the CPU nor CUDA."""
    r = int(o.x.shape[0]) if isinstance(o.x, torch.Tensor) else -1
    dev = o.x.device if r >= 0 else None
    for c in (o.x, o.y, o.z, d.x, d.y, d.z, *more):
        if not (isinstance(c, torch.Tensor) and c.dtype == torch.float32
                and c.shape == (r,) and c.is_contiguous()
                and c.device == dev):
            raise ValueError("rays must be contiguous float32 [R] component "
                             "tensors on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return r, dev


def _check(trav: TravData, o: V3, d: V3, t_max, mask, stack_depth: int):
    """The device of a checked traversal call."""
    r, dev = check_rays(o, d, t_max)
    if mask is not None and not (
            mask.dtype == torch.bool and mask.shape == (r,)
            and mask.is_contiguous() and mask.device == dev):
        raise ValueError("mask must be a contiguous bool [R] tensor on the "
                         "rays' device")
    for name, t, width in (("nodes16c", trav.nodes16c, 16),
                           ("tri9", trav.tri9, 9),
                           ("tri_attr16", trav.tri_attr16, 16)):
        if not (t.dtype == torch.float32 and t.dim() == 2
                and t.shape[1] == width and t.is_contiguous()
                and t.device == dev):
            raise ValueError(f"trav.{name} must be a contiguous float32 "
                             f"[N, {width}] tensor on the rays' device")
    if stack_depth < trav.bvh_depth:
        raise ValueError(
            f"stack_depth={stack_depth} is too shallow for this scene's BVH "
            f"(depth {trav.bvh_depth}); the traversal stack would silently "
            f"drop nodes.  Raise stack_depth to at least {trav.bvh_depth}.")
    if dev.type == "cuda":
        if stack_depth > KERNEL_STACK:
            raise ValueError(f"the CUDA walk keeps a {KERNEL_STACK}-entry "
                             f"stack; stack_depth={stack_depth} exceeds it")
        for t in (trav.nodes16c, trav.tri_attr16):
            if t.data_ptr() % 16:
                raise ValueError("node/attribute rows must be 16-byte "
                                 "aligned (float4 loads)")
    return dev


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_closest(trav, o, d, t_max, mask, attr, with_stats):
    from pnraytracing_tpu_torch.cuda_build import library

    r = o.x.shape[0]
    f32 = lambda: torch.empty(r, dtype=torch.float32, device=o.x.device)
    t, b1, b2 = f32(), f32(), f32()
    tri = torch.empty(r, dtype=torch.int32, device=o.x.device)
    attrs = (f32(), f32(), f32(), f32(), f32(),
             torch.empty(r, dtype=torch.int32, device=o.x.device)) \
        if attr else (None,) * 6
    stats = (torch.empty((3, r), dtype=torch.int32, device=o.x.device)
             if with_stats else None)
    err = library("traverse").pnrt_closest_hit(
        _ptr(trav.nodes16c), _ptr(trav.tri9), _ptr(trav.tri_attr16),
        _ptr(o.x), _ptr(o.y), _ptr(o.z), _ptr(d.x), _ptr(d.y), _ptr(d.z),
        _ptr(t_max), _ptr(mask), r, int(attr), _ptr(t), _ptr(tri),
        _ptr(b1), _ptr(b2), *[_ptr(a) for a in attrs], _ptr(stats),
        torch.cuda.current_stream(o.x.device).cuda_stream)
    if err:
        raise RuntimeError(f"closest-hit kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["closest_hit_attr" if attr else "closest_hit"] += 1
    return Hit(tri=tri, t=t, b1=b1, b2=b2), (attrs if attr else None), stats


def _kernel_any(trav, o, d, t_max, mask, with_stats):
    from pnraytracing_tpu_torch.cuda_build import library

    r = o.x.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=o.x.device)
    stats = (torch.empty((3, r), dtype=torch.int32, device=o.x.device)
             if with_stats else None)
    err = library("traverse").pnrt_any_hit(
        _ptr(trav.nodes16c), _ptr(trav.tri9), _ptr(o.x), _ptr(o.y),
        _ptr(o.z), _ptr(d.x), _ptr(d.y), _ptr(d.z), _ptr(t_max),
        _ptr(mask), r, _ptr(occ), _ptr(stats),
        torch.cuda.current_stream(o.x.device).cuda_stream)
    if err:
        raise RuntimeError(f"any-hit kernel launch failed: CUDA error {err}")
    LAUNCHES["any_hit"] += 1
    return occ, stats


def _walk_plain(trav: TravData, o: V3, d: V3, t_max, mask, stack_depth: int,
                mode: str):
    """Plain PyTorch version of the kernels' per-ray walk: every ray keeps
    its own stack (a row of an [R, stack_depth] tensor); each step pops
    one entry for every ray whose stack is not empty, and works on just
    those rays.  Same visit order, same arithmetic, same results as
    csrc/traverse.cu.  ``mode``: 'closest', 'attr' or 'any'."""
    ox, oy, oz, dx, dy, dz = o.x, o.y, o.z, d.x, d.y, d.z
    r, dev = ox.shape[0], ox.device
    i32 = torch.int32
    inv_x, inv_y, inv_z = safe_inv_dir(dx), safe_inv_dir(dy), safe_inv_dir(dz)
    setup = triangle_setup_c(dx, dy, dz)
    active = (torch.ones(r, dtype=torch.bool, device=dev) if mask is None
              else mask)
    stack = torch.zeros((r, stack_depth), dtype=i32, device=dev)
    top = active.to(torch.int64)  # the root row 0 sits in slot 0
    t_best = t_max.clone()
    tri_best = torch.full((r,), -1, dtype=i32, device=dev)
    b1_best = torch.zeros(r, dtype=torch.float32, device=dev)
    b2_best = torch.zeros_like(b1_best)
    attrs = [torch.zeros_like(b1_best), torch.zeros_like(b1_best),
             torch.ones_like(b1_best), torch.zeros_like(b1_best),
             torch.zeros_like(b1_best), torch.zeros(r, dtype=i32, device=dev)]
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    stats = torch.zeros((3, r), dtype=i32, device=dev)
    nodes, tri9, attr16 = trav.nodes16c, trav.tri9, trav.tri_attr16
    any_mode = mode == "any"

    while True:
        idx = torch.nonzero(top > 0).squeeze(1)
        if idx.numel() == 0:
            break
        top[idx] -= 1
        info = stack[idx, top[idx]]
        stats[0, idx] += 1
        leaf = info < 0

        # leaf pops: triangle tests in slot order
        lrows = idx[leaf]
        if lrows.numel():
            meta = (-info[leaf] - 1).long()
            start = torch.div(meta, 16, rounding_mode="floor")
            count = meta % 16
            stats[1, lrows] += 1
            for k in range(int(count.max())):
                sel = count > k
                if any_mode:
                    sel = sel & ~occ[lrows]
                rows = lrows[sel]
                if rows.numel() == 0:
                    continue
                ti = start[sel] + k
                stats[2, rows] += 1
                p = tri9[ti]
                t_lim = t_max[rows] if any_mode else t_best[rows]
                hit, t, b1, b2 = intersect_triangle_c(
                    (p[:, 0], p[:, 1], p[:, 2]), (p[:, 3], p[:, 4], p[:, 5]),
                    (p[:, 6], p[:, 7], p[:, 8]),
                    ox[rows], oy[rows], oz[rows], dx[rows], dy[rows],
                    dz[rows], t_lim, setup=tuple(s[rows] for s in setup))
                if any_mode:
                    occ[rows[hit]] = True
                    continue
                win = hit & (t < t_lim)
                w = rows[win]
                t_best[w] = t[win]
                tri_best[w] = ti[win].to(i32)
                b1w, b2w = b1[win], b2[win]
                b1_best[w] = b1w
                b2_best[w] = b2w
                if mode == "attr":
                    a = attr16[ti[win]]
                    b0w = 1.0 - b1w - b2w
                    for j, (c0, c1, c2) in enumerate(
                            ((0, 3, 6), (1, 4, 7), (2, 5, 8), (9, 11, 13),
                             (10, 12, 14))):
                        attrs[j][w] = (a[:, c0] * b0w + a[:, c1] * b1w
                                       + a[:, c2] * b2w)
                    attrs[5][w] = a[:, 15].to(i32)

        # internal pops: slab-test both children, push far then near
        irows = idx[~leaf]
        if irows.numel():
            row = nodes[info[~leaf].long()]
            t_lim = t_max[irows] if any_mode else t_best[irows]
            ray = (ox[irows], oy[irows], oz[irows],
                   inv_x[irows], inv_y[irows], inv_z[irows], t_lim)
            hl = intersect_aabb_c((row[:, 0], row[:, 1], row[:, 2]),
                                  (row[:, 3], row[:, 4], row[:, 5]), *ray)
            hr = intersect_aabb_c((row[:, 6], row[:, 7], row[:, 8]),
                                  (row[:, 9], row[:, 10], row[:, 11]), *ray)
            li, ri = row[:, 12].to(i32), row[:, 13].to(i32)
            axis = row[:, 14].to(i32)
            d_ax = torch.where(axis == 0, dx[irows],
                               torch.where(axis == 1, dy[irows], dz[irows]))
            d_neg = d_ax < 0
            near = torch.where(d_neg, ri, li)
            far = torch.where(d_neg, li, ri)
            h_near = torch.where(d_neg, hr, hl)
            h_far = torch.where(d_neg, hl, hr)
            # slots >= top are free: write, then commit by advancing top
            t0 = top[irows]
            stack[irows, t0.clamp(max=stack_depth - 1)] = far
            t1 = t0 + h_far
            stack[irows, t1.clamp(max=stack_depth - 1)] = near
            top[irows] = t1 + h_near

        if any_mode:
            top[occ] = 0

    if any_mode:
        return occ, stats
    hit = Hit(tri=tri_best, t=t_best, b1=b1_best, b2=b2_best)
    return hit, (tuple(attrs) if mode == "attr" else None), stats


def plain_closest_hit_attr(trav, o, d, t_max, mask=None, *, stack_depth=64,
                           with_stats=False):
    """The plain version of :func:`closest_hit_attr` on any device (also
    for holding the kernel against it on the card); never launches a
    kernel."""
    hit, attrs, stats = _walk_plain(trav, o, d, t_max, mask, stack_depth,
                                    "attr")
    return (hit, attrs, stats) if with_stats else (hit, attrs)


def plain_closest_hit(trav, o, d, t_max, mask=None, *, stack_depth=64,
                      with_stats=False):
    hit, _, stats = _walk_plain(trav, o, d, t_max, mask, stack_depth,
                                "closest")
    return (hit, stats) if with_stats else hit


def plain_any_hit(trav, o, d, t_max, mask=None, *, stack_depth=64,
                  with_stats=False):
    occ, stats = _walk_plain(trav, o, d, t_max, mask, stack_depth, "any")
    return (occ, stats) if with_stats else occ


def closest_hit_attr(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                     mask: torch.Tensor | None = None, *,
                     stack_depth: int = 64, with_stats: bool = False):
    """Closest hit + interaction fill: ``(Hit, (nx, ny, nz, u, v, mt))``
    (+ stats).  ``nx..nz`` is the barycentric-interpolated, unnormalized,
    unflipped shading normal; ``mt`` the int32 material/texture word."""
    if _check(trav, o, d, t_max, mask, stack_depth).type == "cpu":
        return plain_closest_hit_attr(trav, o, d, t_max, mask,
                                      stack_depth=stack_depth,
                                      with_stats=with_stats)
    hit, attrs, stats = _kernel_closest(trav, o, d, t_max, mask, True,
                                        with_stats)
    return (hit, attrs, stats) if with_stats else (hit, attrs)


def closest_hit(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                mask: torch.Tensor | None = None, *, stack_depth: int = 64,
                with_stats: bool = False):
    """Closest hit: ``Hit`` (+ stats)."""
    if _check(trav, o, d, t_max, mask, stack_depth).type == "cpu":
        return plain_closest_hit(trav, o, d, t_max, mask,
                                 stack_depth=stack_depth,
                                 with_stats=with_stats)
    hit, _, stats = _kernel_closest(trav, o, d, t_max, mask, False,
                                    with_stats)
    return (hit, stats) if with_stats else hit


def any_hit(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
            mask: torch.Tensor | None = None, *, stack_depth: int = 64,
            with_stats: bool = False):
    """Occlusion: True where a triangle is hit within ``t_max`` (+ stats)."""
    if _check(trav, o, d, t_max, mask, stack_depth).type == "cpu":
        return plain_any_hit(trav, o, d, t_max, mask, stack_depth=stack_depth,
                             with_stats=with_stats)
    occ, stats = _kernel_any(trav, o, d, t_max, mask, with_stats)
    return (occ, stats) if with_stats else occ
