"""BVH traversal over a resident scene: the hand-written CUDA kernels and
their plain versions.

PyTorch/CUDA counterpart of ``pnraytracing_tpu/accel/traverse_pallas.py``
(kernels ``_closest_kernel_wide_attr``, ``_closest_kernel_wide``,
``_any_kernel_wide``, and the binary ``_closest_kernel`` and
``_any_kernel``).  The kernels live in ``csrc/traverse.cu``; see the note
there for their design and bound.

Each wrapper (:func:`closest_hit_attr`, :func:`closest_hit`,
:func:`any_hit`) takes rays as component tensors (``V3`` origins and
directions, ``[R]`` t_max, optional ``[R]`` bool mask), checks them,
and then

* on CUDA tensors launches its kernel on the current stream and adds one
  to its entry of :data:`LAUNCHES`;
* on CPU tensors runs the plain PyTorch version of the same walk
  (``plain_*``), which visits nodes in the kernel's order.

``closest_hit`` and ``any_hit`` take ``variant="wide"`` (push-test walk
over the compact wide rows ``nodes16c``) or ``"binary"`` (pop-test walk
over ``nodes8``), resolved by ``accel/route.py::pick_variant`` as the
JAX package resolves it.  Every kernel reads triangles from the padded
rows ``tri12``, every plain version from ``tri9`` (the same values).
The interaction fill is a function of the winning hit alone
(:func:`interaction_fill`); kernel and plain version evaluate it once
after the walk.
:func:`kernel_info` reports the resident kernels' registers and blocks an
SM.

Results: the closest ``t`` (``t_max`` on a miss), ``tri`` (-1 on a miss)
and barycentrics; the attribute variant also the raw interpolated shading
normal ((0, 0, 1) on a miss), ``u``, ``v`` and the encoded
material/texture word (layout.py::ATTR_TEX_BASE; 0 on a miss); the any
hit an occlusion flag.  Masked rays, and rays of
``ops/intersect.py::never_enters`` (a NaN component, or an infinite
origin and direction on one axis), walk nothing and report a miss.
``with_stats`` adds an ``[3, R]`` int32 tensor of per-ray pops, leaf
pops and triangle tests.

Every entry point and plain version takes ``compat`` (the JAX package's
``compat`` of its walks, ``RenderConfig.compat_pnrt``): the reference's
ray setup and interval-free slab test (``ops/intersect.py``), so a walk
prunes no box by its ``t``.  On the card it launches the kernel's compat
instantiation, counted under the kernel's name with ``_compat`` appended.

``max_leaf_size`` caps the triangles tested a leaf, as the JAX package's
Pallas kernels and XLA walks cap them: the integrator passes
``RenderConfig.max_leaf_size`` on every route.  It defaults to 15, the
packed layout's largest leaf, which tests every triangle.
"""

from __future__ import annotations

import dataclasses

import torch

from pnraytracing_tpu_torch.accel.layout import (
    MAX_PACKED_LEAF,
    TravData,
    decode_leaf_info,
    unpack_node_rows,
    unpack_wide_rows,
)
from pnraytracing_tpu_torch.accel.loops import chunked_while
from pnraytracing_tpu_torch.accel.route import pick_variant
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import (
    Hit,
    intersect_aabb_c,
    intersect_triangle_c,
    never_enters,
    safe_inv_dir,
    triangle_setup_c,
)
from pnraytracing_tpu_torch.utils.profiling import launched

_KERNELS = ("closest_hit_attr", "closest_hit", "any_hit",
            "closest_hit_binary", "any_hit_binary")
# Launches per kernel since the last reset (the caller zeroes them); a
# compat instantiation counts under its own name
LAUNCHES = {k + c: 0 for c in ("", "_compat") for k in _KERNELS}

KERNEL_STACK = 64  # KSTACK of csrc/intersect.cuh


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


def _cut(x):
    if isinstance(x, V3):
        return x.map(_cut)
    return x.detach() if isinstance(x, torch.Tensor) else x


def detached(*xs):
    """A walk's inputs cut from the autograd graph, the counterpart of the
    JAX package's ``_stop_gradient_trace``: every walk entry point starts
    with it, so a walk's answer carries no gradient on the card (a ctypes
    launch has no backward) and on the CPU alike (the plain versions are
    torch ops, which would pass the barycentrics' gradient back into
    ``o`` and ``d``)."""
    return tuple(_cut(x) for x in xs)


def check_table(name: str, t: torch.Tensor, width: int, dev,
                align: bool = False):
    """Raise unless ``t`` is a contiguous float32 [N, width] tensor on
    ``dev`` (16-byte aligned when ``align`` and on the card)."""
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
            and t.dim() == 2 and t.shape[1] == width and t.is_contiguous()
            and t.device == dev):
        raise ValueError(f"{name} must be a contiguous float32 [N, {width}] "
                         "tensor on the rays' device")
    if align and dev.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")


def check_mask(mask, r: int, dev):
    if mask is not None and not (
            mask.dtype == torch.bool and mask.shape == (r,)
            and mask.is_contiguous() and mask.device == dev):
        raise ValueError("mask must be a contiguous bool [R] tensor on the "
                         "rays' device")


def _check(trav: TravData, o: V3, d: V3, t_max, mask, stack_depth: int,
           variant: str = "wide"):
    """The device of a checked traversal call over the tables that
    ``variant`` ('wide', 'attr' or 'binary') reads."""
    r, dev = check_rays(o, d, t_max)
    check_mask(mask, r, dev)
    check_table("trav.tri9", trav.tri9, 9, dev)
    check_table("trav.tri12", trav.tri12, 12, dev, align=True)
    if trav.tri12.shape[0] != trav.tri9.shape[0]:
        raise ValueError("trav.tri12 must have a row per row of tri9")
    if variant == "binary":
        check_table("trav.nodes8", trav.nodes8, 8, dev, align=True)
    else:
        check_table("trav.nodes16c", trav.nodes16c, 16, dev, align=True)
    if variant == "attr":
        check_table("trav.tri_attr16", trav.tri_attr16, 16, dev, align=True)
    if stack_depth < trav.bvh_depth:
        raise ValueError(
            f"stack_depth={stack_depth} is too shallow for this scene's BVH "
            f"(depth {trav.bvh_depth}); the traversal stack would silently "
            f"drop nodes.  Raise stack_depth to at least {trav.bvh_depth}.")
    if dev.type == "cuda" and stack_depth > KERNEL_STACK:
        raise ValueError(f"the CUDA walk keeps a {KERNEL_STACK}-entry "
                         f"stack; stack_depth={stack_depth} exceeds it")
    return dev


def ptr(t):
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _outputs(r, dev, closest: bool, with_stats: bool, n_stats: int = 3):
    f32 = lambda: torch.empty(r, dtype=torch.float32, device=dev)
    if closest:
        outs = (f32(), torch.empty(r, dtype=torch.int32, device=dev), f32(),
                f32())
    else:
        outs = (torch.empty(r, dtype=torch.bool, device=dev),)
    stats = (torch.empty((n_stats, r), dtype=torch.int32, device=dev)
             if with_stats else None)
    return outs, stats


def _raise_on(err, what: str):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def launch_name(kernel: str, compat: bool) -> str:
    """The LAUNCHES key of ``kernel`` in its default or compat form."""
    return kernel + ("_compat" if compat else "")


def kernel_attributes(query, kernels) -> dict:
    """What the card gives each of ``kernels`` (``(which, name)`` pairs)
    as built, both instantiations (the compat ones under their
    ``_compat`` names): registers and bytes of local memory a thread,
    threads a block and the blocks an SM holds at once, each read by
    ``query(which, compat, what)`` (a library's ``*_kernel_info``, what
    0-3); raises if the card refuses to say."""
    out = {}
    for compat in (False, True):
        for which, kernel in kernels:
            name = launch_name(kernel, compat)
            vals = {k: query(which, int(compat), what)
                    for what, k in enumerate(("registers", "blocks_per_sm",
                                              "threads", "local_bytes"))}
            if min(vals.values()) < 0:
                raise RuntimeError(f"{name}: CUDA error "
                                   f"{-min(vals.values())} reading the "
                                   "kernel's attributes")
            out[name] = vals
    return out


def kernel_info() -> dict:
    """:func:`kernel_attributes` of the resident walk kernels."""
    from pnraytracing_tpu_torch.cuda_build import library

    return kernel_attributes(library("traverse").pnrt_walk_kernel_info,
                             tuple(enumerate(_KERNELS)))


def _kernel_closest(trav, o, d, t_max, mask, attr, with_stats, compat,
                    max_leaf=MAX_PACKED_LEAF):
    from pnraytracing_tpu_torch.cuda_build import library

    r, dev = o.x.shape[0], o.x.device
    (t, tri, b1, b2), stats = _outputs(r, dev, True, with_stats)
    f32 = lambda: torch.empty(r, dtype=torch.float32, device=dev)
    attrs = (f32(), f32(), f32(), f32(), f32(),
             torch.empty(r, dtype=torch.int32, device=dev)) \
        if attr else (None,) * 6
    err = library("traverse").pnrt_closest_hit(
        ptr(trav.nodes16c), ptr(trav.tri12), ptr(trav.tri_attr16),
        ptr(o.x), ptr(o.y), ptr(o.z), ptr(d.x), ptr(d.y), ptr(d.z),
        ptr(t_max), ptr(mask), r, int(attr), int(compat), int(max_leaf),
        ptr(t), ptr(tri),
        ptr(b1), ptr(b2), *[ptr(a) for a in attrs], ptr(stats),
        stream_of(o.x))
    _raise_on(err, "closest-hit")
    launched(LAUNCHES, launch_name(
        "closest_hit_attr" if attr else "closest_hit", compat))
    return Hit(tri=tri, t=t, b1=b1, b2=b2), (attrs if attr else None), stats


def _kernel_any(trav, o, d, t_max, mask, with_stats, compat,
                max_leaf=MAX_PACKED_LEAF):
    from pnraytracing_tpu_torch.cuda_build import library

    (occ,), stats = _outputs(o.x.shape[0], o.x.device, False, with_stats)
    err = library("traverse").pnrt_any_hit(
        ptr(trav.nodes16c), ptr(trav.tri12), ptr(o.x), ptr(o.y),
        ptr(o.z), ptr(d.x), ptr(d.y), ptr(d.z), ptr(t_max),
        ptr(mask), o.x.shape[0], int(compat), int(max_leaf), ptr(occ),
        ptr(stats),
        stream_of(o.x))
    _raise_on(err, "any-hit")
    launched(LAUNCHES, launch_name("any_hit", compat))
    return occ, stats


def _kernel_binary(trav, o, d, t_max, mask, closest, with_stats, compat,
                   max_leaf=MAX_PACKED_LEAF):
    from pnraytracing_tpu_torch.cuda_build import library

    r = o.x.shape[0]
    outs, stats = _outputs(r, o.x.device, closest, with_stats)
    rays = (ptr(o.x), ptr(o.y), ptr(o.z), ptr(d.x), ptr(d.y), ptr(d.z),
            ptr(t_max), ptr(mask), r, int(compat), int(max_leaf))
    lib = library("traverse")
    fn = lib.pnrt_closest_hit_binary if closest else lib.pnrt_any_hit_binary
    err = fn(ptr(trav.nodes8), ptr(trav.tri12), *rays,
             *[ptr(x) for x in outs], ptr(stats), stream_of(o.x))
    name = "closest_hit_binary" if closest else "any_hit_binary"
    _raise_on(err, name)
    launched(LAUNCHES, launch_name(name, compat))
    if closest:
        t, tri, b1, b2 = outs
        return Hit(tri=tri, t=t, b1=b1, b2=b2), stats
    return outs[0], stats


# ---- the plain versions ---------------------------------------------------

@dataclasses.dataclass
class Rays:
    """Per-ray components of a plain walk (origins, directions, their
    safe inverses, the watertight setup, t_max) and whether the walk
    takes the compat forms of the tests."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    t_max: torch.Tensor
    compat: bool = False

    def __post_init__(self):
        self.inv = (safe_inv_dir(self.dx), safe_inv_dir(self.dy),
                    safe_inv_dir(self.dz))
        self.setup = triangle_setup_c(self.dx, self.dy, self.dz,
                                      compat=self.compat)

    @classmethod
    def of(cls, o: V3, d: V3, t_max, compat: bool = False):
        return cls(o.x, o.y, o.z, d.x, d.y, d.z, t_max, compat)

    def slab(self, rows, bmin, bmax, t_lim):
        """intersect_aabb_c of rays ``rows`` against boxes [n, 3] x 2."""
        return intersect_aabb_c(
            (bmin[:, 0], bmin[:, 1], bmin[:, 2]),
            (bmax[:, 0], bmax[:, 1], bmax[:, 2]),
            self.ox[rows], self.oy[rows], self.oz[rows], self.inv[0][rows],
            self.inv[1][rows], self.inv[2][rows], t_lim, compat=self.compat)

    def triangle(self, rows, p, t_lim):
        """intersect_triangle_c of rays ``rows`` against triangles [n, 9]."""
        return intersect_triangle_c(
            (p[:, 0], p[:, 1], p[:, 2]), (p[:, 3], p[:, 4], p[:, 5]),
            (p[:, 6], p[:, 7], p[:, 8]),
            self.ox[rows], self.oy[rows], self.oz[rows], self.dx[rows],
            self.dy[rows], self.dz[rows], t_lim,
            setup=tuple(s[rows] for s in self.setup))

    def d_on(self, rows, axis):
        return torch.where(axis == 0, self.dx[rows],
                           torch.where(axis == 1, self.dy[rows],
                                       self.dz[rows]))


class WalkState:
    """The results a plain walk carries per ray: the closest hit, the
    occlusion flag and the stats (``n_stats`` rows:
    pops, leaf pops, triangle tests, and what the walk adds); a leaf's
    tests stop after ``max_leaf`` triangles."""

    def __init__(self, ray: Rays, mode: str, n_stats: int = 3,
                 max_leaf: int = MAX_PACKED_LEAF):
        r, dev = ray.t_max.shape[0], ray.t_max.device
        self.max_leaf = max_leaf
        self.any_mode = mode == "any"
        self.t_best = ray.t_max.clone()
        self.tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
        self.b1 = torch.zeros(r, dtype=torch.float32, device=dev)
        self.b2 = torch.zeros_like(self.b1)
        self.occ = torch.zeros(r, dtype=torch.bool, device=dev)
        self.stats = torch.zeros((n_stats, r), dtype=torch.int32,
                                 device=dev)

    def t_lim(self, ray: Rays, rows):
        return ray.t_max[rows] if self.any_mode else self.t_best[rows]

    def test_leaves(self, ray: Rays, lrows, start, count, fetch_tri):
        """The triangle tests of leaf pops ``lrows`` (leaf k of row j is
        triangle start[j] + k), in slot order; ``fetch_tri(rows, ti)``
        gives their [n, 9] corners and global ids."""
        self.stats[1, lrows] += 1
        count = count.clamp(max=self.max_leaf)
        for k in range(int(count.max()) if count.numel() else 0):
            sel = count > k
            if self.any_mode:
                sel = sel & ~self.occ[lrows]
            rows = lrows[sel]
            if rows.numel() == 0:
                continue
            p, ids = fetch_tri(rows, start[sel] + k)
            self.stats[2, rows] += 1
            t_lim = self.t_lim(ray, rows)
            hit, t, b1, b2 = ray.triangle(rows, p, t_lim)
            if self.any_mode:
                self.occ[rows[hit]] = True
                continue
            win = hit & (t < t_lim)
            w = rows[win]
            self.t_best[w] = t[win]
            self.tri[w] = ids[win].to(torch.int32)
            b1w, b2w = b1[win], b2[win]
            self.b1[w] = b1w
            self.b2[w] = b2w

    def hit(self) -> Hit:
        return Hit(tri=self.tri, t=self.t_best, b1=self.b1, b2=self.b2)


# tri_attr16 columns of the three corners' values of nx, ny, nz, u, v
_ATTR_COLUMNS = ((0, 3, 6), (1, 4, 7), (2, 5, 8), (9, 11, 13), (10, 12, 14))


def interaction_fill(tri_attr16, tri, b1, b2):
    """The interaction fill ``(nx, ny, nz, u, v, mt)`` of hits ``tri``
    [R] int32 at barycentrics ``b1``, ``b2``: each value interpolated as
    ``a0 * (1 - b1 - b2) + a1 * b1 + a2 * b2`` from the triangle's row of
    ``tri_attr16``, ``mt`` its material/texture word; on a miss
    (``tri < 0``) the defaults: normal +z, uv 0, word 0.  It depends on
    the winning hit alone, so the kernel evaluates it once after its
    walk, in this order of operations."""
    valid = tri >= 0
    a = tri_attr16[tri.clamp(min=0).long()]
    b0 = 1.0 - b1 - b2
    default = (0.0, 0.0, 1.0, 0.0, 0.0)
    out = [torch.where(valid, a[:, c0] * b0 + a[:, c1] * b1 + a[:, c2] * b2,
                       torch.full_like(b1, miss))
           for (c0, c1, c2), miss in zip(_ATTR_COLUMNS, default)]
    word = a[:, 15].to(torch.int32)
    return (*out, torch.where(valid, word, torch.zeros_like(word)))


def order_children(ray: Rays, rows, row, t_lim):
    """Both children of wide rows [n, 16] slab-tested against ``t_lim``:
    (near, far, hit near, hit far) by each ray's direction sign on the
    row's split axis."""
    lmin, lmax, rmin, rmax, li, ri, axis = unpack_wide_rows(row)
    hl = ray.slab(rows, lmin, lmax, t_lim)
    hr = ray.slab(rows, rmin, rmax, t_lim)
    d_neg = ray.d_on(rows, axis) < 0
    return (torch.where(d_neg, ri, li), torch.where(d_neg, li, ri),
            torch.where(d_neg, hr, hl), torch.where(d_neg, hl, hr))


def walking(mask, o: V3, d: V3) -> torch.Tensor:
    """[R] bool: the rays a walk starts, those of ``mask`` (all when None)
    that are not :func:`never_enters` rays, as in the kernels."""
    ok = ~never_enters(o, d)
    return ok if mask is None else ok & mask


def push(stack, top, rows, entry, commit):
    """Write ``entry`` at each row's free slot ``top`` and advance ``top``
    where ``commit`` (slots >= top are free, so the write is harmless
    where it does not commit)."""
    t0 = top[rows]
    stack[rows, t0.clamp(max=stack.shape[1] - 1)] = entry
    top[rows] = t0 + commit


def wide_walk(ray: Rays, st: WalkState, active, stack_depth: int,
              fetch_row, fetch_tri, chunk: int = 1):
    """Plain version of the kernels' push-test wide walk: every ray keeps
    its own stack (a row of an [R, stack_depth] tensor); each step pops
    one entry for every ray whose stack is not empty and works on just
    those rays (the loop's condition read every ``chunk`` steps,
    accel/loops.py).  ``fetch_row(rows, info)`` gives the popped wide
    rows [n, 16]."""
    r, dev = ray.t_max.shape[0], ray.t_max.device
    stack = torch.zeros((r, stack_depth), dtype=torch.int32, device=dev)
    top = active.to(torch.int64)  # the root row 0 sits in slot 0

    def step(_):
        idx = torch.nonzero(top > 0).squeeze(1)
        if idx.numel() == 0:
            return None
        top[idx] -= 1
        info = stack[idx, top[idx]]
        st.stats[0, idx] += 1
        leaf = info < 0

        lrows = idx[leaf]
        if lrows.numel():
            st.test_leaves(ray, lrows, *decode_leaf_info(info[leaf]),
                           fetch_tri)

        irows = idx[~leaf]
        if irows.numel():
            near, far, h_near, h_far = order_children(
                ray, irows, fetch_row(irows, info[~leaf].long()),
                st.t_lim(ray, irows))
            push(stack, top, irows, far, h_far)
            push(stack, top, irows, near, h_near)

        if st.any_mode:
            top[st.occ] = 0
        return None

    chunked_while(lambda _: bool((top > 0).any()), step, None, chunk)


def _walk_plain(trav: TravData, o: V3, d: V3, t_max, mask, stack_depth: int,
                mode: str, compat: bool, max_leaf: int = MAX_PACKED_LEAF,
                chunk: int = 1):
    """The resident wide walk of csrc/traverse.cu, plainly: same visit
    order, same arithmetic, same results.  ``mode``: 'closest' or 'any'."""
    ray = Rays.of(o, d, t_max, compat)
    st = WalkState(ray, mode, max_leaf=max_leaf)
    wide_walk(ray, st, walking(mask, o, d), stack_depth,
              lambda rows, info: trav.nodes16c[info],
              lambda rows, ti: (trav.tri9[ti], ti), chunk)
    return st


def _walk_plain_binary(trav: TravData, o: V3, d: V3, t_max, mask,
                       stack_depth: int, mode: str, compat: bool,
                       max_leaf: int = MAX_PACKED_LEAF, chunk: int = 1):
    """The binary pop-test walk of csrc/traverse.cu, plainly: a popped
    node tests its own box against the ray's t, then tests its leaf's
    triangles or pushes both children (left = node + 1), far first."""
    ray = Rays.of(o, d, t_max, compat)
    st = WalkState(ray, mode, max_leaf=max_leaf)
    r, dev = t_max.shape[0], t_max.device
    stack = torch.zeros((r, stack_depth), dtype=torch.int32, device=dev)
    top = walking(mask, o, d).to(torch.int64)
    nodes = trav.nodes8

    def step(_):
        idx = torch.nonzero(top > 0).squeeze(1)
        if idx.numel() == 0:
            return None
        top[idx] -= 1
        node = stack[idx, top[idx]]
        st.stats[0, idx] += 1
        row = nodes[node.long()]
        nmin, nmax, right, start, count, axis = unpack_node_rows(row)
        hit = ray.slab(idx, nmin, nmax, st.t_lim(ray, idx))
        leaf = hit & (right < 0)
        lrows = idx[leaf]
        if lrows.numel():
            st.test_leaves(ray, lrows, start[leaf], count[leaf],
                           lambda rows, ti: (trav.tri9[ti], ti))
        inner = hit & (right >= 0)
        irows = idx[inner]
        if irows.numel():
            left, right = node[inner] + 1, right[inner]
            d_neg = ray.d_on(irows, axis[inner]) < 0
            one = torch.ones_like(irows)
            push(stack, top, irows, torch.where(d_neg, left, right), one)
            push(stack, top, irows, torch.where(d_neg, right, left), one)
        if st.any_mode:
            top[st.occ] = 0
        return None

    chunked_while(lambda _: bool((top > 0).any()), step, None, chunk)
    return st


def plain_closest_hit_attr(trav, o, d, t_max, mask=None, *, stack_depth=64,
                           with_stats=False, compat=False,
                           max_leaf_size=MAX_PACKED_LEAF):
    """The plain version of :func:`closest_hit_attr` on any device (also
    for holding the kernel against it on the card); never launches a
    kernel."""
    st = _walk_plain(trav, o, d, t_max, mask, stack_depth, "closest", compat,
                     max_leaf_size)
    out = (st.hit(), interaction_fill(trav.tri_attr16, st.tri, st.b1, st.b2))
    return out + (st.stats,) if with_stats else out


def plain_closest_hit(trav, o, d, t_max, mask=None, *, stack_depth=64,
                      with_stats=False, compat=False,
                      max_leaf_size=MAX_PACKED_LEAF, chunk=1):
    st = _walk_plain(trav, o, d, t_max, mask, stack_depth, "closest", compat,
                     max_leaf_size, chunk)
    return (st.hit(), st.stats) if with_stats else st.hit()


def plain_any_hit(trav, o, d, t_max, mask=None, *, stack_depth=64,
                  with_stats=False, compat=False,
                  max_leaf_size=MAX_PACKED_LEAF, chunk=1):
    st = _walk_plain(trav, o, d, t_max, mask, stack_depth, "any", compat,
                     max_leaf_size, chunk)
    return (st.occ, st.stats) if with_stats else st.occ


def plain_closest_hit_binary(trav, o, d, t_max, mask=None, *,
                             stack_depth=64, with_stats=False, compat=False,
                             max_leaf_size=MAX_PACKED_LEAF, chunk=1):
    st = _walk_plain_binary(trav, o, d, t_max, mask, stack_depth, "closest",
                            compat, max_leaf_size, chunk)
    return (st.hit(), st.stats) if with_stats else st.hit()


def plain_any_hit_binary(trav, o, d, t_max, mask=None, *, stack_depth=64,
                         with_stats=False, compat=False,
                         max_leaf_size=MAX_PACKED_LEAF, chunk=1):
    st = _walk_plain_binary(trav, o, d, t_max, mask, stack_depth, "any",
                            compat, max_leaf_size, chunk)
    return (st.occ, st.stats) if with_stats else st.occ


# ---- the entry points -----------------------------------------------------

def closest_hit_attr(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                     mask: torch.Tensor | None = None, *,
                     stack_depth: int = 64, with_stats: bool = False,
                     compat: bool = False,
                     max_leaf_size: int = MAX_PACKED_LEAF):
    """Closest hit + interaction fill: ``(Hit, (nx, ny, nz, u, v, mt))``
    (+ stats).  ``nx..nz`` is the barycentric-interpolated, unnormalized,
    unflipped shading normal; ``mt`` the int32 material/texture word."""
    o, d, t_max, mask = detached(o, d, t_max, mask)
    cap = _leaf_cap(max_leaf_size)
    if _check(trav, o, d, t_max, mask, stack_depth, "attr").type == "cpu":
        return plain_closest_hit_attr(trav, o, d, t_max, mask,
                                      stack_depth=stack_depth,
                                      with_stats=with_stats, compat=compat,
                                      max_leaf_size=cap)
    hit, attrs, stats = _kernel_closest(trav, o, d, t_max, mask, True,
                                        with_stats, compat, cap)
    return (hit, attrs, stats) if with_stats else (hit, attrs)


def _leaf_cap(max_leaf_size: int) -> int:
    if max_leaf_size < 0:
        raise ValueError(f"max_leaf_size must be >= 0, got {max_leaf_size}")
    return min(int(max_leaf_size), MAX_PACKED_LEAF)


def closest_hit(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                mask: torch.Tensor | None = None, *, stack_depth: int = 64,
                variant: str = "wide", with_stats: bool = False,
                compat: bool = False,
                max_leaf_size: int = MAX_PACKED_LEAF):
    """Closest hit: ``Hit`` (+ stats), by the wide or binary walk."""
    o, d, t_max, mask = detached(o, d, t_max, mask)
    variant = pick_variant(trav, variant)
    binary = variant == "binary"
    cap = _leaf_cap(max_leaf_size)
    if _check(trav, o, d, t_max, mask, stack_depth, variant).type == "cpu":
        fn = plain_closest_hit_binary if binary else plain_closest_hit
        return fn(trav, o, d, t_max, mask, stack_depth=stack_depth,
                  with_stats=with_stats, compat=compat, max_leaf_size=cap)
    if binary:
        hit, stats = _kernel_binary(trav, o, d, t_max, mask, True,
                                    with_stats, compat, cap)
    else:
        hit, _, stats = _kernel_closest(trav, o, d, t_max, mask, False,
                                        with_stats, compat, cap)
    return (hit, stats) if with_stats else hit


def any_hit(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
            mask: torch.Tensor | None = None, *, stack_depth: int = 64,
            variant: str = "wide", with_stats: bool = False,
            compat: bool = False, max_leaf_size: int = MAX_PACKED_LEAF):
    """Occlusion: True where a triangle is hit within ``t_max`` (+ stats),
    by the wide or binary walk."""
    o, d, t_max, mask = detached(o, d, t_max, mask)
    variant = pick_variant(trav, variant)
    binary = variant == "binary"
    cap = _leaf_cap(max_leaf_size)
    if _check(trav, o, d, t_max, mask, stack_depth, variant).type == "cpu":
        fn = plain_any_hit_binary if binary else plain_any_hit
        return fn(trav, o, d, t_max, mask, stack_depth=stack_depth,
                  with_stats=with_stats, compat=compat, max_leaf_size=cap)
    if binary:
        occ, stats = _kernel_binary(trav, o, d, t_max, mask, False,
                                    with_stats, compat, cap)
    else:
        occ, stats = _kernel_any(trav, o, d, t_max, mask, with_stats, compat,
                                 cap)
    return (occ, stats) if with_stats else occ
