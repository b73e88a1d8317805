"""Brick-streaming BVH traversal: the hand-written CUDA kernels and their
plain versions.

PyTorch/CUDA counterpart of ``pnraytracing_tpu/accel/traverse_stream.py``
(``closest_hit_stream`` / ``any_hit_stream`` over
``_make_stream_kernel``).  The kernels live in ``csrc/traverse_stream.cu``;
see the note there for their design and bound.  They read the scene's
brick layout (``trav.stream``, accel/bricks.py) where it lies in device
memory: the top tree ``top16`` and the brick blobs ``bricks``.  One
thread a ray walks the top tree near child first and enters each brick
the moment it pops the brick's ref, so a brick behind the closest hit so
far is never entered.

Each wrapper checks its inputs and then

* on CUDA tensors launches its kernel on the current stream and adds one
  to its entry of :data:`LAUNCHES`; it raises if the nested walk could
  need a deeper stack than the kernel keeps;
* on CPU tensors runs the plain PyTorch version (``plain_*``), which
  walks the same layout in the kernel's order.

Results as in accel/traverse_cuda.py.  ``with_stats`` adds a [4, R] int32
tensor of per-ray pops (top tree and bricks), leaf pops, triangle tests
and bricks entered.  ``compat`` as there: the reference's tests, so a
closest walk also enters the bricks behind its hit; the compat
instantiation counts under ``closest_hit_stream_compat`` /
``any_hit_stream_compat``.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel.bricks import BRICK_HEADER_WORDS
from pnraytracing_tpu_torch.accel.layout import (
    MAX_PACKED_LEAF,
    TravData,
    decode_leaf_info,
)
from pnraytracing_tpu_torch.accel.traverse_cuda import (
    KERNEL_STACK,
    Rays,
    WalkState,
    _leaf_cap,
    _outputs,
    _raise_on,
    check_mask,
    check_rays,
    check_table,
    detached,
    launch_name,
    order_children,
    ptr,
    push,
    stream_of,
    walking,
)
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import Hit
from pnraytracing_tpu_torch.utils.profiling import launched

# Launches per kernel since the last reset (the caller zeroes them).
LAUNCHES = {k + c: 0 for c in ("", "_compat")
            for k in ("closest_hit_stream", "any_hit_stream")}


def walk_stack_depth(stream) -> int:
    """Stack entries the nested walk can need: the top tree's and one
    brick's, each at most ``brick_stack`` (accel/bricks.py sizes it for
    the deeper of the two)."""
    return 2 * stream.brick_stack


def check_walk_depth(stream, dev) -> None:
    """Raise if ``dev`` is the card and the nested walk over ``stream``
    could need more stack than the kernel keeps (the plain version sizes
    its stack by the layout)."""
    if dev.type == "cuda" and walk_stack_depth(stream) > KERNEL_STACK:
        raise ValueError(
            f"the CUDA walk keeps a {KERNEL_STACK}-entry stack; the top "
            f"tree and a brick of this layout can need "
            f"{walk_stack_depth(stream)} (2 x brick_stack "
            f"{stream.brick_stack})")


def _check(trav: TravData, o: V3, d: V3, t_max, mask):
    r, dev = check_rays(o, d, t_max)
    check_mask(mask, r, dev)
    s = trav.stream
    if s is None:
        raise ValueError("the scene has no stream layout (trav.stream); "
                         "accel/bricks.py::build_stream_data builds it")
    check_table("stream.top16", s.top16, 16, dev, align=True)
    check_table("stream.bricks", s.bricks, s.brick_words, dev, align=True)
    if (s.bricks.shape[0] != s.n_bricks or s.brick_words % 4
            or s.top16.shape[0] != s.n_top_rows):
        raise ValueError("stream.bricks must hold n_bricks rows of a "
                         "multiple of 4 words, stream.top16 n_top_rows rows")
    check_walk_depth(s, dev)
    return dev


def kernel_info(trav: TravData) -> dict:
    """Registers a thread, threads a block and blocks an SM can hold of
    the two kernels, both instantiations (the compat ones under their
    ``_compat`` names), as the CUDA runtime reports them on this card."""
    from pnraytracing_tpu_torch.cuda_build import library

    fn = library("traverse_stream").pnrt_stream_kernel_info
    return {launch_name(name, compat): {
                "registers": fn(closest, int(compat), 0),
                "blocks_per_sm": fn(closest, int(compat), 1),
                "threads": fn(closest, int(compat), 2)}
            for compat in (False, True)
            for name, closest in (("closest_hit_stream", 1),
                                  ("any_hit_stream", 0))}


def _kernel(trav, o, d, t_max, mask, closest, with_stats, compat,
            max_leaf):
    from pnraytracing_tpu_torch.cuda_build import library

    s = trav.stream
    r, dev = o.x.shape[0], o.x.device
    outs, stats = _outputs(r, dev, closest, with_stats, n_stats=4)
    hit_outs = outs if closest else (None,) * 4
    occ = None if closest else outs[0]
    err = library("traverse_stream").pnrt_stream(
        int(closest), int(compat), int(max_leaf), ptr(s.top16),
        ptr(s.bricks),
        s.brick_words, ptr(o.x), ptr(o.y), ptr(o.z), ptr(d.x), ptr(d.y),
        ptr(d.z), ptr(t_max), ptr(mask), r, *[ptr(x) for x in hit_outs],
        ptr(occ), ptr(stats), stream_of(o.x))
    name = "closest_hit_stream" if closest else "any_hit_stream"
    _raise_on(err, name)
    launched(LAUNCHES, launch_name(name, compat))
    if closest:
        t, tri, b1, b2 = outs
        return Hit(tri=tri, t=t, b1=b1, b2=b2), stats
    return occ, stats


# ---- the plain versions ---------------------------------------------------

def _walk_plain(trav: TravData, o: V3, d: V3, t_max, mask, mode: str,
                compat: bool, max_leaf: int):
    """The stream kernel's walk, plainly: every ray keeps one stack (a
    row of an [R, depth] tensor) whose entries carry the brick they
    belong to in a second tensor (-1: the top tree).  Each step pops one
    entry for every ray whose stack is not empty.  A negative top-tree
    entry is a brick ref and is walked as that brick's row 0 at once; a
    negative brick entry is a leaf; the rest are wide rows, whose hit
    children are pushed far first.  Closest mode tests boxes against
    t_best, any mode against t_max and stops at the first occluder (with
    ``compat``, against nothing)."""
    s = trav.stream
    ray = Rays.of(o, d, t_max, compat)
    st = WalkState(ray, mode, n_stats=4, max_leaf=max_leaf)
    r, dev = t_max.shape[0], t_max.device
    depth = walk_stack_depth(s)
    stack = torch.zeros((r, depth), dtype=torch.int32, device=dev)
    owner = torch.full((r, depth), -1, dtype=torch.int32, device=dev)
    top = walking(mask, o, d).to(torch.int64)

    flat = s.bricks.reshape(-1)
    w = s.brick_words
    tris_off = s.bricks[:, 0].long()
    tri_base = s.bricks[:, 1].long()
    ar16 = torch.arange(16, device=dev)
    ar9 = torch.arange(9, device=dev)
    cur = torch.zeros(r, dtype=torch.int64, device=dev)  # a leaf's brick

    def fetch_tri(rows, ti):
        b = cur[rows]
        base = b * w + tris_off[b] + 9 * ti
        return flat[base[:, None] + ar9], tri_base[b] + ti

    while True:
        idx = torch.nonzero(top > 0).squeeze(1)
        if idx.numel() == 0:
            break
        top[idx] -= 1
        info = stack[idx, top[idx]].long()
        brick = owner[idx, top[idx]].long()
        st.stats[0, idx] += 1
        ref = (brick < 0) & (info < 0)  # enter the brick: its row 0
        st.stats[3, idx[ref]] += 1
        brick = torch.where(ref, -info - 1, brick)
        info = torch.where(ref, torch.zeros_like(info), info)
        leaf = info < 0

        lrows = idx[leaf]
        if lrows.numel():
            cur[lrows] = brick[leaf]
            st.test_leaves(ray, lrows, *decode_leaf_info(info[leaf]),
                           fetch_tri)

        irows = idx[~leaf]
        if irows.numel():
            b, k = brick[~leaf], info[~leaf]
            in_top = b < 0
            at = torch.where(in_top, 0, b * w + BRICK_HEADER_WORDS + 16 * k)
            row = flat[at[:, None] + ar16]
            row[in_top] = s.top16[k[in_top]]
            near, far, h_near, h_far = order_children(ray, irows, row,
                                                      st.t_lim(ray, irows))
            for c, h in ((far, h_far), (near, h_near)):
                owner[irows, top[irows].clamp(max=depth - 1)] = b.to(
                    torch.int32)
                push(stack, top, irows, c, h)

        if st.any_mode:
            top[st.occ] = 0
    return st


def plain_closest_hit_stream(trav, o, d, t_max, mask=None, *,
                             stack_depth=64, with_stats=False, compat=False,
                             max_leaf_size=MAX_PACKED_LEAF):
    """The plain version of :func:`closest_hit_stream` on any device (also
    for holding the kernel against it on the card); never launches a
    kernel."""
    st = _walk_plain(trav, o, d, t_max, mask, "closest", compat,
                     max_leaf_size)
    return (st.hit(), st.stats) if with_stats else st.hit()


def plain_any_hit_stream(trav, o, d, t_max, mask=None, *, stack_depth=64,
                         with_stats=False, compat=False,
                         max_leaf_size=MAX_PACKED_LEAF):
    st = _walk_plain(trav, o, d, t_max, mask, "any", compat, max_leaf_size)
    return (st.occ, st.stats) if with_stats else st.occ


# ---- the entry points -----------------------------------------------------

def closest_hit_stream(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                       mask: torch.Tensor | None = None, *,
                       stack_depth: int = 64, with_stats: bool = False,
                       compat: bool = False,
                       max_leaf_size: int = MAX_PACKED_LEAF):
    """Closest hit over the brick layout: ``Hit`` (+ stats).
    ``stack_depth`` is unused, as in the JAX package: the walk's depth
    follows from the layout's ``brick_stack``."""
    o, d, t_max, mask = detached(o, d, t_max, mask)
    cap = _leaf_cap(max_leaf_size)
    if _check(trav, o, d, t_max, mask).type == "cpu":
        return plain_closest_hit_stream(trav, o, d, t_max, mask,
                                        with_stats=with_stats, compat=compat,
                                        max_leaf_size=cap)
    hit, stats = _kernel(trav, o, d, t_max, mask, True, with_stats, compat,
                         cap)
    return (hit, stats) if with_stats else hit


def any_hit_stream(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                   mask: torch.Tensor | None = None, *,
                   stack_depth: int = 64, with_stats: bool = False,
                   compat: bool = False,
                   max_leaf_size: int = MAX_PACKED_LEAF):
    """Occlusion over the brick layout (+ stats)."""
    o, d, t_max, mask = detached(o, d, t_max, mask)
    cap = _leaf_cap(max_leaf_size)
    if _check(trav, o, d, t_max, mask).type == "cpu":
        return plain_any_hit_stream(trav, o, d, t_max, mask,
                                    with_stats=with_stats, compat=compat,
                                    max_leaf_size=cap)
    occ, stats = _kernel(trav, o, d, t_max, mask, False, with_stats, compat,
                         cap)
    return (occ, stats) if with_stats else occ
