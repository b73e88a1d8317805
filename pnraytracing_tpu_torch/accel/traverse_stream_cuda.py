"""Brick-streaming BVH traversal: the hand-written CUDA kernels and their
plain versions.

PyTorch/CUDA counterpart of ``pnraytracing_tpu/accel/traverse_stream.py``
(``closest_hit_stream`` / ``any_hit_stream`` over
``_make_stream_kernel``).  The kernels live in ``csrc/traverse_stream.cu``;
see the note there for their design and bound.  They read the scene's
brick layout (``trav.stream``, accel/bricks.py): the top tree ``top16``
and the brick blobs ``bricks``.

Each wrapper checks its inputs and then

* on CUDA tensors launches its kernel on the current stream and adds one
  to its entry of :data:`LAUNCHES`; it raises if the bricks do not fit
  the shared memory a block can have;
* on CPU tensors runs the plain PyTorch version (``plain_*``), which
  walks the same layout and visits each ray's bricks in the kernel's
  order (ascending brick id).

Results as in accel/traverse_cuda.py.  ``with_stats`` adds an [3, R]
int32 tensor of per-ray pops (top tree and bricks), leaf pops and
triangle tests, and an [ceil(R / 128)] int32 tensor of the bricks each
block of 128 rays staged.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel.bricks import BRICK_HEADER_WORDS
from pnraytracing_tpu_torch.accel.layout import TravData
from pnraytracing_tpu_torch.accel.traverse_cuda import (
    KERNEL_STACK,
    Rays,
    WalkState,
    _outputs,
    _raise_on,
    check_mask,
    check_rays,
    check_table,
    order_children,
    ptr,
    push,
    stream_of,
    wide_walk,
)
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import Hit

# Launches per kernel since the last reset (the caller zeroes them).
LAUNCHES = {"closest_hit_stream": 0, "any_hit_stream": 0}

BLOCK_RAYS = 128  # rays per block (kThreads of csrc/traverse_stream.cu)
# dynamic shared memory one block can opt into on sm_90 (227 KB)
MAX_SHARED_BYTES = 232448


def _check(trav: TravData, o: V3, d: V3, t_max, mask):
    r, dev = check_rays(o, d, t_max)
    check_mask(mask, r, dev)
    s = trav.stream
    if s is None:
        raise ValueError("the scene has no stream layout (trav.stream); "
                         "accel/bricks.py::build_stream_data builds it")
    check_table("stream.top16", s.top16, 16, dev, align=True)
    check_table("stream.bricks", s.bricks, s.brick_words, dev, align=True)
    if s.bricks.shape[0] != s.n_bricks or s.brick_words % 4:
        raise ValueError("stream.bricks must hold n_bricks rows of a "
                         "multiple of 4 words")
    if dev.type == "cuda" and s.brick_stack > KERNEL_STACK:
        raise ValueError(f"the CUDA walk keeps a {KERNEL_STACK}-entry "
                         f"stack; the layout needs {s.brick_stack}")
    return dev


def stream_smem_bytes(trav: TravData) -> int:
    """Dynamic shared memory per block that the stream kernel asks for on
    this layout (one brick slot + the per-thread brick masks)."""
    from pnraytracing_tpu_torch.cuda_build import library

    s = trav.stream
    return int(library("traverse_stream").pnrt_stream_smem_bytes(
        s.brick_words, s.n_bricks))


def _kernel(trav, o, d, t_max, mask, closest, with_stats):
    from pnraytracing_tpu_torch.cuda_build import library

    s = trav.stream
    smem = stream_smem_bytes(trav)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"bricks of {s.brick_words} words need {smem} B of shared memory "
            f"per block, more than the {MAX_SHARED_BYTES} B a block can "
            "have; rebuild the layout with a smaller brick_budget_bytes")
    r, dev = o.x.shape[0], o.x.device
    outs, stats = _outputs(r, dev, closest, with_stats)
    block_stats = (torch.empty((r + BLOCK_RAYS - 1) // BLOCK_RAYS,
                               dtype=torch.int32, device=dev)
                   if with_stats else None)
    hit_outs = outs if closest else (None,) * 4
    occ = None if closest else outs[0]
    err = library("traverse_stream").pnrt_stream(
        int(closest), ptr(s.top16), ptr(s.bricks), s.brick_words,
        s.n_bricks, ptr(o.x), ptr(o.y), ptr(o.z), ptr(d.x), ptr(d.y),
        ptr(d.z), ptr(t_max), ptr(mask), r, *[ptr(x) for x in hit_outs],
        ptr(occ), ptr(stats), ptr(block_stats), stream_of(o.x))
    name = "closest_hit_stream" if closest else "any_hit_stream"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    if closest:
        t, tri, b1, b2 = outs
        res = Hit(tri=tri, t=t, b1=b1, b2=b2)
    else:
        res = occ
    return res, stats, block_stats


# ---- the plain versions ---------------------------------------------------

def _reached_bricks(trav: TravData, ray: Rays, active, st: WalkState):
    """[R, n_bricks] bool: the bricks each ray reaches in the top tree
    within t_max (phase 1 of the kernel).  Counts the top pops."""
    s = trav.stream
    r, dev = active.shape[0], active.device
    reached = torch.zeros((r, s.n_bricks), dtype=torch.bool, device=dev)
    stack = torch.zeros((r, s.brick_stack), dtype=torch.int32, device=dev)
    top = active.to(torch.int64)
    while True:
        idx = torch.nonzero(top > 0).squeeze(1)
        if idx.numel() == 0:
            break
        top[idx] -= 1
        row = s.top16[stack[idx, top[idx]].long()]
        st.stats[0, idx] += 1
        near, far, h_near, h_far = order_children(ray, idx, row,
                                                  ray.t_max[idx])
        for c, h in ((far, h_far), (near, h_near)):
            brick = h & (c < 0)
            reached[idx[brick], (-c[brick] - 1).long()] = True
            push(stack, top, idx, c, h & (c >= 0))
    return reached


def _walk_plain(trav: TravData, o: V3, d: V3, t_max, mask, mode: str):
    """The stream kernel's walk, plainly: the top tree, then each ray's
    reached bricks in ascending id, one brick after the other in one
    loop over all rays (a ray whose stack runs empty moves on to its next
    brick); closest mode carries t_best, any mode stops at the first
    occluder.  Returns the WalkState and the per-block staged counts."""
    s = trav.stream
    ray = Rays.of(o, d, t_max)
    st = WalkState(ray, mode)
    active = torch.ones_like(st.occ) if mask is None else mask
    reached = _reached_bricks(trav, ray, active, st)

    # each ray's bricks as one ascending list: pairs sorted by (ray, id)
    pairs = torch.nonzero(reached)
    pair_brick = pairs[:, 1]
    counts = reached.sum(dim=1)
    first = torch.cumsum(counts, 0) - counts
    taken = torch.zeros_like(counts)
    cur = torch.zeros_like(counts)  # the brick each ray walks now

    def refill(rows):
        ok = taken[rows] < counts[rows]
        if st.any_mode:
            ok &= ~st.occ[rows]
        rows = rows[ok]
        cur[rows] = pair_brick[first[rows] + taken[rows]]
        taken[rows] += 1
        return rows

    flat = s.bricks.reshape(-1)
    w = s.brick_words
    tris_off = s.bricks[:, 0].long()
    tri_base = s.bricks[:, 1].long()
    dev = flat.device
    ar16 = torch.arange(16, device=dev)
    ar9 = torch.arange(9, device=dev)

    def fetch_row(rows, info):
        base = cur[rows] * w + BRICK_HEADER_WORDS + 16 * info
        return flat[base[:, None] + ar16]

    def fetch_tri(rows, ti):
        b = cur[rows]
        base = b * w + tris_off[b] + 9 * ti
        return flat[base[:, None] + ar9], tri_base[b] + ti

    wide_walk(ray, st, torch.zeros_like(active), s.brick_stack, fetch_row,
              fetch_tri, refill=refill)

    # bricks a block of BLOCK_RAYS rays stages: those some ray of it still
    # needs (an occluded ray needs none after the brick that occluded it)
    need = reached
    if st.any_mode:
        last = torch.where(st.occ, cur, s.n_bricks)
        need = reached & (torch.arange(s.n_bricks, device=dev)[None, :]
                          <= last[:, None])
    r = need.shape[0]
    pad = (-r) % BLOCK_RAYS
    need = torch.cat([need, need.new_zeros((pad, s.n_bricks))])
    staged = need.reshape(-1, BLOCK_RAYS, s.n_bricks).any(dim=1).sum(dim=1)
    return st, staged.to(torch.int32)


def plain_closest_hit_stream(trav, o, d, t_max, mask=None, *,
                             stack_depth=64, with_stats=False):
    """The plain version of :func:`closest_hit_stream` on any device (also
    for holding the kernel against it on the card); never launches a
    kernel."""
    st, staged = _walk_plain(trav, o, d, t_max, mask, "closest")
    return (st.hit(), st.stats, staged) if with_stats else st.hit()


def plain_any_hit_stream(trav, o, d, t_max, mask=None, *, stack_depth=64,
                         with_stats=False):
    st, staged = _walk_plain(trav, o, d, t_max, mask, "any")
    return (st.occ, st.stats, staged) if with_stats else st.occ


# ---- the entry points -----------------------------------------------------

def closest_hit_stream(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                       mask: torch.Tensor | None = None, *,
                       stack_depth: int = 64, with_stats: bool = False):
    """Closest hit over the brick layout: ``Hit`` (+ stats, block stats).
    ``stack_depth`` is unused, as in the JAX package: the walk's depth is
    the layout's ``brick_stack``."""
    if _check(trav, o, d, t_max, mask).type == "cpu":
        return plain_closest_hit_stream(trav, o, d, t_max, mask,
                                        with_stats=with_stats)
    hit, stats, block_stats = _kernel(trav, o, d, t_max, mask, True,
                                      with_stats)
    return (hit, stats, block_stats) if with_stats else hit


def any_hit_stream(trav: TravData, o: V3, d: V3, t_max: torch.Tensor,
                   mask: torch.Tensor | None = None, *,
                   stack_depth: int = 64, with_stats: bool = False):
    """Occlusion over the brick layout (+ stats, block stats)."""
    if _check(trav, o, d, t_max, mask).type == "cpu":
        return plain_any_hit_stream(trav, o, d, t_max, mask,
                                    with_stats=with_stats)
    occ, stats, block_stats = _kernel(trav, o, d, t_max, mask, False,
                                      with_stats)
    return (occ, stats, block_stats) if with_stats else occ
