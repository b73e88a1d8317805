"""The walk of ``RenderConfig.traversal="wide4"``: the 4-wide
collect-then-test walk, its CUDA kernel and its plain version.

PyTorch counterpart of ``pnraytracing_tpu/accel/traverse_wide4.py``
(``closest_hit_wide4``, ``any_hit_wide4``), an XLA walk over the layout
of ``accel/wide4.py`` (``TravData.w4``, :class:`~pnraytracing_tpu_torch.
accel.layout.Wide4Data`).  Phase 1 walks the wide tree's internal nodes
only, box-testing each popped row's ``width`` children against
``t_max``, pushing the internal ones and appending the leaves to a
per-ray buffer of ``leaf_buffer`` slots; phase 2 tests the buffered
leaves' triangles (``leaf40`` rows).  A ray that collects more leaves
than the buffer holds is marked in ``overflow``; with ``fallback`` its
answer is replaced by ``fallback(o, d, t_max, redo)``'s, ``redo`` the
overflowed active rays (the JAX integrator passes the pop-test walk,
``accel/traverse_packed.py::closest_hit_pop`` / ``any_hit_pop``).

The kernel is ``csrc/traverse_wide4.cu`` (``wide4_walk_kernel``; design
and bound noted there), counted in :data:`LAUNCHES` under
``closest_hit_wide4`` / ``any_hit_wide4`` (+ ``_compat``).  The JAX
package calls its fallback behind ``lax.cond(any(redo))``, which would
read a device value on the host; here the fallback is called for every
batch, with ``redo`` as its mask (on the card a launch of kernel 5 / 6
whose rays are mostly masked), and merged with ``torch.where``, so a
captured frame stays one CUDA graph.  The answers are the same.

Rays are ``V3`` component tensors with ``[R]`` ``t_max`` and an optional
``[R]`` bool mask.  Each entry point detaches its inputs
(``traverse_cuda.detached``), checks them and the layout, then launches
the kernel on CUDA tensors or runs the plain version on CPU tensors.
The plain version reads its phase-1 loop condition every ``chunk``
steps (accel/loops.py); the kernel ignores it.  Returns ``(Hit, overflow)``
or ``(occlusion, overflow)``, ``overflow`` an [R] bool, and with
``with_stats`` a [4, R] int32 of per-ray phase-1 pops, leaves that
passed their box test, phase-2 triangle tests and the overflow flag.
Phase 1's box tests are the clipped slab test also under ``compat``, as
in the JAX walk; ``compat`` selects the triangle test's ray setup.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel.layout import Wide4Data
from pnraytracing_tpu_torch.accel.loops import chunked_while
from pnraytracing_tpu_torch.accel.wide4 import _row_width
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.intersect import Hit, intersect_aabb_c
from pnraytracing_tpu_torch.utils.profiling import launched

_KERNELS = ("closest_hit_wide4", "any_hit_wide4")
# Launches per kernel since the last reset (the caller zeroes them)
LAUNCHES = {k + c: 0 for c in ("", "_compat") for k in _KERNELS}


def _check(w4: Wide4Data, o: V3, d: V3, t_max, mask, stack_depth: int,
           leaf_buffer: int, max_leaf_size: int):
    """The device of a checked walk; raises on what the kernel does not
    take."""
    r, dev = trv.check_rays(o, d, t_max)
    trv.check_mask(mask, r, dev)
    trv.check_table("w4.nodes32", w4.nodes32, _row_width(w4.width), dev)
    if not (w4.leaf40.dim() == 2 and w4.leaf40.shape[1] % 10 == 0):
        raise ValueError("w4.leaf40 must be [NL, 10 * L]")
    trv.check_table("w4.leaf40", w4.leaf40, w4.leaf40.shape[1], dev)
    if stack_depth < 1 or leaf_buffer < 0 or max_leaf_size < 0:
        raise ValueError("stack_depth must be >= 1, leaf_buffer and "
                         "max_leaf_size >= 0")
    if dev.type == "cuda" and stack_depth > trv.KERNEL_STACK:
        raise ValueError(f"the CUDA walk keeps a {trv.KERNEL_STACK}-entry "
                         f"stack; stack_depth={stack_depth} exceeds it")
    return dev


def kernel_info() -> dict:
    """Registers and local bytes a thread, threads a block and blocks an
    SM of the four instantiations, by their LAUNCHES names
    (``traverse_cuda.kernel_attributes``)."""
    from pnraytracing_tpu_torch.cuda_build import library

    return trv.kernel_attributes(
        library("traverse_wide4").pnrt_wide4_kernel_info,
        ((1, "closest_hit_wide4"), (0, "any_hit_wide4")))


def _kernel(w4, o, d, t_max, mask, closest, stack_depth, max_leaf_size,
            compat, leaf_buffer, with_stats):
    from pnraytracing_tpu_torch.cuda_build import library

    r, dev = o.x.shape[0], o.x.device
    outs, _ = trv._outputs(r, dev, closest, False)
    t, tri, b1, b2 = outs if closest else (None,) * 4
    occ = None if closest else outs[0]
    overflow = torch.empty(r, dtype=torch.bool, device=dev)
    stats = (torch.empty((4, r), dtype=torch.int32, device=dev)
             if with_stats else None)
    buf = torch.empty((max(leaf_buffer, 1), r), dtype=torch.int32,
                      device=dev)
    p = trv.ptr
    err = library("traverse_wide4").pnrt_wide4_walk(
        p(w4.nodes32), p(w4.leaf40), int(w4.width), int(w4.nodes32.shape[1]),
        int(w4.leaf40.shape[1]) // 10, int(max_leaf_size), int(stack_depth),
        int(leaf_buffer), p(buf), p(o.x), p(o.y), p(o.z), p(d.x), p(d.y),
        p(d.z), p(t_max), p(mask), r, int(closest), int(compat), p(t),
        p(tri), p(b1), p(b2), p(occ), p(overflow), p(stats),
        trv.stream_of(o.x))
    name = "closest_hit_wide4" if closest else "any_hit_wide4"
    trv._raise_on(err, name)
    launched(LAUNCHES, trv.launch_name(name, compat))
    out = Hit(tri=tri, t=t, b1=b1, b2=b2) if closest else occ
    return out, overflow, stats


# ---- the plain version ----------------------------------------------------

def _collect(w4: Wide4Data, ray: trv.Rays, active, stack_depth: int,
             leaf_buffer: int, stats, chunk: int):
    """Phase 1 of the kernel, plainly: ``(buffer [R, leaf_buffer] int64
    leaf ids, count [R], overflow [R] bool)``; ``stats`` rows 0 and 1
    (pops, leaves that passed) filled in."""
    r, dev = ray.t_max.shape[0], ray.t_max.device
    width = w4.width
    stack = torch.zeros((r, stack_depth), dtype=torch.int64, device=dev)
    top = active.to(torch.int64)  # the root, node 0, in slot 0
    buf = torch.full((r, leaf_buffer), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros(r, dtype=torch.int64, device=dev)
    overflow = torch.zeros(r, dtype=torch.bool, device=dev)

    def step(_):
        idx = torch.nonzero(top > 0).squeeze(1)
        if idx.numel() == 0:
            return None
        top[idx] -= 1
        rows = w4.nodes32[stack[idx, top[idx]]]
        stats[0, idx] += 1
        for k in range(width):  # slot order, as the kernel
            code = rows[:, 6 * width + k].to(torch.int64)
            b = rows[:, 6 * k:6 * k + 6]
            hit = (code != 0) & intersect_aabb_c(
                (b[:, 0], b[:, 1], b[:, 2]), (b[:, 3], b[:, 4], b[:, 5]),
                ray.ox[idx], ray.oy[idx], ray.oz[idx], ray.inv[0][idx],
                ray.inv[1][idx], ray.inv[2][idx], ray.t_max[idx])
            leaf = hit & (code % 2 == 1)
            lrows = idx[leaf]
            stats[1, lrows] += 1
            c = cnt[lrows]
            fits = c < leaf_buffer
            buf[lrows[fits], c[fits]] = torch.div(code[leaf][fits] - 1, 2,
                                                  rounding_mode="floor")
            cnt[lrows[fits]] += 1
            overflow[lrows[~fits]] = True
            inner = hit & (code % 2 == 0)
            irows = idx[inner]
            t0 = top[irows]
            room = t0 < stack_depth
            stack[irows[room], t0[room]] = torch.div(
                code[inner][room], 2, rounding_mode="floor") - 1
            top[irows[room]] += 1
        return None

    chunked_while(lambda _: bool((top > 0).any()), step, None, chunk)
    return buf, cnt, overflow


def _plain(w4, o, d, t_max, mask, closest, stack_depth, max_leaf_size,
           compat, leaf_buffer, chunk):
    ray = trv.Rays.of(o, d, t_max, compat)
    st = trv.WalkState(ray, "closest" if closest else "any", n_stats=4)
    buf, cnt, overflow = _collect(w4, ray, trv.walking(mask, o, d),
                                  stack_depth, leaf_buffer, st.stats, chunk)
    st.stats[3] = overflow.to(torch.int32)
    leaf_l = w4.leaf40.shape[1] // 10
    per_leaf = min(max_leaf_size, leaf_l)
    for s in range(leaf_buffer):  # phase 2, in collection order
        rows = torch.nonzero(cnt > s).squeeze(1)
        if rows.numel() == 0:
            break
        lr = w4.leaf40[buf[rows, s]]
        for k in range(per_leaf):
            tid = lr[:, 9 * leaf_l + k].to(torch.int32)
            sel = tid >= 0
            if not closest:
                sel = sel & ~st.occ[rows]
            if not bool(sel.any()):
                continue
            rs = rows[sel]
            st.stats[2, rs] += 1
            t_lim = st.t_lim(ray, rs)
            hit, t, b1, b2 = ray.triangle(rs, lr[sel, 9 * k:9 * k + 9],
                                          t_lim)
            if not closest:
                st.occ[rs[hit]] = True
                continue
            win = hit & (t < t_lim)
            w = rs[win]
            st.t_best[w] = t[win]
            st.tri[w] = tid[sel][win]
            st.b1[w] = b1[win]
            st.b2[w] = b2[win]
    return (st.hit() if closest else st.occ), overflow, st.stats


# ---- the entry points -----------------------------------------------------

def _walk(w4, o, d, t_max, mask, closest, stack_depth, max_leaf_size,
          compat, leaf_buffer, chunk, fallback, with_stats, plain=False):
    o, d, t_max, mask = trv.detached(o, d, t_max, mask)
    dev = _check(w4, o, d, t_max, mask, stack_depth, leaf_buffer,
                 max_leaf_size)
    if plain or dev.type == "cpu":
        out, overflow, stats = _plain(w4, o, d, t_max, mask, closest,
                                      stack_depth, max_leaf_size, compat,
                                      leaf_buffer, chunk)
    else:
        out, overflow, stats = _kernel(w4, o, d, t_max, mask, closest,
                                       stack_depth, max_leaf_size, compat,
                                       leaf_buffer, with_stats)
    if fallback is not None:
        redo = overflow if mask is None else overflow & mask
        if closest:
            fb = fallback(o, d, t_max, redo)
            out = Hit(*(torch.where(redo, getattr(fb, k), getattr(out, k))
                        for k in ("tri", "t", "b1", "b2")))
        else:
            redo = redo & ~out
            out = out | (redo & fallback(o, d, t_max, redo))
    return (out, overflow, stats) if with_stats else (out, overflow)


def closest_hit_wide4(w4: Wide4Data, o: V3, d: V3, t_max: torch.Tensor,
                      mask: torch.Tensor | None = None, *,
                      stack_depth: int = 24, max_leaf_size: int = 4,
                      compat: bool = False, leaf_buffer: int = 32,
                      chunk: int = 8, fallback=None,
                      with_stats: bool = False):
    """``(Hit, overflow)`` (+ stats) by the 4-wide walk; ``fallback(o, d,
    t_max, redo)`` answers the overflowed rays."""
    return _walk(w4, o, d, t_max, mask, True, stack_depth, max_leaf_size,
                 compat, leaf_buffer, chunk, fallback, with_stats)


def any_hit_wide4(w4: Wide4Data, o: V3, d: V3, t_max: torch.Tensor,
                  mask: torch.Tensor | None = None, *, stack_depth: int = 24,
                  max_leaf_size: int = 4, compat: bool = False,
                  leaf_buffer: int = 32, chunk: int = 8, fallback=None,
                  with_stats: bool = False):
    """``(occlusion, overflow)`` (+ stats) by the 4-wide walk;
    ``fallback(o, d, t_max, redo)`` answers the overflowed rays that are
    not occluded already."""
    return _walk(w4, o, d, t_max, mask, False, stack_depth, max_leaf_size,
                 compat, leaf_buffer, chunk, fallback, with_stats)


def plain_closest_hit_wide4(w4, o, d, t_max, mask=None, *, stack_depth=24,
                            max_leaf_size=4, compat=False, leaf_buffer=32,
                            chunk=8, fallback=None, with_stats=False):
    """The plain version of :func:`closest_hit_wide4` on any device (also
    for holding the kernel against it on the card); never launches the
    4-wide kernel (``fallback`` is called as given)."""
    return _walk(w4, o, d, t_max, mask, True, stack_depth, max_leaf_size,
                 compat, leaf_buffer, chunk, fallback, with_stats, True)


def plain_any_hit_wide4(w4, o, d, t_max, mask=None, *, stack_depth=24,
                        max_leaf_size=4, compat=False, leaf_buffer=32,
                        chunk=8, fallback=None, with_stats=False):
    """The plain version of :func:`any_hit_wide4`."""
    return _walk(w4, o, d, t_max, mask, False, stack_depth, max_leaf_size,
                 compat, leaf_buffer, chunk, fallback, with_stats, True)
