"""Live-ray compaction and the treelet-entry coherence sort key.

PyTorch counterpart of ``pnraytracing_tpu/ops/compaction.py``:
``sort_live_first`` (the permutation that packs live rays first, in key
order), the plain ``treelet_entry_key`` and the wrapper
:func:`entry_key` over its hand-written CUDA kernel
(``csrc/entry_key.cu``, replacing ``treelet_entry_key_pallas``).
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel.traverse_cuda import check_rays
from pnraytracing_tpu_torch.core.vec import V3

# Launches of the key kernel since the last reset (the caller zeroes it).
LAUNCHES = {"treelet_entry_key": 0}


def sort_live_first(mask: torch.Tensor, key: torch.Tensor):
    """Permutation packing live lanes first, ordered by ``key`` (stable);
    ``key`` must be below 2^16."""
    composite = (~mask).to(torch.int64) * (1 << 16) + key.to(torch.int64)
    return torch.argsort(composite, stable=True), mask.sum()


def _octant(dx, dy, dz):
    return ((dx > 0).to(torch.int32) * 4 + (dy > 0).to(torch.int32) * 2
            + (dz > 0).to(torch.int32))


def treelet_entry_key(o: V3, d: V3, treelets: torch.Tensor) -> torch.Tensor:
    """Plain version of the key kernel: per ray, the index k of the
    nearest treelet box its ray enters (argmin of the slab-entry t_near,
    clamped >= 0, over boxes with t_far >= t_near; first minimum wins; K
    when none), as ``k*8 + octant(d)`` (int32).  A loop over the K boxes
    with a strict ``<``, the kernel's own order."""
    ox, oy, oz = o.x, o.y, o.z
    inv = lambda c: torch.where(c >= 0, 1.0, -1.0) / torch.clamp_min(
        torch.abs(c), 1e-20)
    ix, iy, iz = inv(d.x), inv(d.y), inv(d.z)
    k_total = int(treelets.shape[0])
    best_t = torch.full_like(ox, 3e38)
    best_k = torch.full(ox.shape, k_total, dtype=torch.int32,
                        device=ox.device)
    for k in range(k_total):
        b = treelets[k]
        nx = (b[0] - ox) * ix
        ny = (b[1] - oy) * iy
        nz = (b[2] - oz) * iz
        fx = (b[3] - ox) * ix
        fy = (b[4] - oy) * iy
        fz = (b[5] - oz) * iz
        t_far = torch.minimum(
            torch.minimum(torch.maximum(fx, nx), torch.maximum(fy, ny)),
            torch.maximum(fz, nz))
        t_near = torch.maximum(
            torch.maximum(torch.minimum(fx, nx), torch.minimum(fy, ny)),
            torch.clamp_min(torch.minimum(fz, nz), 0.0))
        win = (t_far >= t_near) & (t_near < best_t)
        best_t = torch.where(win, t_near, best_t)
        best_k = torch.where(win, k, best_k)
    return best_k * 8 + _octant(d.x, d.y, d.z)


def entry_key(o: V3, d: V3, treelets: torch.Tensor) -> torch.Tensor:
    """The treelet-entry key: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  Rays are contiguous float32 [R] components."""
    r, dev = check_rays(o, d)
    k_total = int(treelets.shape[0])
    if not (treelets.dtype == torch.float32 and treelets.dim() == 2
            and treelets.shape[1] == 6 and treelets.is_contiguous()
            and treelets.device == dev and 0 < k_total <= 512):
        raise ValueError("treelets must be a contiguous float32 [K, 6] "
                         "tensor (0 < K <= 512) on the rays' device")
    if dev.type == "cpu":
        return treelet_entry_key(o, d, treelets)
    from pnraytracing_tpu_torch.cuda_build import library

    key = torch.empty(r, dtype=torch.int32, device=dev)
    err = library("entry_key").pnrt_entry_key(
        treelets.data_ptr(), k_total, o.x.data_ptr(), o.y.data_ptr(),
        o.z.data_ptr(), d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(), r,
        key.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"entry-key kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["treelet_entry_key"] += 1
    return key
