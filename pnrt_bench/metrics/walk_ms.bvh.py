"""walk_ms.bvh: device ms a frame of the plain-BVH walk kernel
(``csrc/traverse_bvh.cu`` ``bvh_walk_kernel`` over the plain tree, closest
hit and any hit; route ``bvh``) in the traced stretch.  Moves
``frame_ms.large``; silent where no such kernel ran."""

from pnrt_bench import yardstick as ys

KERNEL = "bvh_walk_kernel"
PACKED = "PackedRows"  # the same kernel over the packed rows (route packed)


def read(run):
    if run.trace is None:
        return None
    us = sum(e - s for n, s, e in run.trace.ops
             if KERNEL in ys.words(n) and PACKED not in ys.words(n))
    if not us:
        return None
    return ys.per_unit(run, us * 1e-3)
