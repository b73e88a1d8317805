"""Fixed figures the per-layer readers share: the card's peaks and the
names of the program's hand-written kernels (``csrc/*.cu``) as the
profiler shows them."""

from __future__ import annotations

import re

# NVIDIA H100 SXM (the data sheet, at its 700 W limit): HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12

# the walks of csrc/traverse*.cu (kernels 1-3, 5-7, the plain-BVH and
# 4-wide walks) and the sort key of csrc/entry_key.cu (kernel 4)
WALK_KERNELS = ("closest_hit_kernel", "any_hit_kernel",
                "closest_hit_binary_kernel", "any_hit_binary_kernel",
                "stream_kernel", "bvh_walk_kernel", "wide4_walk_kernel")
PORT_KERNELS = WALK_KERNELS + ("entry_key_kernel",)
_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def words(name: str) -> set:
    return set(_WORD.findall(name))


def is_copy(name: str) -> bool:
    return name.startswith(_COPIES)


def is_walk(name: str) -> bool:
    return bool(words(name) & set(WALK_KERNELS))


def is_port_kernel(name: str) -> bool:
    return bool(words(name) & set(PORT_KERNELS))


def per_unit(run, value):
    """``value`` over the frames or steps of the profiled stretch; None
    without device operations."""
    if run.trace is None or not run.trace.ops or not run.trace.units:
        return None
    return value / run.trace.units
