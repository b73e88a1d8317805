"""ctypes binding to the native C++ BVH builder (``csrc/bvh_builder.cpp``).

PyTorch counterpart of ``pnraytracing_tpu/accel/native.py``: the same
flat SAH tree as ``accel/bvh.py::build_bvh``, built in C++ for large
scenes, where the numpy builder's per-node Python loop dominates the
scene's build time.  The library is compiled on first use
(``utils/nativelib.py``); without g++ :func:`native_available` is False
and the callers build with numpy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pnraytracing_tpu_torch.accel.bvh import BVHArrays
from pnraytracing_tpu_torch.utils.nativelib import get_lib

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def _load():
    lib = get_lib()
    if lib is not None:
        lib.pnrt_build_bvh.restype = ctypes.c_int
        lib.pnrt_build_bvh.argtypes = [
            _F, ctypes.c_int, _I32, ctypes.c_int, ctypes.c_int,
            _F, _F, _I32, _I32, _I32, _I32, _I32, _I32]
    return lib


def native_available() -> bool:
    """Whether the native builder can run (g++ exists); a broken build
    raises."""
    return _load() is not None


def bvh_builder(use_native_builder: bool | None = None):
    """The BVH builder a build takes, with the JAX package's semantics
    (``scene/build.py:158-172`` there): None = the native builder when
    g++ exists, else numpy; True = the native one or raise; False =
    numpy."""
    from pnraytracing_tpu_torch.accel.bvh import build_bvh

    if use_native_builder is False:
        return build_bvh
    if native_available():
        return build_bvh_native
    if use_native_builder:
        raise RuntimeError("native BVH builder unavailable (no g++)")
    return build_bvh


def build_bvh_native(positions: np.ndarray, indices: np.ndarray,
                     max_leaf_size: int = 4) -> BVHArrays:
    """Drop-in replacement for :func:`accel.bvh.build_bvh` backed by the
    C++ builder (same flat layout)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native BVH builder unavailable (no g++)")
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    num_tris = len(indices)
    cap = max(2 * num_tris, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    axis, right, start, end = (np.empty(cap, np.int32) for _ in range(4))
    order = np.empty(num_tris, np.int32)
    num_nodes = np.zeros(1, np.int32)
    f32 = lambda a: a.ctypes.data_as(_F)
    i32 = lambda a: a.ctypes.data_as(_I32)
    ret = lib.pnrt_build_bvh(
        f32(positions), len(positions), i32(indices), num_tris,
        max_leaf_size, f32(node_min), f32(node_max), i32(axis), i32(right),
        i32(start), i32(end), i32(order), i32(num_nodes))
    if ret != 0:
        raise RuntimeError(f"pnrt_build_bvh failed with code {ret}")
    n = int(num_nodes[0])
    return BVHArrays(node_min=node_min[:n].copy(),
                     node_max=node_max[:n].copy(), axis=axis[:n].copy(),
                     right_child=right[:n].copy(), start=start[:n].copy(),
                     end=end[:n].copy(), order=order)
