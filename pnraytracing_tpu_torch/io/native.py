"""ctypes bindings to the native C++ IO components (csrc/obj_loader.cpp,
csrc/image_io.cpp).

The reference's asset layer is native code: assimp for model import
(include/model.hpp:25, lib/assimp-vc143-mt.lib) and stb for image IO
(stbi_loadf, include/shader.hpp:131; stb_image_write vendored at
PnRT.hpp:7-9).  These are the TPU framework's native counterparts, with the
pure-Python implementations in :mod:`pnraytracing_tpu_torch.io.obj` /
:mod:`pnraytracing_tpu_torch.io.hdr` / :mod:`pnraytracing_tpu_torch.utils.image` as the
always-available fallback and cross-validation oracle.

PyTorch port of ``pnraytracing_tpu/io/native.py``: the same bindings to
the library that ``utils/nativelib.py`` builds into the port's build
directory.  A broken build raises there; only a missing g++ makes
:func:`native_io_available` False.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pnraytracing_tpu_torch.utils.nativelib import get_lib


def _load():
    lib = get_lib()
    if lib is None:
        return None
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_i32_p = ctypes.POINTER(ctypes.c_int32)
    c_u8_p = ctypes.POINTER(ctypes.c_uint8)

    lib.pnrt_hdr_read_size.restype = ctypes.c_int
    lib.pnrt_hdr_read_size.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
    lib.pnrt_hdr_read.restype = ctypes.c_int
    lib.pnrt_hdr_read.argtypes = [ctypes.c_char_p, c_float_p]
    lib.pnrt_hdr_write.restype = ctypes.c_int
    lib.pnrt_hdr_write.argtypes = [
        ctypes.c_char_p, c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pnrt_png_write.restype = ctypes.c_int
    lib.pnrt_png_write.argtypes = [
        ctypes.c_char_p, c_u8_p, ctypes.c_int, ctypes.c_int,
    ]

    lib.pnrt_obj_load.restype = ctypes.c_void_p
    lib.pnrt_obj_load.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pnrt_obj_num_groups.restype = ctypes.c_int
    lib.pnrt_obj_num_groups.argtypes = [ctypes.c_void_p]
    lib.pnrt_obj_group_counts.restype = ctypes.c_int
    lib.pnrt_obj_group_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_int, c_int_p, c_int_p,
    ]
    lib.pnrt_obj_group_name.restype = ctypes.c_char_p
    lib.pnrt_obj_group_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pnrt_obj_group_map_kd.restype = ctypes.c_char_p
    lib.pnrt_obj_group_map_kd.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pnrt_obj_group_material.restype = ctypes.c_int
    lib.pnrt_obj_group_material.argtypes = [
        ctypes.c_void_p, ctypes.c_int, c_float_p, c_int_p,
    ]
    lib.pnrt_obj_group_data.restype = ctypes.c_int
    lib.pnrt_obj_group_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int, c_float_p, c_float_p, c_float_p, c_i32_p,
    ]
    lib.pnrt_obj_free.restype = None
    lib.pnrt_obj_free.argtypes = [ctypes.c_void_p]
    return lib


def native_io_available() -> bool:
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_hdr_native(path: str) -> np.ndarray:
    """Native Radiance .hdr reader — same contract as
    :func:`pnraytracing_tpu_torch.io.hdr.read_hdr`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO unavailable (no g++)")
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.pnrt_hdr_read_size(path.encode(), ctypes.byref(h), ctypes.byref(w)):
        raise ValueError(f"not a readable Radiance HDR file: {path}")
    out = np.empty((h.value, w.value, 3), np.float32)
    rc = lib.pnrt_hdr_read(path.encode(), _fp(out))
    if rc:
        raise ValueError(f"HDR decode failed ({rc}): {path}")
    return out


def write_hdr_native(path: str, image: np.ndarray, rle: bool = False) -> None:
    """Native .hdr writer; ``rle=True`` writes adaptive-RLE scanlines (the
    stb-compatible compressed form the reference's assets use)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO unavailable (no g++)")
    image = np.ascontiguousarray(image, np.float32)
    h, w = image.shape[:2]
    rc = lib.pnrt_hdr_write(path.encode(), _fp(image), h, w, int(rle))
    if rc:
        raise IOError(f"HDR write failed ({rc}): {path}")


def save_png_native(path: str, image: np.ndarray, gamma: float = 2.2) -> None:
    """Native PNG writer — same contract as
    :func:`pnraytracing_tpu_torch.utils.image.save_png`."""
    from pnraytracing_tpu_torch.utils.image import tonemap

    lib = _load()
    if lib is None:
        raise RuntimeError("native IO unavailable (no g++)")
    img8 = np.ascontiguousarray(
        (tonemap(image, gamma=gamma) * 255.0 + 0.5).astype(np.uint8)
    )
    h, w = img8.shape[:2]
    rc = lib.pnrt_png_write(
        path.encode(), img8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w
    )
    if rc:
        raise IOError(f"PNG write failed ({rc}): {path}")


def load_obj_native(path: str, flip_v: bool = True):
    """Native OBJ/MTL parser — same return contract as
    :func:`pnraytracing_tpu_torch.io.obj.load_obj`: a list of
    (mesh_dict, material_dict, texture_or_None, name) per material group."""
    import os

    from pnraytracing_tpu_torch.io.obj import load_texture

    lib = _load()
    if lib is None:
        raise RuntimeError("native IO unavailable (no g++)")
    handle = lib.pnrt_obj_load(path.encode(), int(flip_v))
    if not handle:
        raise FileNotFoundError(path)
    try:
        out = []
        stem = os.path.splitext(os.path.basename(path))[0]
        for g in range(lib.pnrt_obj_num_groups(handle)):
            nv = ctypes.c_int()
            nt = ctypes.c_int()
            lib.pnrt_obj_group_counts(handle, g, ctypes.byref(nv), ctypes.byref(nt))
            positions = np.empty((nv.value, 3), np.float32)
            normals = np.empty((nv.value, 3), np.float32)
            uvs = np.empty((nv.value, 2), np.float32)
            indices = np.empty((nt.value, 3), np.int32)
            lib.pnrt_obj_group_data(
                handle, g, _fp(positions), _fp(normals), _fp(uvs),
                indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            mat7 = np.zeros(7, np.float32)
            flags = ctypes.c_int()
            lib.pnrt_obj_group_material(handle, g, _fp(mat7), ctypes.byref(flags))
            mdef: dict = {}
            if flags.value & 1:
                mdef["base_color"] = tuple(float(x) for x in mat7[0:3])
            if flags.value & 2:
                mdef["emissive"] = tuple(float(x) for x in mat7[3:6])
            if flags.value & 4:
                mdef["roughness"] = float(mat7[6])
            map_kd = lib.pnrt_obj_group_map_kd(handle, g).decode()
            tex = load_texture(map_kd) if map_kd else None
            mtl_name = lib.pnrt_obj_group_name(handle, g).decode()
            name = f"{stem}:{mtl_name}" if mtl_name else stem
            mesh = dict(positions=positions, normals=normals, uvs=uvs, indices=indices)
            out.append((mesh, mdef, tex, name))
        return out
    finally:
        lib.pnrt_obj_free(handle)
