"""Asset IO: OBJ/MTL models, Radiance HDR images, PNG output.

Each format has two interchangeable implementations: native C++
(csrc/obj_loader.cpp, csrc/image_io.cpp — the counterparts of the
reference's assimp/stb native code) and pure Python (the fallback and
cross-validation oracle).  The functions exported here auto-dispatch to the
native path when the toolchain is available.

PyTorch port of ``pnraytracing_tpu/io/__init__.py``: the same dispatchers,
choosing only by whether g++ exists.
"""

from __future__ import annotations

import numpy as np


def _native():
    """The native module when g++ exists, else None (the pure-Python
    path).  The JAX package also falls back on any error of the native
    build; here a broken build raises (utils/nativelib.py)."""
    from pnraytracing_tpu_torch.io import native

    return native if native.native_io_available() else None


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> [H, W, 3] float32 (native if available)."""
    n = _native()
    if n is not None:
        return n.read_hdr_native(path)
    from pnraytracing_tpu_torch.io.hdr import read_hdr as py_read_hdr

    return py_read_hdr(path)


def write_hdr(path: str, image: np.ndarray, rle: bool = False) -> None:
    """Write [H, W, 3] float32 radiance as RGBE (native if available;
    ``rle`` only with the native writer)."""
    n = _native()
    if n is not None:
        return n.write_hdr_native(path, image, rle=rle)
    from pnraytracing_tpu_torch.io.hdr import write_hdr as py_write_hdr

    return py_write_hdr(path, image)


def load_obj(path: str, flip_v: bool = True):
    """Parse an OBJ/MTL file into per-material mesh groups (native if
    available)."""
    n = _native()
    if n is not None:
        return n.load_obj_native(path, flip_v=flip_v)
    from pnraytracing_tpu_torch.io.obj import load_obj as py_load_obj

    return py_load_obj(path, flip_v=flip_v)


def load_model(path: str):
    """Load any supported mesh format by extension.

    * ``.obj`` -> list of (mesh, material, texture, name) groups
    * ``.ply`` -> single mesh dict
    * ``.gltf``/``.glb`` -> list of (mesh, material, texture, name,
      transform, texture_key) primitives
    * ``.fbx`` -> list of (mesh, material, None, name, transform) geometries

    The reference funnels every format through assimp (model.hpp:25);
    here each parser is from scratch (io/obj.py, io/ply.py, io/gltf.py,
    io/fbx.py).
    """
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "obj":
        return load_obj(path)
    if ext == "ply":
        from pnraytracing_tpu_torch.io.ply import load_ply

        return load_ply(path)
    if ext in ("gltf", "glb"):
        from pnraytracing_tpu_torch.io.gltf import load_gltf

        return load_gltf(path)
    if ext == "fbx":
        from pnraytracing_tpu_torch.io.fbx import load_fbx

        return load_fbx(path)
    raise ValueError(f"unsupported model format .{ext}")


def save_png(path: str, image: np.ndarray, gamma: float = 2.2) -> None:
    """Save [H, W, 3] linear float image to PNG (native if available)."""
    n = _native()
    if n is not None:
        return n.save_png_native(path, image, gamma=gamma)
    from pnraytracing_tpu_torch.utils.image import save_png as py_save_png

    return py_save_png(path, image, gamma=gamma)
