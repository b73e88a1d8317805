"""Build and load the repo's native C++ helper library.

PyTorch counterpart of ``pnraytracing_tpu/utils/nativelib.py``.  The
native components (the SAH BVH builder, the OBJ/MTL parser, RGBE/PNG
image IO: ``csrc/*.cpp`` at the repo root, shared with the JAX package)
compile with g++ into ONE shared object in the port's build directory
(``cuda_build.BUILD_DIR``), named by a hash of the sources, so an edited
source is rebuilt and a stale library is never loaded; the JAX package's
``build/libpnrt_native.so`` is a different file.  The sources are built
where they lie, never copied.

:func:`get_lib` returns None only when no g++ exists: the callers then
take their pure-Python paths, as the JAX package does.  Unlike the JAX
loader, a compile or load error raises with the compiler's output: a
broken build is never hidden behind the fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from pnraytracing_tpu_torch import cuda_build

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "csrc")
# the JAX loader's flags
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources(csrc_dir: str | None = None) -> list[str]:
    """The sources of the library: every ``*.cpp`` of ``csrc/``, sorted,
    the JAX loader's list."""
    return sorted(glob.glob(os.path.join(csrc_dir or CSRC_DIR, "*.cpp")))


def lib_path(srcs: list[str]) -> str:
    """Where the library of ``srcs`` lives: ``cuda_build.BUILD_DIR`` /
    ``pnrt_native-<hash of the sources>.so``."""
    h = hashlib.sha1()
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode() + b"\0" + fh.read())
    return os.path.join(cuda_build.BUILD_DIR,
                        f"pnrt_native-{h.hexdigest()[:16]}.so")


def compiler() -> str | None:
    return shutil.which("g++")


def _compile(cxx: str, srcs: list[str], out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *srcs],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {', '.join(srcs)}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def get_lib(csrc_dir: str | None = None) -> ctypes.CDLL | None:
    """The native library, compiled first if it is not built yet; None
    when no g++ exists.  Raises on a compile or load error, and when
    ``csrc/`` holds no source."""
    cxx = compiler()
    if cxx is None:
        return None
    srcs = sources(csrc_dir)
    if not srcs:
        raise RuntimeError(f"no native sources under {csrc_dir or CSRC_DIR}")
    out = lib_path(srcs)
    with _lock:
        if out not in _libs:
            if not os.path.exists(out):
                _compile(cxx, srcs, out)
            _libs[out] = ctypes.CDLL(out)
        return _libs[out]
