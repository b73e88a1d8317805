"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/torch_kernels/`` of the
checkout, then loaded with ``ctypes``.  The library's file name carries a
hash of its source and of the shared headers (``csrc/*.cuh``), so an
edited source is rebuilt and a stale library is never loaded.  The first
call that needs a kernel builds it; ``build_all`` builds every source at
once, one ``nvcc`` process each, in parallel.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that the
kernels' float arithmetic matches their plain PyTorch versions op for op
(see csrc/intersect.cuh).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                                 "torch_kernels")
# where the libraries are built and loaded from (utils/cache.py moves it)
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("traverse", "traverse_stream", "entry_key", "traverse_bvh",
           "traverse_wide4", "shade")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _ptxas_summary(log: str) -> list[str]:
    """The per-kernel register / spill lines of ``-Xptxas -v``."""
    keep = re.compile(r"Compiling entry function|Used \d+ registers|spill")
    return [ln.strip() for ln in log.splitlines() if keep.search(ln)]


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once.  Returns ``{name: {"seconds", "ptxas",
    "cached"}}``; raises with the compiler's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            info[name] = {"seconds": 0.0, "ptxas": [], "cached": True}
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, out)
        info[name] = {"seconds": time.perf_counter() - t0,
                      "ptxas": _ptxas_summary(log), "cached": False}
    return info


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# argtypes of every entry point; all return an int (the launchers a CUDA
# error code)
_SIGNATURES = {
    "pnrt_closest_hit": [_P] * 11 + [_I] * 4 + [_P] * 12,
    "pnrt_any_hit": [_P] * 10 + [_I] * 3 + [_P] * 3,
    "pnrt_walk_kernel_info": [_I] * 3,
    "pnrt_closest_hit_binary": [_P] * 10 + [_I] * 3 + [_P] * 6,
    "pnrt_any_hit_binary": [_P] * 10 + [_I] * 3 + [_P] * 3,
    "pnrt_stream": [_I, _I, _I, _P, _P, _I] + [_P] * 8 + [_I] + [_P] * 7,
    "pnrt_stream_kernel_info": [_I] * 3,
    "pnrt_entry_key": [_P] + [_I] * 3 + [_P] * 6 + [_I] + [_P] * 3,
    "pnrt_entry_key_kernel_info": [_I] * 2,
    "pnrt_bvh_walk": [_P] * 8 + [_I] * 2 + [_P] * 8 + [_I] * 3 + [_P] * 7,
    "pnrt_packed_walk": [_P, _P, _I, _I] + [_P] * 8 + [_I] * 3 + [_P] * 7,
    "pnrt_bvh_kernel_info": [_I] * 4,
    "pnrt_wide4_walk": [_P, _P] + [_I] * 6 + [_P] * 9 + [_I] * 3 + [_P] * 8,
    "pnrt_wide4_kernel_info": [_I] * 3,
    "pnrt_shade": [_I] * 10 + [_U] + [_P] * 32,
    "pnrt_shade_kernel_info": [_I] * 2,
    "pnrt_accumulate": [_I] * 8 + [_F, _F] + [_P] * 6,
    "pnrt_accumulate_inputs": [],
    "pnrt_accumulate_kernel_info": [_I] * 2,
}


def _load(name: str) -> ctypes.CDLL:
    build_all((name,))
    lib = ctypes.CDLL(_lib_path(name))
    for fn, argtypes in _SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` declared for every entry point."""
    with _lock:
        if name not in _libs:
            _libs[name] = _load(name)
        return _libs[name]
