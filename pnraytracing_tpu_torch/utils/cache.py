"""Where the compiled kernels are kept.

PyTorch counterpart of ``pnraytracing_tpu/utils/cache.py``.  The JAX
package caches XLA executables on disk; the port's only compiled
artifacts are its kernel libraries (``cuda_build.py``: one shared
library per ``csrc/*.cu`` source, named by a hash of the source), so
:func:`enable_compile_cache` moves the directory they are built into
and loaded from.  Call it before the first kernel is built.
"""

from __future__ import annotations

import hashlib
import os
import platform

from pnraytracing_tpu_torch import cuda_build


def host_cpu_tag() -> str:
    """Fingerprint of this host's CPU feature set (the JAX package keys
    its CPU-backend cache directories by it: an executable compiled for
    other machine features can SIGILL)."""
    try:
        with open("/proc/cpuinfo") as f:
            src = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        src = ""
    src = src or platform.processor() or platform.machine() or "unknown"
    return hashlib.sha1(src.encode()).hexdigest()[:10]


def enable_compile_cache(path: str | None = None) -> None:
    """Build and load the kernel libraries under ``path`` (default: the
    checkout's ``build/torch_kernels``).  Safe to call more than once;
    a library already loaded stays loaded."""
    cuda_build.BUILD_DIR = os.path.abspath(path
                                           or cuda_build.DEFAULT_BUILD_DIR)
