"""Profiling / observability.

PyTorch counterpart of ``pnraytracing_tpu/utils/profiling.py``.  The
reference's surfaces: wall-clock brackets around BVH build and buffer
upload (main.cpp:368-371, 566-567) and a window-title FPS counter
(main.cpp:578-583).  Here: step timers, the operation count of one
profiled call, and a ``torch.profiler`` trace in Chrome's format.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def wallclock(label: str, sink=print):
    """Wall-clock bracket (the clock() pattern of main.cpp:368-371)."""
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


class StepTimer:
    """Running frame/step statistics (the FPS counter of main.cpp:578-583)."""

    def __init__(self, window: int = 32):
        self.window = window
        self.samples: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)
        if len(self.samples) > self.window:
            self.samples.pop(0)

    @property
    def mean_s(self) -> float:
        return sum(self.samples) / max(len(self.samples), 1)

    @property
    def fps(self) -> float:
        m = self.mean_s
        return 1.0 / m if m > 0 else 0.0


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def cost_analysis(fn, *args, **kwargs) -> dict:
    """The JAX function's keys (``flops``, ``bytes_accessed``,
    ``arithmetic_intensity``, ``raw``) from one call of ``fn`` under
    ``torch.profiler`` with ``with_flops=True``.

    XLA's cost model has no PyTorch counterpart: the profiler counts the
    floating-point operations of the PyTorch operators that have a
    formula for them (matrix products, convolutions, elementwise
    arithmetic), and nothing of the hand-written walks, which it sees as
    opaque launches; it counts no bytes, so ``bytes_accessed`` is 0.0 and
    the intensity 0.0 with it.  ``raw`` holds the operations by
    operator."""
    with torch.profiler.profile(activities=_activities(),
                                with_flops=True) as prof:
        fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    raw = {e.key: float(e.flops) for e in prof.key_averages() if e.flops}
    flops = float(sum(raw.values()))
    bytes_accessed = 0.0
    return {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": (flops / bytes_accessed if bytes_accessed
                                 else 0.0),
        "raw": raw,
    }


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the body with ``torch.profiler`` (host and, where there is
    a card, device activity) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (default ``log_dir``: ``pnrt_trace`` in the
    temporary directory); yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "pnrt_trace")
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
