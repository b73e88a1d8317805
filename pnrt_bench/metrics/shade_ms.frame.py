"""shade_ms.frame: device ms a frame of every kernel that is not one of
the program's hand-written ``csrc/`` kernels (the shading, integrator,
sampling and compaction torch ops), from the traced stretch.  Moves
``frame_ms``."""

from pnrt_bench import yardstick as ys


def read(run):
    if run.trace is None:
        return None
    us = sum(e - s for n, s, e in run.trace.ops
             if not ys.is_copy(n) and not ys.is_port_kernel(n))
    return ys.per_unit(run, us * 1e-3)
