"""kernels.frame: device kernels a frame counted in the traced stretch
(copies and sets left out).  Moves ``frame_ms``."""

from pnrt_bench import yardstick as ys


def read(run):
    if run.trace is None:
        return None
    return ys.per_unit(run, float(sum(1 for n, _, _ in run.trace.ops
                                      if not ys.is_copy(n))))
