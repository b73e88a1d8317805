"""idle_share.frame: 1 - (union of the device's operation intervals) /
(the traced stretch's wall time), in %.  Moves ``frame_ms``."""

from pnrt_bench.tracing import idle_share


def read(run):
    if run.trace is None:
        return None
    v = idle_share(run.trace)
    return None if v is None else 100.0 * v
