"""sort_ms.frame: device ms a frame of the operations of the replayed
frame whose node ordinal lies in a ``phase.sort`` range of the program's
capture (the entry key, the live-first ``argsort`` or compaction, and
the ``[C, R]`` pack gather of the sorted bounces; ``replays.py`` splits
the stretch).  Moves ``frame_ms``."""

from pnrt_bench import replays
from pnrt_bench import yardstick as ys


def read(run):
    found = replays.replays(run)
    if found is None:
        return None
    cap, ops, starts = found
    sort = replays.ordinals(cap, "sort")
    if not replays.pinned(cap, sort):
        return None
    us = sum(ops[s + i][2] - ops[s + i][1] for s in starts for i in sort)
    return ys.per_unit(run, us * 1e-3)
