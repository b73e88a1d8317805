"""The program's own record (``pnraytracing_tpu_torch/utils/profiling.py``:
``record()``) as the readers of its spans and counters see it, and the
traced stretch split into the replays of the captured frame.

A replayed CUDA graph shows only kernel names, so a replay is found by
its walks: at capture the program noted its graph's node count
(``nodes``), the node ordinals of its walk kernels (``walks``) and the
ordinal ranges of its phases (``phases``); the first walk kernel of each
replay in the stretch anchors that replay at its index less
``walks[0]``.  Nothing is guessed: the stretch is split only when every
replay is found whole (``nodes`` operations in the stretch, each walk
ordinal on a walk kernel and no other walk kernel among them), every
replay starts after the one before it has ended and shows the same
operations, by name and in order, as the first, every walk kernel of the
stretch lies in one, there is one replay per frame of the stretch, and
the phases tile ``[0, nodes)``.  Otherwise, and with a program that
keeps no record, the readers read None.

An operation the trace lost between two walks moves every later walk
off its ordinal.  One lost before the first walk or after the last, its
slot taken by an operation of the harness (the inputs' copies, the mean,
the fetch), leaves the walks in place; the names tell it only where the
stretch holds a second replay.  So a reader reads ordinals that lie
between the first and the last walk (:func:`pinned`; ``sort_ms.*``: the
sorted bounces lie there), where the walks alone pin every operation.
"""

from __future__ import annotations

from pnrt_bench import yardstick as ys

_last = [None, None]  # the trace last split, and its replays


def program_record() -> dict | None:
    """The program's record, or None where the program keeps none."""
    try:
        from pnraytracing_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "record", None)
    return read() if callable(read) else None


def tiles(phases, nodes: int) -> bool:
    """Whether the ``(phase, bounce, tile, first, n)`` ranges cover
    ``[0, nodes)`` in order, without gap or overlap."""
    at = 0
    for p in phases:
        if p[3] != at or p[4] < 0:
            return False
        at += p[4]
    return at == nodes


def split(ops: list, nodes: int, walks: list) -> list | None:
    """The index in ``ops`` (sorted by start) of each replay's first
    operation, or None unless every walk kernel of ``ops`` lies in a
    whole replay whose walk ordinals are exactly ``walks``, each replay
    starts after the one before it ends, and all show the first one's
    operations by name."""
    if not walks or nodes <= walks[-1]:
        return None
    walk_at = [i for i, (name, _, _) in enumerate(ops) if ys.is_walk(name)]
    starts, end, k = [], 0, 0
    while k < len(walk_at):
        s = walk_at[k] - walks[0]
        if s < end or s + nodes > len(ops):
            return None
        if walk_at[k:k + len(walks)] != [s + w for w in walks]:
            return None
        starts.append(s)
        end = s + nodes
        k += len(walks)
    first, last_end = None, None
    for s in starts:
        block = ops[s:s + nodes]
        if last_end is not None and block[0][1] < last_end:
            return None
        last_end = max(e for _, _, e in block)
        names = [name for name, _, _ in block]
        if first is None:
            first = names
        elif names != first:
            return None
    return starts


def replays(run):
    """``(capture, ops, starts)``: the last captured frame of the record
    whose replays the stretch holds, the stretch's device operations
    sorted by start, and the index of each replay's first one; None
    without a trace, a record or a split that validates."""
    trace = getattr(run, "trace", None)
    if trace is None or not trace.ops or not trace.units:
        return None
    if _last[0] is trace:
        return _last[1]
    found = None
    rec = program_record()
    ops = sorted(trace.ops, key=lambda o: (o[1], o[2]))
    for cap in reversed(rec["captures"] if rec else []):
        if not tiles(cap["phases"], cap["nodes"]):
            continue
        starts = split(ops, cap["nodes"], cap["walks"])
        if starts is not None and len(starts) == trace.units:
            found = (cap, ops, starts)
            break
    _last[:] = [trace, found]
    return found


def ordinals(capture: dict, phase: str) -> list:
    """The node ordinals of every range of ``phase``."""
    return [i for name, _, _, first, n in capture["phases"] if name == phase
            for i in range(first, first + n)]


def pinned(capture: dict, at: list) -> bool:
    """Whether the ordinals ``at`` all lie between the capture's first
    and last walk, where the walks pin each operation (see the module's
    docstring)."""
    walks = capture["walks"]
    return not at or walks[0] < min(at) <= max(at) < walks[-1]
