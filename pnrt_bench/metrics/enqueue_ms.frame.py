"""enqueue_ms.frame: host ms a frame inside the program's
``frame.replay`` spans (each ``graph.replay()``) outside the profiler:
the program's record of those spans (the set-up's call, the timed
window and the traced stretch) less the first (the graph's first launch
also uploads it) and the stretch's own, over the replays left.  The
profiler makes each replay's launch several times longer, so the
stretch's spans are left out.  Read only where the stretch shows one
``frame.replay`` a frame and the record holds replays besides the first
and the stretch's.  Moves ``frame_ms``."""

from pnrt_bench import replays


def read(run):
    trace = run.trace
    rec = replays.program_record()
    span = rec["spans"].get("frame.replay") if rec else None
    if trace is None or not trace.units or span is None:
        return None
    traced = [e - s for name, s, e in trace.spans if name == "frame.replay"]
    if len(traced) != trace.units:
        return None
    n = span["count"] - 1 - len(traced)
    seconds = span["seconds"] - span["first"] - sum(traced) * 1e-6
    if n <= 0 or seconds <= 0:
        return None
    return seconds * 1e3 / n
