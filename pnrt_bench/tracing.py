"""Spans, the profiled stretch, and the reduction of its trace.

The harness wraps its own calls into the program's layers in spans
(:func:`span`: a ``torch.profiler.record_function`` range, a few
microseconds while no profiler runs).  A traced run profiles one bounded
stretch with ``torch.profiler`` (CPU and CUDA activity) and reduces it
here to plain lists, which the per-layer metric readers (``metrics/``)
read:

- ``ops``: every device operation (kernels, copies, sets) as
  ``(name, start_us, end_us)``;
- ``spans``: the harness's spans inside the stretch, same form;
- ``wall_us``: the stretch's host-clock bounds.

Busy time is the length of the union of the device intervals, never a
sum of durations (overlapping kernels would count twice).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

SPAN_PREFIX = "pnrt."


@dataclasses.dataclass
class Trace:
    ops: list  # (name, start_us, end_us) of device operations
    spans: list  # (name, start_us, end_us) of the harness's spans
    wall_us: tuple  # (start, end) of the profiled stretch
    units: int  # frames or steps the stretch completed

    @property
    def window_s(self) -> float:
        return (self.wall_us[1] - self.wall_us[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_length(self.ops) * 1e-6


def merge(intervals) -> list:
    """The union of ``(name, start, end)`` (or ``(start, end)``) intervals
    as sorted, disjoint ``(start, end)`` pairs."""
    pairs = sorted((iv[-2], iv[-1]) for iv in intervals if iv[-1] > iv[-2])
    out = []
    for s, e in pairs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals) -> float:
    return sum(e - s for s, e in merge(intervals))


def idle_share(trace: Trace) -> float | None:
    """1 - (union of the device intervals inside the stretch) / (the
    stretch's wall time); None without device operations."""
    if not trace.ops:
        return None
    lo, hi = trace.wall_us
    clipped = [(max(s, lo), min(e, hi)) for _, s, e in trace.ops]
    return 1.0 - union_length(clipped) / (hi - lo)


def gaps(trace: Trace) -> list:
    """The idle intervals ``(start, end)`` of the device inside the
    stretch."""
    lo, hi = trace.wall_us
    out, t = [], lo
    for s, e in merge(trace.ops):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and
    the idle gaps summed by the innermost harness span the host was in
    at each gap's midpoint ("no span" outside them), in seconds."""
    by_op = collections.Counter()
    for name, s, e in trace.ops:
        by_op[name[:120]] += (e - s) * 1e-6
    by_span = collections.Counter()
    spans = sorted(trace.spans, key=lambda x: x[1])
    for s, e in gaps(trace):
        mid = 0.5 * (s + e)
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = (min(inner, key=lambda x: x[2] - x[1])[0] if inner
                else "no span")
        by_span[name] += (e - s) * 1e-6
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in by_span.most_common(top)]}


@contextlib.contextmanager
def span(name: str):
    """One of the harness's spans around a call into the program."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def profile(fn, device) -> Trace:
    """Run ``fn()`` (which returns the frames or steps it completed) under
    ``torch.profiler`` after a synchronize, synchronize again, and reduce
    the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "stretch"):
            units = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    ops, spans, stretch = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a record_function range shows on the device too, as an
            # annotation spanning its kernels: not an operation
            if not (e.name.startswith(SPAN_PREFIX)
                    or getattr(e, "is_user_annotation", False)):
                ops.append((e.name, s, t))
        elif e.name == SPAN_PREFIX + "stretch":
            stretch = (s, t)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], s, t))
    return Trace(ops=ops, spans=spans, wall_us=stretch, units=int(units))
