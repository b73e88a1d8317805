"""Profiling / observability.

PyTorch counterpart of ``pnraytracing_tpu/utils/profiling.py``.  The
reference's surfaces: wall-clock brackets around BVH build and buffer
upload (main.cpp:368-371, 566-567) and a window-title FPS counter
(main.cpp:578-583).  Here: a wall-clock bracket, a ``torch.profiler``
trace in Chrome's format, and the program's recorder.

The recorder (one per process; :func:`record` reads it, :func:`reset`
empties it):

- :func:`span` is a ``torch.profiler.record_function("pnrt." + name)``
  range, so inside a profiled stretch it lies on the profiler's clock
  beside the device operations, and its host seconds are added to the
  record by name (a count, a total and the first span's seconds: a
  graph's first replay also uploads it), so a span outside any profiler
  (set-up) can be read too.  Names: ``frame.*`` and ``capture.*``
  (``render/program.py``), ``build.tree`` (``scene/build.py``),
  ``phase.*`` (:func:`phase`).
- :func:`phase` is the span ``phase.<name>`` of one part of a frame.  A
  replayed CUDA graph runs no Python, so while a stream captures into an
  open :func:`collect`, a phase also notes the capture's node count at
  its start and end: the ordinals of its device operations in every
  replay.  One stream's capture is one chain of nodes, so the count is
  kept by walking back from the capture's last node (libcuda's
  ``cuStreamGetCaptureInfo``) through each node's dependency
  (``cuGraphNodeGetDependencies``) to the last node counted, each node
  once; both queries are allowed during a capture.  Nothing is added to
  the graph.
- :func:`count` hands a number or a device tensor to every open
  :func:`collect`, labelled with its bounce and tile, without reading it
  back; :func:`record` is the only place that synchronises.  Callers
  compute a counter only where :func:`collecting` (so nothing is added
  while no one collects), and never while a stream captures: a
  counter's arithmetic would join the graph.
- :func:`launched` counts a hand-written kernel's launch in its wrapper's
  ``LAUNCHES`` table and, in a capture, notes the kernel's node ordinal.
- :func:`keep_capture` keeps a captured frame's layout (its node count,
  phases, walk ordinals and its warm-up frame's counters) in the record.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import os
import tempfile
import time

import torch

PREFIX = "pnrt."
CAPTURES_KEPT = 8


@contextlib.contextmanager
def wallclock(label: str, sink=print):
    """Wall-clock bracket (the clock() pattern of main.cpp:368-371)."""
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the body with ``torch.profiler`` (host and, where there is
    a card, device activity) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (default ``log_dir``: ``pnrt_trace`` in the
    temporary directory), the program's spans included; yields
    ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "pnrt_trace")
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---- the recorder ---------------------------------------------------------

@dataclasses.dataclass
class Span:
    """One span: its name and, once closed, its host seconds."""

    name: str
    seconds: float | None = None


@dataclasses.dataclass
class Collected:
    """What a :func:`collect` body recorded of its own, in order: counter
    values ``(name, bounce, tile, value)``, and while a stream captures,
    in node ordinals of the capture, phases ``(name, bounce, tile,
    first_ordinal, n_nodes)`` and kernel launches ``(key, ordinal)``.
    ``chain`` turns False where the capture is found not to be one chain
    of nodes (its ordinals are then void)."""

    counts: list = dataclasses.field(default_factory=list)
    phases: list = dataclasses.field(default_factory=list)
    kernels: list = dataclasses.field(default_factory=list)
    chain: bool = True
    # the last node counted (0: none yet) and the nodes up to it
    _seen: tuple = dataclasses.field(default=(0, 0), repr=False)

    def nodes(self) -> int | None:
        """The nodes the current stream's capture holds so far, counted
        by walking back from its last node to the last one counted (each
        node once over the whole capture); None once it is no chain."""
        if self.chain:
            last = _last_node()
            seen, n = self._seen
            end, steps = _walk_back(last, seen)
            self.chain = end == seen
            self._seen = (last, n + steps)
        return self._seen[1] if self.chain else None

    def add_phase(self, name, bounce, tile, first: int, end: int) -> None:
        """Note a phase's nodes ``[first, end)``; a phase continued across
        two functions (the frame's image and the program's accumulation)
        stays one range."""
        prev = self.phases[-1] if self.phases else None
        if prev and prev[:3] == (name, bounce, tile) and (
                prev[3] + prev[4] == first):
            self.phases[-1] = prev[:4] + (end - prev[3],)
        else:
            self.phases.append((name, bounce, tile, first, end - first))


class _Recorder:
    def __init__(self):
        self.spans: dict[str, list] = {}  # name -> [count, seconds, first]
        self.captures = collections.deque(maxlen=CAPTURES_KEPT)
        self.scopes: list[Collected] = []
        self.tile: int | None = None
        self.bounce: int | None = None


_rec = _Recorder()


def reset() -> None:
    """Empty the record."""
    global _rec
    _rec = _Recorder()


def collecting() -> bool:
    """Whether a :func:`collect` is open (a counter has a reader)."""
    return bool(_rec.scopes)


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


_libcuda_fns = None


def _libcuda():
    global _libcuda_fns
    if _libcuda_fns is None:
        lib = ctypes.CDLL("libcuda.so.1")
        P, S = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        info = lib.cuStreamGetCaptureInfo_v2
        info.argtypes = [P, ctypes.POINTER(ctypes.c_int),
                         ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(P),
                         ctypes.POINTER(ctypes.POINTER(P)), S]
        deps = lib.cuGraphNodeGetDependencies
        deps.argtypes = [P, P, S]
        for f in (info, deps):
            f.restype = ctypes.c_int
        _libcuda_fns = (info, deps)
    return _libcuda_fns


SEVERAL = -1  # a node that depends on several: the graph is no chain


def _one(handles, n: int):
    """0, the handle, or :data:`SEVERAL` for ``n`` handles."""
    return 0 if n == 0 else handles[0] if n == 1 else SEVERAL


def _last_node():
    """The node the current stream captured last (the one its next node
    will depend on): 0 before any, :data:`SEVERAL` where there are
    several; raises unless the stream captures."""
    info = _libcuda()[0]
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    deps = ctypes.POINTER(ctypes.c_void_p)()
    n = ctypes.c_size_t()
    err = info(torch.cuda.current_stream().cuda_stream,
               ctypes.byref(status), None, ctypes.byref(graph),
               ctypes.byref(deps), ctypes.byref(n))
    if err or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"cuStreamGetCaptureInfo: CUDA error {err}, "
                           f"capture status {status.value}")
    return _one(deps, n.value)


def _walk_back(node, stop) -> tuple:
    """``(where the walk ended, steps)`` of a walk from ``node`` back
    through each node's one dependency to ``stop``; it ends early at a
    node that depends on none (0) or on several (:data:`SEVERAL`)."""
    get = _libcuda()[1]
    deps, n = (ctypes.c_void_p * 2)(), ctypes.c_size_t()
    ref, steps = ctypes.byref(n), 0
    while node != stop and node and node != SEVERAL:
        n.value = 2
        if get(node, deps, ref):
            raise RuntimeError("cuGraphNodeGetDependencies failed")
        node, steps = _one(deps, n.value), steps + 1
    return node, steps


def _ordinals() -> list:
    """``(collector, nodes captured so far)`` of every open
    :func:`collect` while a stream captures, else none."""
    if not (_rec.scopes and capturing()):
        return []
    return [(c, c.nodes()) for c in _rec.scopes]


@contextlib.contextmanager
def span(name: str):
    """A ``record_function`` range ``pnrt.<name>`` whose host seconds are
    added to the record; yields a :class:`Span`."""
    s = Span(name)
    t0 = time.perf_counter()
    with torch.profiler.record_function(PREFIX + name):
        yield s
    s.seconds = time.perf_counter() - t0
    slot = _rec.spans.setdefault(name, [0, 0.0, s.seconds])
    slot[0] += 1
    slot[1] += s.seconds


@contextlib.contextmanager
def phase(name: str, bounce: int | None = None):
    """The span ``phase.<name>`` of one part of a frame (of ``bounce``,
    in the current :func:`tile`); in a capture, also its node ordinals."""
    outer = _rec.bounce
    _rec.bounce = bounce
    try:
        with span("phase." + name):
            firsts = _ordinals()
            yield
            for c, first in firsts:
                end = c.nodes()
                if first is not None and end is not None:
                    c.add_phase(name, bounce, _rec.tile, first, end)
    finally:
        _rec.bounce = outer


@contextlib.contextmanager
def tile(index: int):
    """Phases and counters inside the body belong to tile ``index`` of
    the frame."""
    outer = _rec.tile
    _rec.tile = index
    try:
        yield
    finally:
        _rec.tile = outer


def count(name: str, value) -> None:
    """Hand ``value`` (a number or a tensor, read back only by
    :func:`record`) to every open :func:`collect` under ``name``,
    labelled with the current phase's bounce and tile."""
    if isinstance(value, torch.Tensor):
        if capturing():
            raise RuntimeError(f"count({name!r}) while a stream captures: "
                               "the counter would join the graph")
        value = value.detach()
    for c in _rec.scopes:
        c.counts.append((name, _rec.bounce, _rec.tile, value))


def launched(table: dict, key: str) -> None:
    """Count one launch of a hand-written kernel under ``key`` of its
    wrapper's ``table``; in a capture, note its node ordinal (called
    right after the launch, so the kernel is the capture's last node)."""
    table[key] += 1
    for c, n in _ordinals():
        if n is not None:
            c.kernels.append((key, n - 1))


@contextlib.contextmanager
def collect():
    """Yield a :class:`Collected` that records what the body counts, and,
    while a stream captures, its phases' and kernels' node ordinals."""
    c = Collected()
    _rec.scopes.append(c)
    try:
        yield c
    finally:  # by identity: two open collects may hold equal records
        _rec.scopes[:] = [s for s in _rec.scopes if s is not c]


def keep_capture(layout: dict) -> None:
    """Keep a captured frame's layout in the record (the last
    :data:`CAPTURES_KEPT`)."""
    _rec.captures.append(layout)


def _number(v) -> float:
    return float(v.item() if isinstance(v, torch.Tensor) else v)


def record() -> dict:
    """The record as plain numbers: ``spans`` {name: {"count",
    "seconds", "first"}} and ``captures`` (each kept layout, its
    counters' values as numbers).  The only place a device counter is
    read back."""
    return {
        "spans": {k: {"count": n, "seconds": s, "first": f}
                  for k, (n, s, f) in _rec.spans.items()},
        "captures": [{**c, "counts": [(n, b, t, _number(v))
                                      for n, b, t, v in c["counts"]]}
                     for c in _rec.captures],
    }
