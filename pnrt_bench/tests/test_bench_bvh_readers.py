"""The readers of route ``bvh``'s walk and of the tree build
(``walk_ms.bvh``, ``walk_pops.bvh``, ``tree_s``) on synthetic traces and
a synthetic program record: a well-formed stretch reads the expected
numbers; a stretch without the plain-BVH kernel, a record without the
walk counters or the ``build.tree`` span (a program that keeps none of
them), and ``walk_ms.bvh`` without a trace read None; ``walk_pops.bvh``
reads the record's counters whatever the stretch holds."""

import types

import pytest

from pnrt_bench import bench, replays, tracing

NS = "pnrt::(anonymous namespace)::"
WALK_C = f"void {NS}bvh_walk_kernel<true, false, {NS}PlainTree>(int)"
WALK_A = f"void {NS}bvh_walk_kernel<false, false, {NS}PlainTree>(int)"
PACKED_C = f"void {NS}bvh_walk_kernel<true, false, {NS}PackedRows>(int)"
STREAM_C = "void (anonymous namespace)::stream_kernel<true, false>(float*)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor>()"
SHADE = f"void {NS}shade_bounce_kernel<true>()"
COPY = "Memcpy DtoH (Device -> Pageable)"

# a frame of 6 nodes: camera [0, 2), shadow [2, 4), next [4, 6); walks
# at 1 (closest), 3 (shadow) and 5 (closest)
CAPTURE = {
    "nodes": 6,
    "phases": [("camera", None, 0, 0, 2), ("shadow", 0, 0, 2, 2),
               ("next", 0, 0, 4, 2)],
    "walks": [1, 3, 5],
    "counts": [
        ("rays.live", 0, 0, 30.0), ("rays.launched", 0, 0, 40.0),
        ("walk.closest.pops", None, 0, 400.0),
        ("walk.closest.slabs", None, 0, 1100.0),
        ("walk.closest.tests", None, 0, 60.0),
        ("walk.closest.queries", None, 0, 40.0),
        ("walk.shadow.pops", 0, 0, 150.0),
        ("walk.shadow.slabs", 0, 0, 420.0),
        ("walk.shadow.tests", 0, 0, 20.0),
        ("walk.shadow.queries", 0, 0, 45.0),
        ("walk.closest.pops", 0, 0, 250.0),
        ("walk.closest.slabs", 0, 0, 700.0),
        ("walk.closest.tests", 0, 0, 30.0),
        ("walk.closest.queries", 0, 0, 25.0),
    ],
}
FRAME = [FILL, WALK_C, SHADE, WALK_A, FILL, WALK_C]
OP_US = 10  # each op's length


def _replay(t0, frame=FRAME):
    """One replay from ``t0``: each op 10 us, 1 us apart."""
    return [(name, t0 + 11 * i, t0 + 11 * i + OP_US)
            for i, name in enumerate(frame)]


def _trace(ops=None, units=2):
    ops = ops if ops is not None else (
        _replay(0) + [(COPY, 70, 80)] + _replay(100))
    return tracing.Trace(ops=ops, spans=[("replay", 0, 200)],
                         wall_us=(0, 200), units=units)


@pytest.fixture
def record(monkeypatch):
    rec = {"spans": {"build.tree": {"count": 1, "seconds": 12.5,
                                    "first": 12.5}},
           "captures": [CAPTURE]}
    monkeypatch.setattr(replays, "program_record", lambda: rec)
    return rec


def _read(name, trace):
    run = types.SimpleNamespace(trace=trace, setup={}, counters={},
                                config={})
    return bench.metric_reader(name)(run)


def test_a_well_formed_stretch(record):
    t = _trace()
    # three walk kernels a frame, 10 us each
    assert _read("walk_ms.bvh", t) == pytest.approx(30e-3)
    # (400 + 150 + 250) pops over (40 + 45 + 25) queries
    assert _read("walk_pops.bvh", t) == pytest.approx(800.0 / 110.0)
    assert _read("tree_s", t) == 12.5
    assert _read("tree_s", None) == 12.5  # a span of the set-up


def test_walk_ms_counts_only_the_plain_tree_walk(record):
    """The packed instantiation of the same kernel (route ``packed``) and
    the other routes' walks are not this reader's."""
    other = [FILL, PACKED_C, SHADE, STREAM_C, FILL, PACKED_C]
    assert _read("walk_ms.bvh", _trace(_replay(0, other))) is None
    mixed = [FILL, WALK_C, SHADE, STREAM_C, FILL, PACKED_C]
    assert _read("walk_ms.bvh", _trace(_replay(0, mixed), units=1)) == (
        pytest.approx(10e-3))


def test_walk_pops_without_the_counters_reads_none(record):
    """The parent's program: the capture holds only the live-ray
    counters."""
    record["captures"] = [dict(CAPTURE, counts=[
        c for c in CAPTURE["counts"] if not c[0].startswith("walk.")])]
    assert _read("walk_pops.bvh", _trace()) is None
    assert _read("live_share.frame", _trace()) == pytest.approx(75.0)


def test_walk_pops_ignores_other_counters(record):
    record["captures"] = [dict(CAPTURE, counts=CAPTURE["counts"] + [
        ("walk.other.pops", 0, 0, 1e6), ("walk.closest.pops.x", 0, 0, 1e6),
        ("walk.shadow.slabs", 1, 0, 1e6)])]
    assert _read("walk_pops.bvh", _trace()) == pytest.approx(800.0 / 110.0)


def test_walk_pops_reads_the_record_whatever_the_stretch(record):
    """The warm-up frame's counters are in the record whether or not the
    traced stretch splits into replays, and whatever it holds."""
    ops = _replay(0) + [(COPY, 70, 80)] + _replay(100)
    del ops[9]  # the second replay's op between its walks
    assert replays.replays(types.SimpleNamespace(trace=_trace(ops))) is None
    assert _read("walk_pops.bvh", _trace(ops)) == pytest.approx(800 / 110)
    assert _read("walk_pops.bvh", None) == pytest.approx(800 / 110)


def test_walk_pops_reads_the_last_capture_that_counted_walks(record):
    """A later capture without walk counters (another scene's program,
    off route ``bvh``) does not hide the last one that has them."""
    later = dict(CAPTURE, counts=[("walk.closest.pops", 0, 0, 90.0),
                                  ("walk.closest.queries", 0, 0, 10.0)])
    bare = dict(CAPTURE, counts=[("rays.live", 0, 0, 1.0)])
    record["captures"] = [CAPTURE, later, bare]
    assert _read("walk_pops.bvh", _trace()) == pytest.approx(9.0)


def test_tree_s_without_the_span_reads_none(record):
    del record["spans"]["build.tree"]
    assert _read("tree_s", _trace()) is None


def test_a_program_without_a_record_reads_none(monkeypatch):
    monkeypatch.setattr(replays, "program_record", lambda: None)
    for q in ("walk_pops.bvh", "tree_s"):
        assert _read(q, _trace()) is None


def test_walk_ms_is_silent_without_a_trace(record):
    assert _read("walk_ms.bvh", None) is None
