"""The readers of the program's spans and counters (``sort_ms``,
``live_share``, ``enqueue_ms``, ``warmup_s``) and the split of a stretch
into replays (``replays.py``), on synthetic traces and a synthetic
program record: a well-formed stretch reads the expected numbers; a
missing operation (also where a foreign one takes its slot), a walk off
its ordinal, overlapping replays, phases that do not tile the graph or a
sort outside the walks, a replay span missing or a program without a
record read None."""

import types

import pytest

from pnrt_bench import bench, replays, tracing

WALK_C = "void closest_hit_kernel<true, false>(float const*)"
WALK_A = "void any_hit_kernel<false>(float const*)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor>()"
ADD = "void at::native::vectorized_elementwise_kernel<4, AddFunctor>()"
SORT = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel()"
COPY = "Memcpy DtoH (Device -> Pageable)"

# a frame of 6 nodes: camera [0, 2), sort [2, 4), shadow [4, 6); walks
# at 1 and 4
CAPTURE = {
    "nodes": 6,
    "phases": [("camera", None, 0, 0, 2), ("sort", 0, 0, 2, 2),
               ("shadow", 0, 0, 4, 2)],
    "walks": [1, 4],
    "counts": [("rays.live", 0, 0, 30.0), ("rays.launched", 0, 0, 40.0),
               ("rays.live", 1, 0, 10.0), ("rays.launched", 1, 0, 40.0)],
}
FRAME = [FILL, WALK_C, ADD, SORT, WALK_A, ADD]


def _replay(t0):
    """One replay from ``t0``: each op 10 us, 1 us apart (gaps 5 us)."""
    return [(name, t0 + 11 * i, t0 + 11 * i + 10)
            for i, name in enumerate(FRAME)]


def _trace(ops=None, spans=None):
    ops = ops if ops is not None else (
        _replay(0) + [(COPY, 70, 80)] + _replay(100))
    spans = spans if spans is not None else [
        ("replay", 0, 200), ("frame.replay", 2, 5), ("frame.replay", 6, 8)]
    return tracing.Trace(ops=ops, spans=spans, wall_us=(0, 200), units=2)


@pytest.fixture
def record(monkeypatch):
    # 11 replays in all: the first (the graph's upload) 40 ms, the
    # stretch's two 5 us, 8 more in 24 ms
    rec = {"spans": {"capture.warmup": {"count": 1, "seconds": 2.5,
                                        "first": 2.5},
                     "frame.replay": {"count": 11, "seconds": 0.064005,
                                      "first": 0.04}},
           "captures": [CAPTURE]}
    monkeypatch.setattr(replays, "program_record", lambda: rec)
    return rec


def _read(name, trace):
    run = types.SimpleNamespace(trace=trace, setup={}, counters={},
                                config={})
    return bench.metric_reader(name)(run)


def test_a_well_formed_stretch(record):
    t = _trace()
    found = replays.replays(types.SimpleNamespace(trace=t))
    assert found is not None and found[2] == [0, 7]
    assert _read("sort_ms.frame", t) == pytest.approx(20e-3)
    assert _read("live_share.frame", t) == pytest.approx(50.0)
    assert _read("enqueue_ms.frame", t) == pytest.approx(3.0)
    assert _read("warmup_s", t) == 2.5
    for q in ("sort_ms", "live_share", "enqueue_ms"):
        assert _read(q + ".large", t) == _read(q + ".frame", t)


@pytest.mark.parametrize("fault", ["missing_op", "walk_off", "extra_walk",
                                   "last_op_missing", "frames",
                                   "tail_slot_taken", "head_slot_taken",
                                   "overlap"])
def test_a_broken_stretch_reads_none(record, fault):
    ops = _replay(0) + [(COPY, 70, 80)] + _replay(100)
    units = 2
    if fault == "missing_op":  # the second replay's add between its walks
        del ops[9]
    elif fault == "tail_slot_taken":  # the first replay's last add lost,
        del ops[5]  # the copy after it in its slot: the walks still fit
    elif fault == "head_slot_taken":  # the second replay's first op lost,
        del ops[7]  # the copy before it in its slot
    elif fault == "overlap":  # the second replay starts inside the first
        ops = _replay(0) + _replay(60)
    elif fault == "walk_off":  # a walk one ordinal late
        ops[8], ops[9] = ops[9], ops[8]
        ops[8], ops[9] = (ops[8][0], 111, 121), (ops[9][0], 122, 132)
    elif fault == "extra_walk":  # a walk kernel outside both replays
        ops[6] = (WALK_A, 70, 80)
    elif fault == "last_op_missing":
        ops = ops[:-1]
    else:  # more frames than replays
        units = 3
    t = _trace(ops)
    t.units = units
    for q in ("sort_ms.frame", "live_share.frame"):
        assert _read(q, t) is None


def test_phases_that_do_not_tile_read_none(record):
    bad = dict(CAPTURE, phases=CAPTURE["phases"][:2] + [
        ("shadow", 0, 0, 5, 1)])
    record["captures"] = [bad]
    assert _read("sort_ms.frame", _trace()) is None
    record["captures"] = [bad, CAPTURE]  # the capture that splits it
    assert _read("sort_ms.frame", _trace()) == pytest.approx(20e-3)


def test_a_sort_outside_the_walks_reads_none(record):
    """Sort ordinals before the first walk are not pinned by the walks:
    the reader refuses them rather than trust the head's alignment."""
    record["captures"] = [dict(CAPTURE, phases=[
        ("sort", 0, 0, 0, 2), ("camera", None, 0, 2, 2),
        ("shadow", 0, 0, 4, 2)])]
    assert _read("sort_ms.frame", _trace()) is None
    assert _read("live_share.frame", _trace()) == pytest.approx(50.0)


@pytest.mark.parametrize("spans", [
    [("frame.replay", 2, 5)],  # a replay of the stretch without its span
    [("frame.replay", 2, 5), ("frame.replay", 6, 8), ("frame.replay", 9, 10)],
    []])
def test_enqueue_reads_none_unless_one_span_a_frame(record, spans):
    assert _read("enqueue_ms.frame", _trace(spans=spans)) is None


@pytest.mark.parametrize("count", [3, 2])
def test_enqueue_reads_none_without_replays_outside_the_stretch(
        record, count):
    """The first replay and the stretch's two leave none to read."""
    record["spans"]["frame.replay"] = {"count": count, "seconds": 0.04001,
                                       "first": 0.04}
    assert _read("enqueue_ms.frame", _trace()) is None
    del record["spans"]["frame.replay"]
    assert _read("enqueue_ms.frame", _trace()) is None


def test_a_program_without_a_record_reads_none(monkeypatch):
    monkeypatch.setattr(replays, "program_record", lambda: None)
    t = _trace()
    for q in ("sort_ms.frame", "live_share.frame", "enqueue_ms.frame",
              "warmup_s"):
        assert _read(q, t) is None


def test_program_record_of_a_program_without_one(monkeypatch):
    from pnraytracing_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "record")
    assert replays.program_record() is None
    monkeypatch.undo()
    assert set(replays.program_record()) == {"spans", "captures"}


def test_readers_are_silent_without_a_trace(record):
    for q in ("sort_ms", "live_share", "enqueue_ms"):
        for s in (".frame", ".large"):
            assert _read(q + s, None) is None
