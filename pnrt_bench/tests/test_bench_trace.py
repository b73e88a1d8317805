"""The trace reduction and the walk roofline's byte count, on synthetic
traces."""

import importlib.util
import os
import types

import pytest

from pnrt_bench import bench, tracing, yardstick
from pnrt_bench.tests.conftest import ROOT


def _walk_module():
    path = os.path.join(ROOT, "pnrt_bench", "metrics",
                        "walk_roofline.frame.py")
    spec = importlib.util.spec_from_file_location("walk", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_walk_bytes_counts_each_query_and_round():
    w = _walk_module()
    # 2 pixels, depth 1, 1 triangle: closest 2 * 2 * 44, shadow 2 * 2 * 32,
    # triangles 36 * 3 rounds
    assert w.walk_bytes(2, 1, 1) == 176 + 128 + 108
    # the flagship frame: 512^2, depth 4, 5,692 triangles
    assert w.walk_bytes(512 * 512, 4, 5692) == (
        262144 * 5 * 44 + 262144 * 8 * 32 + 5692 * 36 * 9)


def _trace():
    ops = [("void closest_hit_kernel<true, false>(float const*)", 10, 20),
           ("void at::native::add_kernel(float)", 15, 30),   # overlaps
           ("void entry_key_kernel(float4 const*)", 40, 45),
           ("Memcpy DtoH (Device -> Pageable)", 50, 60),
           ("void stream_kernel<false, false>(float const*)", 70, 80)]
    spans = [("replay", 0, 46), ("fetch", 46, 65), ("replay", 65, 100)]
    return tracing.Trace(ops=ops, spans=spans, wall_us=(0, 100), units=2)


def test_union_not_sum_of_durations():
    t = _trace()
    assert tracing.union_length(t.ops) == 20 + 5 + 10 + 10
    assert t.busy_s == pytest.approx(45e-6)
    assert tracing.idle_share(t) == pytest.approx(1 - 45 / 100)


def test_gaps_and_breakdown():
    t = _trace()
    assert tracing.gaps(t) == [(0, 10), (30, 40), (45, 50), (60, 70),
                               (80, 100)]
    b = tracing.breakdown(t)
    gaps = dict(b["idle_gaps"])
    assert gaps["replay"] == pytest.approx((10 + 10 + 20) * 1e-6)
    assert gaps["fetch"] == pytest.approx((5 + 10) * 1e-6)
    assert b["device_ops"][0][1] == pytest.approx(15e-6)


def test_kernel_classes():
    assert yardstick.is_walk("void closest_hit_kernel<true, false>(x)")
    assert yardstick.is_walk("void stream_kernel<false, false>(x)")
    assert not yardstick.is_walk("void entry_key_kernel(x)")
    assert yardstick.is_port_kernel("void entry_key_kernel(x)")
    assert not yardstick.is_port_kernel(
        "void at::native::vectorized_elementwise_kernel<4>(x)")
    assert yardstick.is_copy("Memcpy DtoH (Device -> Pageable)")


def test_readers_on_a_synthetic_trace():
    run = types.SimpleNamespace(
        trace=_trace(), setup={"build_s": 1.5, "capture_s": 0.25},
        counters={},
        config={"render": {"width": 4, "height": 4, "max_depth": 2},
                "triangles": 10})
    read = lambda m: bench.metric_reader(m)(run)
    assert read("kernels.frame") == 2.0  # 4 kernels, 2 frames
    assert read("shade_ms.frame") == pytest.approx(15e-3 / 2)
    assert read("idle_share.frame") == pytest.approx(55.0)
    assert read("build_s") == 1.5
    walk_s = 20e-6 / 2  # kernels 1 and 7a, per frame
    least = _walk_module().walk_bytes(16, 2, 10) / yardstick.HBM_BYTES_PER_S
    assert read("walk_roofline.frame") == pytest.approx(100 * least / walk_s)


@pytest.mark.parametrize("quantity", ["shade_ms", "kernels",
                                      "walk_roofline", "idle_share"])
def test_large_readers_read_as_the_frame_readers(quantity):
    run = types.SimpleNamespace(
        trace=_trace(), setup={}, counters={},
        config={"render": {"width": 4, "height": 4, "max_depth": 2},
                "triangles": 10})
    got = bench.metric_reader(f"{quantity}.large")(run)
    assert got is not None
    assert got == bench.metric_reader(f"{quantity}.frame")(run)


def test_readers_are_silent_without_a_trace():
    run = types.SimpleNamespace(trace=None, setup={}, counters={},
                                config={})
    for m in ("kernels.frame", "shade_ms.frame", "walk_roofline.frame",
              "idle_share.frame", "kernels.large", "shade_ms.large",
              "walk_roofline.large", "idle_share.large"):
        assert bench.metric_reader(m)(run) is None
