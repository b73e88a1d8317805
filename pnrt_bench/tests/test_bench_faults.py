"""Each cell's run, on the CPU at a small size with the look for a card
skipped, comes out correct; with the timed path broken underneath it
comes out not correct, once for each fault the cell can have: a call
that returns its previous image (``stale``), half of the frames left
out, the mean taken over the rest (``half``), an image altered where it
is produced (``altered``).  The cells run on one card, so no exchange
between cards can be left out."""

import time

import pytest

from pnrt_bench import bench, check
from pnrt_bench.tests.conftest import ROOT

SKY = {"height": 16, "width": 32, "sun_dir": [-0.5, 0.25, 0.6],
       "sun_intensity": 20.0, "sky_tint": [0.02, 0.03, 0.08],
       "horizon": [0.25, 0.15, 0.08], "ground": [0.02, 0.02, 0.03]}
SMALL = {
    "teapot_night.progressive": {"render": {"width": 12, "height": 12,
                                            "max_depth": 2},
                                 "env": {"sky": SKY}},
    "bunny_class.progressive": {"render": {"width": 12, "height": 12,
                                           "max_depth": 2},
                                "env": {"sky": SKY}},
}


def _small(cell):
    ov = dict(SMALL[cell])
    if cell.startswith("bunny_class"):
        cfg = bench.find_cell(bench.benchmark(ROOT), cell, ROOT)[1]
        models = [dict(m) for m in cfg["models"]]
        for m in models:
            if m["shape"] == "icosphere":
                m["args"] = {"subdivisions": m["args"]["subdivisions"] - 4}
        ov["models"] = models
    return ov


def _run(cell, fault):
    return bench.run_cell(cell, 3141592653, 0.05, False, ROOT,
                          time.perf_counter(), device="cpu",
                          overrides=_small(cell), fault=fault)[0]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    res = _run(cell, None)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in bench.metrics_of(bench.benchmark(ROOT),
                                                  "end_to_end", cell)}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_broken_path_is_not_correct(cell, fault):
    res = _run(cell, fault)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_a_number(cell):
    """The reference in bfloat16 put in the program's place fails at
    least one of the cell's numbers."""
    _, config, traffic = bench.find_cell(bench.benchmark(ROOT), cell, ROOT)
    config = {**config, **_small(cell)}
    limits = check.load_limits(cell)
    numbers = bench.loop_module(traffic["kind"]).control(
        config, traffic, limits, 2718281828, __import__("torch").device(
            "cpu"))
    assert any(not v <= limits["limits"][k] for k, v in numbers.items())
