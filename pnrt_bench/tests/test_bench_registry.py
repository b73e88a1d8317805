"""Everything BENCHMARK.json names is found by name, and a new
configuration, traffic mix or metric is picked up from its file alone."""

import json
import os
import shutil

import pytest

from pnrt_bench import bench
from pnrt_bench.tests.conftest import ROOT

BENCH = bench.benchmark(ROOT)


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    entry, config, traffic = bench.find_cell(BENCH, cell, ROOT)
    assert config["name"] == entry["config"]
    loop = bench.loop_module(traffic["kind"])
    assert hasattr(loop, "Loop") and hasattr(loop, "control")
    assert os.path.exists(os.path.join(ROOT, "pnrt_bench", "limits",
                                       f"{cell}.json"))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(bench.metric_reader(metric))


def test_every_end_to_end_metric_is_reported_by_its_cells():
    kinds = {c["name"]: bench.find_cell(BENCH, c["name"], ROOT)[2]["kind"]
             for c in BENCH["workloads"]}
    for cell in kinds:
        names = {m["name"] for m in bench.metrics_of(BENCH, "end_to_end",
                                                      cell)}
        assert "setup_s" in names and len(names) >= 2


def test_config_files_match_their_entries():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        assert sorted(config["reduced"]) == sorted(c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric reader, a cell's limits and their entries; nothing that was
    there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "pnrt_bench"), root / "pnrt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads(json.dumps(BENCH))
    cfg = json.load(open(os.path.join(ROOT, "pnrt_bench", "configs",
                                      "teapot_night.json")))
    cfg["name"] = "teapot_small"
    cfg["render"] = {"width": 64, "height": 64, "max_depth": 2}
    (root / "pnrt_bench" / "configs" / "teapot_small.json").write_text(
        json.dumps(cfg))
    mix = json.load(open(os.path.join(ROOT, "pnrt_bench", "traffic",
                                      "progressive.json")))
    mix["spp_per_call"] = 4
    (root / "pnrt_bench" / "traffic" / "progressive4.json").write_text(
        json.dumps(mix))
    (root / "pnrt_bench" / "metrics" / "frames.traced.py").write_text(
        "def read(run):\n    return 41.0 + 1.0\n")
    (root / "pnrt_bench" / "limits" / "teapot_small.progressive4.json"
     ).write_text(json.dumps({"pixels": 16, "answers": 1, "pixel_tol": 1e-3,
                              "limits": {"mismatch_share": 0.05}}))
    b["configs"].append({"name": "teapot_small", "source": "x",
                         "file": "pnrt_bench/configs/teapot_small.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "teapot_small.progressive4",
                           "config": "teapot_small",
                           "traffic": "progressive4", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "frames.traced", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "frame_ms",
                           "workloads": ["teapot_small.progressive4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    nb = bench.benchmark(str(root))
    entry, config, traffic = bench.find_cell(nb, "teapot_small.progressive4",
                                             str(root))
    assert config["render"]["width"] == 64 and traffic["spp_per_call"] == 4
    names = [m["name"] for m in bench.metrics_of(
        nb, "per_layer", "teapot_small.progressive4")]
    assert names == ["frames.traced"]
    path = root / "pnrt_bench" / "metrics" / "frames.traced.py"
    import importlib.util

    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(None) == 42.0
