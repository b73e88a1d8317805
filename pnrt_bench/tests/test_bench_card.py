"""On the card: one short run of each cell through the command, which
must end correct with every metric it names.  Skips without a card (the
look is made inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from pnrt_bench import bench
from pnrt_bench.tests.conftest import ROOT

CELLS = [c["name"] for c in bench.benchmark(ROOT)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "pnrt_bench", "run.py"),
         "--workload", cell, "--seed", "2147483647", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    names = {m["name"] for m in bench.metrics_of(
        bench.benchmark(ROOT), "end_to_end", cell)}
    assert set(res["metrics"]) == names
