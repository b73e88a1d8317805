"""Nothing under pnrt_bench imports JAX or the JAX package, compared by
whole top-level module names (so the port's own name passes); and the
command refuses to run without a card."""

import json
import os
import subprocess
import sys

from pnrt_bench.tests.conftest import ROOT

CODE = """
import os, pkgutil, importlib, sys, runpy
sys.path.insert(0, {root!r})
import pnrt_bench
for m in pkgutil.walk_packages(pnrt_bench.__path__, 'pnrt_bench.'):
    if '.tests' not in m.name:
        importlib.import_module(m.name)
for f in os.listdir(os.path.join({root!r}, 'pnrt_bench', 'metrics')):
    runpy.run_path(os.path.join({root!r}, 'pnrt_bench', 'metrics', f))
from pnrt_bench import bench
print(json.dumps([sorted({{m.split('.')[0] for m in sys.modules}}),
                  bench.forbidden_modules()]))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    out = subprocess.run(
        [sys.executable, "-c", "import json\n" + CODE.format(root=ROOT)],
        check=True, capture_output=True, text=True).stdout
    tops, forbidden = json.loads(out.strip().splitlines()[-1])
    assert forbidden == []
    assert not {"jax", "jaxlib", "flax", "pnraytracing_tpu"} & set(tops)


def test_forbidden_names_are_compared_whole():
    from pnrt_bench import bench

    saved = dict(sys.modules)
    try:
        sys.modules["pnraytracing_tpu_torch_x"] = sys
        sys.modules["jaxtyping"] = sys
        assert bench.forbidden_modules() == [
            m for m in bench.forbidden_modules()
            if m.split(".")[0] in bench.FORBIDDEN]
        assert "jaxtyping" not in bench.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert "jax.numpy" in bench.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_command_needs_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "pnrt_bench", "run.py"),
         "--workload", "teapot_night.progressive", "--seed", "3000000000",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT)
    assert p.returncode != 0
    assert "correct" not in p.stdout
