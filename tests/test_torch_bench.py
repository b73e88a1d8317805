"""The port's bench (``pnraytracing_tpu_torch/bench.py``) on the CPU.

* ``python -m pnraytracing_tpu_torch.bench --cpu`` at 16x16, depth 2,
  an env map of height 16 and 2 frames, forward, ``--bwd`` and ``--bwd
  --no-replay``: exactly one JSON line on stdout with ``bench.py``'s
  four keys and metric string, ``value`` = rays / seconds of the timed
  calls (16 * 16 * (1 + 3 * 2) * 2 rays, the seconds from the last
  phase line), ``vs_baseline`` against the H100 anchor, not the TPU's;
  ``--quiet`` leaves stderr empty;
* without ``--cpu`` and without a card it fails and prints no JSON line;
* the retry: one re-exec (``os.execv``) on a device loss, after
  ``wait_for_device``, none a second time, none on a ``ValueError``;
* the ``--bwd`` step (``frames_loss_and_grad``) at 16x16, depth 2, k = 2
  against the same quantity by the JAX package: ``value_and_grad`` of
  the mean over the frames of ``mean((img - target) ** 2)`` through its
  ``render_rays_replay`` of the port's records (``trace_paths``), on the
  JAX package's flagship scene (``__graft_entry__._flagship``), with
  ``tests/test_torch_grad.py``'s tolerance (rtol 1e-4, atol 1e-6 x
  max|g|; the loss rtol 1e-5) and its pixel rule (the pixels of
  ``off_plane_light_pixels`` left out of both losses); the live step
  (``--no-replay``) against the replayed one with the live-against-replay
  bounds of that file (rtol 1e-5, atol 1e-7).
"""

import functools
import json
import os
import re
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from pnraytracing_tpu.diff.grad import apply_params as jax_apply_params
from pnraytracing_tpu.diff.grad import extract_params as jax_extract_params
from pnraytracing_tpu.render.integrator import (
    render_rays_replay as jax_render_rays_replay,
)
from pnraytracing_tpu_torch import bench
from pnraytracing_tpu_torch.convert import params_to_arrays
from pnraytracing_tpu_torch.diff.grad import extract_params
from pnraytracing_tpu_torch.entry import _flagship
from pnraytracing_tpu_torch.render.integrator import trace_paths
from tests.test_torch_grad import off_plane_light_pixels
from tests.test_torch_replay import jax_records
from tests.test_torch_scene import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--cpu", "--width", "16", "--height", "16", "--depth", "2",
         "--env-height", "16", "--frames", "2"]
RAYS = 16 * 16 * (1 + 3 * 2) * 2
MODES = {"fwd": [], "bwd": ["--bwd"], "bwd_live": ["--bwd", "--no-replay"]}


def run_bench(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "pnraytracing_tpu_torch.bench", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


@pytest.mark.parametrize("mode", MODES)
def test_bench_line(mode, capsys):
    assert bench.main(SMALL + MODES[mode]) == 0
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert len(lines) == 1, out.out
    line = json.loads(lines[0])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    kind = "fwd" if mode == "fwd" else "fwd+bwd"
    assert line["metric"] == (f"rays/s/chip {kind} (16x16, 1spp, 2 "
                              "bounces, teapot_night)")
    assert line["unit"] == "rays/s/chip"
    done = re.search(r"timed fetch complete: (\d+) rays in (\S+) s",
                     out.err)
    assert int(done.group(1)) == RAYS
    rays_per_s = RAYS / float(done.group(2))
    assert line["value"] == round(rays_per_s, 1) > 0
    assert line["vs_baseline"] == round(
        rays_per_s / bench.BASELINE_RAYS_PER_S, 4)
    # the last stderr line is the card's (here: the host's) name
    assert out.err.splitlines()[-1] == "cpu"


def test_bench_module_quiet():
    """``python -m`` in a fresh process, ``--quiet``: the JSON line alone
    on stdout, nothing on stderr."""
    out = run_bench(*SMALL, "--quiet")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    assert sorted(json.loads(lines[0])) == ["metric", "unit", "value",
                                            "vs_baseline"]
    assert out.stderr == ""


def test_vs_baseline_is_the_h100_anchor():
    """582.92 gathered bytes a query of the port's layouts at 3.35 TB/s,
    not the JAX bench's v5e roofline (1.2e9)."""
    assert bench.BYTES_PER_QUERY == pytest.approx(582.92, abs=0.01)
    assert bench.BASELINE_RAYS_PER_S == pytest.approx(5.747e9, rel=1e-3)


def test_no_card_fails(capsys):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            bench._main_with_retry(SMALL[1:])
    assert capsys.readouterr().out == ""


def test_no_card_subprocess():
    """The same in a fresh process: a non-zero exit code and no JSON
    line (no card visible to it)."""
    out = run_bench(*SMALL[1:], env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_retry_once_on_device_loss():
    lost = RuntimeError("CUDA error: unspecified launch failure")
    with mock.patch.dict(os.environ), \
            mock.patch.object(bench, "main", side_effect=lost), \
            mock.patch("pnraytracing_tpu_torch.utils.resilience."
                       "wait_for_device", return_value=True) as wait, \
            mock.patch.object(os, "execv") as execv:
        os.environ.pop("PNRT_BENCH_RETRIED", None)
        bench._main_with_retry(["--frames", "2"])
        assert wait.call_count == 1
        execv.assert_called_once_with(sys.executable, [
            sys.executable, "-m", "pnraytracing_tpu_torch.bench",
            "--frames", "2"])
        assert os.environ["PNRT_BENCH_RETRIED"] == "1"
        # the re-executed process fails again: no second re-exec
        assert bench._main_with_retry(["--frames", "2"]) == 1
        assert execv.call_count == 1


def test_no_retry_on_other_errors():
    os.environ.pop("PNRT_BENCH_RETRIED", None)
    for err in (ValueError("bad flag"),
                RuntimeError("CUDA error: out of memory")):
        with mock.patch.object(bench, "main", side_effect=err), \
                mock.patch.object(os, "execv") as execv:
            with pytest.raises(type(err)):
                bench._main_with_retry([])
            execv.assert_not_called()
    assert "PNRT_BENCH_RETRIED" not in os.environ


@functools.lru_cache(maxsize=1)
def bwd_inputs():
    """The bench's ``--bwd`` inputs at 16x16, depth 2 (its config, the
    port's flagship scene on the CPU, the rays of the pixels outside
    ``off_plane_light_pixels`` of both frames' records, a zero
    target)."""
    args = bench.parse_args(SMALL + ["--frames-per-call", "2"])
    cfg = bench.render_config(args)
    _, scene, o, d, px, py = _flagship(16, 16, env_height=16, max_depth=2,
                                       device="cpu")
    recs = [trace_paths(scene, o, d, px, py, j, cfg) for j in range(2)]
    left_out = off_plane_light_pixels(scene, recs, cfg.max_depth)
    assert len(left_out) <= 0.02 * cfg.num_pixels
    keep = torch.from_numpy(np.setdiff1d(np.arange(cfg.num_pixels),
                                         left_out))
    rays = [x[keep] for x in (o, d, px, py)]
    return cfg, scene, rays, torch.zeros((len(keep), 3))


def test_bwd_step_matches_jax():
    cfg, scene, rays, target = bwd_inputs()
    jcfg, js, *_ = jax_entry._flagship(16, 16, env_height=16, max_depth=2)
    params = extract_params(scene, bench.PARAM_KEYS)
    loss, grads = bench.frames_loss_and_grad(params, scene, *rays, 0, 2,
                                             target, cfg)
    # the JAX package's replay of the port's records, one compiled
    # value_and_grad a frame, averaged as the bench's scan averages
    jr = [jnp.asarray(x.numpy()) for x in rays]
    jt = jnp.asarray(target.numpy())

    @jax.jit
    def frame_value_and_grad(p, frame, rec):
        return jax.value_and_grad(lambda q: jnp.mean((jax_render_rays_replay(
            jax_apply_params(js, q), *jr, frame, jcfg, rec) - jt) ** 2))(p)

    p0 = jax_extract_params(js, bench.PARAM_KEYS)
    outs = [frame_value_and_grad(p0, jnp.uint32(j), jax_records(
        trace_paths(scene, *rays, j, cfg))) for j in range(2)]
    jloss = (outs[0][0] + outs[1][0]) / 2
    jgrads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, outs[0][1],
                                    outs[1][1])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = params_to_arrays(grads), params_to_arrays(jgrads)
    assert sorted(got) == sorted(want)
    for k in got:
        g, w = got[k], np.asarray(want[k])
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    for k in ("materials.base_color", "materials.roughness", "env_image"):
        assert np.abs(got[k]).max() > 0, k


def test_bwd_live_matches_replay():
    cfg, scene, rays, target = bwd_inputs()
    params = extract_params(scene, bench.PARAM_KEYS)
    l0, g0 = bench.frames_loss_and_grad(params, scene, *rays, 0, 2, target,
                                        cfg, replay=False)
    l1, g1 = bench.frames_loss_and_grad(params, scene, *rays, 0, 2, target,
                                        cfg)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    a, b = params_to_arrays(g0), params_to_arrays(g1)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
