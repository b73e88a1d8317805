"""The port's entry points (``pnraytracing_tpu_torch/entry.py``)
on the CPU, against the JAX package's ``__graft_entry__.py``.

* ``_flagship(16, 16, env_height=16, max_depth=2, device="cpu")``: the
  config (``traversal="packed"`` on both, the JAX package's rule off its
  TPU), the camera rays (directions within tests/test_torch_core.py's
  rtol 1e-6, atol 1e-7) and pixel coordinates of the JAX ``_flagship``
  at the same arguments; ``render_rays`` of both within atol 3e-5
  (``tests/test_torch_render.py::assert_frame_close``) outside the rim
  pixels, the rule of ``tests/test_torch_parallel.py::rim_pixels``
  (primary ``t`` of the two packages' walks beyond rtol 1e-6; at most
  2%);
* ``entry(device="cpu")``: ``render_rays`` at 512x512, depth 4, its
  arguments on the CPU;
* the body of ``dryrun_multichip`` (``entry._dryrun_rank``) at 32x32 on
  two gloo ranks (``tests/test_torch_parallel_workers.py::spawn``):
  finite losses and the same parameters on both ranks, moved by the
  steps;
* ``dryrun_multichip`` refuses NCCL ranks it cannot place.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from pnraytracing_tpu.accel.traverse import closest_hit as jax_closest_hit
from pnraytracing_tpu.render.integrator import render_rays as jax_render_rays
from pnraytracing_tpu_torch import entry
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.convert import params_to_arrays
from pnraytracing_tpu_torch.core.math import FLOAT_MAX
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.diff.grad import extract_params
from pnraytracing_tpu_torch.render.integrator import render_rays
from tests import test_torch_parallel_workers as workers
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import _torch_threads  # noqa: F401


def test_flagship_matches_jax():
    cfg, scene, o, d, px, py = entry._flagship(16, 16, env_height=16,
                                               max_depth=2, device="cpu")
    jcfg, js, jo, jd, jpx, jpy = jax_entry._flagship(16, 16, env_height=16,
                                                     max_depth=2)
    assert cfg.traversal == jcfg.traversal == "packed"
    assert (cfg.width, cfg.height, cfg.max_depth) == (
        jcfg.width, jcfg.height, jcfg.max_depth) == (16, 16, 2)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    # tests/test_torch_core.py::test_camera_rays_match's bound
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))

    t_max = np.full(len(o), FLOAT_MAX, np.float32)
    hit = trv.closest_hit(scene.trav, V3.of(o).map(torch.Tensor.contiguous),
                          V3.of(d).map(torch.Tensor.contiguous),
                          torch.from_numpy(t_max))
    jhit = jax_closest_hit(js.bvh, js.mesh, jo, jd, jnp.asarray(t_max))
    t, t_jax = hit.t.numpy(), np.asarray(jhit.t)
    rim = np.abs(t - t_jax) > 1e-6 * np.abs(t_jax)
    assert rim.sum() <= 0.02 * len(t)

    got = render_rays(scene, o, d, px, py, 0, cfg).numpy()
    want = np.asarray(jax_render_rays(js, jo, jd, jpx, jpy, jnp.uint32(0),
                                      jcfg))
    got[rim] = want[rim]
    assert_frame_close(got.reshape(16, 16, 3), want.reshape(16, 16, 3))
    assert want.mean() > 0.02  # the frame is lit


def test_entry_on_cpu():
    fn, args = entry.entry(device="cpu")
    assert fn.func is render_rays
    cfg = fn.keywords["cfg"]
    assert (cfg.width, cfg.height, cfg.max_depth, cfg.traversal) == (
        512, 512, 4, "packed")
    scene, o, d, px, py, frame = args
    assert frame == 0
    assert o.shape == d.shape == (512 * 512, 3)
    assert px.shape == py.shape == (512 * 512,)
    assert scene.env.image.shape[0] == 256
    for t in (o, d, px, py, scene.mesh.positions, scene.trav.nodes16c,
              scene.env.image):
        assert t.device.type == "cpu"


def test_dryrun_rank_on_two_gloo_ranks(tmp_path):
    ranks = workers.spawn(workers.dryrun_job, 2, str(tmp_path), 32, 32)
    assert ranks[0].keys() == ranks[1].keys()
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    losses = ranks[0]["losses"]
    assert losses.shape == (2,) and np.isfinite(losses).all()
    assert losses[1] < losses[0]  # a step towards the zero target
    _, scene, *_ = entry._flagship(32, 32, env_height=32, device="cpu")
    start = params_to_arrays(extract_params(scene, entry.PARAM_KEYS))
    assert sorted(start) == sorted(k for k in ranks[0] if k != "losses")
    assert not np.array_equal(ranks[0]["env_image"], start["env_image"])


def test_dryrun_multichip_refuses_nccl_ranks_it_cannot_place():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            entry.dryrun_multichip(2)
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=1):
        with pytest.raises(ValueError, match="NCCL refuses two ranks"):
            entry.dryrun_multichip(2)
        with pytest.raises(ValueError, match="backend='gloo'"):
            entry.dryrun_multichip(2, backend="nccl")
