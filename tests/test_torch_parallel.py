"""The port's ``parallel/`` (``distributed.py``, ``mesh.py``) on the CPU,
in real multi-process worlds (gloo, ``torch.multiprocessing.spawn``, the
workers of ``tests/test_torch_parallel_workers.py``), against itself and
against the JAX package on its 8 forced CPU devices.

* ``shard_render_rays`` on a world of 2 (mesh 2) and of 4 (meshes 2 and
  4, the subset as ``tests/test_parallel.py::test_mesh_subset_sizes``),
  on the 16x16 depth-2 hash-sampler scene of ``tests/test_parallel.py``,
  all 256 rays and ``16*16 - 3``: bit for bit the port's unsharded
  ``render_rays`` on every rank of the mesh, and within
  ``assert_frame_close`` (tests/test_torch_render.py) of the JAX
  package's ``shard_render_rays`` on ``make_device_mesh(2)`` / ``(4)``;
* ``dp_loss_and_grad`` (world 2, replayed and live) and one replayed
  ``dp_train_step`` on ``16*16 - 5`` rays (one padded row) at depth 1:
  against the port's single-process ``loss_and_grad_replay`` /
  ``loss_and_grad`` (spp 1, plain MSE) and a ``torch.optim.Adam`` step
  on its gradient, rtol 1e-5; the replayed gradient also against
  ``jax.vjp`` of the JAX package's replay on the port's records (the
  route of tests/test_torch_grad.py): rtol 1e-4, atol 1e-6 x max|g|;
* ``all_hosts_image``, ``scaling_efficiency``, ``pad_to_multiple``, the
  device and backend rules of ``initialize``, and that no module of
  ``parallel/`` or ``utils/`` imports JAX or the JAX package.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.accel.traverse import closest_hit as jax_closest_hit
from pnraytracing_tpu.core.camera import camera_rays as jax_camera_rays
from pnraytracing_tpu.core.camera import make_camera as jax_make_camera
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.diff.grad import apply_params as jax_apply_params
from pnraytracing_tpu.diff.grad import extract_params as jax_extract_params
from pnraytracing_tpu.parallel import distributed as jax_distributed
from pnraytracing_tpu.parallel import mesh as jax_mesh
from pnraytracing_tpu.render.integrator import (
    render_rays_replay as jax_render_rays_replay,
)
from pnraytracing_tpu.render.renderer import pixel_coords as jax_pixel_coords
from pnraytracing_tpu.scene import shapes as jax_shapes
from pnraytracing_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from pnraytracing_tpu.scene.transform import compose, rotate, translate
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.convert import (
    params_from_arrays,
    params_to_arrays,
    scene_to_arrays,
)
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.math import FLOAT_MAX
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.diff.grad import (
    extract_params,
    leaf_copies,
    loss_and_grad,
    loss_and_grad_replay,
    param_leaves,
)
from pnraytracing_tpu_torch.parallel import distributed, mesh
from pnraytracing_tpu_torch.render.integrator import render_rays, trace_paths
from tests import test_torch_parallel_workers as workers
from tests.test_torch_render import assert_frame_close
from tests.test_torch_replay import jax_config, jax_records, port_rays, scenes
from tests.test_torch_scene import _torch_threads, port_scene  # noqa: F401

CFG = RenderConfig(width=16, height=16, max_depth=2, sampler="hash",
                   clamp_radiance=False)
JAX_CFG = JaxRenderConfig(width=16, height=16, max_depth=2, sampler="hash",
                          clamp_radiance=False)
COUNTS = (256, 16 * 16 - 3)
# the default unrolled loop: the JAX replay's vjp below runs eagerly,
# op by op (18 s here), where a scan's body compiles first (43 s)
DP = RenderConfig(width=16, height=16, max_depth=1, sampler="hash",
                  clamp_radiance=False)
DP_RAYS = 16 * 16 - 5
KEYS = ("materials", "env_image", "positions")
LIVE_KEYS = ("materials", "env_image")
LR = 5e-2

PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pnraytracing_tpu_torch")


def _save(workdir, name, **arrays):
    np.savez(os.path.join(workdir, name + ".npz"), **arrays)


@functools.lru_cache(maxsize=1)
def small_scene():
    """(JAX scene, rays as numpy) of tests/test_parallel.py's setup."""
    b = JaxSceneBuilder()
    b.add(jax_shapes.cube(0.8), dict(base_color=(0.7, 0.3, 0.3),
                                     roughness=0.5),
          name="cube", transform=translate(0, 0.8, 0))
    b.add(jax_shapes.quad(6.0), dict(base_color=(0.7, 0.7, 0.7),
                                     roughness=0.9), name="floor")
    b.add(jax_shapes.quad(1.0), dict(emissive=(15.0, 15.0, 15.0)),
          name="light",
          transform=compose(translate(0, 5.0, 0), rotate(180, (0, 0, 1))))
    scene = b.build(env_constant=(0.2, 0.25, 0.3))
    cam = jax_make_camera((3.5, 3.0, 3.5), (0, 0.8, 0), (0, 1, 0), 45.0, 1.0)
    px, py = jax_pixel_coords(JAX_CFG)
    o, d, _ = jax_camera_rays(cam, JAX_CFG.width, JAX_CFG.height)
    return scene, {"o": np.asarray(o), "d": np.asarray(d),
                   "px": np.asarray(px).astype(np.int64),
                   "py": np.asarray(py).astype(np.int64)}


@pytest.fixture(scope="module")
def render_runs(tmp_path_factory):
    """Each rank's results of ``workers.render_job`` in a world of 2 (mesh
    2) and of 4 (meshes 2 and 4)."""
    js, rays = small_scene()
    out = {}
    for world, sizes in ((2, (2,)), (4, (2, 4))):
        wd = str(tmp_path_factory.mktemp(f"render{world}"))
        _save(wd, "scene", **scene_to_arrays(js))
        _save(wd, "rays", **rays)
        out[world] = workers.spawn(workers.render_job, world, wd, CFG,
                                   sizes, COUNTS)
    return out


@functools.lru_cache(maxsize=1)
def unsharded():
    js, rays = small_scene()
    t = {k: torch.from_numpy(v.copy()) for k, v in rays.items()}
    return render_rays(port_scene(js), t["o"], t["d"], t["px"], t["py"], 0,
                       CFG).numpy()


@pytest.mark.parametrize("world,n", [(2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("count", COUNTS)
def test_sharded_render_equals_unsharded(render_runs, world, n, count):
    """Every rank of the mesh holds the whole batch, bit for bit the
    unsharded render (padding cut); ranks outside a subset mesh hold
    nothing of it."""
    key = f"render_{n}_{count}"
    want = unsharded()[:count]
    for rank, got in enumerate(render_runs[world]):
        if rank >= n:
            assert key not in got
            continue
        assert got[key].shape == (count, 3)
        np.testing.assert_array_equal(got[key], want)


@functools.lru_cache(maxsize=1)
def rim_pixels():
    """The pixels whose primary hit the port's walk and the JAX package's
    XLA walk place apart (``t`` beyond rtol 1e-6, the bound of
    tests/test_torch_replay.py): rays through the rim of a triangle that
    one walk hits and the other misses (tests/test_torch_replay.py
    leaves such pixels out the same way).  A tie between two triangles
    of one surface gives other triangle ids but the same ``t``, and
    stays in."""
    js, rays = small_scene()
    o, d = (torch.from_numpy(rays[k].copy()) for k in ("o", "d"))
    t_max = np.full(len(rays["o"]), FLOAT_MAX, np.float32)
    got = trv.closest_hit(port_scene(js).trav, V3.of(o).map(torch.Tensor
                                                             .contiguous),
                          V3.of(d).map(torch.Tensor.contiguous),
                          torch.from_numpy(t_max))
    want = jax_closest_hit(js.bvh, js.mesh, jnp.asarray(rays["o"]),
                           jnp.asarray(rays["d"]), jnp.asarray(t_max))
    t, t_jax = got.t.numpy(), np.asarray(want.t)
    return np.nonzero(np.abs(t - t_jax) > 1e-6 * np.abs(t_jax))[0]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_render_matches_jax(render_runs, n):
    """Within ``assert_frame_close`` of the JAX package's sharded frame
    outside the rim pixels, at most 2% of them."""
    js, rays = small_scene()
    want = np.asarray(jax_mesh.shard_render_rays(
        js, *(jnp.asarray(rays[k]) for k in ("o", "d", "px", "py")), 0,
        JAX_CFG, jax_mesh.make_device_mesh(n)))
    got = render_runs[4][0][f"render_{n}_256"].copy()
    rim = rim_pixels()
    assert len(rim) <= 0.02 * len(rays["o"])  # observed: 3 of 256
    got[rim] = want[rim]
    assert_frame_close(got.reshape(16, 16, 3), want.reshape(16, 16, 3))
    assert want.mean() > 0.05  # the frame is lit


def test_all_hosts_image(render_runs):
    """Rows of every rank, in rank order, on every rank: the JAX
    package's ``process_allgather(tiled=True)``."""
    for world, outs in render_runs.items():
        want = np.repeat(np.arange(world, dtype=np.float32), 2)[:, None]
        for got in outs:
            np.testing.assert_array_equal(got["all_hosts"],
                                          np.broadcast_to(want, (2 * world,
                                                                 3)))


def test_scaling_efficiency_matches_jax():
    times = {1: 4.0, 2: 2.2, 4: 1.3}
    assert (distributed.scaling_efficiency(times)
            == jax_distributed.scaling_efficiency(times))
    with pytest.raises(ValueError, match="1-host"):
        distributed.scaling_efficiency({2: 1.0})


@pytest.mark.parametrize("rows,m", [(7, 4), (8, 4), (5, 1), (5, 8)])
def test_pad_to_multiple_matches_jax(rows, m):
    """The JAX package's row counts; the port's padded rows repeat the
    last row where the JAX package's are zero."""
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3) + 1
    got, r = mesh.pad_to_multiple(torch.from_numpy(x), m)
    want, rw = jax_mesh.pad_to_multiple(jnp.asarray(x), m)
    assert r == rw == rows
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy()[:rows], np.asarray(want)[:rows])
    np.testing.assert_array_equal(got.numpy()[rows:],
                                  np.broadcast_to(x[-1], got[rows:].shape))
    assert not np.asarray(want)[rows:].any()


def test_device_and_backend_rules():
    """No card here: ``initialize`` with the default (nccl) backend and
    ``rank_device()`` raise instead of falling back to the CPU; a mesh
    needs the default group."""
    assert not distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA card"):
        distributed.initialize("tcp://localhost:1", world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        distributed.rank_device()
    assert distributed.rank_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        mesh.make_device_mesh()


def test_initialize_forgets_prefix_groups(tmp_path):
    """A subset group belongs to one default group: ``initialize`` drops
    those of an earlier default group, whose id a new one may reuse."""
    stale = object()
    distributed._PREFIX_GROUPS[1] = stale
    distributed.initialize("file://" + str(tmp_path / "store"),
                           world_size=1, rank=0, device="cpu")
    try:
        assert stale not in distributed._PREFIX_GROUPS.values()
        m = mesh.make_device_mesh()
        assert (m.group, m.size, m.index) == (None, 1, 0)
    finally:
        torch.distributed.destroy_process_group()


def _modules():
    for sub in ("parallel", "utils"):
        for f in sorted(os.listdir(os.path.join(PORT_DIR, sub))):
            if f.endswith(".py"):
                yield f"{sub}/{f}"


@pytest.mark.parametrize("module", list(_modules()))
def test_no_jax_import(module):
    with open(os.path.join(PORT_DIR, module)) as f:
        src = f.read()
    pat = re.compile(r"^\s*(import|from)\s+(jax|pnraytracing_tpu)\b",
                     re.MULTILINE)
    assert not pat.search(src), module


# ---- data-parallel gradients ------------------------------------------------

@functools.lru_cache(maxsize=1)
def dp_inputs():
    """(port scene, rays, target): tests/test_torch_replay.py's scene with
    its environment, ``DP_RAYS`` of DP's rays, a constant target."""
    _, _, ps, pcam = scenes(True)
    rays = [x[:DP_RAYS].contiguous() for x in port_rays(DP, pcam)]
    return ps, rays, torch.full((DP_RAYS, 3), 0.2)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    ps, rays, target = dp_inputs()
    wd = str(tmp_path_factory.mktemp("dp"))
    _save(wd, "scene", **scene_to_arrays(ps))
    _save(wd, "rays", **dict(zip(("o", "d", "px", "py"),
                                 (x.numpy() for x in rays))))
    _save(wd, "target", target=target.numpy())
    return workers.spawn(workers.dp_job, 2, wd, DP, KEYS, LIVE_KEYS, LR)


def _assert_grads(got: dict, prefix: str, want: dict, rtol, atol_rel=0.0):
    want = params_to_arrays(want)
    assert sorted(k for k in got if k.startswith(prefix)
                  and k != prefix + "loss") == sorted(prefix + k
                                                      for k in want)
    for k, w in want.items():
        g = got[prefix + k]
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_rel * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("replay", [True, False])
def test_dp_gradients_match_single_process(dp_runs, replay):
    """World 2 (one padded row) against the single-process estimator; the
    ranks hold one result."""
    ps, rays, target = dp_inputs()
    keys, fn, tag = ((KEYS, loss_and_grad_replay, "replay") if replay else
                     (LIVE_KEYS, loss_and_grad, "live"))
    loss, grads = fn(extract_params(ps, keys), ps, *rays, 3, target, DP,
                     spp=1, dual=False)
    for got in dp_runs:
        np.testing.assert_allclose(got[f"{tag}.loss"], float(loss),
                                   rtol=1e-5)
        _assert_grads(got, f"{tag}.", grads, rtol=1e-5, atol_rel=1e-7)
    for k in dp_runs[0]:
        np.testing.assert_array_equal(dp_runs[0][k], dp_runs[1][k])


def test_dp_train_step_matches_adam(dp_runs):
    """One replayed ``dp_train_step``: its loss the single-process one,
    and its parameters a ``torch.optim.Adam`` step (optax's constants) on
    the data-parallel gradient, the same on both ranks.  (The step is
    held against the dp gradient, which the test above holds against
    the single-process one: Adam's first step ``lr * g / (|g| + eps)``
    turns the rounding of a near-zero gradient into a step of any size
    up to ``lr``.)"""
    ps, rays, target = dp_inputs()
    params = extract_params(ps, KEYS)
    loss, _ = loss_and_grad_replay(params, ps, *rays, 3, target, DP, spp=1,
                                   dual=False)
    for got in dp_runs:
        grads = params_from_arrays({k[len("replay."):]: v
                                    for k, v in got.items()
                                    if k.startswith("replay.")
                                    and k != "replay.loss"}, device="cpu")
        p, leaves = leaf_copies(params)
        opt = torch.optim.Adam(leaves, lr=LR, betas=(0.9, 0.999), eps=1e-8)
        for x, g in zip(leaves, param_leaves(grads)):
            x.grad = g
        opt.step()
        np.testing.assert_allclose(got["step.loss"], float(loss), rtol=1e-5)
        _assert_grads(got, "step.", p, rtol=0)
        # the step moved the parameters
        assert not np.array_equal(got["step.env_image"],
                                  params["env_image"].numpy())


def test_dp_replay_gradients_match_jax(dp_runs):
    """The world-2 replayed gradient against ``jax.vjp`` of the JAX
    package's replay of the port's records (one sample, plain MSE):
    ``dL/dp = J^T 2 (img - t) / n``."""
    js, jcam, ps, _ = scenes(True)
    _, rays, target = dp_inputs()
    jcfg = jax_config(DP)
    recs = jax_records(trace_paths(ps, *rays, 3, DP))
    jrays = [jnp.asarray(x.numpy()) for x in rays]

    def replay(p):
        return jax_render_rays_replay(jax_apply_params(js, p), *jrays,
                                      jnp.uint32(3), jcfg, recs)

    img, pull = jax.vjp(replay, jax_extract_params(js, KEYS))
    t = jnp.asarray(target.numpy())
    n = t.size
    (jgrads,) = pull(2.0 * (img - t) / n)
    jloss = float(jnp.mean((img - t) ** 2))
    for got in dp_runs:
        np.testing.assert_allclose(got["replay.loss"], jloss, rtol=1e-5)
        _assert_grads(got, "replay.", jgrads, rtol=1e-4, atol_rel=1e-6)
    assert np.abs(dp_runs[0]["replay.positions"]).max() > 0
