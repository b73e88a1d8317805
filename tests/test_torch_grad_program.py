"""The gradient step as one captured program (``diff/program.py``) on
the CPU, where a step always runs op by op:

* the step's body (``diff/grad.py::step_body``) with the frame counter
  as a 0-d int64 tensor, the program's input, gives the int-frame
  step's loss and gradients bit for bit, for the replay, the live and
  the bench's loss, at spp (or frames a step) 1 and 2;
* the replay body's gradients against ``jax.vjp`` of the JAX package's
  replay, with the tolerance and the left-out pixels of
  ``tests/test_torch_grad.py::test_replay_gradients_match_jax`` (rtol
  1e-4, atol 1e-6 x max|g|; :func:`off_plane_light_pixels`), at depth 2;
* ``StepProgram`` refuses the CPU, an off-device scene, an unknown kind
  and a static argument of another kind;
* the program cache keys on the kind, its static arguments, the scene's
  tensors, ``cfg``, the params' shapes, the ray count and the device, and
  keeps ``STEP_CACHE_SIZE``; ``render/program.py::clear_programs``
  empties it;
* the entry points return copies: a later call overwrites none of an
  earlier call's tensors, though a program's own buffers are
  overwritten by each replay;
* ``load_scene`` copies a refit scene of the same layout in place and
  refuses another layout;
* ``adam_optimize`` on the CPU makes no program, and ``eager=True`` gives
  the same losses and parameters bit for bit (its optax comparison is
  ``tests/test_torch_grad.py::test_adam_optimize_matches_optax``).

The capture and the replays need the card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.diff.grad import apply_params as jax_apply_params
from pnraytracing_tpu.diff.grad import extract_params as jax_extract_params
from pnraytracing_tpu.render.integrator import (
    render_rays_replay as jax_render_rays_replay,
)
from pnraytracing_tpu_torch.convert import params_to_arrays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import _map, tensors
from pnraytracing_tpu_torch.diff import grad as dg
from pnraytracing_tpu_torch.diff import program as sp
from pnraytracing_tpu_torch.render import program
from pnraytracing_tpu_torch.render.integrator import trace_paths
from tests.test_torch_grad import (
    GRAD,
    KEYS,
    _jax_dual_loss_and_grad,
    off_plane_light_pixels,
    opt_scene,
)
from tests.test_torch_replay import (
    jax_config,
    jax_rays,
    jax_records,
    port_rays,
    scenes,
)
from tests.test_torch_scene import _torch_threads  # noqa: F401

CFG = dataclasses.replace(GRAD, max_depth=2, loop="unroll")


def _setup(keys=KEYS, cfg=CFG):
    _, _, ps, pcam = scenes(True)
    rays = port_rays(cfg, pcam)
    target = torch.full((cfg.num_pixels, 3), 0.2)
    return ps, rays, dg.extract_params(ps, keys), target


def _static(kind, n):
    return dict(k=n, replay=True) if kind == "frames" else dict(spp=n,
                                                                dual=True)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("kind", ["replay", "live", "frames"])
def test_body_with_frame_tensor_equals_int_frame(kind, n):
    ps, rays, params, target = _setup()
    static = _static(kind, n)
    want_loss, want = dg.step_loss_and_grad(kind, params, ps, *rays, 3,
                                            target, CFG, **static)
    p, leaves = dg.leaf_copies(params)
    frame = torch.tensor(3, dtype=torch.int64)
    loss, grads = dg.step_body(kind, p, leaves, ps, *rays, frame, target,
                               CFG, **static)
    assert torch.equal(loss, want_loss)
    want = dg.param_leaves(want)
    assert len(grads) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert float(torch.cat([g.reshape(-1) for g in grads]).abs().max()) > 0


def test_replay_body_matches_jax():
    """The replay body (dual loss, spp 2, a tensor frame) against the JAX
    replay's vjp at depth 2, the pixels of off_plane_light_pixels left
    out of both losses."""
    cfg = dataclasses.replace(GRAD, max_depth=2)
    js, jcam, ps, pcam = scenes(True)
    all_rays = port_rays(cfg, pcam)
    recs = [trace_paths(ps, *all_rays, 3 + j, cfg) for j in range(2)]
    left_out = off_plane_light_pixels(ps, recs, cfg.max_depth)
    assert len(left_out) <= 0.02 * cfg.num_pixels
    keep = np.setdiff1d(np.arange(cfg.num_pixels), left_out)
    jcfg = jax_config(cfg)
    jrays = tuple(x[keep] for x in jax_rays(jcfg, jcam))

    @jax.jit
    def vjp(params, frame, records, cot):
        img, pull = jax.vjp(lambda p: jax_render_rays_replay(
            jax_apply_params(js, p), *jrays, frame, jcfg, records), params)
        return img, pull(cot)[0]

    rays = tuple(x[torch.from_numpy(keep)] for x in all_rays)
    target = torch.full((len(keep), 3), 0.2)
    p, leaves = dg.leaf_copies(dg.extract_params(ps, KEYS))
    loss, grads = dg.step_body("replay", p, leaves, ps, *rays,
                               torch.tensor(3, dtype=torch.int64), target,
                               cfg, spp=2, dual=True)
    jrecs = [jax_records(trace_paths(ps, *rays, 3 + j, cfg))
             for j in range(2)]
    jloss, jgrads = _jax_dual_loss_and_grad(
        vjp, jax_extract_params(js, KEYS), jrecs, 3,
        jnp.full((len(keep), 3), 0.2, jnp.float32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = params_to_arrays(dg.params_like(p, grads))
    want = params_to_arrays(jgrads)
    assert sorted(got) == sorted(want)
    for k in got:
        g, w = got[k], want[k]
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    for k in ("materials.base_color", "env_image", "positions"):
        assert np.abs(got[k]).max() > 0, k


def test_step_program_refuses_the_cpu():
    ps, _, params, _ = _setup()
    with pytest.raises(ValueError, match="CUDA device"):
        sp.StepProgram("replay", ps, CFG, params, CFG.num_pixels,
                       device="cpu", spp=1, dual=True)


def test_step_program_refuses_an_off_device_scene():
    """A captured step reads the scene where it lies: a scene that is not
    on the program's device is refused, not copied."""
    ps, _, params, _ = _setup()
    with pytest.raises(ValueError, match="not on cuda:0"):
        sp.StepProgram("replay", ps, CFG, params, CFG.num_pixels,
                       device=torch.device("cuda", 0), spp=1, dual=True)


@pytest.mark.parametrize("kind,static,match", [
    ("backward", {}, "unknown step kind"),
    ("replay", dict(k=2), "static arguments"),
    ("frames", dict(spp=2), "static arguments")])
def test_step_program_refuses_unknown_kinds(kind, static, match):
    ps, _, params, _ = _setup()
    with pytest.raises(ValueError, match=match):
        sp.StepProgram(kind, ps, CFG, params, CFG.num_pixels,
                       device=torch.device("cuda", 0), **static)


class _FakeStep:
    def __init__(self, *args, **static):
        self.args, self.static = args, static


def test_step_cache_keys_and_bound(monkeypatch):
    """The cache keys a program by its kind and static arguments, the
    scene's tensors (not the scene object), the cfg, the params' keys and
    shapes, the ray count and the device; it keeps the STEP_CACHE_SIZE
    most recently used and is emptied by clear_programs."""
    monkeypatch.setattr(sp, "StepProgram", _FakeStep)
    program.clear_programs()
    ps, _, params, _ = _setup()
    dev = torch.device("cuda", 0)
    n = CFG.num_pixels
    get = lambda kind="replay", scene=ps, cfg=CFG, p=params, rays=n, \
        device=dev, **static: sp.step_program(
            kind, scene, cfg, p, rays, device,
            **(static or dict(spp=2, dual=True)))
    a = get()
    assert get(scene=dataclasses.replace(ps)) is a
    assert get() is a
    others = [
        get(kind="live"), get(spp=1, dual=True), get(spp=2, dual=False),
        get(device=torch.device("cuda", 1)), get(rays=n // 2),
        get(cfg=dataclasses.replace(CFG, max_depth=3)),
        get(p={k: params[k] for k in ("materials", "env_image")}),
        get(p=dict(params, env_image=params["env_image"][:4])),
        get(scene=dataclasses.replace(ps, materials=dataclasses.replace(
            ps.materials, base_color=ps.materials.base_color.clone()))),
        get(kind="frames", k=2, replay=True)]
    assert all(x is not a for x in others)
    assert len(sp._programs) == sp.STEP_CACHE_SIZE == 2
    assert get() is not a  # evicted
    frame_key = object()
    program._programs[frame_key] = object()
    program.clear_programs()
    assert not sp._programs and not program._programs


class _OverwritingStep:
    """A program whose replay returns its own buffers, overwritten by the
    next replay (as a captured step's outputs are)."""

    def __init__(self, params):
        self.loss = torch.zeros(())
        self.grads = [torch.zeros_like(x) for x in dg.param_leaves(params)]
        self.params = params

    def replay(self, params, o, d, px, py, frame, target):
        self.loss.fill_(float(frame))
        for g in self.grads:
            g.fill_(float(frame))
        return self.loss, dg.params_like(self.params, self.grads)


def test_entry_points_return_copies(monkeypatch):
    """On the card the entry points replay a program whose outputs the
    next replay overwrites; what they return is a copy that no later call
    changes (chip_smoke's reproducibility gate compares two calls)."""
    ps, rays, params, target = _setup(("materials", "env_image"))
    fake = _OverwritingStep(params)
    monkeypatch.setattr(dg, "_on_card", lambda t: True)
    monkeypatch.setattr(sp, "step_program", lambda *a, **k: fake)
    calls = [lambda f: dg.loss_and_grad_replay(params, ps, *rays, f, target,
                                               CFG, spp=2),
             lambda f: dg.loss_and_grad(params, ps, *rays, f, target, CFG)]
    for call in calls:
        first = call(5)
        second = call(7)
        assert float(first[0]) == 5.0 and float(second[0]) == 7.0
        assert all(bool((g == 5.0).all()) for g in
                   dg.param_leaves(first[1]))
        assert all(bool((g == 7.0).all()) for g in
                   dg.param_leaves(second[1]))
        assert float(fake.loss) == 7.0
    # eager=True never reaches the program, whatever the device
    loss, _ = dg.loss_and_grad_replay(params, ps, *rays, 3, target, CFG,
                                      eager=True)
    assert float(fake.loss) == 7.0 and float(loss) > 0


def test_cpu_calls_return_independent_tensors():
    """On the CPU two calls of one step give equal, separate tensors."""
    ps, rays, params, target = _setup(("materials", "env_image"))
    a = dg.loss_and_grad_replay(params, ps, *rays, 3, target, CFG, spp=2)
    b = dg.loss_and_grad_replay(params, ps, *rays, 3, target, CFG, spp=2)
    assert torch.equal(a[0], b[0])
    for x, y in zip(dg.param_leaves(a[1]), dg.param_leaves(b[1])):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


def test_load_scene_copies_a_refit_in_place():
    """``load_scene`` (a positions run's refit) copies a scene of one
    layout into the program's scene tensors in place and refuses a scene
    of another layout, changing nothing."""
    ps = dg.refit_scene(_setup()[0])  # this builder's tree
    prog = object.__new__(sp.StepProgram)
    prog.scene = _map(ps, torch.clone)
    held = list(tensors(prog.scene))
    moved = dg.apply_params(ps, {"positions": ps.mesh.positions * 1.01})
    refit = dg.refit_scene(moved)
    assert sp._layout(refit) == sp._layout(ps)
    assert not torch.equal(refit.bvh.node_min, ps.bvh.node_min)
    assert prog.load_scene(refit)
    now = list(tensors(prog.scene))
    assert all(a is b for a, b in zip(now, held))  # the same storage
    assert all(torch.equal(a, b) for a, b in
               zip(now, tensors(refit)))
    other = dataclasses.replace(refit, bvh_depth=refit.bvh_depth + 1)
    before = [t.clone() for t in now]
    assert not prog.load_scene(other)
    shorter = dataclasses.replace(refit, mesh=dataclasses.replace(
        refit.mesh, area=refit.mesh.area[:-1]))
    assert not prog.load_scene(shorter)
    assert all(torch.equal(a, b) for a, b in
               zip(tensors(prog.scene), before))


@pytest.mark.parametrize("keys", [("materials",), ("materials", "env_image")])
def test_adam_optimize_on_the_cpu_makes_no_program(keys):
    """The CPU runs every step op by op: no capture, and ``eager=True``
    gives the same losses and parameters bit for bit."""
    scene, cam, target = opt_scene()
    if "env_image" in keys:
        from pnraytracing_tpu_torch.ops.envmap import build_envmap

        env = build_envmap(np.full((4, 8, 3), 0.7, np.float32),
                           device="cpu")
        scene = dataclasses.replace(scene, env=env)
    before = sp.CAPTURES["steps"]
    runs = [dg.adam_optimize(scene, cam, CFG_OPT, target, keys=keys,
                             steps=2, lr=0.05, spp_per_step=2, device="cpu",
                             eager=eager) for eager in (False, True)]
    assert sp.CAPTURES["steps"] == before
    (s0, l0), (s1, l1) = runs
    assert l0 == l1 and np.isfinite(l0).all()
    p0 = dg.param_leaves(dg.extract_params(s0, keys))
    p1 = dg.param_leaves(dg.extract_params(s1, keys))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


CFG_OPT = RenderConfig(width=16, height=16, max_depth=2, sampler="hash",
                       clamp_radiance=True)
