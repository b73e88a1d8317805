"""Gradients of the port (``diff/grad.py`` on ``torch.autograd``) on the
CPU, against the JAX package and against finite differences.

* kinks: ``Materials.sanitized()`` and the ``core/math.py`` stand-ins of
  ``jnp.maximum`` / ``jnp.minimum`` / ``jnp.clip`` / ``jnp.abs`` give
  ``jax.grad``'s derivative at 0, 0.5 and 1 (half at a tie, +1 for |x|
  at 0) and ``torch.clamp``'s values bit for bit;
* every walk entry point detaches its inputs: no gradient reaches the
  rays through a walk's answer;
* the port's ``loss_and_grad_replay`` (dual loss, spp 2) against
  ``jax.vjp`` of the same loss over the JAX package's
  ``render_rays_replay`` on the port's records, for materials
  (the floor at metallic 0 and roughness 1, so the tie factor is
  pinned), env texels and vertex positions: rtol 1e-4, atol 1e-6 x
  max|g|, at depth 1, 2 and 4 (observed: materials and texels within
  3e-7 of max|g| 0.16, positions within 8e-7 of 0.14).  A path shading a
  point on the area light samples that same light, so the cosine of its
  shadow segment on the light is the rounding of a coplanar dot product,
  which the two packages' arithmetic may round to other signs and send
  its lane's vertex gradient apart: the pixels whose recorded hit on an
  emitting triangle, at a vertex that samples the light, lies off that
  triangle's plane by rounding (:func:`off_plane_light_pixels`, from the
  records alone) are left out of both packages' loss (their rays are
  not rendered), at most 2% of the pixels (observed: none at depth 1,
  2 of 144 at depths 2 and 4);
* live against replay gradients in the port: the JAX package's
  rtol 1e-5, atol 1e-7 (tests/test_replay.py);
* finite differences as tests/test_grad.py: emissive rtol 0.05, an env
  texel 0.1, vertex positions with ``refit_scene`` 0.08;
* ``refit_scene``: the tree, the packed rows, the remapped triangle
  arrays and the lights bit for bit the JAX refit's; the attribute and
  key tables kept; a captured frame's key changes;
* ``adam_optimize``: three steps against the same loop with
  ``optax.adam`` on the port's gradients (losses and params rtol 1e-4),
  and ``grad_mask``;
* optimizer checkpoints: a round trip, a JAX-written npz resumed in the
  port, and the port's npz unflattened into the JAX package's tree.
"""

import dataclasses
import functools
import json
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pnraytracing_tpu.core.types import Materials as JaxMaterials
from pnraytracing_tpu.diff.grad import apply_params as jax_apply_params
from pnraytracing_tpu.diff.grad import extract_params as jax_extract_params
from pnraytracing_tpu.diff.grad import refit_scene as jax_refit_scene
from pnraytracing_tpu.render.integrator import (
    render_rays_replay as jax_render_rays_replay,
)
from pnraytracing_tpu.render.session import (
    save_optimizer_checkpoint as jax_save_optimizer_checkpoint,
)
from pnraytracing_tpu.scene import shapes as jax_shapes
from pnraytracing_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel import traverse_stream_cuda as trs
from pnraytracing_tpu_torch.accel.bricks import build_stream_data
from pnraytracing_tpu_torch.convert import params_from_arrays, params_to_arrays
from pnraytracing_tpu_torch.core import math as pmath
from pnraytracing_tpu_torch.core.camera import make_camera
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Materials
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.diff.grad import (
    adam_optimize,
    apply_params,
    extract_params,
    loss_and_grad,
    loss_and_grad_replay,
    param_leaves,
    params_like,
    refit_scene,
    render_image_from_params,
)
from pnraytracing_tpu_torch.io.hdr import procedural_sky
from pnraytracing_tpu_torch.ops import compaction
from pnraytracing_tpu_torch.ops.envmap import (
    _pack_quads,
    build_envmap,
    envmap_in_graph,
)
from pnraytracing_tpu_torch.render import program
from pnraytracing_tpu_torch.render.integrator import render_rays, trace_paths
from pnraytracing_tpu_torch.render.session import (
    load_optimizer_checkpoint,
    save_optimizer_checkpoint,
)
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.scene.transform import (
    compose,
    rotate,
    translate,
)
from tests.test_torch_replay import (
    jax_config,
    jax_rays,
    jax_records,
    port_rays,
    scenes,
)
from tests.test_torch_scene import _torch_threads, port_scene  # noqa: F401

KEYS = ("materials", "env_image", "positions")
GRAD = RenderConfig(width=12, height=12, max_depth=1, sampler="hash",
                    clamp_radiance=False, loop="scan")


# ---- kinks ------------------------------------------------------------------

def test_sanitized_kink_derivatives():
    """d/dp of a weighted sum of ``sanitized()``'s fields against
    ``jax.grad`` of the JAX package's, with every field at -0.5, 0, 0.5,
    1 and 1.5: both bounds of each clip and the floors of emissive and
    ior."""
    vals = np.array([-0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
    fields = [f.name for f in dataclasses.fields(Materials)]
    rng = np.random.default_rng(0)
    arrays = {n: (np.stack([vals] * 3, axis=1)
                  if n in ("emissive", "base_color") else vals.copy())
              for n in fields}
    weights = {n: rng.uniform(0.5, 2.0, arrays[n].shape).astype(np.float32)
               for n in fields}

    def jax_loss(m):
        s = m.sanitized()
        return sum(jnp.sum(getattr(s, n) * weights[n]) for n in fields)

    want = jax.grad(jax_loss)(JaxMaterials(**{
        n: jnp.asarray(a) for n, a in arrays.items()}))
    leaves = {n: torch.tensor(a, requires_grad=True)
              for n, a in arrays.items()}
    s = Materials(**leaves).sanitized()
    sum(torch.sum(getattr(s, n) * torch.from_numpy(weights[n]))
        for n in fields).backward()
    for n in fields:
        np.testing.assert_array_equal(leaves[n].grad.numpy(),
                                      np.asarray(getattr(want, n)), n)
    # the tie factor is there: metallic at 0 gets half, at 0.5 all
    np.testing.assert_array_equal(leaves["metallic"].grad.numpy()[1:3],
                                  weights["metallic"][1:3] * [0.5, 1.0])
    # and the values are torch.clamp's, with or without a gradient
    plain = Materials(**{n: torch.from_numpy(a)
                         for n, a in arrays.items()}).sanitized()
    for n in fields:
        assert torch.equal(getattr(s, n).detach(), getattr(plain, n)), n


@pytest.mark.parametrize("name", ["maximum", "minimum", "clip", "absolute"])
def test_kink_helpers_match_jax(name):
    x = np.array([-1.0, -0.0, 0.0, 0.25, 0.5, 1.0, 2.0], np.float32)
    jfn, pfn = {
        "maximum": (lambda a: jnp.maximum(a, 0.0),
                    lambda a: pmath.maximum(a, 0.0)),
        "minimum": (lambda a: jnp.minimum(a, 0.5),
                    lambda a: pmath.minimum(a, 0.5)),
        "clip": (lambda a: jnp.clip(a, 0.0, 1.0),
                 lambda a: pmath.clip(a, 0.0, 1.0)),
        "absolute": (jnp.abs, pmath.absolute),
    }[name]
    want = jax.vmap(jax.grad(jfn))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    y = pfn(t)
    y.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    plain = pfn(torch.tensor(x))
    assert not plain.requires_grad
    np.testing.assert_array_equal(y.detach().numpy().view(np.int32),
                                  plain.numpy().view(np.int32))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jfn(x)))


# ---- the walks carry no gradient ------------------------------------------------

def _stream_trav():
    _, _, ps, _ = scenes(True)
    return dataclasses.replace(ps.trav, stream=build_stream_data(
        ps.bvh, ps.mesh, brick_budget_bytes=8 << 10, device="cpu"))


@pytest.mark.parametrize("walk", [
    "closest_hit_attr", "closest_hit", "any_hit", "closest_hit_binary",
    "any_hit_binary", "closest_hit_stream", "any_hit_stream", "entry_key"])
def test_walk_answers_carry_no_gradient(walk):
    """Each entry point cuts its rays from the graph (the JAX package's
    ``_stop_gradient_trace``): its answer has no ``grad_fn``, and a loss
    through it gives the rays a zero gradient."""
    _, _, ps, pcam = scenes(True)
    o, d, _, _ = port_rays(RenderConfig(width=8, height=8), pcam)
    ox = o[:, 0].contiguous().requires_grad_(True)
    dx = d[:, 0].contiguous().requires_grad_(True)
    ov = V3(ox * 1.0, o[:, 1].contiguous(), o[:, 2].contiguous())
    dv = V3(dx * 1.0, d[:, 1].contiguous(), d[:, 2].contiguous())
    tm = torch.full((64,), 1e7, requires_grad=True)
    trav = _stream_trav() if "stream" in walk else ps.trav
    if walk == "entry_key":
        out = [compaction.entry_key(ov, dv, trav.treelets,
                                    trav.treelet_tree)]
    else:
        mod = trs if "stream" in walk else trv
        kw = {}
        if walk.endswith("_binary"):
            walk, kw = walk[:-len("_binary")], dict(variant="binary")
        res = getattr(mod, walk)(trav, ov, dv, tm * 1.0, **kw)
        if walk == "closest_hit_attr":
            res = res[0]
        out = ([res] if isinstance(res, torch.Tensor)
               else [res.t, res.b1, res.b2])
    assert all(a.grad_fn is None and not a.requires_grad for a in out)
    if hasattr(out[0], "dtype") and out[0].dtype == torch.float32:
        assert (out[0] < 1e7).any()  # some ray hits
    loss = sum(a.float().sum() for a in out) + 0.0 * (ox + dx).sum() \
        + 0.0 * tm.sum()
    gs = torch.autograd.grad(loss, [ox, dx, tm])
    assert all(torch.equal(g, torch.zeros_like(g)) for g in gs)


# ---- gradients against the JAX package ----------------------------------------

DEPTHS = (1, 2, 4)


def off_plane_light_pixels(scene, records, depth: int) -> np.ndarray:
    """The pixels with a vertex that samples the light (the primary hit
    or a continuation hit before the last bounce) recorded on an emitting
    triangle whose hit point, interpolated from the recorded
    barycentrics, lies off the triangle's plane by rounding: the shadow
    segment from it to the light's plane has a cosine that is a rounding
    of a coplanar dot product.  From the records and the mesh alone."""
    idx = scene.mesh.indices.long()
    light = scene.lights.tri_index.long()
    out = torch.zeros(records[0].primary.tri.shape, dtype=torch.bool)
    for r in records:
        hits = [(r.primary.tri, r.primary.b1, r.primary.b2)] + [
            (r.bounce.tri[b], r.bounce.b1[b], r.bounce.b2[b])
            for b in range(depth - 1)]
        for tri, b1, b2 in hits:
            p = scene.mesh.positions[idx[torch.clamp_min(tri.long(), 0)]]
            at = (p[:, 0] * (1.0 - b1 - b2)[:, None] + p[:, 1] * b1[:, None]
                  + p[:, 2] * b2[:, None])
            n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            out |= (torch.isin(tri.long(), light)
                    & (((at - p[:, 0]) * n).sum(-1) != 0))
    return torch.nonzero(out).flatten().numpy()


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda d: f"depth{d}")
def jax_replay_vjp(request):
    """``(cfg, kept pixels, vjp)`` at one depth: GRAD's config at that
    depth, the pixels outside :func:`off_plane_light_pixels` of the
    port's records of both samples, and one jitted ``jax.vjp`` of the
    JAX replay of one sample over their rays, compiled once a depth:
    ``(image, cotangent's pullback to the params)``."""
    cfg = dataclasses.replace(GRAD, max_depth=request.param)
    js, jcam, ps, pcam = scenes(True)
    recs = [trace_paths(ps, *port_rays(cfg, pcam), 3 + j, cfg)
            for j in range(2)]
    left_out = off_plane_light_pixels(ps, recs, cfg.max_depth)
    print(f"depth {cfg.max_depth}: {len(left_out)} of {cfg.num_pixels} "
          f"pixels left out: {left_out.tolist()}")
    assert len(left_out) <= 0.02 * cfg.num_pixels
    keep = np.setdiff1d(np.arange(cfg.num_pixels), left_out)
    jcfg = jax_config(cfg)
    rays = tuple(x[keep] for x in jax_rays(jcfg, jcam))

    @jax.jit
    def vjp(params, frame, records, cot):
        img, pull = jax.vjp(lambda p: jax_render_rays_replay(
            jax_apply_params(js, p), *rays, frame, jcfg, records), params)
        return img, pull(cot)[0]

    return cfg, keep, vjp


def _jax_dual_loss_and_grad(vjp, params, records, frame, target):
    """``value_and_grad`` of the dual loss ``mean((A-t)(B-t))`` over two
    replayed samples, by the chain rule: dL/dp = A'^T (B-t)/n +
    B'^T (A-t)/n."""
    zero = jnp.zeros_like(target)
    a, _ = vjp(params, jnp.uint32(frame), records[0], zero)
    b, _ = vjp(params, jnp.uint32(frame + 1), records[1], zero)
    n = target.size
    _, ga = vjp(params, jnp.uint32(frame), records[0], (b - target) / n)
    _, gb = vjp(params, jnp.uint32(frame + 1), records[1], (a - target) / n)
    return (jnp.mean((a - target) * (b - target)),
            jax.tree_util.tree_map(lambda x, y: x + y, ga, gb))


def test_replay_gradients_match_jax(jax_replay_vjp):
    cfg, keep, vjp = jax_replay_vjp
    js, jcam, ps, pcam = scenes(True)
    rays = tuple(x[torch.from_numpy(keep)] for x in port_rays(cfg, pcam))
    target = torch.full((len(keep), 3), 0.2)
    loss, grads = loss_and_grad_replay(extract_params(ps, KEYS), ps, *rays,
                                       3, target, cfg, spp=2)
    recs = [jax_records(trace_paths(ps, *rays, 3 + j, cfg))
            for j in range(2)]
    jloss, jgrads = _jax_dual_loss_and_grad(
        vjp, jax_extract_params(js, KEYS), recs, 3,
        jnp.full((len(keep), 3), 0.2, jnp.float32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = params_to_arrays(grads), params_to_arrays(jgrads)
    assert sorted(got) == sorted(want)
    for k in got:
        g, w = got[k], want[k]
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    # the floor (material 1) sits at metallic 0 and roughness 1
    assert float(ps.materials.metallic[1]) == 0.0
    assert float(ps.materials.roughness[1]) == 1.0
    assert abs(got["materials.metallic"][1]) > 0
    assert abs(got["materials.roughness"][1]) > 0
    for k in ("materials.base_color", "env_image", "positions"):
        assert np.abs(got[k]).max() > 0, k


@pytest.mark.parametrize("spp", [1, 2])
def test_replay_gradients_match_live(spp):
    """The trace/replay step and the live step (walks inside the
    differentiated pass) give one loss and one gradient: the JAX
    package's tests/test_replay.py bounds, at depth 2."""
    cfg = dataclasses.replace(GRAD, max_depth=2, loop="unroll")
    _, _, ps, pcam = scenes(True)
    rays = port_rays(cfg, pcam)
    params = extract_params(ps, ("materials", "env_image"))
    target = torch.full((cfg.num_pixels, 3), 0.2)
    l0, g0 = loss_and_grad(params, ps, *rays, 3, target, cfg, spp=spp)
    l1, g1 = loss_and_grad_replay(params, ps, *rays, 3, target, cfg, spp=spp)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    assert isinstance(g0["materials"], Materials)
    for a, b in zip(param_leaves(g0), param_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert params["env_image"].grad is None  # the scene is left alone


# ---- finite differences (tests/test_grad.py) -----------------------------------

FD = RenderConfig(width=8, height=8, max_depth=1, sampler="hash",
                  clamp_radiance=False)


@functools.lru_cache(maxsize=2)
def tiny_scene(with_env=False):
    b = SceneBuilder()
    b.add(shapes.triangle((-2, -2, 0), (2, -2, 0), (0, 2, 0)),
          dict(base_color=(0.6, 0.4, 0.3), roughness=0.7), name="tri")
    b.add(shapes.quad(half=0.7), dict(emissive=(8.0, 8.0, 8.0)), name="light",
          transform=compose(translate(0, 3, 2), rotate(180, (0, 0, 1))))
    return b.build(env_image=procedural_sky(16, 32) if with_env else None,
                   env_constant=None if with_env else (0.3, 0.3, 0.35),
                   device="cpu")


def fd_setup(cam_args=((0, 0, 4), (0, 0, 0), (0, 1, 0), 50.0, 1.0)):
    cam = make_camera(*cam_args, device="cpu")
    return port_rays(FD, cam), torch.zeros((FD.num_pixels, 3))


def loss_value(params, scene, rays, target):
    img = render_image_from_params(params, scene, *rays, 0, FD)
    return float(torch.mean((img - target) ** 2))


def test_emissive_gradient_finite_difference():
    scene = tiny_scene()
    rays, target = fd_setup()
    params = extract_params(scene, ("materials",))
    _, grads = loss_and_grad(params, scene, *rays, 0, target, FD)
    g = grads["materials"].emissive.numpy()
    assert np.isfinite(g).all() and np.abs(g[1]).max() > 0
    eps = 1e-2

    def moved(delta):
        em = params["materials"].emissive.clone()
        em[1, 0] += delta
        return {"materials": dataclasses.replace(params["materials"],
                                                 emissive=em)}

    fd = (loss_value(moved(eps), scene, rays, target)
          - loss_value(moved(-eps), scene, rays, target)) / (2 * eps)
    np.testing.assert_allclose(g[1, 0], fd, rtol=0.05, atol=1e-6)


def test_env_texel_gradient_finite_difference():
    scene = tiny_scene(with_env=True)
    rays, target = fd_setup()
    params = extract_params(scene, ("env_image",))
    _, grads = loss_and_grad(params, scene, *rays, 0, target, FD)
    g = grads["env_image"].numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 1e-2

    def moved(delta):
        img = params["env_image"].clone()
        img[idx] += delta
        return {"env_image": img}

    fd = (loss_value(moved(eps), scene, rays, target)
          - loss_value(moved(-eps), scene, rays, target)) / (2 * eps)
    np.testing.assert_allclose(g[idx], fd, rtol=0.1, atol=1e-6)


def test_vertex_position_gradient_finite_difference():
    """Every pixel ray hits the triangle ~1 unit from its edges, so a
    +-eps vertex move flips no hit; each side of the quotient is
    rendered on a refit scene (tests/test_grad.py)."""
    scene = tiny_scene()
    rays, target = fd_setup(((0, -0.6, 4), (0, -0.6, 0), (0, 1, 0), 12.0,
                             1.0))
    params = extract_params(scene, ("positions",))
    _, grads = loss_and_grad(params, scene, *rays, 0, target, FD)
    g = grads["positions"].numpy()

    def loss_refit(pos):
        s = refit_scene(apply_params(scene, {"positions": pos}))
        img = render_rays(s, *rays, 0, FD)
        return float(torch.mean((img - target) ** 2))

    eps = 2e-3
    checked = 0
    for v, ch in ((0, 2), (1, 2), (2, 0)):
        up, down = scene.mesh.positions.clone(), scene.mesh.positions.clone()
        up[v, ch] += eps
        down[v, ch] -= eps
        fd = (loss_refit(up) - loss_refit(down)) / (2 * eps)
        if abs(fd) < 1e-7 and abs(g[v, ch]) < 1e-7:
            continue
        np.testing.assert_allclose(g[v, ch], fd, rtol=0.08, atol=1e-6)
        checked += 1
    assert checked >= 2, "FD signal too weak to validate anything"


def test_unconstrained_params_cannot_nan_forward():
    """Out-of-domain materials (anisotropic 5, where sqrt(1 - 0.9a) is
    NaN; metallic -2; roughness 7) are sanitized at fetch: the frame and
    its gradients stay finite, also where a lane sees no radiance."""
    b = SceneBuilder()
    b.add(shapes.icosphere(2), dict(base_color=(0.5, 0.5, 0.5),
                                    roughness=0.6),
          name="ball", transform=translate(0, 1.0, 0))
    b.add(shapes.quad(6.0), dict(base_color=(0.6, 0.6, 0.6), roughness=0.9),
          name="floor")
    scene = b.build(env_constant=(0.0, 0.0, 0.0), device="cpu")
    m = scene.materials
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        m, anisotropic=torch.full_like(m.anisotropic, 5.0),
        metallic=torch.full_like(m.metallic, -2.0),
        roughness=torch.full_like(m.roughness, 7.0)))
    cfg = RenderConfig(width=16, height=16, max_depth=2, sampler="hash")
    cam = make_camera((3.2, 2.6, 3.2), (0, 0.9, 0), (0, 1, 0), 45.0, 1.0,
                      device="cpu")
    rays = port_rays(cfg, cam)
    img = render_rays(scene, *rays, 0, cfg)
    assert torch.isfinite(img).all()
    assert (img == 0).all(dim=-1).any()  # escaped lanes see black
    _, grads = loss_and_grad_replay(extract_params(scene, ("materials",)),
                                    scene, *rays, 0,
                                    torch.full((256, 3), 0.3), cfg, spp=2)
    assert all(torch.isfinite(g).all() for g in param_leaves(grads))


# ---- refit ------------------------------------------------------------------

def test_refit_matches_jax():
    b = JaxSceneBuilder()
    b.add(jax_shapes.triangle((-2, -2, 0), (2, -2, 0), (0, 2, 0)),
          dict(base_color=(0.6, 0.4, 0.3), roughness=0.7), name="tri")
    b.add(jax_shapes.icosphere(1, radius=0.5), dict(roughness=0.3),
          name="ball", transform=translate(0.5, 0.0, 0.8))
    b.add(jax_shapes.quad(half=0.7), dict(emissive=(8.0, 8.0, 8.0)),
          name="light",
          transform=compose(translate(0, 3, 2), rotate(180, (0, 0, 1))))
    js = b.build(env_constant=(0.3, 0.3, 0.35), use_native_builder=False)
    rng = np.random.default_rng(1)
    pos = np.asarray(js.mesh.positions) + rng.normal(
        0, 0.3, js.mesh.positions.shape).astype(np.float32)
    moved = js.replace(mesh=js.mesh.replace(positions=jnp.asarray(pos)))
    ps = port_scene(moved)
    with mock.patch("pnraytracing_tpu.accel.native.native_available",
                    return_value=False):
        want = jax_refit_scene(moved)
    got = refit_scene(ps)
    eq = lambda a, b_, n: np.testing.assert_array_equal(
        a.numpy(), np.asarray(b_), err_msg=n)
    for n in ("node_min", "node_max", "axis", "right_child", "start", "end"):
        eq(getattr(got.bvh, n), getattr(want.bvh, n), n)
    for n in ("indices", "material_id", "texture_id", "area", "positions"):
        eq(getattr(got.mesh, n), getattr(want.mesh, n), n)
    for n in ("tri_index", "prefix_area", "total_area"):
        eq(getattr(got.lights, n), getattr(want.lights, n), n)
    eq(got.trav.nodes8, want.trav.nodes8, "nodes8")
    eq(got.trav.tri9, want.trav.tri9, "tri9")
    assert not np.array_equal(got.mesh.indices.numpy(),
                              ps.mesh.indices.numpy())
    # the port keeps the attribute rows and the key tables, as a built
    # scene of these positions has them, and the new tree's depth
    assert got.trav.tri_attr16.shape == ps.trav.tri_attr16.shape
    assert got.trav.treelets is not None
    assert got.trav.treelet_tree is not None
    assert got.bvh_depth == got.trav.bvh_depth
    # a captured frame is keyed by the scene's tensors: the refit scene
    # is another program
    assert program._leaves(got) != program._leaves(ps)


def test_refit_scene_renders_as_a_fresh_build():
    """Moving every vertex by a constant and refitting gives the frame
    of a scene built at the moved positions."""
    scene = tiny_scene()
    shift = torch.tensor([0.25, -0.1, 0.05])
    s = refit_scene(apply_params(scene, {
        "positions": scene.mesh.positions + shift}))
    b = SceneBuilder()
    b.add(shapes.triangle((-2, -2, 0), (2, -2, 0), (0, 2, 0)),
          dict(base_color=(0.6, 0.4, 0.3), roughness=0.7), name="tri",
          transform=translate(0.25, -0.1, 0.05))
    b.add(shapes.quad(half=0.7), dict(emissive=(8.0, 8.0, 8.0)), name="light",
          transform=compose(translate(0.25, -0.1, 0.05), translate(0, 3, 2),
                            rotate(180, (0, 0, 1))))
    fresh = b.build(env_constant=(0.3, 0.3, 0.35), device="cpu")
    rays, _ = fd_setup()
    got = render_rays(s, *rays, 0, FD)
    want = render_rays(fresh, *rays, 0, FD)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


# ---- the optimizer ------------------------------------------------------------

OPT = RenderConfig(width=16, height=16, max_depth=2, sampler="hash",
                   clamp_radiance=True)


@functools.lru_cache(maxsize=1)
def opt_scene():
    b = SceneBuilder()
    b.add(shapes.icosphere(2), dict(base_color=(0.75, 0.3, 0.2),
                                    roughness=0.6),
          name="ball", transform=translate(0, 1.0, 0))
    b.add(shapes.quad(6.0), dict(base_color=(0.6, 0.6, 0.6), roughness=0.9),
          name="floor")
    scene = b.build(env_constant=(0.85, 0.85, 0.85), device="cpu")
    cam = make_camera((3.2, 2.6, 3.2), (0, 0.9, 0), (0, 1, 0), 45.0, 1.0,
                      device="cpu")
    target = torch.full((16, 16, 3), 0.4)
    return scene, cam, target


def test_adam_optimize_matches_optax():
    """Three steps of ``adam_optimize`` against the same loop written with
    ``optax.adam`` on the port's own gradients and the JAX package's
    projection (``Materials.sanitized()``)."""
    scene, cam, target = opt_scene()
    lr, spp = 0.06, 2
    logs = []
    out, losses = adam_optimize(scene, cam, OPT, target, steps=3, lr=lr,
                                spp_per_step=spp, log_every=1,
                                log_fn=logs.append, device="cpu")
    rays = port_rays(OPT, cam)
    flat = {k: jnp.asarray(v) for k, v in params_to_arrays(
        extract_params(scene, ("materials",))).items()}
    opt = optax.adam(lr)
    state = opt.init(flat)
    want_losses = []
    for step in range(3):
        params = params_from_arrays({k: np.asarray(v)
                                     for k, v in flat.items()}, "cpu")
        loss, grads = loss_and_grad_replay(params, scene, *rays, step * spp,
                                           target.reshape(-1, 3), OPT,
                                           spp=spp)
        want_losses.append(float(loss))
        g = {k: jnp.asarray(v) for k, v in params_to_arrays(grads).items()}
        upd, state = opt.update(g, state, flat)
        flat = optax.apply_updates(flat, upd)
        m = JaxMaterials(**{k[len("materials."):]: v
                            for k, v in flat.items()}).sanitized()
        flat = {f"materials.{k}": getattr(m, k) for k in (
            f.name for f in dataclasses.fields(Materials))}
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    got = params_to_arrays({"materials": out.materials})
    for k, v in flat.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert not np.allclose(got["materials.base_color"],
                           scene.materials.base_color.numpy())
    assert len(logs) == 3
    line = json.loads(logs[-1])
    assert sorted(line) == ["grad_norm", "grad_norms", "loss", "rays_per_s",
                            "step", "step_s"]
    assert sorted(line["grad_norms"]) == ["materials"]
    assert line["step"] == 2 and line["loss"] == losses[-1]


def test_adam_grad_mask_freezes_coordinates():
    scene, cam, target = opt_scene()
    zeros = {f.name: torch.zeros_like(getattr(scene.materials, f.name))
             for f in dataclasses.fields(Materials)}
    zeros["base_color"] = torch.zeros(2, 3)
    zeros["base_color"][0] = 1.0
    out, losses = adam_optimize(scene, cam, OPT, target, steps=2, lr=0.05,
                                spp_per_step=2,
                                grad_mask={"materials": Materials(**zeros)},
                                device="cpu")
    assert np.isfinite(losses).all()
    before, after = scene.materials, out.materials
    assert not torch.equal(after.base_color[0], before.base_color[0])
    assert torch.equal(after.base_color[1], before.base_color[1])
    for f in dataclasses.fields(Materials):
        if f.name != "base_color":
            assert torch.equal(getattr(after, f.name),
                               getattr(before, f.name)), f.name


# ---- optimizer checkpoints -------------------------------------------------------

def _port_state(seed=0, steps=2):
    """(params, torch Adam, its leaves) after ``steps`` updates with
    random gradients; ``steps=0`` gives a fresh optimizer."""
    scene, _, _ = opt_scene()
    params = extract_params(scene, ("materials",))
    params["env_image"] = torch.ones(4, 8, 3)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in param_leaves(params)]
    params = params_like(params, leaves)
    opt = torch.optim.Adam(leaves, lr=0.05)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for x in leaves:
            x.grad = torch.from_numpy(rng.normal(
                size=tuple(x.shape)).astype(np.float32))
        opt.step()
    return params, opt, leaves


def test_optimizer_checkpoint_roundtrip(tmp_path):
    params, opt, leaves = _port_state()
    path = str(tmp_path / "opt")
    save_optimizer_checkpoint(path, params, opt, 7)
    p2, o2, l2 = _port_state(seed=1, steps=0)
    _, _, step = load_optimizer_checkpoint(path, (p2, o2, 0))
    assert step == 7
    for a, b in zip(leaves, l2):
        assert torch.equal(a.detach(), b.detach())
        sa, sb = opt.state[a], o2.state[b]
        assert float(sa["step"]) == float(sb["step"]) == 2.0
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    # both resume with one more identical step
    for a, b in zip(leaves, l2):
        a.grad = torch.ones_like(a)
        b.grad = torch.ones_like(b)
    opt.step()
    o2.step()
    for a, b in zip(leaves, l2):
        assert torch.equal(a.detach(), b.detach())


def _jax_state(seed=2):
    """A JAX params tree (materials, env_image) and its optax.adam state
    after two updates with random gradients."""
    scene, _, _ = opt_scene()
    arrays = params_to_arrays(extract_params(scene, ("materials",)))
    params = {"materials": JaxMaterials(**{
        k[len("materials."):]: jnp.asarray(v) for k, v in arrays.items()}),
        "env_image": jnp.ones((4, 8, 3), jnp.float32)}
    opt = optax.adam(0.05)
    state = opt.init(params)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.normal(
            size=x.shape).astype(np.float32)), params)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, opt, state


def test_jax_optimizer_checkpoint_resumes_in_port(tmp_path):
    """The JAX package's npz fallback (written with orbax hidden from
    it) loads into the port; one more step with the same gradient gives
    the same params in both."""
    jparams, jopt, jstate = _jax_state()
    path = str(tmp_path / "jax_opt")
    with mock.patch.dict(sys.modules, {"orbax": None,
                                       "orbax.checkpoint": None}):
        jax_save_optimizer_checkpoint(path, jparams, jstate, 11)
    params, opt, leaves = _port_state(steps=0)
    _, _, step = load_optimizer_checkpoint(path, (params, opt, 0))
    assert step == 11
    jleaves = jax.tree_util.tree_leaves(jparams)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    adam_state = jstate[0]
    for a, mu, nu in zip(leaves, jax.tree_util.tree_leaves(adam_state.mu),
                         jax.tree_util.tree_leaves(adam_state.nu)):
        np.testing.assert_array_equal(opt.state[a]["exp_avg"].numpy(),
                                      np.asarray(mu))
        np.testing.assert_array_equal(opt.state[a]["exp_avg_sq"].numpy(),
                                      np.asarray(nu))
        assert float(opt.state[a]["step"]) == int(adam_state.count)
    g = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.5), jparams)
    upd, _ = jopt.update(g, jstate, jparams)
    jnext = jax.tree_util.tree_leaves(optax.apply_updates(jparams, upd))
    for a in leaves:
        a.grad = torch.full_like(a, 0.5)
    opt.step()
    # optax takes Adam's bias correction 1 - 0.999^t in float32 (at t = 3
    # its cancellation leaves ~3e-5 relative), torch in float64: the
    # updates (~lr = 0.05) agree to ~4e-6 relative (observed 1.8e-7)
    for a, b in zip(leaves, jnext):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)


def test_port_optimizer_checkpoint_unflattens_in_jax(tmp_path):
    """The port's npz holds the leaves of the JAX package's
    ``(params, optax.adam state, step)`` in its flatten order."""
    params, opt, leaves = _port_state()
    path = str(tmp_path / "port_opt")
    save_optimizer_checkpoint(path, params, opt, 5)
    data = np.load(path + ".npz")
    jparams, _, jstate = _jax_state()
    treedef = jax.tree_util.tree_structure((jparams, jstate, 5))
    assert treedef.num_leaves == len(data.files)
    p, st, step = jax.tree_util.tree_unflatten(
        treedef, [data[f"leaf_{i}"] for i in range(len(data.files))])
    assert int(step) == 5 and int(st[0].count) == 2
    assert st[0].count.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(p["env_image"]),
                                  params["env_image"].detach().numpy())
    np.testing.assert_array_equal(
        np.asarray(st[0].mu["materials"].base_color),
        opt.state[params["materials"].base_color]["exp_avg"].numpy())


# ---- the environment tables in the graph ------------------------------------------

def test_envmap_in_graph_matches_host_tables():
    sky = procedural_sky(16, 32)
    host = build_envmap(sky, device="cpu")
    img = torch.from_numpy(sky).requires_grad_(True)
    graph = build_envmap(img)
    assert graph.pdf_xy.requires_grad and graph.alias_x is None
    np.testing.assert_array_equal(_pack_quads(img).detach().numpy(),
                                  _pack_quads(sky))
    for n in ("pdf_xy", "cdf_marginal_x", "cdf_y_given_x"):
        np.testing.assert_allclose(getattr(graph, n).detach().numpy(),
                                   getattr(host, n).numpy(), rtol=2e-6,
                                   atol=1e-7, err_msg=n)
    assert envmap_in_graph(img.detach()).quad12.shape == (16, 32, 12)
    with pytest.raises(ValueError, match="alias"):
        build_envmap(img, alias=True)
    # a template without alias tables gets them rebuilt in the graph
    scene = tiny_scene(with_env=True)
    no_alias = dataclasses.replace(scene, env=host)
    grafted = apply_params(no_alias, {"env_image": img * 1.0})
    assert grafted.env.cdf_y_given_x.requires_grad
    kept = apply_params(scene, {"env_image": img * 1.0})
    assert kept.env.alias_x is scene.env.alias_x
    assert kept.env.alias_fat is None and kept.env.quad12.requires_grad
