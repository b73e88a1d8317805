"""Differentiable rendering: parameter plumbing, losses, optimization steps.

PyTorch counterpart of ``pnraytracing_tpu/diff/grad.py``: pixel gradients
reach **material parameters**, **environment texels** and **vertex
positions** through the trace/replay split of the integrator (the walks
detached, the shading re-derived differentiably: ``render_rays_replay``,
``make_interaction``), by ``torch.autograd``.

The optimization targets live in a plain dict (``params``) that is
grafted onto a scene template per evaluation (:func:`apply_params`):

* ``"materials"``  -> a whole ``Materials``;
* ``"env_image"``  -> the [H, W, 3] environment radiance;
* ``"positions"``  -> the [V, 3] vertex positions.  The BVH is built for
  the template's geometry: gradients are exact for infinitesimal motion,
  and after a step that moves geometry :func:`refit_scene` rebuilds the
  walk's tables.

Each step's loss is a function of the params (:data:`LOSSES`:
:func:`replay_loss`, :func:`live_loss` and the bench's
:func:`frames_loss`), and :func:`step_body` differentiates it.  On the
card the entry points replay that body captured as one CUDA graph
(``diff/program.py``, the counterpart of the JAX package's ``jax.jit``);
``eager=True``, and the CPU, run it op by op.

A params dict flattens to its leaves in the JAX package's order
(:func:`param_leaves`: keys sorted, a ``Materials`` by field), which is
also the order of the optimizer checkpoints (``render/session.py``) and
of ``convert.py::params_to_arrays``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable

import numpy as np
import torch

from pnraytracing_tpu_torch.accel.native import bvh_builder
from pnraytracing_tpu_torch.core.camera import camera_rays, resolve_device
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import BVH, Camera, Materials, Scene
from pnraytracing_tpu_torch.ops.envmap import _pack_quads, envmap_in_graph
from pnraytracing_tpu_torch.render.integrator import (
    render_rays,
    render_rays_replay,
    trace_paths,
)
from pnraytracing_tpu_torch.render.renderer import pixel_coords
from pnraytracing_tpu_torch.scene.build import pack_traversal

PARAM_KEYS = ("materials", "env_image", "positions")
_MAT_FIELDS = tuple(f.name for f in dataclasses.fields(Materials))


def extract_params(scene: Scene, keys: Iterable[str]) -> dict:
    """Pull the requested optimization targets out of a scene."""
    params = {}
    for k in keys:
        if k == "materials":
            params[k] = scene.materials
        elif k == "env_image":
            if scene.env is None:
                raise ValueError("scene has no environment map")
            params[k] = scene.env.image
        elif k == "positions":
            params[k] = scene.mesh.positions
        else:
            raise KeyError(f"unknown param key {k!r}; choose from "
                           f"{PARAM_KEYS}")
    return params


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The leaves of a params dict in the JAX package's flatten order:
    keys sorted, a ``Materials`` field by field."""
    out = []
    for k in sorted(params):
        v = params[k]
        out += ([getattr(v, n) for n in _MAT_FIELDS]
                if isinstance(v, Materials) else [v])
    return out


def params_like(params: dict, leaves) -> dict:
    """A params dict of ``params``' structure holding ``leaves`` (in
    :func:`param_leaves` order)."""
    it = iter(leaves)
    out = {}
    for k in sorted(params):
        out[k] = (Materials(**{n: next(it) for n in _MAT_FIELDS})
                  if isinstance(params[k], Materials) else next(it))
    return {k: out[k] for k in params}


def apply_params(scene: Scene, params: dict) -> Scene:
    """Graft an optimization-parameter dict back onto a scene template.

    The environment keeps the template's host-baked alias tables when it
    has them: cells sampled from the (stale) tables with their (stale)
    pdf stay an unbiased estimator, while the radiance fetched at them is
    the new, differentiable image (``quad12`` rebuilt from it,
    ``alias_fat`` dropped, since its rows bake the old radiance).  A
    template without alias tables gets its pdf and CDFs rebuilt in the
    graph (``ops/envmap.py::envmap_in_graph``)."""
    if "materials" in params:
        scene = dataclasses.replace(scene, materials=params["materials"])
    if "env_image" in params:
        img = params["env_image"].to(torch.float32)
        env0 = scene.env
        if env0 is not None and env0.alias_x is not None:
            env = dataclasses.replace(env0, image=img,
                                      quad12=_pack_quads(img),
                                      alias_fat=None)
        else:
            env = envmap_in_graph(img)
        scene = dataclasses.replace(scene, env=env)
    if "positions" in params:
        scene = dataclasses.replace(scene, mesh=dataclasses.replace(
            scene.mesh, positions=params["positions"]))
    return scene


def refit_scene(scene: Scene, max_leaf_size: int = 4) -> Scene:
    """Rebuild the BVH for the scene's current vertex positions on the
    host (call after optimizer steps that move geometry), with the
    native builder when g++ exists, else the numpy one (the JAX
    package's choice), from the triangles in their current leaf order.
    ``indices``, ``material_id``, ``texture_id``, ``area`` and the
    lights' ``tri_index`` are remapped through the new order, as the JAX
    package does (areas and prefix areas are not recomputed there
    either).  The walk's tables (``TravData``) are packed by the code
    ``SceneBuilder.build`` uses, so the next trace still runs the
    attribute and key kernels; the JAX package's refit keeps no
    ``tri_attr16`` or treelets, which changes only the ray order and the
    ulps of its next frame, not what it computes.  A scene that had the
    4-wide layout gets it repacked at its width (the JAX package repacks
    it at width 4, the default), so ``traversal="wide4"`` walks the new
    tree.  ``bvh_depth`` follows the new tree."""
    mesh0 = scene.mesh.detach()
    dev = mesh0.positions.device
    host = lambda t: t.cpu().numpy()
    positions, indices = host(mesh0.positions), host(mesh0.indices)
    built = bvh_builder()(positions, indices, max_leaf_size=max_leaf_size)
    order = built.order
    idx_o = indices[order]
    o_t = torch.as_tensor(order, dtype=torch.int64, device=dev)
    t = lambda a: torch.as_tensor(np.array(a), device=dev)
    mesh = dataclasses.replace(
        scene.mesh, indices=t(idx_o),
        material_id=scene.mesh.material_id[o_t],
        texture_id=scene.mesh.texture_id[o_t], area=scene.mesh.area[o_t])
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=order.dtype)
    lights = dataclasses.replace(
        scene.lights, tri_index=t(inv[host(scene.lights.tri_index)]))
    bvh = BVH(node_min=t(built.node_min), node_max=t(built.node_max),
              axis=t(built.axis), right_child=t(built.right_child),
              start=t(built.start), end=t(built.end))
    w4 = scene.trav.w4 if scene.trav is not None else None
    trav = pack_traversal(
        built, positions, host(mesh0.normals), host(mesh0.uvs), idx_o,
        host(mesh.material_id), host(mesh.texture_id), mesh.detach(), dev,
        with_w4=w4 is not None, width=w4.width if w4 is not None else None)
    return dataclasses.replace(scene, mesh=mesh, bvh=bvh, lights=lights,
                               trav=trav, bvh_depth=built.max_depth)


def render_image_from_params(params: dict, scene: Scene, o, d, px, py,
                             frame, cfg: RenderConfig) -> torch.Tensor:
    """[R, 3] radiance with ``params`` grafted in: the differentiable
    live forward pass.  ``kernel_interaction`` is forced off: the
    attribute kernel's interaction values carry no gradient, so the
    vertex / normal / uv gradients need ``make_interaction``'s
    re-derivation (the trace/replay path gets the attribute kernel in
    its trace phase instead)."""
    cfg = dataclasses.replace(cfg, kernel_interaction=False)
    return render_rays(apply_params(scene, params), o, d, px, py, frame, cfg)


def leaf_copies(params: dict) -> tuple[dict, list[torch.Tensor]]:
    """``(params, leaves)``: a copy of ``params`` whose leaves are fresh
    tensors that require grad, and those leaves in
    :func:`param_leaves` order."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in param_leaves(params)]
    return params_like(params, leaves), leaves


def detached_params(params: dict) -> dict:
    """``params`` with every tensor leaf cut from the autograd graph (the
    values a trace runs with)."""
    return {k: (v.detach() if isinstance(v, (torch.Tensor, Materials))
                else v) for k, v in params.items()}


def _loss(renders, target: torch.Tensor, spp: int, dual: bool):
    """The squared-error loss of the mean of ``spp`` samples; with
    ``spp >= 2`` and ``dual`` the dual-buffer estimator
    ``mean((A - t) * (B - t))`` over two independent halves."""
    if spp >= 2 and dual:
        ka = spp // 2
        a, b = renders(0, ka), renders(ka, spp - ka)
        return torch.mean((a - target) * (b - target))
    return torch.mean((renders(0, spp) - target) ** 2)


def _value_and_grad(loss: torch.Tensor, p: dict, leaves):
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g
          for g, x in zip(gs, leaves)]
    return loss.detach(), params_like(p, gs)


def live_loss(p: dict, scene: Scene, o, d, px, py, frame,
              target: torch.Tensor, cfg: RenderConfig, spp: int = 1,
              dual: bool = True) -> torch.Tensor:
    """The loss of :func:`loss_and_grad` as a function of ``p`` (a params
    dict whose leaves may require grad): sample j renders frame
    ``frame + j`` through the live integrator, the walks inside the
    differentiated pass (detached).  ``frame`` is an int or a 0-d
    integer tensor (a captured step's counter, ``diff/program.py``)."""

    def renders(j0, k):
        img = torch.zeros_like(target)
        for j in range(j0, j0 + k):
            img = img + render_image_from_params(p, scene, o, d, px, py,
                                                 frame + j, cfg)
        return img / k

    return _loss(renders, target, spp, dual)


def replay_loss(p: dict, scene: Scene, o, d, px, py, frame,
                target: torch.Tensor, cfg: RenderConfig, spp: int = 1,
                dual: bool = True) -> torch.Tensor:
    """The loss of :func:`loss_and_grad_replay` as a function of ``p``:
    each sample's walks run once, forward only, with ``p``'s values
    (:func:`trace_paths`), then the walk-free replay of every sample is
    the differentiated function.  ``frame`` as in :func:`live_loss`."""
    with torch.no_grad():
        scene_now = apply_params(scene, detached_params(p))
        recs = [trace_paths(scene_now, o, d, px, py, frame + j, cfg)
                for j in range(spp)]

    def renders(j0, k):
        sc = apply_params(scene, p)
        img = torch.zeros_like(target)
        for j in range(j0, j0 + k):
            img = img + render_rays_replay(sc, o, d, px, py, frame + j, cfg,
                                           recs[j])
        return img / k

    return _loss(renders, target, spp, dual)


def frames_loss(p: dict, scene: Scene, o, d, px, py, start,
                target: torch.Tensor, cfg: RenderConfig, k: int = 1,
                replay: bool = True) -> torch.Tensor:
    """The JAX bench's ``--bwd`` loss as a function of ``p``: the mean
    over frames ``start`` .. ``start + k - 1`` of each frame's
    ``mean((img - target) ** 2)``, summed in frame order
    (``bench.py::frames_loss_and_grad``).  ``replay``: each frame's
    walks run once on ``scene`` itself, forward only, then the walk-free
    replay is differentiated; else the live integrator."""
    if replay:
        recs = [trace_paths(scene, o, d, px, py, start + j, cfg)
                for j in range(k)]
        sc = apply_params(scene, p)
    loss = torch.zeros((), dtype=torch.float32, device=o.device)
    for j in range(k):
        img = (render_rays_replay(sc, o, d, px, py, start + j, cfg, recs[j])
               if replay else render_image_from_params(
                   p, scene, o, d, px, py, start + j, cfg))
        loss = loss + torch.mean((img - target) ** 2)
    return loss / k


LOSSES = {"live": live_loss, "replay": replay_loss, "frames": frames_loss}


def step_body(kind: str, params: dict, leaves, scene: Scene, o, d, px, py,
              frame, target, cfg: RenderConfig, **static):
    """One gradient step op by op: ``(loss, gradient leaves)`` of the loss
    ``LOSSES[kind]`` at ``params``, whose leaves ``leaves`` (in
    :func:`param_leaves` order) require grad.  The eager step, and the
    body of a captured one (``diff/program.py``), whose ``frame`` is a
    0-d int64 tensor."""
    loss = LOSSES[kind](params, scene, o, d, px, py, frame, target, cfg,
                        **static)
    loss, grads = _value_and_grad(loss, params, leaves)
    return loss, param_leaves(grads)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def step_loss_and_grad(kind: str, params: dict, scene: Scene, o, d, px, py,
                       frame, target: torch.Tensor, cfg: RenderConfig,
                       eager: bool = False, **static):
    """``(loss, grads)`` of the loss ``LOSSES[kind]`` (static arguments
    ``static``) at ``params``.  On a CUDA device it replays the step's
    captured program (``diff/program.py::step_program``, captured at the
    first call for this scene's tensors, ``cfg``, kind, static
    arguments, params shapes, ray count and device) and returns copies
    of its loss and gradients, which the next replay overwrites; with
    ``eager=True``, and always on the CPU, the step runs op by op.  Both
    give the same loss and gradients bit for bit."""
    if eager or not _on_card(o):
        p, leaves = leaf_copies(params)
        loss, grads = step_body(kind, p, leaves, scene, o, d, px, py, frame,
                                target, cfg, **static)
        return loss, params_like(params, grads)
    from pnraytracing_tpu_torch.diff.program import step_program

    prog = step_program(kind, scene, cfg, params, o.shape[0], o.device,
                        **static)
    loss, grads = prog.replay(params, o, d, px, py, frame, target)
    return loss.clone(), params_like(params, [g.clone() for g in
                                              param_leaves(grads)])


def loss_and_grad(params: dict, scene: Scene, o, d, px, py, frame,
                  target: torch.Tensor, cfg: RenderConfig, spp: int = 1,
                  dual: bool = True, eager: bool = False):
    """Squared-error loss against a target ray-color batch [R, 3] and its
    gradient: ``(loss, grads)`` with ``grads`` of ``params``' structure.

    With ``spp >= 2`` the samples are split into two independent halves
    A, B and the loss is the dual-buffer estimator ``mean((A-t)*(B-t))``:
    ``E[(A-t)(B-t)] = (E[render]-t)^2`` exactly, with no ``Var/n`` term.
    ``spp == 1`` (or ``dual=False``) is plain MSE, the right choice
    under common random numbers.  Sample j renders frame ``frame + j``.
    The walks run inside the differentiated pass (detached).  On the
    card the step is one replayed CUDA graph (the counterpart of the JAX
    package's ``jax.jit``; :func:`step_loss_and_grad`), ``eager=True``
    runs it op by op."""
    return step_loss_and_grad("live", params, scene, o, d, px, py, frame,
                              target, cfg, eager, spp=spp, dual=dual)


def loss_and_grad_replay(params: dict, scene: Scene, o, d, px, py, frame,
                         target: torch.Tensor, cfg: RenderConfig,
                         spp: int = 1, dual: bool = True,
                         eager: bool = False):
    """The estimator and gradients of :func:`loss_and_grad` by the
    trace/replay split: each sample's walks run once, forward only, with
    the current parameter values (:func:`trace_paths`), and the
    differentiated function is the walk-free replay, so the backward
    never walks the BVH.  Gradients match the live ones because every
    recorded quantity (hit ids, occlusion bits) is one the live pass
    detaches.  On the card one replayed CUDA graph a step, as
    :func:`loss_and_grad`."""
    return step_loss_and_grad("replay", params, scene, o, d, px, py, frame,
                              target, cfg, eager, spp=spp, dual=dual)


def _global_norm(ts) -> float:
    return float(torch.sqrt(sum(torch.sum(t * t) for t in ts)))


def adam_optimize(scene: Scene, camera: Camera, cfg: RenderConfig,
                  target_image, keys: Iterable[str] = ("materials",),
                  steps: int = 32, lr: float = 2e-2, frame_offset: int = 0,
                  spp_per_step: int = 4, use_replay: bool = True,
                  resample: bool = True, grad_mask: dict | None = None,
                  log_every: int | None = None, log_fn=None, device=None,
                  eager: bool = False):
    """A small inverse-rendering loop on ``device`` (None = the card):
    ``(optimized scene, loss history)``.  ``torch.optim.Adam`` with the
    JAX package's ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8); after
    each step the parameters are projected back into their domain
    (``Materials.sanitized()``, env radiance >= 0) in place, and a
    positions step refits the scene (:func:`refit_scene`).

    ``use_replay`` picks the trace/replay gradient step.
    ``resample=False`` renders the same frame window every step (common
    random numbers; plain MSE).  ``grad_mask`` (a dict like the params,
    broadcastable leaves) freezes coordinates where it is 0.
    ``log_every=N`` emits one JSON line per N steps through ``log_fn``
    (default print): step, loss, global grad norm, per-key grad norms,
    rays/s and step wall time, the JAX package's keys.

    On a CUDA device every step replays one captured gradient step
    (``diff/program.py::StepProgram``, the counterpart of the JAX loop's
    one compiled step); ``eager=True``, and the CPU, run it op by op,
    with the same losses and parameters bit for bit.  The update (the
    mask, ``Adam.step()``, ``sanitized()``, the env clamp) stays outside
    the graph, a few multi-tensor kernels on the parameters in place
    (the counterpart of JAX's jitted, donating ``_update``): it is ~10
    kernels against the step's thousands, and Adam's moments then live
    outside any program, so a recapture keeps them.  A positions run
    refits the scene on the host after each step, as JAX does, and as
    JAX reuses its compiled step when the refit arrays keep their
    shapes, the refit tables are copied into the program's own copy of
    the scene (:meth:`StepProgram.load_scene`) and a new program is
    captured only when a shape changes (``diff/program.py::CAPTURES``
    counts the captures).  The only host read of a step is
    ``float(loss)``, beside the refit's and the log's."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    params, leaves = leaf_copies(extract_params(scene, keys))
    opt = torch.optim.Adam(leaves, lr=lr)
    mask_leaves = (None if grad_mask is None else
                   [torch.as_tensor(m, dtype=torch.float32, device=dev)
                    for m in param_leaves({k: grad_mask[k]
                                           for k in params})])
    px, py = pixel_coords(cfg, dev)
    o, d, _ = camera_rays(camera, cfg.width, cfg.height)
    target = torch.as_tensor(target_image, dtype=torch.float32,
                             device=dev).reshape(-1, 3)

    kind = "replay" if use_replay else "live"
    static = dict(spp=spp_per_step, dual=resample)
    prog = None
    if dev.type == "cuda" and not eager:
        from pnraytracing_tpu_torch.core.types import _map
        from pnraytracing_tpu_torch.diff.program import StepProgram

        new_program = lambda sc: StepProgram(kind, sc, cfg, params,
                                             o.shape[0], dev, **static)
        # a positions run refits into the program's scene: its own copy
        prog = new_program(_map(scene, torch.clone) if "positions" in params
                           else scene)
    losses = []
    emit = log_fn or (lambda line: print(line, flush=True))
    rays_per_sample = cfg.num_pixels * (1 + 3 * cfg.max_depth)
    t_prev = time.perf_counter()
    for step in range(steps):
        frame = frame_offset + (step * spp_per_step if resample else 0)
        if prog is None:
            loss, grads = step_loss_and_grad(kind, params, scene, o, d, px,
                                             py, frame, target, cfg, True,
                                             **static)
        else:
            loss, grads = prog.replay(params, o, d, px, py, frame, target)
        g_leaves = param_leaves(grads)
        with torch.no_grad():
            for i, (x, g) in enumerate(zip(leaves, g_leaves)):
                x.grad = g if mask_leaves is None else g * mask_leaves[i]
            opt.step()
            # project back into the physical domain (the clips also keep
            # the forward's sanitization from zeroing gradients for good)
            if "materials" in params:
                m, ms = params["materials"], params["materials"].sanitized()
                for n in _MAT_FIELDS:
                    getattr(m, n).copy_(getattr(ms, n))
            if "env_image" in params:
                params["env_image"].clamp_min_(0.0)
        if "positions" in params:
            # finite motion invalidates the template's BVH and layout
            scene = refit_scene(apply_params(
                scene, {"positions": params["positions"].detach().clone()}))
            if prog is not None and not prog.load_scene(scene):
                prog = new_program(scene)
        losses.append(float(loss))
        if log_every and (step % log_every == 0 or step == steps - 1):
            now = time.perf_counter()  # float(loss) synchronized the step
            dt = now - t_prev
            t_prev = now
            emit(json.dumps({
                "step": step,
                "loss": losses[-1],
                "grad_norm": _global_norm(g_leaves),
                "grad_norms": {k: _global_norm(param_leaves({k: grads[k]}))
                               for k in grads},
                "rays_per_s": round(rays_per_sample * spp_per_step / dt, 1),
                "step_s": round(dt, 4),
            }))
        else:
            t_prev = time.perf_counter()
    final = params_like(params, [x.detach() for x in leaves])
    return apply_params(scene, final), losses
