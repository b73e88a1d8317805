"""Multi-card scaling: the rank mesh, tile-sharded rendering, data-parallel
gradients.

PyTorch counterpart of ``pnraytracing_tpu/parallel/mesh.py``.  The JAX
package runs one program over a 1-D ``Mesh`` of chips (``shard_map``);
the port runs one process per card (``parallel/distributed.py``) and the
same split by hand:

* a 1-D group of ranks, axis ``"tiles"`` (:class:`Mesh`);
* primary rays split into one contiguous chunk a rank, the scene
  replicated: each rank renders its chunk with ``render_rays`` and one
  ``all_gather`` gives every rank the whole batch
  (:func:`shard_render_rays`, :func:`render_frame_sharded`);
* for training, each rank's local loss and gradients are summed over
  the ranks by one ``all_reduce``, outside the differentiated function
  (:func:`dp_loss_and_grad`, :func:`dp_train_step`).

The JAX package's ``to_global`` has no counterpart: it assembles global
arrays of a multi-host mesh from the full host copies every process
holds, while each rank of the port already holds its full inputs and
takes its chunk of them itself.

Every rank of the mesh calls these functions with the same arguments, in
the same order (the collectives pair up by order).  They run on the
tensors' device; ``render_frame_sharded`` takes ``device`` (None = the
rank's card, ``distributed.rank_device``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pnraytracing_tpu_torch.core.camera import camera_rays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Camera, Scene
from pnraytracing_tpu_torch.diff.grad import (
    apply_params,
    detached_params,
    leaf_copies,
    param_leaves,
    params_like,
    render_image_from_params,
)
from pnraytracing_tpu_torch.parallel.distributed import (
    all_gather_rows,
    all_reduce,
    prefix_group,
    rank_device,
)
from pnraytracing_tpu_torch.render.integrator import (
    render_rays,
    render_rays_replay,
    trace_paths,
)
from pnraytracing_tpu_torch.render.renderer import pixel_coords, primary_jitter

AXIS = "tiles"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the default group as one axis named
    :data:`AXIS`: ``group`` is their process group (None for the whole
    default group), ``index`` this rank's place on the axis (-1 for a
    rank outside the mesh)."""

    group: object
    size: int
    index: int

    def chunk(self, rows: int) -> slice:
        """This rank's rows of a batch of ``rows`` (a multiple of
        ``size``)."""
        if self.index < 0:
            raise ValueError("this rank is not in the mesh")
        c = rows // self.size
        return slice(self.index * c, (self.index + 1) * c)


def make_device_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks (default: all).  The
    default group must be up (``distributed.initialize``).  Every rank
    calls it, in the same order: a subset's group is made by a
    collective over all ranks (once per size and default group; later
    calls reuse it)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call "
                           "parallel.distributed.initialize first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"mesh of {n} ranks in a world of {world}")
    # None stands for the default group
    group = None if n == world else prefix_group(n)
    return Mesh(group=group, size=n, index=rank if rank < n else -1)


def pad_to_multiple(x: torch.Tensor, m: int):
    """``(x with rows appended to a multiple of m rows, its original row
    count)``.  The JAX package appends zero rows; the port repeats the
    last row: a zero ray has no direction, and the replay's derivative
    through its (missed) hit point is NaN, which the zero weight of a
    padded row cannot cancel (0 * NaN), while a repeated ray is a real
    one."""
    r = x.shape[0]
    pad = (-r) % m
    if pad == 0:
        return x, r
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]), r


def local_rows(mesh: Mesh, *xs):
    """This rank's chunk of each of ``xs`` (batches of one row count),
    padded to a multiple of the mesh first."""
    padded = [pad_to_multiple(x, mesh.size)[0] for x in xs]
    sl = mesh.chunk(padded[0].shape[0])
    return [x[sl].contiguous() for x in padded]


def shard_render_rays(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                      px: torch.Tensor, py: torch.Tensor, frame,
                      cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """Render a ray batch with the rays split over the mesh's ranks and
    the scene replicated: ``[R, 3]`` radiance on every rank, padding cut.
    The render itself exchanges nothing (rays are independent); one
    ``all_gather`` assembles the batch."""
    r = o.shape[0]
    o_l, d_l, px_l, py_l = local_rows(mesh, o, d, px, py)
    out = render_rays(scene, o_l, d_l, px_l, py_l, frame, cfg)
    return all_gather_rows(out, mesh.group)[:r]


def render_frame_sharded(scene: Scene, camera: Camera, cfg: RenderConfig,
                         frame, mesh: Mesh, device=None) -> torch.Tensor:
    """Tile-sharded version of ``render_frame``: one full [H, W, 3] sample
    image computed across the mesh, on every rank (the frame's rays in
    ``camera_rays`` order, each rank rendering its contiguous chunk
    eagerly)."""
    dev = rank_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    if isinstance(frame, torch.Tensor):
        frame = frame.to(dev)
    px, py = pixel_coords(cfg, dev)
    o, d, _ = camera_rays(camera, cfg.width, cfg.height,
                          jitter=primary_jitter(px, py, frame, cfg))
    color = shard_render_rays(scene, o, d, px, py, frame, cfg, mesh)
    return color.reshape(cfg.height, cfg.width, 3)


def dp_loss_and_grad(params: dict, scene: Scene, o: torch.Tensor,
                     d: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                     frame, target: torch.Tensor, cfg: RenderConfig,
                     mesh: Mesh, use_replay: bool = False):
    """Data-parallel value and gradient of the squared-error loss
    ``mean((render - target)^2)`` over a ray batch: the rays split over
    the mesh, each rank's local sum of squares and its gradient summed
    over the ranks by one ``all_reduce`` (outside the differentiated
    function) and divided by the global element count ``R * 3``.
    Returns ``(loss, grads)`` on every rank, ``grads`` of ``params``'
    structure: the loss and gradients of ``diff.grad.loss_and_grad``
    (``spp=1``), up to the order of the sums.

    Padded rows (repeats of the last ray, :func:`pad_to_multiple`) are
    weighted out of the loss.  ``use_replay`` runs each rank's chunk
    through the trace/replay split (``trace_paths`` forward only, then
    the walk-free ``render_rays_replay`` differentiated), as
    ``loss_and_grad_replay``."""
    r = o.shape[0]
    o_l, d_l, px_l, py_l, t_l = local_rows(mesh, o, d, px, py, target)
    rows = torch.arange(o_l.shape[0], device=o.device)
    w_l = (rows + mesh.index * o_l.shape[0] < r).to(torch.float32)
    rays = (o_l, d_l, px_l, py_l, frame, cfg)
    if use_replay:
        with torch.no_grad():
            recs = trace_paths(apply_params(scene, detached_params(params)),
                               *rays)
    p, leaves = leaf_copies(params)
    img = (render_rays_replay(apply_params(scene, p), *rays, recs)
           if use_replay else render_image_from_params(p, scene, *rays))
    local = torch.sum(w_l[:, None] * (img - t_l) ** 2)
    gs = torch.autograd.grad(local, leaves, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g
          for g, x in zip(gs, leaves)]
    # one collective for the loss and every gradient leaf
    flat = torch.cat([local.detach().reshape(1)]
                     + [g.detach().reshape(-1) for g in gs])
    flat = all_reduce(flat, "sum", mesh.group) / torch.tensor(
        float(r * target.shape[-1]), dtype=torch.float32, device=flat.device)
    out, at = [], 1
    for x in param_leaves(params):
        out.append(flat[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return flat[0], params_like(params, out)


def adam(params: dict, lr: float):
    """``(params, optimizer)`` for :func:`dp_train_step`: the leaves of
    ``params`` copied as optimizable tensors and a ``torch.optim.Adam``
    over them, whose defaults are ``optax.adam(lr)``'s (b1 0.9, b2 0.999,
    eps 1e-8), as in ``diff.grad.adam_optimize``."""
    p, leaves = leaf_copies(params)
    return p, torch.optim.Adam(leaves, lr=lr)


def dp_train_step(params: dict, optimizer, scene: Scene, o, d, px, py,
                  frame, target, cfg: RenderConfig, mesh: Mesh,
                  use_replay: bool = False):
    """One data-parallel training step: the sharded forward and backward
    of :func:`dp_loss_and_grad`, then the same optimizer update on every
    rank (the gradients are equal there, so the parameters stay
    replicated).  ``params`` and ``optimizer`` come from :func:`adam`;
    the parameters are updated in place.  Returns ``(params, loss)``."""
    loss, grads = dp_loss_and_grad(params, scene, o, d, px, py, frame,
                                   target, cfg, mesh, use_replay=use_replay)
    with torch.no_grad():
        for x, g in zip(param_leaves(params), param_leaves(grads)):
            x.grad = g
        optimizer.step()
    return params, loss
