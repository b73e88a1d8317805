"""Entry points of the port, the counterpart of the JAX package's
``__graft_entry__.py``.

* :func:`entry` -- the flagship forward step on one card as ``(fn,
  example_args)``: ``render_rays`` of the teapot_night configuration at
  the official bench's shape (512x512, 4 bounces), full Disney BRDF,
  NEE + MIS, HDR environment sampling, the resident wide walks.
* :func:`dryrun_multichip` -- ``n_devices`` ranks (one process each,
  ``parallel/distributed.py::initialize``) run one sharded forward frame
  and two data-parallel Adam steps on the materials and environment
  texels through the trace/replay split, on tiny shapes.

As in the JAX package, the decomposition is data parallelism over rays
with the scene replicated: the forward pass exchanges nothing until one
``all_gather``, and the only collective of a training step is the
gradient ``all_reduce``.

Both run on the card unless the caller passes ``device="cpu"``.  Usage:

    python -c "from pnraytracing_tpu_torch.entry import entry; \\
        fn, args = entry(); print(fn(*args).shape)"
    python -c "from pnraytracing_tpu_torch.entry import dryrun_multichip; \\
        print(dryrun_multichip(2, backend='gloo'))"
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math

import torch

from pnraytracing_tpu_torch.core.camera import camera_rays, resolve_device
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.render.integrator import render_rays
from pnraytracing_tpu_torch.render.renderer import pixel_coords
from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

PARAM_KEYS = ("materials", "env_image")


def _flagship(width, height, env_height=128, max_depth=4, device=None):
    """``(cfg, scene, o, d, px, py)`` of the flagship at ``width`` x
    ``height`` on ``device`` (None = the card): the JAX package's scene,
    aspect, camera rays and pixel coordinates.  ``traversal`` is
    ``"pallas"`` (the resident wide kernels) on the card, the JAX rule
    for its accelerator, and ``"packed"`` on the CPU, as the JAX package
    picks off its TPU."""
    dev = resolve_device(device)
    cfg = RenderConfig(width=width, height=height, max_depth=max_depth,
                       traversal="pallas" if dev.type == "cuda"
                       else "packed")
    scene, cam_state = config3_teapot_night(env_height=env_height,
                                            device=dev)
    cam_state.aspect = width / height
    camera = cam_state.basis(device=dev)
    px, py = pixel_coords(cfg, dev)
    o, d, _ = camera_rays(camera, cfg.width, cfg.height)
    return cfg, scene, o, d, px, py


def entry(device=None):
    """``(fn, example_args)``: the single-card forward render step at the
    official bench's shape (512x512, 4 bounces, teapot_night, an env map
    of height 256); ``fn(*example_args)`` is the [262144, 3] radiance of
    frame 0."""
    cfg, scene, o, d, px, py = _flagship(width=512, height=512,
                                         env_height=256, device=device)
    fn = functools.partial(render_rays, cfg=cfg)
    return fn, (scene, o, d, px, py, 0)


def _digest(params: dict) -> str:
    """sha1 of the parameters' bytes in ``param_leaves`` order: equal on
    every rank exactly when the parameters are equal bit for bit."""
    from pnraytracing_tpu_torch.diff.grad import param_leaves

    h = hashlib.sha1()
    for x in param_leaves(params):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dryrun_rank(width: int = 128, height: int = 128,
                 device=None) -> dict:
    """The body of :func:`dryrun_multichip` on one rank of an initialized
    default group, at ``width`` x ``height`` (the JAX function's 128x128
    by default): the sharded forward frame, then two replayed
    data-parallel Adam steps (lr 1e-2) on the materials and env texels
    towards a zero target.  ``device`` None is the rank's card.
    Returns the losses, the final parameters (numpy, ``convert.py``'s
    names), their digest and the launches by kernel."""
    from pnraytracing_tpu_torch.convert import params_to_arrays
    from pnraytracing_tpu_torch.diff.grad import extract_params
    from pnraytracing_tpu_torch.parallel.distributed import rank_device
    from pnraytracing_tpu_torch.parallel.mesh import (
        adam,
        dp_train_step,
        make_device_mesh,
        shard_render_rays,
    )
    from pnraytracing_tpu_torch.render.program import launch_counts

    before = launch_counts()
    m = make_device_mesh()
    # the JAX function's shapes: the full 4-bounce depth on the packet
    # walk (kernels 5 / 6 on the card), compaction and the treelet-entry
    # sort on (defaults), the bounce loop as one scan
    cfg, scene, o, d, px, py = _flagship(width, height, env_height=32,
                                         max_depth=4,
                                         device=rank_device(device))
    cfg = dataclasses.replace(cfg, traversal="packet", loop="scan")

    color = shard_render_rays(scene, o, d, px, py, 0, cfg, m)
    assert color.shape == (cfg.num_pixels, 3), color.shape

    params, optimizer = adam(extract_params(scene, PARAM_KEYS), 1e-2)
    target = torch.zeros((cfg.num_pixels, 3), dtype=torch.float32,
                         device=o.device)
    losses = []
    for step in range(2):
        params, loss = dp_train_step(params, optimizer, scene, o, d, px, py,
                                     step, target, cfg, m, use_replay=True)
        losses.append(float(loss))
        assert math.isfinite(losses[-1]), losses
    after = launch_counts()
    return {"losses": losses, "params": params_to_arrays(params),
            "digest": _digest(params),
            "launches": {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)}}


def _dryrun_worker(rank, world, init_method, backend, device, queue):
    import torch.distributed as dist

    from pnraytracing_tpu_torch.parallel import distributed

    distributed.initialize(init_method, world_size=world, rank=rank,
                           backend=backend, device=device)
    try:
        out = _dryrun_rank(device=device)
        out.pop("params")  # the digest stands for them
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device=None) -> list[dict]:
    """Run :func:`_dryrun_rank` (128x128, depth 4, ``env_height=32``,
    ``traversal="packet"``, ``loop="scan"``) on ``n_devices`` ranks
    joined over ``tcp://localhost``, one spawned process each; returns
    each rank's losses, parameter digest and launches, in rank order,
    after checking that every rank holds the same parameters.

    On the card the backend is NCCL, one card a rank: more ranks than
    cards raise, since NCCL refuses two ranks on one card; name
    ``backend="gloo"`` to share a card.  ``device="cpu"`` runs gloo on
    the host.  Nothing switches silently."""
    from pnraytracing_tpu_torch.parallel.distributed import free_port

    dev = resolve_device(device)
    if dev.type == "cuda" and backend in (None, "nccl"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card; pass device='cpu' to run on "
                               "the host")
        if n_devices > torch.cuda.device_count():
            raise ValueError(
                f"{n_devices} NCCL ranks on {torch.cuda.device_count()} "
                "card(s): NCCL refuses two ranks on one card; pass "
                "backend='gloo' to share a card")
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    torch.multiprocessing.spawn(
        _dryrun_worker, args=(n_devices, f"tcp://localhost:{free_port()}",
                              backend, device, queue),
        nprocs=n_devices, join=True)
    ranks = dict(queue.get() for _ in range(n_devices))
    out = [ranks[k] for k in range(n_devices)]
    if len({r["digest"] for r in out}) != 1:
        raise AssertionError("the ranks' parameters differ after the "
                             "data-parallel steps")
    return out
