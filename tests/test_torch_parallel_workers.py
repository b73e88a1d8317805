"""Worker processes of the port's multi-process tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_primitive.py``).

This module imports only torch, numpy and the port, never JAX: a child
that ``torch.multiprocessing.spawn`` starts imports the module of its
target function.  :func:`spawn` runs a job in ``world`` processes joined
by gloo through a ``file://`` store in ``workdir``; the job reads its
inputs from npz files the parent wrote there and every rank writes its
results to ``rank<k>.npz`` there.  It holds no tests.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from pnraytracing_tpu_torch.convert import (
    params_to_arrays,
    prim_shards_from_arrays,
    scene_from_arrays,
)
from pnraytracing_tpu_torch.diff.grad import extract_params
from pnraytracing_tpu_torch.parallel import distributed, mesh, primitive


def _entry(rank, job, world, workdir, args):
    torch.set_num_threads(1)
    distributed.initialize(
        init_method="file://" + os.path.join(workdir, "store"),
        world_size=world, rank=rank, device="cpu")
    try:
        out = job(workdir, *args)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(job, world: int, workdir: str, *args) -> list[dict]:
    """Run ``job(workdir, *args)`` on ``world`` gloo ranks; each rank's
    returned dict of arrays, in rank order."""
    torch.multiprocessing.spawn(_entry, args=(job, world, workdir, args),
                                nprocs=world, join=True)
    outs = []
    for k in range(world):
        with np.load(os.path.join(workdir, f"rank{k}.npz")) as f:
            outs.append(dict(f))
        os.remove(os.path.join(workdir, f"rank{k}.npz"))
    return outs


def _load(workdir, name):
    with np.load(os.path.join(workdir, name + ".npz")) as f:
        return dict(f)


def _rays(workdir):
    a = _load(workdir, "rays")
    return [torch.from_numpy(a[k]) for k in ("o", "d", "px", "py")]


def render_job(workdir, cfg, mesh_sizes, counts):
    """``shard_render_rays`` of the scene and rays in ``workdir`` on a mesh
    of each size (this rank's results where it is in the mesh) for the
    first ``c`` rays of each of ``counts``; ``all_hosts_image`` of a
    rank-numbered block."""
    scene = scene_from_arrays(_load(workdir, "scene"), device="cpu")
    o, d, px, py = _rays(workdir)
    out = {}
    for n in mesh_sizes:
        m = mesh.make_device_mesh(n)
        if m.index < 0:
            continue
        for c in counts:
            out[f"render_{n}_{c}"] = mesh.shard_render_rays(
                scene, o[:c], d[:c], px[:c], py[:c], 0, cfg, m).numpy()
    rank = dist.get_rank()
    out["all_hosts"] = distributed.all_hosts_image(
        torch.full((2, 3), float(rank))).numpy()
    return out


def dp_job(workdir, cfg, keys, live_keys, lr):
    """``dp_loss_and_grad`` with and without replay and one replayed
    ``dp_train_step`` on the whole mesh, for the scene, rays and target
    in ``workdir``."""
    scene = scene_from_arrays(_load(workdir, "scene"), device="cpu")
    o, d, px, py = _rays(workdir)
    target = torch.from_numpy(_load(workdir, "target")["target"])
    m = mesh.make_device_mesh()
    out = {}
    for tag, ks, replay in (("replay", keys, True),
                            ("live", live_keys, False)):
        loss, grads = mesh.dp_loss_and_grad(
            extract_params(scene, ks), scene, o, d, px, py, 3, target, cfg,
            m, use_replay=replay)
        out[f"{tag}.loss"] = loss.numpy()
        out.update({f"{tag}.{k}": v for k, v in
                    params_to_arrays(grads).items()})
    params, opt = mesh.adam(extract_params(scene, keys), lr)
    params, loss = mesh.dp_train_step(params, opt, scene, o, d, px, py, 3,
                                      target, cfg, m, use_replay=True)
    out["step.loss"] = loss.numpy()
    out.update({f"step.{k}": v for k, v in params_to_arrays(params).items()})
    return out


def _prim_inputs(workdir, shards, rays):
    a = _load(workdir, rays)
    return (prim_shards_from_arrays(_load(workdir, shards)),
            *(torch.from_numpy(a[k]) for k in ("o", "d", "t_max")))


def _prim_query(out, tag, placed, o, d, t_max, m, **kw):
    hit = primitive.primitive_sharded_closest_hit(placed, o, d, t_max, m,
                                                  **kw)
    occ = primitive.primitive_sharded_any_hit(placed, o, d, t_max, m, **kw)
    out.update({f"{tag}.{f}": getattr(hit, f).numpy()
                for f in ("tri", "t", "b1", "b2")})
    out[f"{tag}.occ"] = occ.numpy()


def primitive_job(workdir):
    """This rank's shard of the shards in ``workdir`` walked for every
    ray, combined over the mesh: closest hit and occlusion, in the
    default and the compat form (``compat0.*`` / ``compat1.*``); then
    the leaf-cap shards (leaves of up to 8 triangles) at the default
    cap and at a cap of 8 (``cap4.*`` / ``cap8.*``)."""
    m = mesh.make_device_mesh()
    out = {}
    shards, o, d, t_max = _prim_inputs(workdir, "shards", "prim_rays")
    placed = primitive.put_shards(shards, m, device="cpu")
    for compat in (False, True):
        _prim_query(out, f"compat{int(compat)}", placed, o, d, t_max, m,
                    compat=compat)
    shards, o, d, t_max = _prim_inputs(workdir, "cap_shards", "cap_rays")
    placed = primitive.put_shards(shards, m, device="cpu")
    _prim_query(out, "cap4", placed, o, d, t_max, m)
    _prim_query(out, "cap8", placed, o, d, t_max, m, max_leaf_size=8)
    return out


def dryrun_job(workdir, width, height):
    """``entry._dryrun_rank`` (the body of ``entry.dryrun_multichip``) at
    ``width`` x ``height`` on the CPU: its losses and final
    parameters."""
    from pnraytracing_tpu_torch.entry import _dryrun_rank

    out = _dryrun_rank(width, height, device="cpu")
    return {"losses": np.array(out["losses"]), **out["params"]}
