"""Multi-process bootstrap on ``torch.distributed``.

PyTorch counterpart of ``pnraytracing_tpu/parallel/distributed.py``.
The JAX package runs one process per host, which drives every chip of
the host, and ``jax.distributed`` joins the hosts.  The port runs one
process (rank) per card, as PyTorch does: :func:`initialize` joins them
into the default process group, and ``parallel/mesh.py`` and
``parallel/primitive.py`` exchange results with collectives over it.

Typical launch (one process per card, e.g. by ``torchrun``, which sets
``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK``):

    from pnraytracing_tpu_torch.parallel.distributed import initialize
    from pnraytracing_tpu_torch.parallel.mesh import (
        make_device_mesh, render_frame_sharded)
    initialize()                        # nccl, from the environment
    mesh = make_device_mesh()           # every rank
    img = render_frame_sharded(scene, cam, cfg, 0, mesh)  # on every rank

Each rank works on the card :func:`rank_device` names.  The backend is
``nccl``; ``gloo`` only where the caller names it or asks for the CPU.
There is no fallback: a missing NCCL or card raises.  Gloo runs its
collectives on host memory here: :func:`all_reduce` and
:func:`all_gather_rows` stage a CUDA tensor through the host under it
(gloo implements only some collectives for CUDA tensors, and none of
them without such a copy), so several ranks can share one card.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}

# groups of the first n ranks of the default group, by n (new_group is a
# collective, so each is made once); emptied by initialize, since a
# group outlives no default group
_PREFIX_GROUPS: dict[int, object] = {}


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device=None) -> None:
    """Join the default process group.  Arguments left out are read from
    the environment (``init_method`` ``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), as ``jax.distributed``
    infers them on a pod.  ``backend`` defaults to ``nccl``, or to
    ``gloo`` when ``device`` is the CPU; ``nccl`` raises without a card
    or without NCCL.  Under ``nccl`` the rank's card becomes the current
    device."""
    if backend is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA card; pass "
                               "backend='gloo' (or device='cpu') to run "
                               "on the host")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL")
    _PREFIX_GROUPS.clear()
    kwargs = {"backend": backend, "init_method": init_method}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(**kwargs)
    if backend == "nccl":
        torch.cuda.set_device(rank_device())


def free_port() -> int:
    """A TCP port on ``localhost`` free at the time of the call, for an
    ``init_method`` of ``tcp://localhost:<port>``."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def is_initialized() -> bool:
    """Whether the default process group is up (public API)."""
    return dist.is_available() and dist.is_initialized()


def prefix_group(n: int):
    """The process group of the default group's first ``n`` ranks
    (``n`` below the world size), made by a collective over every rank
    on first use and reused until the next :func:`initialize`."""
    if n not in _PREFIX_GROUPS:
        _PREFIX_GROUPS[n] = dist.new_group(list(range(n)))
    return _PREFIX_GROUPS[n]


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` where a launcher
    set it, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_device(device=None) -> torch.device:
    """The device this rank works on: ``device`` where the caller gives
    one, else ``cuda:{local_rank % device_count}`` (several ranks share
    a card when there are more ranks than cards)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card; pass device='cpu' to run on the "
                           "host")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``x`` reduced over ``group`` (``op``: 'sum', 'min' or 'max'), as a
    new tensor on ``x``'s device; a CUDA tensor under gloo goes through
    the host."""
    buf = x.cpu() if _staged(x, group) else x.clone()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(x.device)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated along
    rows, in rank order, on ``x``'s device."""
    src = x.cpu() if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def all_hosts_image(local: torch.Tensor) -> torch.Tensor:
    """A full copy on every rank of an image whose rows are split over
    the ranks (rank order along rows, as ``process_allgather(tiled=
    True)``)."""
    return all_gather_rows(local)


def scaling_efficiency(times_by_hosts: dict[int, float]) -> dict[int, float]:
    """eff(n) = t(1) / (n * t(n)) for per-sample wall times — the >=85%
    1->N metric of BASELINE.json."""
    if 1 not in times_by_hosts:
        raise ValueError("need the 1-host time as the baseline")
    t1 = times_by_hosts[1]
    return {n: t1 / (n * t) for n, t in times_by_hosts.items()}
