"""Carry a scene over between packages as a dict of numpy arrays.

:func:`scene_to_arrays` flattens a scene into ``{"group.field": array}``
leaves, taking from it only the fields this port's ``Scene`` has; it
reads any object with those attributes (the port's own scene, or the JAX
package's, whose arrays convert with ``np.asarray``), so this module
never imports JAX.  :func:`scene_from_arrays` builds the port's ``Scene``
from such a dict on a device.  A scene outside the packed layout
(``trav`` None) has no ``trav.*`` leaves and converts to a scene with
``trav=None``; the brick-streaming and 4-wide layouts travel as
``stream.*`` and ``w4.*`` leaves.  Tests use the pair to render the very
scene the JAX package built.

The same holds for the state of a gradient step: :func:`params_to_arrays`
/ :func:`params_from_arrays` carry an optimization-parameter dict
(``diff/grad.py``; leaves ``materials.<field>``, ``env_image``,
``positions``) and :func:`records_to_arrays` / :func:`records_from_arrays`
a frame's ``TraceRecords`` (leaves ``primary.<tri|t|b1|b2>``,
``light_occ``, ``env_occ``, ``bounce.<tri|t|b1|b2>``), so the port's
records can be replayed by the JAX package and the JAX package's
parameters rendered by the port.  :func:`prim_shards_to_arrays` /
:func:`prim_shards_from_arrays` carry the primitive shards of
``parallel/primitive.py`` (``PrimShards``, of either package).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnraytracing_tpu_torch.accel.bricks import StreamData, treelet_index_tree
from pnraytracing_tpu_torch.accel.layout import (
    TravData,
    Wide4Data,
    pack_tri12,
)
from pnraytracing_tpu_torch.core.camera import resolve_device
from pnraytracing_tpu_torch.core.types import (
    BVH,
    EnvMap,
    Lights,
    Materials,
    Scene,
    TextureAtlas,
    TriangleMesh,
)
from pnraytracing_tpu_torch.parallel.primitive import PrimShards

_GROUPS = {"mesh": TriangleMesh, "materials": Materials, "bvh": BVH,
           "lights": Lights, "env": EnvMap, "textures": TextureAtlas}
_TRAV_FIELDS = ("tri9", "nodes8", "nodes16c", "tri_attr16", "treelets")
_STREAM_ARRAYS = ("top16", "bricks")
_STREAM_INTS = ("brick_words", "n_bricks", "n_top_rows", "brick_stack",
                "n_tris")
_W4_ARRAYS = ("nodes32", "leaf40")
_W4_INTS = ("depth4", "width")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scene_to_arrays(scene) -> dict[str, np.ndarray]:
    """Flatten ``scene`` into numpy leaves named ``group.field``."""
    out = {}
    for group, cls in _GROUPS.items():
        obj = getattr(scene, group)
        if obj is None:
            continue
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            if v is not None:
                out[f"{group}.{f.name}"] = _np(v)
    out["bvh_depth"] = np.asarray(scene.bvh_depth, np.int64)
    if scene.env_constant is not None:
        out["env_constant"] = _np(scene.env_constant)
    if scene.trav is None:  # outside the packed layout: no trav leaves
        return out
    for name in _TRAV_FIELDS:
        v = getattr(scene.trav, name)
        if v is not None or name != "treelets":
            out[f"trav.{name}"] = _np(v)
    # the padded triangle rows and the key kernel's union tree are the
    # port's own tables: a scene of the JAX package has none, and their
    # leaves are then made from tri9 and from treelets (a scene without
    # treelets has no tree either)
    tri12 = getattr(scene.trav, "tri12", None)
    out["trav.tri12"] = (_np(tri12) if tri12 is not None
                         else pack_tri12(out["trav.tri9"]))
    tree = getattr(scene.trav, "treelet_tree", None)
    if tree is not None:
        out["trav.treelet_tree"] = _np(tree)
    elif "trav.treelets" in out:
        out["trav.treelet_tree"] = treelet_index_tree(out["trav.treelets"])
    for group, arrays, ints in (("stream", _STREAM_ARRAYS, _STREAM_INTS),
                                ("w4", _W4_ARRAYS, _W4_INTS)):
        obj = getattr(scene.trav, group, None)
        if obj is not None:
            for name in arrays:
                out[f"{group}.{name}"] = _np(getattr(obj, name))
            for name in ints:
                out[f"{group}.{name}"] = np.asarray(getattr(obj, name),
                                                    np.int64)
    return out


def scene_from_arrays(leaves: dict[str, np.ndarray], device=None) -> Scene:
    """The port's ``Scene`` on ``device`` (None = cuda) from the leaves of
    :func:`scene_to_arrays`; every array is copied as it is."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=dev)
    parts = {}
    for group, cls in _GROUPS.items():
        kw = {f.name: t(leaves[f"{group}.{f.name}"])
              for f in dataclasses.fields(cls)
              if f"{group}.{f.name}" in leaves}
        parts[group] = cls(**kw) if kw else None
    depth = int(leaves["bvh_depth"])
    env_constant = (t(leaves["env_constant"]) if "env_constant" in leaves
                    else None)
    if "trav.tri9" not in leaves:  # a scene outside the packed layout
        return Scene(trav=None, env_constant=env_constant, bvh_depth=depth,
                     **parts)
    stream = None
    if "stream.bricks" in leaves:
        stream = StreamData(
            **{n: t(leaves[f"stream.{n}"]) for n in _STREAM_ARRAYS},
            **{n: int(leaves[f"stream.{n}"]) for n in _STREAM_INTS})
    w4 = None
    if "w4.nodes32" in leaves:
        w4 = Wide4Data(**{n: t(leaves[f"w4.{n}"]) for n in _W4_ARRAYS},
                       **{n: int(leaves[f"w4.{n}"]) for n in _W4_INTS})
    opt = lambda k: t(leaves[k]) if k in leaves else None
    trav = TravData(bvh_depth=depth, stream=stream, w4=w4,
                    tri12=t(leaves["trav.tri12"]),
                    treelets=opt("trav.treelets"),
                    treelet_tree=opt("trav.treelet_tree"),
                    **{n: t(leaves[f"trav.{n}"]) for n in _TRAV_FIELDS
                       if n != "treelets"})
    return Scene(trav=trav, env_constant=env_constant, bvh_depth=depth,
                 **parts)


_HIT_FIELDS = ("tri", "t", "b1", "b2")


def params_to_arrays(params: dict) -> dict[str, np.ndarray]:
    """Flatten a params dict (of either package) into numpy leaves:
    ``materials.<field>`` for a Materials, else the key itself."""
    out = {}
    for k, v in params.items():
        if k == "materials":
            for f in dataclasses.fields(Materials):
                out[f"materials.{f.name}"] = _np(getattr(v, f.name))
        else:
            out[k] = _np(v)
    return out


def params_from_arrays(leaves: dict[str, np.ndarray], device=None) -> dict:
    """The port's params dict on ``device`` (None = cuda) from the leaves
    of :func:`params_to_arrays`."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=dev)
    out = {}
    if any(k.startswith("materials.") for k in leaves):
        out["materials"] = Materials(**{
            f.name: t(leaves[f"materials.{f.name}"])
            for f in dataclasses.fields(Materials)})
    for k in ("env_image", "positions"):
        if k in leaves:
            out[k] = t(leaves[k])
    return out


def records_to_arrays(records) -> dict[str, np.ndarray]:
    """Flatten a frame's ``TraceRecords`` (of either package) into numpy
    leaves; an absent occlusion class has no leaf."""
    out = {}
    for group in ("primary", "bounce"):
        for f in _HIT_FIELDS:
            out[f"{group}.{f}"] = _np(getattr(getattr(records, group), f))
    for k in ("light_occ", "env_occ"):
        v = getattr(records, k)
        if v is not None:
            out[k] = _np(v)
    return out


def records_from_arrays(leaves: dict[str, np.ndarray], device=None):
    """The port's ``TraceRecords`` on ``device`` (None = cuda) from the
    leaves of :func:`records_to_arrays`."""
    from pnraytracing_tpu_torch.ops.intersect import Hit
    from pnraytracing_tpu_torch.render.integrator import TraceRecords

    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=dev)
    hit = lambda g: Hit(*(t(leaves[f"{g}.{f}"]) for f in _HIT_FIELDS))
    opt = lambda k: t(leaves[k]) if k in leaves else None
    return TraceRecords(primary=hit("primary"), light_occ=opt("light_occ"),
                        env_occ=opt("env_occ"), bounce=hit("bounce"))


_SHARD_ARRAYS = ("nodes8", "tri9", "tri_map")


def prim_shards_to_arrays(shards) -> dict[str, np.ndarray]:
    """Flatten a ``PrimShards`` (of either package) into numpy leaves:
    ``nodes8``, ``tri9``, ``tri12`` (made from ``tri9`` for the JAX
    package's, which has none), ``tri_map``, ``n_shards`` and
    ``stack_depth``."""
    out = {n: _np(getattr(shards, n)) for n in _SHARD_ARRAYS}
    tri12 = getattr(shards, "tri12", None)
    out["tri12"] = (_np(tri12) if tri12 is not None else
                    np.stack([pack_tri12(t) for t in out["tri9"]]))
    for n in ("n_shards", "stack_depth"):
        out[n] = np.asarray(getattr(shards, n), np.int64)
    return out


def prim_shards_from_arrays(leaves: dict[str, np.ndarray]):
    """The port's host ``PrimShards`` from the leaves of
    :func:`prim_shards_to_arrays`; its ``bvh_depth`` is ``stack_depth -
    4``, as both packages set the stack."""
    return PrimShards(**{n: np.array(leaves[n])
                         for n in (*_SHARD_ARRAYS, "tri12")},
                      n_shards=int(leaves["n_shards"]),
                      bvh_depth=int(leaves["stack_depth"]) - 4)
