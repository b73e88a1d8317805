"""Carry a scene over between packages as a dict of numpy arrays.

:func:`scene_to_arrays` flattens a scene into ``{"group.field": array}``
leaves, taking from it only the fields this port's ``Scene`` has; it
reads any object with those attributes (the port's own scene, or the JAX
package's, whose arrays convert with ``np.asarray``), so this module
never imports JAX.  :func:`scene_from_arrays` builds the port's ``Scene``
from such a dict on a device.  Tests use the pair to render the very
scene the JAX package built.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnraytracing_tpu_torch.accel.bricks import StreamData, treelet_index_tree
from pnraytracing_tpu_torch.accel.layout import TravData, pack_tri12
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

_GROUPS = {"mesh": TriangleMesh, "materials": Materials, "bvh": BVH,
           "lights": Lights, "env": EnvMap, "textures": TextureAtlas}
_TRAV_FIELDS = ("tri9", "nodes8", "nodes16c", "tri_attr16", "treelets")
_STREAM_ARRAYS = ("top16", "bricks")
_STREAM_INTS = ("brick_words", "n_bricks", "n_top_rows", "brick_stack",
                "n_tris")


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
    stream = getattr(scene.trav, "stream", None)
    if stream is not None:
        for name in _STREAM_ARRAYS:
            out[f"stream.{name}"] = _np(getattr(stream, name))
        for name in _STREAM_INTS:
            out[f"stream.{name}"] = np.asarray(getattr(stream, name),
                                               np.int64)
    if scene.env_constant is not None:
        out["env_constant"] = _np(scene.env_constant)
    out["bvh_depth"] = np.asarray(scene.bvh_depth, np.int64)
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
    stream = None
    if "stream.bricks" in leaves:
        stream = StreamData(
            **{n: t(leaves[f"stream.{n}"]) for n in _STREAM_ARRAYS},
            **{n: int(leaves[f"stream.{n}"]) for n in _STREAM_INTS})
    opt = lambda k: t(leaves[k]) if k in leaves else None
    trav = TravData(bvh_depth=depth, stream=stream,
                    tri12=t(leaves["trav.tri12"]),
                    treelets=opt("trav.treelets"),
                    treelet_tree=opt("trav.treelet_tree"),
                    **{n: t(leaves[f"trav.{n}"]) for n in _TRAV_FIELDS
                       if n != "treelets"})
    env_constant = (t(leaves["env_constant"]) if "env_constant" in leaves
                    else None)
    return Scene(trav=trav, env_constant=env_constant, bvh_depth=depth,
                 **parts)
