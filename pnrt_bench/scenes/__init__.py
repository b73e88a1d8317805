"""A configuration's scene made from its recipe (``configs/<name>.json``):
the models' meshes, materials and transforms, the environment texels and
the camera, as plain numpy values that both the program and the
reference receive."""

from __future__ import annotations

import dataclasses

import numpy as np

from pnrt_bench.scenes import shapes
from pnrt_bench.scenes.sky import procedural_sky


@dataclasses.dataclass
class Recipe:
    """``models``: (mesh dict, material dict, name, 4x4 transform or
    None) in the order they are added; ``env``: [H, W, 3] float32
    radiance; ``camera``: eye, center, up, fov_deg, aspect."""

    models: list
    env: np.ndarray
    camera: dict
    max_leaf_size: int

    @property
    def num_triangles(self) -> int:
        return sum(len(m[0]["indices"]) for m in self.models)


def make_recipe(config: dict) -> Recipe:
    models = []
    for m in config["models"]:
        mesh = shapes.SHAPES[m["shape"]](**m.get("args", {}))
        xf = m.get("transform")
        models.append((mesh, dict(m["material"]), m["name"],
                       None if not xf else shapes.compose(xf)))
    return Recipe(models=models, env=procedural_sky(**config["env"]["sky"]),
                  camera=dict(config["camera"]),
                  max_leaf_size=int(config.get("max_leaf_size", 4)))
