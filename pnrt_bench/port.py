"""The harness's bridge to the program (``pnraytracing_tpu_torch``): the
scene handed over through its public ``SceneBuilder.add`` / ``build``,
the camera rig, the render settings, and the route check.  Only the loops
import this module; the reference never does."""

from __future__ import annotations

import time

import numpy as np


def build_scene(recipe, device, run):
    """The program's scene of ``recipe`` on ``device``; the host clock
    around the build and the move to the card is ``run.setup['build_s']``."""
    import torch

    from pnraytracing_tpu_torch.scene.build import SceneBuilder

    t0 = time.perf_counter()
    b = SceneBuilder()
    for mesh, material, name, xf in recipe.models:
        b.add(mesh, material, name=name, transform=xf)
    scene = b.build(env_image=recipe.env, max_leaf_size=recipe.max_leaf_size,
                    device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup["build_s"] = time.perf_counter() - t0
    return scene


def camera_state(cam: dict):
    from pnraytracing_tpu_torch.core.camera import CameraState

    f64 = lambda v: np.asarray(v, np.float64)
    return CameraState(eye=f64(cam["eye"]), center=f64(cam["center"]),
                       up=f64(cam["up"]), fov_deg=float(cam["fov_deg"]),
                       aspect=float(cam["aspect"]))


def render_config(config: dict, **changes):
    from pnraytracing_tpu_torch.core.config import RenderConfig

    return RenderConfig(**{**config["render"], **changes})


def check_route(launches: dict, config: dict) -> None:
    """The kernels a captured program launched must be the configuration's
    route (``launches``: the program's counts at capture)."""
    used = sorted(k for k, v in launches.items() if v)
    want = sorted(config["route"])
    if used != want:
        raise RuntimeError(f"{config['name']}: the captured program "
                           f"launched {used}, the configuration's route "
                           f"is {want}")


def frames_start(seed: int) -> int:
    """The first frame of a seed's traffic: seed x 2^20, modulo 2^32."""
    return (int(seed) << 20) & 0xFFFFFFFF
