"""Scene catalog: the configurations the port renders so far.

PyTorch counterpart of ``config3_teapot_night``, ``config5_large``,
``night_hdr`` and ``_camera`` from ``pnraytracing_tpu/scene/scenes.py``.
"""

from __future__ import annotations

import os

import numpy as np

from pnraytracing_tpu_torch.core.camera import CameraState
from pnraytracing_tpu_torch.io.hdr import procedural_sky, read_hdr
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.scene.transform import compose, rotate, scale, translate


def night_hdr(height: int = 256, hdr_path: str | None = None):
    """The vignaioli_night_1k environment when ``hdr_path`` names an
    existing file, otherwise the procedural night sky the JAX package
    falls back to (same parameters, so the same texels)."""
    if hdr_path is not None and os.path.exists(hdr_path):
        return read_hdr(hdr_path)
    return procedural_sky(
        height=height,
        width=2 * height,
        sun_dir=(-0.5, 0.25, 0.6),
        sun_intensity=20.0,
        sky_tint=(0.02, 0.03, 0.08),
        horizon=(0.25, 0.15, 0.08),
        ground=(0.02, 0.02, 0.03),
    )


def _camera(eye, center, fov, aspect=1.0) -> CameraState:
    return CameraState(
        eye=np.asarray(eye, np.float64),
        center=np.asarray(center, np.float64),
        up=np.asarray((0, 1, 0), np.float64),
        fov_deg=fov,
        aspect=aspect,
    )


def config3_teapot_night(env_height: int = 256, max_leaf_size: int = 4,
                         device=None, hdr_path: str | None = None):
    """Config 3, the flagship: teapot + area light + night HDR env, full
    Disney BRDF.  Returns (scene on ``device``, camera state)."""
    b = SceneBuilder()
    b.add(shapes.teapot(), dict(base_color=(0.6, 0.7, 0.2), metallic=0.7,
                                roughness=0.3),
          name="teapot", transform=scale(0.55))
    b.add(shapes.quad(), dict(base_color=(0.73, 0.73, 0.73), metallic=0.2,
                              roughness=0.85),
          name="floor")
    b.add(
        shapes.quad(half=1.0),
        dict(emissive=(30.0, 28.0, 24.0)),
        name="lamp",
        transform=compose(translate(-2.5, 5, 0), rotate(180, (0, 0, 1))),
    )
    scene = b.build(env_image=night_hdr(env_height, hdr_path),
                    max_leaf_size=max_leaf_size, device=device)
    return scene, _camera((0, 5, 5), (0, 0.8, 0), 45.0)


def config5_large(subdiv: int = 6, device=None):
    """Config 5: green_bunny-class load (102,404 triangles at subdiv=6:
    icospheres of 81,920 and 20,480 triangles + floor + lamp), HDR env.
    Its binary packing exceeds the resident budget (accel/route.py), so
    it carries the brick-streaming layout and renders through the stream
    kernels.  Returns (scene on ``device``, camera state)."""
    b = SceneBuilder()
    b.add(
        shapes.icosphere(subdiv),
        dict(base_color=(0.2, 0.7, 0.25), roughness=0.4, metallic=0.1),
        name="bunny_standin",
        transform=compose(translate(-1.2, 1.0, 0), scale(1.0)),
    )
    b.add(
        shapes.icosphere(subdiv - 1),
        dict(base_color=(0.8, 0.75, 0.6), metallic=0.9, roughness=0.1),
        name="chrome",
        transform=compose(translate(1.4, 0.8, -0.5), scale(0.8)),
    )
    b.add(shapes.quad(), dict(base_color=(0.7, 0.7, 0.7), roughness=0.9),
          name="floor")
    b.add(
        shapes.quad(half=1.5),
        dict(emissive=(18.0, 18.0, 17.0)),
        name="lamp",
        transform=compose(translate(0, 6, 0), rotate(180, (0, 0, 1))),
    )
    scene = b.build(env_image=procedural_sky(256, 512), device=device)
    return scene, _camera((0, 2.5, 6), (0, 1.0, 0), 45.0)
