"""Scene catalog.

PyTorch counterpart of ``pnraytracing_tpu/scene/scenes.py``: the
reference's hardcoded scenes ``cornell_box``, ``scene_flat`` and
``teapot_scene`` (each returns its :class:`SceneBuilder` unbuilt, with
the camera state, as the JAX package does), and the benchmark
configurations ``config1_triangle``, ``config2_teapot``,
``config3_teapot_night``, ``config4_marry`` and ``config5_large`` (built
on ``device``), with ``checkerboard``, ``night_hdr`` and ``_camera``.
``config4_marry`` is the JAX package's stand-in branch (checkerboard
textures on procedural geometry); its branches that load marry's OBJ or
MTL wait for the port of the asset loaders.
"""

from __future__ import annotations

import os

import numpy as np

from pnraytracing_tpu_torch.core.camera import CameraState
from pnraytracing_tpu_torch.io.hdr import procedural_sky, read_hdr
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.scene.transform import compose, rotate, scale, translate


def checkerboard(n: int = 256, squares: int = 8, c0=(0.9, 0.9, 0.9),
                 c1=(0.2, 0.25, 0.35)):
    """Procedural [n, n, 3] texture used where the reference's image
    assets are missing."""
    ij = np.indices((n, n)) // (n // squares)
    mask = (ij[0] + ij[1]) % 2
    tex = np.where(mask[..., None] == 0, np.asarray(c0), np.asarray(c1))
    return tex.astype(np.float32)


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


def cornell_box(aspect: float = 1.0, centerpiece: str = "teapot"):
    """CornellBox (main.cpp:198-247): five walls + ceiling light + an
    object (the teapot, else an icosphere), camera at (0, 2.8, 7) looking
    at (0, 2.8, 0), fov 45.  Returns (builder, camera state)."""
    b = SceneBuilder()
    grey = dict(base_color=(0.65, 0.65, 0.65))
    floor_s = compose(scale(0.1))  # quad(27.5) * 0.1 -> half-size 2.75
    wall = shapes.quad()
    if centerpiece == "teapot":
        b.add(shapes.teapot(), grey, name="teapot",
              transform=compose(translate(0, 0, -1), scale(0.55)))
    else:
        b.add(shapes.icosphere(4), grey, name="sphere",
              transform=compose(translate(0, 1.0, -1.5), scale(1.0)))
    b.add(wall, grey, name="floor", transform=floor_s)
    b.add(wall, grey, name="front_wall",
          transform=compose(translate(0, 2.75, -2.75), rotate(90, (1, 0, 0)),
                            scale(0.1)))
    b.add(wall, dict(base_color=(0.12, 0.45, 0.15)), name="right_wall",
          transform=compose(translate(2.75, 2.75, 0), rotate(90, (0, 0, 1)),
                            scale(0.1)))
    b.add(wall, dict(base_color=(0.65, 0.05, 0.05)), name="left_wall",
          transform=compose(translate(-2.75, 2.75, 0),
                            rotate(-90, (0, 0, 1)), scale(0.1)))
    b.add(wall, dict(base_color=(0.73, 0.73, 0.73)), name="ceiling",
          transform=compose(translate(0, 5.54, 0), rotate(180, (0, 0, 1)),
                            scale(0.1)))
    b.add(wall, dict(base_color=(0.73, 0.73, 0.73),
                     emissive=(60.0, 60.0, 60.0)),
          name="ceiling_light",
          transform=compose(translate(0, 5.53, 0), rotate(180, (0, 0, 1)),
                            scale(0.02)))
    return b, _camera((0, 2.8, 7), (0, 2.8, 0), 45.0, aspect)


def scene_flat(aspect: float = 1.0):
    """SceneFlat (main.cpp:249-327): metallic boards of varying roughness
    lit by four coloured cube lights.  Returns (builder, camera state)."""
    b = SceneBuilder()
    base = dict(base_color=(0.73, 0.73, 0.73), roughness=0.95, metallic=0.05)
    b.add(shapes.quad(), base, name="floor", transform=scale(0.5))
    b.add(shapes.quad(), base, name="front_wall",
          transform=compose(translate(0, 13.85, -13.85),
                            rotate(90, (1, 0, 0)), scale(0.5)))
    boards = [
        (0.95, 0.02, (0, 2.8, -12), 50),
        (0.80, 0.15, (0, 2.2, -9), 35),
        (0.60, 0.35, (0, 1.6, -6), 20),
        (0.30, 0.65, (0, 1.0, -3), 10),
    ]
    for i, (metal, rough, pos, ang) in enumerate(boards):
        b.add(shapes.quad(),
              dict(base_color=(0.83, 0.83, 0.83), metallic=metal,
                   roughness=rough),
              name=f"board{i+1}",
              transform=compose(translate(*pos), rotate(ang, (1, 0, 0)),
                                scale(0.4, 2.0, 0.04)))
    lights = [
        ((0.2, 0.5, 0.7), (-9, 10, -8), 0.25),
        ((0.6, 0.5, 0.2), (-3, 10, -8), 0.5),
        ((0.4, 0.7, 0.2), (3, 10, -8), 1.0),
        ((0.8, 0.1, 0.2), (9, 10, -8), 1.5),
    ]
    for i, (tint, pos, s) in enumerate(lights):
        b.add(shapes.cube(),
              dict(base_color=tint, emissive=tuple(3.0 * c for c in tint),
                   roughness=1.0),
              name=f"light{i+1}", transform=compose(translate(*pos),
                                                    scale(s)))
    return b, _camera((0, 13, 12), (0, 11, 7), 64.0, aspect)


def teapot_scene(aspect: float = 1.0):
    """teapot() (main.cpp:329-347): metallic teapot on a matte floor,
    camera (0, 5, 5) -> origin, fov 45.  Returns (builder, camera
    state)."""
    b = SceneBuilder()
    b.add(shapes.teapot(),
          dict(base_color=(0.6, 0.7, 0.2), metallic=0.7, roughness=0.3),
          name="teapot", transform=scale(0.55))
    b.add(shapes.quad(),
          dict(base_color=(0.73, 0.73, 0.73), metallic=0.2, roughness=0.85),
          name="floor")
    return b, _camera((0, 5, 5), (0, 0, 0), 45.0, aspect)


def config1_triangle(device=None):
    """Config 1: a single textured triangle + constant environment light
    (64x64, 1 bounce in BASELINE.md).  Returns (scene on ``device``,
    camera state)."""
    b = SceneBuilder()
    b.add(shapes.triangle(), dict(base_color=(0.8, 0.4, 0.3), roughness=0.6),
          name="tri", texture=checkerboard(64, 4))
    scene = b.build(env_constant=(0.7, 0.8, 0.9), device=device)
    return scene, _camera((0, 0, 3), (0, 0, 0), 45.0)


def config2_teapot(flat_bvh: bool = False, device=None):
    """Config 2: teapot (~6k triangles) + floor, diffuse materials, an
    area light and a constant environment.  Returns (scene on ``device``,
    camera state).  ``flat_bvh=True`` (one leaf of every triangle, an
    A/B control of the JAX package's XLA walks) is not ported: it is
    queue-1 item 20 of ROADMAP.md."""
    if flat_bvh:
        raise NotImplementedError(
            "config2_teapot(flat_bvh=True) needs SceneBuilder.build("
            "flat_bvh=True), queue-1 item 20 of ROADMAP.md, which is not "
            "ported yet")
    b = SceneBuilder()
    b.add(shapes.teapot(), dict(base_color=(0.6, 0.7, 0.2), roughness=0.8),
          name="teapot", transform=scale(0.55))
    b.add(shapes.quad(), dict(base_color=(0.73, 0.73, 0.73), roughness=0.9),
          name="floor")
    b.add(shapes.quad(half=1.5), dict(emissive=(20.0, 20.0, 20.0)),
          name="key_light",
          transform=compose(translate(2.5, 6, 2.5), rotate(180, (0, 0, 1))))
    scene = b.build(env_constant=(0.15, 0.18, 0.22), device=device)
    return scene, _camera((0, 5, 5), (0, 0.8, 0), 45.0)


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


def config4_marry(aspect: float = 1.0, device=None):
    """Config 4: multi-mesh textured scene (the marry class): a textured
    stand-in figure, a metallic sphere, a textured floor and a lamp under
    a procedural sky.  The JAX package's stand-in branch, which it takes
    when marry's OBJ and MTL are absent.  Returns (scene on ``device``,
    camera state)."""
    b = SceneBuilder()
    b.add(shapes.teapot(), dict(base_color=(0.8, 0.8, 0.8), roughness=0.55),
          name="marry_standin",
          transform=compose(translate(0.1, 0, -0.5), scale(0.35)),
          texture=checkerboard(128, 16, (0.85, 0.6, 0.55), (0.4, 0.2, 0.2)))
    b.add(shapes.icosphere(4),
          dict(base_color=(0.9, 0.9, 0.9), metallic=0.8, roughness=0.15),
          name="sphere",
          transform=compose(translate(-1.4, 0.5, 0.3), scale(0.5)))
    b.add(shapes.quad(), dict(base_color=(0.73, 0.73, 0.73), roughness=0.8),
          name="floor", transform=scale(0.1), texture=checkerboard(256, 16))
    b.add(shapes.quad(half=1.0), dict(emissive=(25.0, 24.0, 22.0)),
          name="lamp",
          transform=compose(translate(2, 4, 2), rotate(180, (0, 0, 1))))
    scene = b.build(env_image=procedural_sky(128, 256), device=device)
    return scene, _camera((0, 1.6, 3.2), (0, 0.9, 0), 45.0, aspect)


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
