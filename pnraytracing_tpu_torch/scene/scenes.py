"""Scene catalog.

PyTorch counterpart of ``pnraytracing_tpu/scene/scenes.py``: the
reference's hardcoded scenes ``cornell_box``, ``scene_flat`` and
``teapot_scene`` (each returns its :class:`SceneBuilder` unbuilt, with
the camera state, as the JAX package does), and the benchmark
configurations ``config1_triangle``, ``config2_teapot``,
``config3_teapot_night``, ``config4_marry`` and ``config5_large`` (built
on ``device``), with ``checkerboard``, ``night_hdr`` and ``_camera``.
``config4_marry`` has the JAX package's three branches (marry's OBJ,
its MTL alone, the stand-in) and takes the asset directory as an
argument.
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
    camera state).  ``flat_bvh=True`` builds one leaf of every triangle
    (the brute-force oracle tree): ``trav`` is None and the scene renders
    over its plain BVH (route 'bvh'), with ``RenderConfig.max_leaf_size``
    set to its triangle count for the leaf's every triangle to be
    tested."""
    b = SceneBuilder()
    b.add(shapes.teapot(), dict(base_color=(0.6, 0.7, 0.2), roughness=0.8),
          name="teapot", transform=scale(0.55))
    b.add(shapes.quad(), dict(base_color=(0.73, 0.73, 0.73), roughness=0.9),
          name="floor")
    b.add(shapes.quad(half=1.5), dict(emissive=(20.0, 20.0, 20.0)),
          name="key_light",
          transform=compose(translate(2.5, 6, 2.5), rotate(180, (0, 0, 1))))
    scene = b.build(flat_bvh=flat_bvh, env_constant=(0.15, 0.18, 0.22),
                    device=device)
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


def config4_marry(aspect: float = 1.0, device=None,
                  marry_dir: str | None = None):
    """Config 4: multi-mesh textured scene (the marry class), the JAX
    package's three branches: with ``marry_dir/marry.obj`` every
    material group of the OBJ (its MTL and ``map_Kd`` textures through
    the loaders of ``io/``); else with ``marry_dir/Marry.mtl`` the real
    material and texture on stand-in geometry (a teapot figure and a
    sphere); else the stand-in with checkerboard textures, which the JAX
    package takes where its asset directory is absent.  All three add a
    textured floor and a lamp under a procedural sky.  As ``night_hdr``,
    the port reads no asset outside its checkout unless given the
    directory: None is the stand-in.  Returns (scene on ``device``,
    camera state)."""
    b = SceneBuilder()
    marry_obj, marry_mtl = (os.path.join(marry_dir or "", f)
                            for f in ("marry.obj", "Marry.mtl"))
    if marry_dir is not None and os.path.exists(marry_obj):
        from pnraytracing_tpu_torch.io import load_obj

        for mesh, mat, tex, name in load_obj(marry_obj):
            mat.setdefault("base_color", (0.8, 0.8, 0.8))
            b.add(mesh, mat, name=name, texture=tex)
    elif marry_dir is not None and os.path.exists(marry_mtl):
        # the MTL and its map_Kd texture alone (the reference loads the
        # same files through assimp, main.cpp:320-339) on stand-in geometry
        from pnraytracing_tpu_torch.io.obj import load_mtl, load_texture

        mtl = load_mtl(marry_mtl)
        body = mtl.get("MC003_Kozakura_Mari", {})
        tex = load_texture(body.pop("map_Kd", ""))
        body.setdefault("base_color", (0.8, 0.8, 0.8))
        b.add(shapes.teapot(), dict(body, roughness=0.55), name="marry",
              transform=compose(translate(0.1, 0, -0.5), scale(0.35)),
              texture=tex, texture_key="MC003_Kozakura_Mari")
        second = next((m for n, m in mtl.items()
                       if n != "MC003_Kozakura_Mari"), {})
        second.pop("map_Kd", None)
        second.setdefault("base_color", (0.9, 0.9, 0.9))
        b.add(shapes.icosphere(4), dict(second, metallic=0.3, roughness=0.35),
              name="sphere",
              transform=compose(translate(-1.4, 0.5, 0.3), scale(0.5)))
    else:
        b.add(shapes.teapot(),
              dict(base_color=(0.8, 0.8, 0.8), roughness=0.55),
              name="marry_standin",
              transform=compose(translate(0.1, 0, -0.5), scale(0.35)),
              texture=checkerboard(128, 16, (0.85, 0.6, 0.55),
                                   (0.4, 0.2, 0.2)))
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
    kernels; from ``subdiv=8`` on (1,638,404 triangles) it exceeds the
    packed layout's 2^20 triangles, has no traversal layout and renders
    over its plain BVH (route 'bvh').  Returns (scene on ``device``,
    camera state)."""
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
