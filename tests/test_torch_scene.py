"""The port's host scene pipeline against the JAX package, bit for bit.

Both packages build the flagship teapot_night scene (and the golden test
scenes) from the same numpy code; every array the port keeps must equal
the JAX package's exactly.  Also holds the shared helpers of the
``test_torch_*`` files: the JAX scenes they compare against, carried
over to the port through ``convert.py``.
"""

import functools

import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.camera import make_camera as jax_make_camera
from pnraytracing_tpu.io.hdr import procedural_sky as jax_procedural_sky
from pnraytracing_tpu.scene import scenes as jax_scenes
from pnraytracing_tpu.scene import shapes as jax_shapes
from pnraytracing_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from pnraytracing_tpu.scene.scenes import (
    config3_teapot_night as jax_config3_teapot_night,
)
from pnraytracing_tpu.scene.transform import compose, rotate, translate
from pnraytracing_tpu_torch.convert import scene_from_arrays, scene_to_arrays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Camera
from pnraytracing_tpu_torch.io.hdr import procedural_sky
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

ENV_HEIGHT = 16


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two threads per test process: the suite runs under several
    workers, each of which would otherwise use every core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=1)
def jax_teapot_night():
    """(JAX scene, JAX camera state) of the flagship at ENV_HEIGHT."""
    return jax_config3_teapot_night(env_height=ENV_HEIGHT)


def port_camera(jax_camera) -> Camera:
    """A JAX Camera basis carried over to the port on the CPU."""
    return Camera(**{
        f: torch.from_numpy(np.array(getattr(jax_camera, f)))
        for f in ("eye", "lower_left", "horizontal", "vertical")})


def port_scene(jax_scene):
    return scene_from_arrays(scene_to_arrays(jax_scene), device="cpu")


# ---- the golden-test scenes, built by either package ----------------------

def _small_scene(b, sh):
    b.add(sh.cube(0.8), dict(base_color=(0.7, 0.3, 0.3), roughness=0.5),
          name="cube", transform=translate(0, 0.8, 0))
    b.add(sh.quad(6.0), dict(base_color=(0.7, 0.7, 0.7), roughness=0.9),
          name="floor")
    b.add(sh.quad(1.0), dict(emissive=(15.0, 15.0, 15.0)), name="light",
          transform=compose(translate(0, 5.0, 0), rotate(180, (0, 0, 1))))
    return dict(env_constant=(0.2, 0.25, 0.3))


def _sobol_env_scene(b, sh, sky):
    b.add(sh.icosphere(2), dict(base_color=(0.7, 0.6, 0.2), metallic=0.5,
                                roughness=0.3), name="ball")
    b.add(sh.quad(4.0), dict(base_color=(0.6, 0.6, 0.6), roughness=0.9),
          name="floor")
    return dict(env_image=sky(32, 64))


def build_golden_scene(name: str, port: bool):
    """``small`` (tests/test_render.py::small_scene) or ``sobol_env``
    (tests/test_golden.py), built by the port (on the CPU) or by the JAX
    package with its numpy BVH builder."""
    b = SceneBuilder() if port else JaxSceneBuilder()
    sh = shapes if port else jax_shapes
    sky = procedural_sky if port else jax_procedural_sky
    kw = _small_scene(b, sh) if name == "small" else _sobol_env_scene(
        b, sh, sky)
    if port:
        return b.build(device="cpu", **kw)
    return b.build(use_native_builder=False, **kw)


SMALL_CAMERA = dict(eye=(3.47, 3.02, 3.55), center=(0.013, 0.8, 0.017),
                    up=(0, 1, 0), fov_deg=45.0, aspect=1.0)


def small_scene_camera() -> Camera:
    return port_camera(jax_make_camera(**SMALL_CAMERA))


def _assert_leaves_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_teapot_night_scene_bit_exact():
    js, jcam = jax_teapot_night()
    # the environment follows one rule in both packages: the reference
    # HDR where the JAX package finds it, else the same procedural sky
    ps, pcam = config3_teapot_night(env_height=ENV_HEIGHT, device="cpu",
                                    hdr_path=jax_scenes.REFERENCE_HDR)
    a, b = scene_to_arrays(js), scene_to_arrays(ps)
    for key in ("trav.nodes16c", "trav.tri_attr16", "trav.treelets",
                "env.alias_fat", "env.alias_x", "env.alias_y",
                "env.quad12", "lights.prefix_area"):
        assert key in a
    _assert_leaves_equal(a, b)
    for f in ("eye", "center", "up"):
        np.testing.assert_array_equal(getattr(jcam, f), getattr(pcam, f))
    assert (jcam.fov_deg, jcam.aspect) == (pcam.fov_deg, pcam.aspect)


def test_teapot_night_sizes():
    ps, _ = config3_teapot_night(env_height=ENV_HEIGHT, device="cpu")
    assert ps.trav.tri9.shape == (5692, 9)
    assert ps.trav.nodes16c.shape == (2787, 16)
    assert ps.trav.treelets.shape == (375, 6)
    assert ps.bvh_depth == ps.trav.bvh_depth == 18
    assert ps.lights.count == 2
    assert ps.env.image.shape == (ENV_HEIGHT, 2 * ENV_HEIGHT, 3)


@pytest.mark.parametrize("name", ["small", "sobol_env"])
def test_golden_scenes_bit_exact(name):
    a = scene_to_arrays(build_golden_scene(name, port=False))
    b = scene_to_arrays(build_golden_scene(name, port=True))
    _assert_leaves_equal(a, b)


def test_scene_from_arrays_round_trip():
    js, _ = jax_teapot_night()
    leaves = scene_to_arrays(js)
    ps = scene_from_arrays(leaves, device="cpu")
    _assert_leaves_equal(leaves, scene_to_arrays(ps))
    _assert_leaves_equal(leaves, scene_to_arrays(ps.to("cpu")))
    assert ps.trav.bvh_depth == js.bvh_depth


def test_outside_the_slice_raises():
    """Compat mode, textures and the texture LOD are ported
    (tests/test_torch_compat.py, tests/test_torch_texture.py) and build;
    compat with the balanced estimator raises, as in the JAX package, and
    so does an unknown option."""
    b = SceneBuilder()
    b.add(shapes.triangle(), {}, texture=np.zeros((4, 4, 3), np.float32))
    assert RenderConfig(texture_lod_scale=0.01).texture_lod_scale == 0.01
    assert RenderConfig(compat_pnrt=True).compat_pnrt
    with pytest.raises(ValueError, match="reference estimator"):
        RenderConfig(compat_pnrt=True, mis="balanced")
    with pytest.raises(ValueError):
        RenderConfig(sampler="halton")
