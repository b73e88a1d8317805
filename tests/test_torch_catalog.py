"""The port's untextured scene catalog against the JAX package.

* every scene's arrays, built by the port's ``SceneBuilder``, equal the
  JAX package's ``SceneBuilder`` gives, bit for bit (``cornell_box``
  with both centerpieces, ``scene_flat``, ``teapot_scene``,
  ``config2_teapot``, also with ``flat_bvh=True``, which has no
  traversal layout), and so do the camera states;
* ``cornell_box`` and ``config2_teapot`` frames, rendered by the port
  from its own scene, against the JAX ``render_frame`` with
  ``traversal="packet"`` at 16x16, depth 2: at most 2 pixels outside
  atol 3e-5 (the golden tolerance, tests/test_golden.py:18).  Both
  scenes have area lights and no environment image, so the shadow
  queries go through the lights-only any-hit launch.
"""

import functools

import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.render.renderer import render_frame as jax_render_frame
from pnraytracing_tpu.scene import scenes as jax_scenes
from pnraytracing_tpu_torch.convert import scene_to_arrays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.scene import scenes
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    _assert_leaves_equal,
    _torch_threads,
    port_camera,
)

SCENES = {
    "cornell_teapot": ("cornell_box", {}),
    "cornell_sphere": ("cornell_box", dict(centerpiece="sphere")),
    "flat": ("scene_flat", {}),
    "teapot": ("teapot_scene", {}),
    "config2": ("config2_teapot", {}),
}


@functools.lru_cache(maxsize=None)
def jax_scene(name):
    """(JAX scene, JAX camera state), built with its default BVH builder
    (the native one when g++ exists, as the port's)."""
    fn, kw = SCENES[name]
    out, cam = getattr(jax_scenes, fn)(**kw)
    if fn == "config2_teapot":
        return out, cam
    return out.build(), cam


@functools.lru_cache(maxsize=None)
def port_scene_of(name):
    fn, kw = SCENES[name]
    if fn == "config2_teapot":
        return scenes.config2_teapot(device="cpu", **kw)
    b, cam = getattr(scenes, fn)(**kw)
    return b.build(device="cpu"), cam


@pytest.mark.parametrize("name", list(SCENES))
def test_catalog_scene_bit_exact(name):
    js, jcam = jax_scene(name)
    ps, pcam = port_scene_of(name)
    _assert_leaves_equal(scene_to_arrays(js), scene_to_arrays(ps))
    for f in ("eye", "center", "up"):
        np.testing.assert_array_equal(getattr(jcam, f), getattr(pcam, f))
    assert (jcam.fov_deg, jcam.aspect) == (pcam.fov_deg, pcam.aspect)
    assert ps.lights.count > 0 or name == "teapot"
    assert ps.env is None
    assert (ps.env_constant is not None) == (name == "config2")


def test_catalog_builders_and_aspect():
    b, cam = scenes.cornell_box(aspect=1.5)
    assert [e.name for e in b.entries] == [
        "teapot", "floor", "front_wall", "right_wall", "left_wall",
        "ceiling", "ceiling_light"]
    assert cam.aspect == 1.5
    assert scenes.scene_flat(aspect=2.0)[1].aspect == 2.0
    # the flat config 2: one leaf of every triangle, outside the packed
    # layout (trav None, walked over the plain BVH), the JAX flat scene's
    # arrays bit for bit
    flat, _ = scenes.config2_teapot(flat_bvh=True, device="cpu")
    jflat, _ = jax_scenes.config2_teapot(flat_bvh=True)
    assert flat.trav is None and jflat.trav is None
    assert flat.bvh.end.tolist() == [flat.mesh.indices.shape[0]]
    _assert_leaves_equal(scene_to_arrays(jflat), scene_to_arrays(flat))


@pytest.mark.parametrize("name", ["cornell_teapot", "config2"])
def test_catalog_frame_matches_jax(name):
    js, jcam = jax_scene(name)
    ps, _ = port_scene_of(name)
    size = dict(width=16, height=16, max_depth=2)
    want = np.asarray(jax_render_frame(
        js, jcam.basis(), JaxRenderConfig(traversal="packet", **size), 0))
    got = render_frame(ps, port_camera(jcam.basis()), RenderConfig(**size),
                       0, device="cpu")
    assert_frame_close(got.numpy(), want)
    assert want.mean() > 0.02
    assert torch.isfinite(got).all()
