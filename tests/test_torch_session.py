"""The port's ``RenderSession`` against the JAX session, case by case as
tests/test_session.py holds the JAX one: accumulation, the interaction
reset and 1-bounce preview, the material edit, the checkpoint round trip
and the stats; then checkpoints crossing between the packages (a JAX
checkpoint loads in the port and the next steps agree, and the other way
round).

Both sessions render the scene the JAX package built (carried over by
``convert.py``) at 16x16, depth 2, with the hash sampler; the JAX one
walks with ``traversal="packet"`` (the pallas walk's results without the
interpreter).  Images: at most 2 pixels outside atol 3e-5 (the golden
tolerance, tests/test_golden.py:18); counts, materials and camera states
exactly.
"""

import functools

import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.render.session import RenderSession as JaxSession
from pnraytracing_tpu.scene import shapes as jax_shapes
from pnraytracing_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from pnraytracing_tpu.scene.scenes import _camera as jax_camera
from pnraytracing_tpu.scene.transform import compose, rotate, translate
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.render.session import RenderSession
from pnraytracing_tpu_torch.scene.scenes import _camera
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import _torch_threads, port_scene  # noqa: F401

SIZE = dict(width=16, height=16, max_depth=2, sampler="hash")


@functools.lru_cache(maxsize=1)
def _jax_scene():
    """tests/test_session.py's scene, built by the JAX package."""
    b = JaxSceneBuilder()
    b.add(jax_shapes.cube(0.8), dict(base_color=(0.7, 0.3, 0.3),
                                     roughness=0.5),
          name="cube", transform=translate(0, 0.8, 0))
    b.add(jax_shapes.quad(half=1.0), dict(emissive=(10.0, 10.0, 10.0)),
          name="light",
          transform=compose(translate(0, 4, 0), rotate(180, (0, 0, 1))))
    return b.build(env_constant=(0.2, 0.2, 0.25), use_native_builder=False)


def make_sessions():
    """(port session, JAX session) over the same scene and camera."""
    js = _jax_scene()
    pose = ((3, 3, 3), (0, 0.8, 0), 45.0)
    port = RenderSession(port_scene(js), _camera(*pose),
                         RenderConfig(**SIZE), device="cpu")
    jax = JaxSession(js, jax_camera(*pose),
                     JaxRenderConfig(traversal="packet", **SIZE))
    return port, jax


def _close(img, jimg):
    assert_frame_close(img.numpy(), np.asarray(jimg))


def _same_state(s, js):
    assert int(s.accum.count) == int(js.accum.count)
    assert s.interacting == js.interacting
    for f in ("eye", "center", "up"):
        np.testing.assert_array_equal(getattr(s.camera, f),
                                      getattr(js.camera, f))
    assert s.camera.fov_deg == js.camera.fov_deg


def test_progressive_accumulation_advances():
    s, js = make_sessions()
    for _ in range(3):
        _close(s.step(), js.step())
        _same_state(s, js)
    assert int(s.accum.count) == 3
    assert s.accum.count.dtype == torch.int32
    _close(s.accum.total, js.accum.total)


def test_interaction_resets_and_previews():
    s, js = make_sessions()
    s.step(), js.step()
    s.step(), js.step()
    for obj in (s, js):
        obj.orbit(10, 5)
        obj.pan(0.4, -0.2)
        obj.zoom(-5.0)
    _same_state(s, js)
    assert int(s.accum.count) == 0  # reset (main.cpp:596)
    assert s.preview_cfg.max_depth == 1 and not s.preview_cfg.compact_rays
    _close(s.step(), js.step())  # the preview frame: not accumulated
    assert int(s.accum.count) == 0
    _close(s.step(), js.step())  # converged mode resumes
    assert int(s.accum.count) == 1
    _same_state(s, js)


def test_material_edit_patches_scene():
    s, js = make_sessions()
    base = s.scene.materials.base_color
    s.step(), js.step()
    for obj in (s, js):
        obj.edit_material(0, base_color=(0.1, 0.9, 0.1), roughness=0.2)
    assert int(s.accum.count) == 0
    assert s.scene.materials.base_color is base  # written in place
    for k in ("base_color", "roughness"):
        np.testing.assert_array_equal(
            getattr(s.scene.materials, k).numpy(),
            np.asarray(getattr(js.scene.materials, k)))
    # the caller's scene keeps its materials
    assert float(port_scene(_jax_scene()).materials.roughness[0]) == 0.5
    _close(s.step(), js.step())
    _close(s.step(), js.step())


def test_checkpoint_roundtrip(tmp_path):
    s, _ = make_sessions()
    s.step()
    s.step()
    s.edit_material(1, emissive=(12.0, 11.0, 10.0))
    s.step()
    s.step()
    img_before = s.accum.resolve().clone()
    path = str(tmp_path / "ckpt.npz")
    s.save(path)

    s2, _ = make_sessions()
    s2.load(path)
    assert int(s2.accum.count) == 1
    assert torch.equal(s2.accum.resolve(), img_before)
    assert torch.equal(s2.scene.materials.emissive,
                       s.scene.materials.emissive)
    # stepping after the restore continues the same stream
    assert torch.equal(s.step(), s2.step())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint of one package's session loads in the other's: the
    same npz keys, accumulation, camera and materials, and the next steps
    agree."""
    s, js = make_sessions()
    for obj in (s, js):
        obj.step()
        obj.orbit(-20, 10)
        obj.step()
        obj.step()
        obj.edit_material(0, base_color=(0.2, 0.3, 0.8), metallic=0.4)
        obj.step()
        obj.step()
    path = str(tmp_path / f"{writer}.npz")
    (js if writer == "jax" else s).save(path)
    r, jr = make_sessions()
    (r if writer == "jax" else jr).load(path)
    src, dst = ((js, r) if writer == "jax" else (s, jr))
    keys = set(np.load(path).files)
    assert {"total", "count", "eye", "center", "up", "fov", "aspect",
            "mat_base_color"} <= keys and len(keys) == 21
    _same_state(src, dst)
    if writer == "jax":
        np.testing.assert_array_equal(r.accum.total.numpy(),
                                      np.asarray(js.accum.total))
        _close(r.step(), js.step())
        _close(r.step(), js.step())
    else:
        np.testing.assert_array_equal(np.asarray(jr.accum.total),
                                      s.accum.total.numpy())
        _close(s.step(), jr.step())
        _close(s.step(), jr.step())


def test_stats_populated():
    s, _ = make_sessions()
    s.step()
    assert s.stats.frames == 1
    assert s.stats.last_frame_ms > 0
    assert s.stats.rays_per_s == pytest.approx(
        16 * 16 * 7 / (s.stats.last_frame_ms / 1e3))
