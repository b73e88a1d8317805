"""The slice as a whole: the port's ``render_frame`` on the CPU (plain
versions of every kernel) against the JAX package.

* the flagship teapot_night that the JAX package built, carried over by
  ``convert.scene_from_arrays``, at 32x32, depth 2, against the JAX
  ``render_frame`` with ``traversal="packet"`` (bit-identical to
  ``"pallas"``, traverse_pallas.py:26-30, without the interpreter), with
  ``kernel_interaction`` on and off;
* the JAX goldens (tests/golden/*.npz), their scenes rebuilt by the
  port's own SceneBuilder.

Bound: at most 2 pixels of a frame outside atol 3e-5 (the golden
tolerance, tests/test_golden.py:18).  The odd pixel differs where an
ulp-level change of a sampled direction (libm, FMA contraction) moves a
path across a triangle edge.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.render.renderer import render_frame as jax_render_frame
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.render.renderer import render, render_frame
from pnraytracing_tpu_torch.scene.scenes import _camera
from tests.test_torch_scene import (  # noqa: F401
    _torch_threads,
    build_golden_scene,
    jax_teapot_night,
    port_camera,
    port_scene,
    small_scene_camera,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def assert_frame_close(got: np.ndarray, want: np.ndarray, atol=3e-5,
                       max_off=2):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    off = np.abs(got - want).max(axis=-1) > atol
    assert off.sum() <= max_off, (
        f"{off.sum()} pixels outside atol {atol} (max diff "
        f"{np.abs(got - want).max()})")


TEAPOT = dict(width=32, height=32, max_depth=2)


@functools.lru_cache(maxsize=2)
def _jax_teapot_frame(**kw):
    js, jcam = jax_teapot_night()
    cfg = JaxRenderConfig(traversal="packet", **TEAPOT, **kw)
    return np.asarray(jax_render_frame(js, jcam.basis(), cfg, 0))


@pytest.mark.parametrize("kernel_interaction", [True, False])
def test_teapot_night_matches_jax(kernel_interaction):
    js, jcam = jax_teapot_night()
    cfg = RenderConfig(kernel_interaction=kernel_interaction, **TEAPOT)
    got = render_frame(port_scene(js), port_camera(jcam.basis()), cfg, 0,
                       device="cpu")
    want = _jax_teapot_frame()
    assert_frame_close(got.numpy(), want)
    assert want.mean() > 0.05  # the frame is lit


def test_teapot_night_balanced_rr_clamp_hash():
    """The other estimator options of the slice: balanced MIS, Russian
    roulette, the radiance clamp and the hash sampler."""
    kw = dict(mis="balanced", rr_start=1, max_radiance=4.0, sampler="hash")
    js, jcam = jax_teapot_night()
    got = render_frame(port_scene(js), port_camera(jcam.basis()),
                       RenderConfig(**TEAPOT, **kw), 3, device="cpu")
    js_cfg = JaxRenderConfig(traversal="packet", **TEAPOT, **kw)
    want = np.asarray(jax_render_frame(js, jcam.basis(), js_cfg, 3))
    assert_frame_close(got.numpy(), want)


@pytest.mark.parametrize("frame", [0, 5])
def test_golden_small_scene(frame):
    cfg = RenderConfig(width=32, height=32, max_depth=2, sampler="hash")
    got = render_frame(build_golden_scene("small", port=True),
                       small_scene_camera(), cfg, frame, device="cpu")
    want = np.load(os.path.join(GOLDEN, f"small_scene_f{frame}.npz"))["img"]
    assert_frame_close(got.numpy(), want)


def test_golden_sobol_env():
    scene = build_golden_scene("sobol_env", port=True)
    cam = _camera((0, 2, 4), (0, 0.5, 0), 45.0).basis(device="cpu")
    cfg = RenderConfig(width=24, height=24, max_depth=3, sampler="sobol")
    got = render_frame(scene, cam, cfg, 0, device="cpu")
    want = np.load(os.path.join(GOLDEN, "sobol_env_f0.npz"))["img"]
    assert_frame_close(got.numpy(), want)


def test_render_averages_frames_and_is_deterministic():
    scene = build_golden_scene("small", port=True)
    cam = small_scene_camera()
    cfg = RenderConfig(width=16, height=16, max_depth=2, sampler="hash",
                       tile_pixels=64)  # 4 tiles
    f0 = render_frame(scene, cam, cfg, 0, device="cpu")
    f1 = render_frame(scene, cam, cfg, 1, device="cpu")
    torch.testing.assert_close(
        render_frame(scene, cam, dataclasses.replace(cfg, tile_pixels=256),
                     0, device="cpu"), f0, rtol=0, atol=0)
    mean = render(scene, cam, cfg, spp=2, device="cpu")
    torch.testing.assert_close(mean, (f0 + f1) / 2.0, rtol=0, atol=0)
    assert float((f0 - f1).abs().max()) > 1e-4


def test_stack_depth_guard():
    scene = build_golden_scene("small", port=True)
    cfg = RenderConfig(width=8, height=8, stack_depth=scene.bvh_depth - 1)
    with pytest.raises(ValueError, match="stack_depth"):
        render_frame(scene, small_scene_camera(), cfg, 0, device="cpu")
