"""The port's texture slice against the JAX package, on the CPU:

* ``build_atlas``: data, sizes and mip strip bit-identical to the JAX
  package's for textures of several sizes (odd ones too), with and
  without mips;
* ``fetch_base_color`` and ``fetch_base_color_trilinear`` (at LODs 0 to
  past the last level) against the JAX functions on uvs outside [0, 1)
  and untextured lanes: within atol 2e-7 (an ulp or two of values in
  [0, 1]: XLA contracts the lerps into FMAs, the port does not);
* ``config1_triangle`` and ``config4_marry`` (its stand-in branch):
  scene arrays bit-identical to the JAX builder's, textures and texture
  ids included, and a carried textured scene round-trips through
  ``convert.py``;
* frames of both scenes, and one ``texture_lod_scale`` frame, against
  the JAX ``render_frame`` at 16x16 (``traversal="packet"``;
  ``"pallas"``, in the interpreter, for the one-triangle scene, which
  the packet walk's 4-row leaf slice does not fit): at most 2 pixels
  outside atol 3e-5 (the golden tolerance, tests/test_golden.py:18);
  and the textures do show in the frame.  Depth 2 for config 1, depth 1
  for config 4: at depth 2 config 4's frame 0 has 5 such pixels (up to
  4.4e-4) with its textures taken out as well, on the same pixels, so
  the ulp-level shading differences of the two packages (FMA
  contraction, libm) grow there through the 25-unit lamp and the
  metallic sphere, not through the texture fetch.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.ops import texture as jax_texture
from pnraytracing_tpu.render.renderer import render_frame as jax_render_frame
from pnraytracing_tpu.scene import scenes as jax_scenes
from pnraytracing_tpu_torch.convert import scene_from_arrays, scene_to_arrays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.ops import texture
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.scene import scenes, shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    _assert_leaves_equal,
    _torch_threads,
    port_camera,
)

FETCH_ATOL = 2e-7


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
            for h, w in ((16, 16), (7, 12), (32, 9), (1, 5))]


@pytest.mark.parametrize("mips", [True, False])
def test_build_atlas_bit_exact(mips):
    imgs = _images()
    got = texture.build_atlas(imgs, mips=mips, device="cpu")
    want = jax_texture.build_atlas(imgs, mips=mips)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    assert got.sizes.dtype == torch.int32 and got.count == 4
    if mips:
        np.testing.assert_array_equal(got.mips.numpy(),
                                      np.asarray(want.mips))
        assert float(got.mips.abs().sum()) > 0
    else:
        assert got.mips is None and want.mips is None
    assert texture.build_atlas([], device="cpu") is None


def _lanes(n=4096, seed=1):
    rng = np.random.default_rng(seed)
    tid = rng.integers(-1, 4, n).astype(np.int32)
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:16] = [[0.0, 0.0], [1.0, 1.0], [0.5, 0.999999], [-1e-7, 1e-7]] * 4
    base = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return tid, uv, base


@functools.lru_cache(maxsize=1)
def _atlases():
    imgs = _images(3)
    return texture.build_atlas(imgs, device="cpu"), \
        jax_texture.build_atlas(imgs)


def test_fetch_base_color_matches_jax():
    atlas, jatlas = _atlases()
    tid, uv, base = _lanes()
    got = texture.fetch_base_color(atlas, torch.from_numpy(tid),
                                   torch.from_numpy(uv),
                                   torch.from_numpy(base)).numpy()
    want = np.asarray(jax_texture.fetch_base_color(
        jatlas, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(base)))
    np.testing.assert_allclose(got, want, rtol=0, atol=FETCH_ATOL)
    np.testing.assert_array_equal(got[tid < 0], base[tid < 0])
    assert np.abs(got[tid >= 0] - base[tid >= 0]).max() > 0.1


@pytest.mark.parametrize("lod", [0.0, 0.5, 1.3, 2.75, 4.0, 9.0])
def test_fetch_trilinear_matches_jax(lod):
    atlas, jatlas = _atlases()
    tid, uv, base = _lanes(seed=2)
    lods = np.full(tid.shape, lod, np.float32)
    lods[::7] = -1.0  # clamped to the base level
    got = texture.fetch_base_color_trilinear(
        atlas, torch.from_numpy(tid), torch.from_numpy(uv),
        torch.from_numpy(base), torch.from_numpy(lods)).numpy()
    want = np.asarray(jax_texture.fetch_base_color_trilinear(
        jatlas, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(base),
        jnp.asarray(lods)))
    np.testing.assert_allclose(got, want, rtol=0, atol=FETCH_ATOL)
    if lod == 0.0:  # LOD 0 is the bilinear fetch
        np.testing.assert_array_equal(got, texture.fetch_base_color(
            atlas, torch.from_numpy(tid), torch.from_numpy(uv),
            torch.from_numpy(base)).numpy())


SCENES = ("config1_triangle", "config4_marry")


@functools.lru_cache(maxsize=None)
def _scene_pair(name):
    """((JAX scene, JAX camera state), (port scene, port camera state)).
    Both packages build with their default BVH builder (the native one
    when g++ exists), as the catalog's do (tests/test_torch_catalog.py)."""
    return getattr(jax_scenes, name)(), getattr(scenes, name)(device="cpu")


@pytest.mark.parametrize("name", SCENES)
def test_textured_scene_bit_exact(name):
    (js, jcam), (ps, pcam) = _scene_pair(name)
    a, b = scene_to_arrays(js), scene_to_arrays(ps)
    _assert_leaves_equal(a, b)
    assert "textures.mips" in a and "textures.data" in a
    for f in ("eye", "center", "up"):
        np.testing.assert_array_equal(getattr(jcam, f), getattr(pcam, f))
    assert (jcam.fov_deg, jcam.aspect) == (pcam.fov_deg, pcam.aspect)
    tex = ps.mesh.texture_id
    assert ps.textures.count == (1 if name == "config1_triangle" else 2)
    assert int(tex.max()) == ps.textures.count - 1
    # the carried scene keeps its atlas
    back = scene_from_arrays(b, device="cpu")
    _assert_leaves_equal(scene_to_arrays(back), b)


def test_texture_key_shares_a_texture():
    checker = scenes.checkerboard(8, 2)
    b = SceneBuilder()
    b.add(shapes.quad(1.0), {}, name="a", texture=checker, texture_key="k")
    b.add(shapes.quad(2.0), {}, name="b", texture=checker * 0.5,
          texture_key="k")
    b.add(shapes.quad(3.0), {}, name="c", texture=checker)
    b.add(shapes.triangle(), {}, name="d")
    scene = b.build(device="cpu")
    assert scene.textures.count == 2
    ids = sorted(set(scene.mesh.texture_id.tolist()))
    assert ids == [-1, 0, 1]
    # the attribute rows carry the texture id too (kernel 1's fill)
    assert scene.trav.tri_attr16 is not None


_FRAMES = {"config1_triangle": dict(max_depth=2),
           "config4_marry": dict(max_depth=1),
           "config4_marry/lod": dict(max_depth=1, texture_lod_scale=0.02)}


@pytest.mark.parametrize("case", list(_FRAMES))
def test_textured_frame_matches_jax(case):
    name = case.split("/")[0]
    (js, jcam), (ps, _) = _scene_pair(name)
    size = dict(width=16, height=16, **_FRAMES[case])
    walk = "pallas" if name == "config1_triangle" else "packet"
    want = np.asarray(jax_render_frame(
        js, jcam.basis(), JaxRenderConfig(traversal=walk, **size), 0))
    got = render_frame(ps, port_camera(jcam.basis()), RenderConfig(**size),
                       0, device="cpu")
    assert_frame_close(got.numpy(), want)
    assert torch.isfinite(got).all() and want.mean() > 0.02
    # without its textures the scene renders otherwise
    plain = render_frame(dataclasses.replace(ps, textures=None),
                         port_camera(jcam.basis()), RenderConfig(**size), 0,
                         device="cpu")
    assert float((plain - got).abs().max()) > 0.05
    if "lod" in case:  # the mip levels change the image
        base = render_frame(ps, port_camera(jcam.basis()), RenderConfig(
            width=16, height=16, max_depth=1), 0, device="cpu")
        assert float((base - got).abs().max()) > 1e-3
