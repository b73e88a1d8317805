"""Camera, pixel coordinates and the RNG stack: the port against the JAX
package.  Integer words (seeds, hashes, Sobol) and the floats made from
them must match exactly; camera vectors within rtol 1e-6 where XLA
contracts a*b + c into an FMA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.camera import camera_rays as jax_camera_rays
from pnraytracing_tpu.core.camera import make_camera as jax_make_camera
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.ops import sampling as jsmp
from pnraytracing_tpu.render.renderer import pixel_coords as jax_pixel_coords
from pnraytracing_tpu_torch.core.camera import camera_rays, make_camera
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.ops import sampling as smp
from pnraytracing_tpu_torch.render.renderer import pixel_coords
from tests.test_torch_scene import _torch_threads, port_camera  # noqa: F401

GRID = 64
FRAMES = (0, 1, 7, 4096, 123456789)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _grid():
    px, py = pixel_coords(RenderConfig(width=GRID, height=GRID),
                          device="cpu")
    jpx, jpy = jax_pixel_coords(JaxRenderConfig(width=GRID, height=GRID))
    return px, py, jpx, jpy


@pytest.mark.parametrize("w,h", [(64, 64), (24, 40)])
def test_pixel_coords_exact(w, h):
    px, py = pixel_coords(RenderConfig(width=w, height=h), device="cpu")
    jpx, jpy = jax_pixel_coords(JaxRenderConfig(width=w, height=h))
    np.testing.assert_array_equal(px.numpy(), _u32(jpx))
    np.testing.assert_array_equal(py.numpy(), _u32(jpy))


def test_make_camera_matches():
    args = ((0.0, 5.0, 5.0), (0.0, 0.8, 0.0), (0.0, 1.0, 0.0), 45.0, 1.25)
    a = jax_make_camera(*args)
    b = make_camera(*args, device="cpu")
    for f in ("eye", "lower_left", "horizontal", "vertical"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def test_camera_rays_match():
    jcam = jax_make_camera((3.47, 3.02, 3.55), (0.013, 0.8, 0.017),
                           (0, 1, 0), 45.0, 1.0)
    jo, jd, jt = jax_camera_rays(jcam, 48, 32)
    o, d, t = camera_rays(port_camera(jcam), 48, 32)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


@pytest.mark.parametrize("frame", FRAMES)
def test_pixel_seed_and_hash_stream_exact(frame):
    px, py, jpx, jpy = _grid()
    s = smp.pixel_seed(px, py, frame)
    js = jsmp.pixel_seed(jpx, jpy, jnp.uint32(frame))
    np.testing.assert_array_equal(s.numpy(), _u32(js))
    for _ in range(6):  # a bounce's worth of draws
        s, u = smp.rand01(s)
        js, ju = jsmp.rand01(js)
        np.testing.assert_array_equal(s.numpy(), _u32(js))
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(smp.wang_hash(s).numpy(),
                                  _u32(jsmp.wang_hash(js)))


@pytest.mark.parametrize("frame", FRAMES)
def test_sobol_and_rotation_exact(frame):
    px, py, jpx, jpy = _grid()
    for bounce in range(6):
        su, sv = smp.sobol_vec2(frame + 1, bounce)
        jsu, jsv = jsmp.sobol_vec2(jnp.uint32(frame) + jnp.uint32(1), bounce)
        assert np.float32(su) == np.asarray(jsu)
        assert np.float32(sv) == np.asarray(jsv)
        salt = (2 * bounce) // smp.SOBOL_DIMS
        r1, r2 = smp.cranley_patterson_rotation_c(su, sv, px, py, GRID, GRID,
                                                  salt=salt)
        jr1, jr2 = jsmp.cranley_patterson_rotation_c(
            jsu, jsv, jpx, jpy, GRID, GRID, salt=salt)
        np.testing.assert_array_equal(r1.numpy(), np.asarray(jr1))
        np.testing.assert_array_equal(r2.numpy(), np.asarray(jr2))


def test_sobol_table_exact():
    np.testing.assert_array_equal(smp.sobol_direction_table(),
                                  jsmp.sobol_direction_table())


def test_pick_light_and_triangle_sampling():
    rng = np.random.default_rng(0)
    areas = rng.uniform(0.1, 2.0, size=7).astype(np.float32)
    prefix = np.cumsum(areas).astype(np.float32)
    total = np.float32(prefix[-1])
    u = rng.uniform(size=4096).astype(np.float32)
    u[:3] = (0.0, 1.0, prefix[2] / total)  # ends and an exact boundary
    got = smp.pick_light(torch.from_numpy(prefix), torch.tensor(total),
                         torch.from_numpy(u))
    want = jsmp.pick_light(jnp.asarray(prefix), jnp.float32(total),
                           jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u2 = rng.uniform(size=4096).astype(np.float32)
    b0, b1 = smp.sample_uniform_triangle(torch.from_numpy(u),
                                         torch.from_numpy(u2))
    jb0, jb1 = jsmp.sample_uniform_triangle(jnp.asarray(u), jnp.asarray(u2))
    np.testing.assert_allclose(b0.numpy(), np.asarray(jb0), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(b1.numpy(), np.asarray(jb1), rtol=1e-6,
                               atol=1e-7)
