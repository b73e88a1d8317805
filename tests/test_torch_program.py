"""The port's frame-as-a-program slice on the CPU, against the JAX package:

* the tensor form of the frame counter: ``pixel_seed``, ``sobol_vec2``
  and the Cranley-Patterson rotation with a 0-d tensor frame equal the
  int forms bit for bit and the JAX package's uint32 values, for frames
  0, 1, 2^31 - 1, 2^32 - 1 and 2^32 + 5 (which counts as 5);
* ``render_average`` against the JAX ``render_average`` (one compiled
  program there): at most 2 pixels outside atol 3e-5 (the golden
  tolerance, tests/test_golden.py:18); with a tensor start frame equal
  to the int one and to the eager sum of frames, bit for bit;
* ``AccumState`` / ``accum_add`` against the JAX values (exact), and
  ``accum_add`` keeps ``total``'s storage (tests/test_donation.py is the
  JAX counterpart);
* ``CameraState.orbit`` / ``pan`` / ``zoom_fov`` equal the JAX package's
  float64 host arithmetic exactly;
* the program cache (``render/program.py::frame_program``): keyed by the
  scene's tensors, bounded, clearable; a program refuses a scene that is
  not on its device.  The capture itself needs the card
  (tests/test_torch_cuda.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.camera import CameraState as JaxCameraState
from pnraytracing_tpu.core.camera import make_camera as jax_make_camera
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.ops import sampling as jax_sampling
from pnraytracing_tpu.render.renderer import AccumState as JaxAccumState
from pnraytracing_tpu.render.renderer import accum_add as jax_accum_add
from pnraytracing_tpu.render.renderer import (
    render_average as jax_render_average,
)
from pnraytracing_tpu_torch.core.camera import CameraState
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.ops import sampling
from pnraytracing_tpu_torch.render import program
from pnraytracing_tpu_torch.render.renderer import (
    AccumState,
    accum_add,
    render_average,
    render_frame,
)
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    SMALL_CAMERA,
    _torch_threads,
    build_golden_scene,
    jax_teapot_night,
    port_camera,
    port_scene,
    small_scene_camera,
)

M32 = 0xFFFFFFFF
FRAMES = [0, 1, 2**31 - 1, 2**32 - 1, 2**32 + 5]


def _frame_forms(f):
    """The int frame and its tensor forms (int64; int32 where it fits)."""
    forms = [f, torch.tensor(f, dtype=torch.int64)]
    if f < 2**31:
        forms.append(torch.tensor(f, dtype=torch.int32))
    return forms


@pytest.mark.parametrize("frame", FRAMES)
def test_pixel_seed_tensor_frame(frame):
    rng = np.random.default_rng(frame % 97)
    x = rng.integers(0, 4096, 64)
    y = rng.integers(0, 4096, 64)
    want = np.asarray(jax_sampling.pixel_seed(
        jnp.asarray(x, jnp.uint32), jnp.asarray(y, jnp.uint32),
        np.uint32(frame & M32))).astype(np.int64)
    for f in _frame_forms(frame):
        got = sampling.pixel_seed(torch.from_numpy(x), torch.from_numpy(y), f)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frame", FRAMES)
def test_sobol_vec2_tensor_frame(frame):
    """Bounces 0-5 (dimension pairs wrap at 8): the device form of the
    Sobol pair equals the host form and the JAX package's, bit for bit,
    and so does the rotated sample."""
    px = torch.arange(0, 40, dtype=torch.int64)
    py = torch.arange(40, 0, -1, dtype=torch.int64)
    for b in range(6):
        ju, jv = jax_sampling.sobol_vec2(np.uint32(frame & M32), b)
        want = (np.float32(ju), np.float32(jv))
        hu, hv = sampling.sobol_vec2(frame, b)
        assert (np.float32(hu), np.float32(hv)) == want
        jr = jax_sampling.cranley_patterson_rotation_c(
            ju, jv, jnp.asarray(px.numpy(), jnp.uint32),
            jnp.asarray(py.numpy(), jnp.uint32), 48, 40, salt=(2 * b) // 8)
        for f in _frame_forms(frame)[1:]:
            tu, tv = sampling.sobol_vec2(f, b)
            assert tu.dtype == torch.float32 and tu.shape == ()
            assert (tu.item(), tv.item()) == want
            r1, r2 = sampling.cranley_patterson_rotation_c(
                tu, tv, px, py, 48, 40, salt=(2 * b) // 8)
            np.testing.assert_array_equal(r1.numpy(), np.asarray(jr[0]))
            np.testing.assert_array_equal(r2.numpy(), np.asarray(jr[1]))


def test_tensor_frame_renders_the_int_frame():
    """A frame counted by a 0-d tensor (the captured program's input,
    the session's accumulation count) renders the int frame bit for bit,
    jittered primaries included, across the 2^32 wrap."""
    js, jcam = jax_teapot_night()
    ps, cam = port_scene(js), port_camera(jcam.basis())
    cfg = RenderConfig(width=16, height=16, max_depth=2, jitter_primary=True)
    for f in (3, 2**32 - 1):
        want = render_frame(ps, cam, cfg, f, device="cpu")
        for t in _frame_forms(f)[1:]:
            assert torch.equal(render_frame(ps, cam, cfg, t, device="cpu"),
                               want)
    assert torch.equal(render_frame(ps, cam, cfg, 2**32 + 3, device="cpu"),
                       render_frame(ps, cam, cfg, 3, device="cpu"))


def test_render_average_matches_jax():
    js = build_golden_scene("small", port=False)
    ps = build_golden_scene("small", port=True)
    size = dict(width=16, height=16, max_depth=2)
    jcam = small_scene_camera()
    want = np.asarray(jax_render_average(
        js, jax_make_camera(**SMALL_CAMERA),
        JaxRenderConfig(traversal="packet", **size), jnp.uint32(5), 3))
    cfg = RenderConfig(**size)
    got = render_average(ps, jcam, cfg, 5, 3, device="cpu")
    assert got.shape == (16, 16, 3)
    assert_frame_close(got.numpy(), want)
    # the tensor start frame, and the eager sum of frames, bit for bit
    assert torch.equal(render_average(ps, jcam, cfg, torch.tensor(5), 3,
                                      device="cpu"), got)
    acc = torch.zeros((16, 16, 3))
    for f in (5, 6, 7):
        acc = acc + render_frame(ps, jcam, cfg, f, device="cpu")
    assert torch.equal(got, acc / 3.0)


def test_accum_state_matches_jax():
    cfg = RenderConfig(width=8, height=6, max_depth=1)
    jcfg = JaxRenderConfig(width=8, height=6, max_depth=1)
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 1, (6, 8, 3)).astype(np.float32) for _ in range(3)]
    acc = AccumState.create(cfg, device="cpu")
    jacc = JaxAccumState.create(jcfg)
    assert acc.count.dtype == torch.int32 and acc.count.shape == ()
    ptr = acc.total.data_ptr()
    for img in imgs:
        acc = accum_add(acc, torch.from_numpy(img))
        jacc = jax_accum_add(jacc, jnp.asarray(img))
    assert acc.total.data_ptr() == ptr  # in place: the port's donation
    np.testing.assert_array_equal(acc.total.numpy(), np.asarray(jacc.total))
    assert int(acc.count) == int(jacc.count) == 3
    np.testing.assert_array_equal(acc.resolve().numpy(),
                                  np.asarray(jacc.resolve()))
    # the functional add leaves its input alone
    added = acc.add(torch.from_numpy(imgs[0]))
    jadded = jacc.add(jnp.asarray(imgs[0]))
    np.testing.assert_array_equal(added.total.numpy(),
                                  np.asarray(jadded.total))
    assert int(acc.count) == 3 and int(added.count) == 4
    reset = acc.reset()
    assert int(reset.count) == 0 and not bool(reset.total.any())
    np.testing.assert_array_equal(reset.resolve().numpy(),
                                  np.asarray(jacc.reset().resolve()))


def test_camera_interaction_matches_jax():
    kw = dict(eye=np.array([0.0, 5.0, 5.0]), center=np.array([0.0, 0.8, 0.0]),
              up=np.array([0.0, 1.0, 0.0]), fov_deg=45.0, aspect=1.5)
    cam, jcam = CameraState(**kw), JaxCameraState(**kw)
    ops = [("orbit", (10.0, 5.0)), ("pan", (0.7, -1.3)),
           ("zoom_fov", (-6.0,)), ("orbit", (-35.0, 60.0)),
           ("orbit", (0.0, 200.0)),  # too close to the pole: no move
           ("zoom_fov", (60.0,)),  # out of (1, 89): no change
           ("pan", (-2.0, 0.5)), ("zoom_fov", (2.5,))]
    for name, args in ops:
        getattr(cam, name)(*args)
        getattr(jcam, name)(*args)
        for f in ("eye", "center", "up"):
            np.testing.assert_array_equal(getattr(cam, f), getattr(jcam, f))
        assert cam.fov_deg == jcam.fov_deg
    assert cam.fov_deg == 41.5
    basis, jbasis = cam.basis(device="cpu"), jcam.basis()
    for f in ("eye", "lower_left", "horizontal", "vertical"):
        np.testing.assert_allclose(getattr(basis, f).numpy(),
                                   np.asarray(getattr(jbasis, f)),
                                   rtol=0, atol=2e-6)


class _FakeProgram:
    def __init__(self, scene, cfg, device):
        self.scene, self.cfg, self.device = scene, cfg, device


def test_program_cache_keys_and_bound(monkeypatch):
    """The cache keys a program by the scene's tensors (not the scene
    object), the cfg and the device; it keeps the
    PROGRAM_CACHE_SIZE most recently used and clears on demand."""
    monkeypatch.setattr(program, "FrameProgram", _FakeProgram)
    program.clear_programs()
    js, _ = jax_teapot_night()
    ps = port_scene(js)
    cfg = RenderConfig(width=16, height=16, max_depth=1)
    dev = torch.device("cuda", 0)
    a = program.frame_program(ps, cfg, dev)
    assert program.frame_program(dataclasses.replace(ps), cfg, dev) is a
    assert program.frame_program(ps, cfg, torch.device("cuda", 1)) is not a
    mats = dataclasses.replace(ps.materials,
                               base_color=ps.materials.base_color.clone())
    assert program.frame_program(dataclasses.replace(ps, materials=mats),
                                 cfg, dev) is not a
    for depth in (2, 3, 4):
        program.frame_program(ps, dataclasses.replace(cfg, max_depth=depth),
                              dev)
    assert len(program._programs) == program.PROGRAM_CACHE_SIZE == 4
    assert program.frame_program(ps, cfg, dev) is not a  # evicted
    program.clear_programs()
    assert not program._programs


def test_program_refuses_the_cpu():
    js, _ = jax_teapot_night()
    with pytest.raises(ValueError, match="CUDA device"):
        program.FrameProgram(port_scene(js), RenderConfig(), device="cpu")


def test_program_refuses_an_off_device_scene():
    """A captured frame reads the scene where it lies, so a scene that is
    not on the program's device is refused, not copied behind the
    caller's back (a copy would hide the caller's later in-place edits)."""
    js, _ = jax_teapot_night()
    with pytest.raises(ValueError, match="not on cuda:0"):
        program.FrameProgram(port_scene(js), RenderConfig(),
                             device=torch.device("cuda", 0))
