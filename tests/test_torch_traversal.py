"""``RenderConfig.traversal`` in the port, on the CPU: the four fields
the JAX package's config has for its walks (``traversal``, ``trav_tile``,
``trav_chunk``, ``trav_leaf_buffer``), the route each value takes
(``accel/route.py::traversal_route``), frames of every value against the
JAX package's frames of the same value, the frame program's cache key and
``scripts/render.py --traversal``.

Frames: 16x16 depth-2 ``render_rays`` of tests/test_torch_parallel.py's
scene (cube, floor, light; its ``w4`` layout carried over from the JAX
scene) and rays, held within atol 3e-5 (tests/test_golden.py) on all but
the rim pixels (tests/test_torch_parallel.py::rim_pixels: rays through a
triangle's rim that the two packages' walks place apart).  Values whose
interactions both come from ``make_interaction`` (all but the default
``pallas`` route with ``kernel_interaction``) agree within the port bit
for bit on this scene.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.render.integrator import (
    render_rays as jax_render_rays,
)
from pnraytracing_tpu_torch.accel.route import traversal_route
from pnraytracing_tpu_torch.core.config import TRAVERSALS, RenderConfig
from pnraytracing_tpu_torch.render import program
from pnraytracing_tpu_torch.render.integrator import render_rays
from pnraytracing_tpu_torch.scripts import render as cli
from tests.test_torch_parallel import CFG, JAX_CFG, rim_pixels, small_scene
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import _torch_threads, port_scene  # noqa: F401

JAX_TRAVERSALS = ("wide", "packed", "pop", "packet", "wide4", "pallas")


def test_config_fields_match_jax():
    """The four fields with the JAX package's defaults, but ``traversal``
    ('pallas' here, 'packed' there); every JAX value constructs, another
    raises ValueError."""
    port, jax_cfg = RenderConfig(), JaxRenderConfig()
    for f in ("trav_tile", "trav_chunk", "trav_leaf_buffer"):
        assert getattr(port, f) == getattr(jax_cfg, f), f
    assert (port.traversal, jax_cfg.traversal) == ("pallas", "packed")
    assert set(TRAVERSALS) == set(JAX_TRAVERSALS)
    for v in JAX_TRAVERSALS:
        cfg = RenderConfig(traversal=v, trav_tile=None, trav_chunk=4,
                           trav_leaf_buffer=8)
        assert cfg.traversal == v and cfg.trav_tile is None
    with pytest.raises(ValueError, match="traversal"):
        RenderConfig(traversal="bvh")


def test_route_of_each_value():
    """The route of each value; 'wide4' falls back to 'packed' without
    the 4-wide layout, as in the JAX package; any value takes 'bvh' on a
    scene outside the packed layout."""
    trav = port_scene(small_scene()[0]).trav
    assert trav.w4 is not None
    want = {"pallas": "attr", "packed": "packed", "pop": "pop",
            "packet": "packet", "wide": "wide_capped", "wide4": "wide4"}
    for v, route in want.items():
        assert traversal_route(trav, True, v) == route
        assert traversal_route(None, True, v) == "bvh"
    assert traversal_route(trav, False, "pallas") == "wide"
    no_w4 = dataclasses.replace(trav, w4=None)
    assert traversal_route(no_w4, True, "wide4") == "packed"
    with pytest.raises(ValueError):
        traversal_route(trav, True, "bvh")


_PORT_FRAMES = {}


def _port_frame(value, **kw):
    key = (value, tuple(sorted(kw.items())))
    if key not in _PORT_FRAMES:
        js, rays = small_scene()
        t = {k: torch.from_numpy(v.copy()) for k, v in rays.items()}
        cfg = dataclasses.replace(CFG, traversal=value, **kw)
        _PORT_FRAMES[key] = render_rays(port_scene(js), t["o"], t["d"],
                                        t["px"], t["py"], 0, cfg).numpy()
    return _PORT_FRAMES[key]


@pytest.mark.parametrize("value", JAX_TRAVERSALS)
def test_frame_matches_jax(value):
    """The port's frame under ``value`` against the JAX package's frame
    under the same value, outside the rim pixels."""
    js, rays = small_scene()
    want = np.asarray(jax_render_rays(
        js, *(jnp.asarray(rays[k]) for k in ("o", "d", "px", "py")), 0,
        dataclasses.replace(JAX_CFG, traversal=value)))
    got = _port_frame(value).copy()
    rim = rim_pixels()
    assert len(rim) <= 0.02 * len(rays["o"])
    got[rim] = want[rim]
    assert_frame_close(got.reshape(16, 16, 3), want.reshape(16, 16, 3),
                       max_off=0)
    assert want.mean() > 0.05
    if value != "pallas":  # one interaction route: the same image
        np.testing.assert_array_equal(
            _port_frame(value), _port_frame("pallas",
                                            kernel_interaction=False))


def test_program_cache_key_holds_traversal(monkeypatch):
    """Two configs that differ only in ``traversal`` get two programs;
    the same config gets the cached one (``frame_program``'s key holds
    ``cfg``; the program class is replaced, so no card is needed)."""
    made = []

    class Program:
        def __init__(self, scene, cfg, dev):
            made.append(cfg.traversal)

    monkeypatch.setattr(program, "FrameProgram", Program)
    program.clear_programs()
    scene = port_scene(small_scene()[0])
    try:
        a = program.frame_program(scene, CFG, "cpu")
        b = program.frame_program(scene, dataclasses.replace(
            CFG, traversal="wide4"), "cpu")
        assert a is not b and made == ["pallas", "wide4"]
        assert program.frame_program(scene, CFG, "cpu") is a
        assert made == ["pallas", "wide4"]
    finally:
        program.clear_programs()


def test_render_cli_traversal(tmp_path):
    """``--traversal`` takes the JAX script's six values into the
    config; its PNG equals that of the same config rendered in process;
    another value is refused."""
    from tests.test_torch_scripts import SMALL, reference_png
    from pnraytracing_tpu_torch.io.png import read_png_rgb

    out = str(tmp_path / "wide4.png")
    assert cli.main(["--cpu", "--scene", "cornell", *SMALL, "--traversal",
                     "wide4", "--out", out]) == 0
    want = reference_png(tmp_path, *cli.build_scene("cornell", 1.0,
                                                    device="cpu"),
                         traversal="wide4")
    np.testing.assert_array_equal(read_png_rgb(out), want)
    with pytest.raises(SystemExit):
        cli.main(["--cpu", "--traversal", "bvh", "--list"])
