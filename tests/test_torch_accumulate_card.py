"""The tail kernel of a bounce (``accumulate_bounce_kernel`` of
``csrc/shade.cu``, ``ops/shade.py::accumulate_bounce``) on the card.
Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is false
(decided inside the fixtures, never at import).  On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_accumulate_card.py``.

* The kernel against its plain version (``accumulate_plain``) on the
  path state of real frames (teapot_night of the benchmark at 512x512,
  every bounce; one 262,144-ray tile of bunny_class, every bounce; the
  textured config 4 stand-in), with 30% of the lanes more made dead:
  every output of every lane equal bit for bit, under each flag set and
  form (lights and environment, lights only, environment only, neither
  (a constant environment); the reference and the balanced MIS; a
  textured scene with LOD; ``rr_start=1``; ``max_radiance``; a map
  without quad rows; ``compat_pnrt``), and each dead lane's state passed
  through: radiance, throughput, surface and material unchanged,
  ``v_dir = -l_out``, not live.
* A captured teapot frame notes the kernel once a bounce and launches
  nothing at a replay, and its 16-frame ``render_average`` equals the
  same frames run eagerly on the torch path by sha256.
"""

import dataclasses
import hashlib
import os
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_shade_card import (  # noqa: E402
    BUNNY_TILE,
    DEAD_SHARE,
    START,
    _bench,
    _bits,
    _components,
    _forced_torch_path,
    _need_card,
    _no_env,
    _no_lights,
)


@pytest.fixture(scope="module")
def teapot():
    _need_card()
    return _bench("teapot_night")


@pytest.fixture(scope="module")
def bunny():
    _need_card()
    return _bench("bunny_class")


@pytest.fixture(scope="module")
def marry():
    """The textured config 4 stand-in (checkerboard textures, a lamp, a
    sky) at 256x256, depth 4, texture LOD on."""
    _need_card()
    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.scene import scenes

    scene, cam = scenes.config4_marry(device="cuda")
    cfg = RenderConfig(width=256, height=256, max_depth=4,
                       texture_lod_scale=2 * 0.4142 / 256)
    return scene, cam.basis(device="cuda"), cfg, None


def _neither(scene):
    """No area light and no map: a constant environment."""
    return dataclasses.replace(
        _no_lights(_no_env(scene)),
        env_constant=torch.tensor([0.3, 0.4, 0.5], device="cuda"))


def _no_quads(scene):
    """The map without its quad rows: the lookup reads the image."""
    return dataclasses.replace(scene, env=dataclasses.replace(
        scene.env, quad12=None))


# (scene, edit, cfg changes, tile): each flag set and form of the kernel
CASES = {
    "both": ("teapot", None, {}, 0),
    "both_balanced": ("teapot", None, dict(mis="balanced"), 0),
    "lights_only": ("teapot", _no_env, {}, 0),
    "lights_only_balanced": ("teapot", _no_env, dict(mis="balanced"), 0),
    "env_only": ("teapot", _no_lights, {}, 0),
    "env_only_balanced": ("teapot", _no_lights, dict(mis="balanced"), 0),
    "neither": ("teapot", _neither, dict(env_scale=1.5), 0),
    "neither_balanced": ("teapot", _neither, dict(mis="balanced"), 0),
    "rr_start": ("teapot", None, dict(rr_start=1), 0),
    "max_radiance": ("teapot", None, dict(max_radiance=0.5, rr_start=0),
                     0),
    "no_quad12": ("teapot", _no_quads, dict(mis="balanced"), 0),
    "compat": ("teapot", None, dict(compat_pnrt=True), 0),
    "textured_lod": ("marry", None, dict(mis="balanced", rr_start=2), 0),
    "textured": ("marry", None, dict(texture_lod_scale=None), 0),
    "bunny_tile": ("bunny", None, {}, BUNNY_TILE),
}


def _record_tail(scene, cam, cfg, tile):
    """The inputs of the integrator's tail-kernel calls of tile ``tile``
    (a bounce each) in one eager frame."""
    from pnraytracing_tpu_torch.render import integrator
    from pnraytracing_tpu_torch.render.renderer import render_frame

    real, calls, seen = integrator.accumulate_bounce, [], [0]
    first = tile * cfg.max_depth

    def call(*args):
        if first <= seen[0] < first + cfg.max_depth:
            calls.append(args)
        seen[0] += 1
        return real(*args)

    integrator.accumulate_bounce = call
    try:
        render_frame(scene, cam, cfg, START, eager=True)
    finally:
        integrator.accumulate_bounce = real
    assert len(calls) == cfg.max_depth
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_version(teapot, bunny, marry, case):
    """Every output of every lane bit for bit, each bounce; dead lanes'
    state passed through."""
    from pnraytracing_tpu_torch.core.vec import V3
    from pnraytracing_tpu_torch.ops import shade

    which, edit, changes, tile = CASES[case]
    scene, cam, cfg, _ = dict(teapot=teapot, bunny=bunny, marry=marry)[which]
    scene = edit(scene) if edit else scene
    cfg = dataclasses.replace(cfg, **changes)
    calls = _record_tail(scene, cam, cfg, tile)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for (card_scene, mat_rows, cfg_, bounce, env_const, path, l_out, weight,
         d_pdf, nee, cont) in calls:
        r = path.active.shape[0]
        drop = torch.rand(r, generator=gen, device="cuda") < DEAD_SHARE
        path = path._replace(active=path.active & ~drop)
        dead = ~path.active
        assert int(path.active.sum()) > 100
        before = shade.LAUNCHES["accumulate"]
        got = shade.accumulate_bounce(card_scene, mat_rows, cfg_, bounce,
                                      env_const, path, l_out, weight, d_pdf,
                                      nee, cont)
        assert shade.LAUNCHES["accumulate"] == before + 1
        want = shade.accumulate_plain(scene, cfg_, bounce, env_const, path,
                                      l_out, weight, d_pdf, nee, cont)
        torch.cuda.synchronize()
        for name, g, w in zip(shade.Path._fields, got, want):
            assert (g is None) == (w is None), name
            if g is None:
                continue
            for k, (gc, wc) in enumerate(zip(_components(g),
                                             _components(w))):
                bad = _bits(gc) != _bits(wc)
                assert not bool(bad.any()), (
                    f"{case} bounce {bounce} {name}[{k}]: "
                    f"{int(bad.sum())} lanes differ ({int((bad & dead).sum())}"
                    f" dead), max |d| {float((gc - wc).abs().max())}")
        # a dead lane passes its state through
        for name in ("lo", "c", "pos", "nrm", "mat_id"):
            for gc, ic in zip(_components(getattr(got, name)),
                              _components(getattr(path, name))):
                assert torch.equal(_bits(gc[dead]), _bits(ic[dead])), name
        assert torch.equal(_bits(got.v_dir.x), _bits(-l_out.x))
        assert not bool(got.active[dead].any())
        assert isinstance(got.lo, V3) and got.lo.x.is_contiguous()


def test_captured_frame_equals_torch_path(teapot):
    """16 teapot frames through the captured program (both kernels)
    against the same 16 frames eagerly on the torch path: equal by
    sha256; the tail kernel noted once a bounce at capture, none at a
    replay."""
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.renderer import render_average
    from pnraytracing_tpu_torch.utils import profiling

    scene, cam, cfg, _ = teapot
    program.clear_programs()
    prog = program.frame_program(scene, cfg, "cuda")
    with profiling.collect() as layout:
        prog.capture(cam, START)
    noted = [k for k, _ in layout.kernels if k == "accumulate"]
    assert len(noted) == cfg.max_depth
    before = shade.LAUNCHES["accumulate"]
    got = render_average(scene, cam, cfg, START, 16)
    torch.cuda.synchronize()
    assert shade.LAUNCHES["accumulate"] == before  # replays launch nothing

    forced = _forced_torch_path(scene)
    want = render_average(forced, cam, cfg, START, 16, eager=True)
    assert shade.LAUNCHES["accumulate"] == before  # the torch path
    sha = lambda x: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
    diff = (got - want).abs()
    assert sha(got) == sha(want), (
        f"{int((diff > 0).sum())} values differ, max {float(diff.max())}")
    assert float(got.mean()) > 0.01
    program.clear_programs()
