"""The shade kernel (``csrc/shade.cu``, ``ops/shade.py``) on the card.
Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is false
(decided inside the fixtures, never at import).  On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_shade_card.py``.

* The kernel against its plain version (the integrator's torch code) on
  the path state of real frames of the benchmark's two scenes
  (``pnrt_bench/configs``: teapot_night 512x512, every bounce; one
  262,144-ray tile of bunny_class, its 13th, every bounce), with 30% of the
  lanes more made dead: every output of every live lane equal bit for
  bit, under each flag set (lights and environment, lights only,
  environment only, the hash sampler, balanced MIS, a textured base
  color) and each form of the draws (``compat_pnrt``; a map with its two
  alias tables and no fat rows, one without alias tables, one whose
  tables were built in the graph); the dead lanes' outputs zero and
  their seeds unchanged.
* A 16-frame ``render_average`` of both benchmark scenes through their
  captured programs (the kernel) equals the same frames run eagerly on
  the torch path, by sha256.  The torch path is taken by the dispatch
  rule itself: a light tensor that requires grad, under grad mode (the
  prefix areas, read only by ``searchsorted``, so autograd records
  nothing and the frame's values are those of a detached scene).
* Frames of those forms (compat, the alias tables, the CDFs) through
  the kernel equal the same frames on the torch path by sha256.
* The program's launches stay the configuration's route (the walk
  kernels); the shade kernel is noted once a bounce and tile in the
  capture (4 and 128) and launches nothing at a replay.
* ``render_rays_replay`` of ``trace_paths`` records equals the live
  frame up to the deferred environment sum, as on the CPU, and the
  replay through the kernel equals the replay on the gradient's torch
  path bit for bit.
"""

import dataclasses
import hashlib
import json
import os
import types

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEAD_SHARE = 0.3  # lanes made dead on top of the frame's own
START = (12345 << 20) & 0xFFFFFFFF  # the 16 frames' first, as a bench seed
BUNNY_TILE = 12  # of 16: rows 1536-1663 from the top, the floor and spheres


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


def _bench(name):
    """(scene, camera basis, cfg, config) of a benchmark configuration,
    built as the benchmark builds it."""
    from pnrt_bench import port
    from pnrt_bench.scenes import make_recipe

    with open(os.path.join(ROOT, "pnrt_bench", "configs",
                           f"{name}.json")) as f:
        config = json.load(f)
    dev = torch.device("cuda")
    recipe = make_recipe(config)
    scene = port.build_scene(recipe, dev, types.SimpleNamespace(setup={}))
    cam = port.camera_state(recipe.camera).basis(device=dev)
    return scene, cam, port.render_config(config), config


@pytest.fixture(scope="module")
def teapot():
    _need_card()
    return _bench("teapot_night")


@pytest.fixture(scope="module")
def bunny():
    _need_card()
    return _bench("bunny_class")


def _record_calls(scene, cam, cfg, tile):
    """The inputs of the integrator's kernel calls of tile ``tile`` (a
    bounce each) in one eager frame."""
    from pnraytracing_tpu_torch.render import integrator
    from pnraytracing_tpu_torch.render.renderer import render_frame

    real, calls, seen = integrator.shade_bounce, [], [0]
    first = tile * cfg.max_depth

    def call(*args, **kw):
        if first <= seen[0] < first + cfg.max_depth:
            calls.append(args)
        seen[0] += 1
        return real(*args, **kw)

    integrator.shade_bounce = call
    try:
        render_frame(scene, cam, cfg, START, eager=True)
    finally:
        integrator.shade_bounce = real
    assert len(calls) == cfg.max_depth
    return calls


@pytest.fixture(scope="module")
def recorded(teapot, bunny):
    out = {}
    for name, (scene, cam, cfg, _), tile in (("teapot", teapot, 0),
                                             ("bunny", bunny, BUNNY_TILE)):
        out[name] = _record_calls(scene, cam, cfg, tile)
    return out


def _no_env(scene):
    return dataclasses.replace(scene, env=None)


def _no_lights(scene):
    from pnraytracing_tpu_torch.core.types import Lights

    dev = scene.lights.tri_index.device
    return dataclasses.replace(scene, lights=Lights(
        tri_index=torch.zeros(0, dtype=torch.int32, device=dev),
        prefix_area=torch.zeros(0, dtype=torch.float32, device=dev),
        total_area=torch.zeros((), dtype=torch.float32, device=dev)))


def _alias_tables(scene):
    """The map without its fat rows (``diff/grad.py::apply_params``)."""
    return dataclasses.replace(scene, env=dataclasses.replace(
        scene.env, alias_fat=None))


def _cdf_env(scene):
    """The map without alias tables: the draw inverts the CDFs."""
    return dataclasses.replace(scene, env=dataclasses.replace(
        scene.env, alias_x=None, alias_y=None, alias_fat=None))


def _in_graph_env(scene):
    """The map's tables built in the graph (not contiguous)."""
    from pnraytracing_tpu_torch.ops.envmap import envmap_in_graph

    return dataclasses.replace(scene, env=envmap_in_graph(scene.env.image))


# (scene, flags, cfg changes, textured): each flag set and form of the
# kernel
CASES = {
    "teapot": ("teapot", None, {}, False),
    "lights_only": ("teapot", _no_env, {}, False),
    "env_only": ("teapot", _no_lights, {}, False),
    "hash_sampler": ("teapot", None, dict(sampler="hash"), False),
    "balanced": ("teapot", None, dict(mis="balanced"), False),
    "balanced_lights_only": ("teapot", _no_env, dict(mis="balanced"),
                             False),
    "textured": ("teapot", None, {}, True),
    "bunny_tile": ("bunny", None, {}, False),
    "compat": ("teapot", None, dict(compat_pnrt=True), False),
    "compat_hash": ("teapot", None, dict(compat_pnrt=True, sampler="hash"),
                    False),
    "alias_tables": ("teapot", _alias_tables, {}, False),
    "cdf_env": ("teapot", _cdf_env, dict(mis="balanced"), False),
    "in_graph_env": ("teapot", _in_graph_env, {}, False),
}


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _components(x):
    from pnraytracing_tpu_torch.core.vec import V3

    return [x.x, x.y, x.z] if isinstance(x, V3) else [x]


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_version(recorded, teapot, bunny, case):
    """Every output of every live lane bit for bit, each bounce; dead
    lanes zero with their seeds unchanged."""
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.ops.brdf import apply_compat_material_decode

    which, edit, changes, textured = CASES[case]
    scene, _, cfg, _ = teapot if which == "teapot" else bunny
    scene = edit(scene) if edit else scene
    cfg = dataclasses.replace(cfg, **changes)
    mat_tbl = scene.materials.sanitized()
    if cfg.compat_pnrt:
        mat_tbl = apply_compat_material_decode(mat_tbl)
    card_scene = dataclasses.replace(scene,
                                     env=shade.contiguous_env(scene.env))
    gen = torch.Generator(device="cuda").manual_seed(7)
    for args in recorded[which]:
        (_, _, irows, _, bounce, frame, active, pos, nrm, v_dir, mat_id,
         seed, px, py) = args
        r = active.shape[0]
        drop = torch.rand(r, generator=gen, device="cuda") < DEAD_SHARE
        active = active & ~drop
        dead = ~active
        assert float(dead.float().mean()) >= DEAD_SHARE
        assert int(active.sum()) > 100
        cdlin = (torch.rand((r, 3), generator=gen, device="cuda")
                 if textured else None)
        if bounce % 2 == 0:  # the frame word as a captured frame holds it
            frame = torch.tensor(frame, dtype=torch.int64, device="cuda")
        state = (cfg, bounce, frame, active, pos, nrm, v_dir, mat_id, seed,
                 px, py)
        before = shade.LAUNCHES["shade"]
        got = shade.shade_bounce(card_scene, shade.material_rows(
            mat_tbl, scene.materials), irows, *state, cdlin=cdlin)
        assert shade.LAUNCHES["shade"] == before + 1
        want = shade.shade_plain(
            scene, mat_tbl, irows, *state,
            texture=None if cdlin is None else (lambda _: cdlin))
        torch.cuda.synchronize()
        for name, g, w in zip(shade.OUTPUTS, got, want):
            assert (g is None) == (w is None), name
            if g is None:
                continue
            for k, (gc, wc) in enumerate(zip(_components(g),
                                             _components(w))):
                label = f"{case} bounce {bounce} {name}[{k}]"
                live = gc[active]
                bad = _bits(live) != _bits(wc[active])
                assert not bool(bad.any()), (
                    f"{label}: {int(bad.sum())} live lanes differ, max "
                    f"|d| {float((live - wc[active]).abs().max())}")
                if name == "seed":
                    assert torch.equal(gc[dead], seed[dead]), label
                else:
                    assert bool((gc[dead] == 0).all()), label


def _forced_torch_path(scene):
    """The scene with its prefix areas requiring grad: the dispatch rule
    sends every bounce to the torch path under grad mode."""
    lights = scene.lights
    return dataclasses.replace(scene, lights=dataclasses.replace(
        lights, prefix_area=lights.prefix_area.detach().clone()
        .requires_grad_()))


@pytest.mark.parametrize("which", ["teapot", "bunny"])
def test_program_average_equals_torch_path(teapot, bunny, which):
    """16 frames through the captured program (the kernel) against the
    same 16 frames eagerly on the torch path: equal by sha256.  The
    program launches its route's walks only, notes the shade kernel once
    a bounce and tile in its capture, and none at a replay."""
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.renderer import render_average
    from pnraytracing_tpu_torch.utils import profiling

    scene, cam, cfg, config = teapot if which == "teapot" else bunny
    program.clear_programs()
    tiles = cfg.width * cfg.height // cfg.tile_pixels
    prog = program.frame_program(scene, cfg, "cuda")
    with profiling.collect() as layout:
        prog.capture(cam, START)
    noted = [k for k, _ in layout.kernels if k == "shade"]
    assert len(noted) == cfg.max_depth * tiles  # 4 and 128
    assert sorted(k for k, v in prog.launches.items() if v) == sorted(
        config["route"])
    before = shade.LAUNCHES["shade"]
    got = render_average(scene, cam, cfg, START, 16)
    torch.cuda.synchronize()
    assert shade.LAUNCHES["shade"] == before  # replays launch nothing

    forced = _forced_torch_path(scene)
    assert torch.is_grad_enabled()
    assert not shade.shade_on_card(forced, "cuda")
    want = render_average(forced, cam, cfg, START, 16, eager=True)
    assert shade.LAUNCHES["shade"] == before  # the torch path
    assert not want.requires_grad
    sha = lambda x: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
    diff = (got - want).abs()
    assert sha(got) == sha(want), (
        f"{which}: {int((diff > 0).sum())} values differ, max "
        f"{float(diff.max())}")
    assert float(got.mean()) > 0.01
    program.clear_programs()


@pytest.mark.parametrize("form", ["compat", "alias_tables", "cdf_env"])
def test_frame_forms_equal_torch_path(teapot, form):
    """A 512x512 teapot frame of each form the benchmark's cells do not
    run, eager through the kernel, against the same frame on the torch
    path: equal by sha256, the kernel launched once a bounce."""
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.render.renderer import render_frame

    scene, cam, cfg, _ = teapot
    if form == "compat":
        cfg = dataclasses.replace(cfg, compat_pnrt=True)
    else:
        scene = (_alias_tables if form == "alias_tables" else _cdf_env)(
            scene)
    before = shade.LAUNCHES["shade"]
    got = render_frame(scene, cam, cfg, START, eager=True)
    assert shade.LAUNCHES["shade"] == before + cfg.max_depth
    want = render_frame(_forced_torch_path(scene), cam, cfg, START,
                        eager=True)
    assert shade.LAUNCHES["shade"] == before + cfg.max_depth
    torch.cuda.synchronize()
    sha = lambda x: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
    diff = (got - want.detach()).abs()
    assert sha(got) == sha(want.detach()), (
        f"{form}: {int((diff > 0).sum())} values differ, max "
        f"{float(diff.max())}")
    assert float(got.mean()) > 0.01


def test_replay_of_trace_equals_live_frame(teapot):
    """``render_rays_replay`` on ``trace_paths`` records (through the
    kernel) against the live frame: within the CPU test's bound (rtol =
    atol = 2e-6, fewer than 25% of values differing: the replay adds
    the escaped paths' environment after the loop); the replay through
    the kernel and on the gradient's torch path (the materials requiring
    grad) bit for bit."""
    from pnraytracing_tpu_torch.core.camera import camera_rays
    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.render.integrator import (
        render_rays,
        render_rays_replay,
        trace_paths,
    )
    from pnraytracing_tpu_torch.render.renderer import pixel_coords

    scene, cam, cfg, _ = teapot
    cfg = dataclasses.replace(cfg, width=128, height=128, max_depth=3,
                              kernel_interaction=False,
                              clamp_radiance=False)
    px, py = pixel_coords(cfg, "cuda")
    o, d, _ = camera_rays(cam, cfg.width, cfg.height)
    rays = (o, d, px, py)
    before = shade.LAUNCHES["shade"]
    live = render_rays(scene, *rays, 5, cfg)
    recs = trace_paths(scene, *rays, 5, cfg)
    replay = render_rays_replay(scene, *rays, 5, cfg, recs)
    assert shade.LAUNCHES["shade"] == before + 3 * cfg.max_depth
    params = dg.extract_params(scene, ("materials",))
    params = {k: v.detach() for k, v in params.items()}
    for f in dataclasses.fields(params["materials"]):
        getattr(params["materials"], f.name).requires_grad_()
    graded = dg.apply_params(scene, params)
    replay_t = render_rays_replay(graded, *rays, 5, cfg, recs)
    assert replay_t.requires_grad
    assert shade.LAUNCHES["shade"] == before + 3 * cfg.max_depth
    assert torch.equal(_bits(replay), _bits(replay_t.detach()))
    a, b = live.cpu().numpy(), replay.cpu().numpy()
    close = np.abs(a - b) <= 2e-6 + 2e-6 * np.abs(b)
    assert close.all(), float(np.abs(a - b).max())
    assert (a != b).mean() < 0.25
