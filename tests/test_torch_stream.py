"""The port's brick-streaming path and binary walk against the JAX
package, on the CPU (plain versions of the kernels).

* the brick layout (``build_stream_data``) and the binary rows
  (``nodes8``) equal the JAX package's array for array, and the two
  packages' default brick budgets and default layouts are the same;
* the plain stream walk (top tree and bricks in one near-first walk)
  against the plain resident wide walk on the same rays: the same ``t``
  bit for bit, the same occlusion, ``tri`` equal off exact-t ties; its
  bricks entered against the bricks a ray's ``t_max`` reaches; masked
  and empty batches; the stack check of a too-deep layout;
* the plain stream walks against ``closest_hit_stream`` /
  ``any_hit_stream`` and the plain binary walks against
  ``closest_hit_pallas(variant="binary")`` / ``any_hit_pallas``, both run
  by the Pallas interpreter as tests/test_stream.py and
  tests/test_pallas_trav.py run them;
* the port routes each scene the way the JAX integrator does, including
  the repaired interaction route of a scene whose attribute rows do not
  fit the budget;
* a frame on the stream route against the JAX package's stream route.

Bounds (tests/test_pallas_trav.py::_assert_hits_close): at most 2 tri
mismatches (exact-t ties resolve by visit order, which differs: the port
walks one stack per ray and enters each ray's bricks near first, the
Pallas kernel one stack and one brick queue per tile), t rtol 1e-6, b
rtol 1e-5
/ atol 1e-6; occlusion exact; frames within atol 3e-5 on all but 2
pixels (tests/test_torch_render.py).
"""

import dataclasses
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnraytracing_tpu.accel.traverse_pallas as jax_tp
from pnraytracing_tpu.accel.bricks import (
    build_stream_data as jax_build_stream_data,
)
from pnraytracing_tpu.accel.traverse_pallas import (
    any_hit_pallas,
    closest_hit_pallas,
)
from pnraytracing_tpu.accel.traverse_stream import (
    any_hit_stream as jax_any_hit_stream,
)
from pnraytracing_tpu.accel.traverse_stream import (
    closest_hit_stream as jax_closest_hit_stream,
)
from pnraytracing_tpu.core.camera import camera_rays as jax_camera_rays
from pnraytracing_tpu.core.camera import make_camera as jax_make_camera
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.render.renderer import render_frame as jax_render_frame
from pnraytracing_tpu.scene import shapes as jax_shapes
from pnraytracing_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from pnraytracing_tpu.scene.scenes import config5_large as jax_config5_large
from pnraytracing_tpu.scene.transform import compose, rotate, translate
from pnraytracing_tpu_torch.accel import route
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel import traverse_stream_cuda as trs
from pnraytracing_tpu_torch.accel.bricks import (
    BRICK_BUDGET_BYTES,
    build_stream_data,
)
from pnraytracing_tpu_torch.convert import scene_to_arrays
from pnraytracing_tpu_torch.core.camera import camera_rays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.render import integrator
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.scene.scenes import config5_large
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    _torch_threads,
    jax_teapot_night,
    port_camera,
    port_scene,
)
from tests.test_torch_traverse import (
    PALLAS,
    _assert_hits_close,
    _t,
    _v3,
    soup,
)

SMALL_BUDGET = 8 << 10  # bricks of the small scene (tests/test_stream.py)


def _lamp(b, sh):
    b.add(sh.quad(half=1.0), dict(emissive=(15.0, 15.0, 15.0)), name="lamp",
          transform=compose(translate(0, 5.0, 0), rotate(180, (0, 0, 1))))


def _small(b, sh):
    """tests/test_stream.py's scene: icosphere(3) + floor."""
    b.add(sh.icosphere(3, radius=1.0), dict(base_color=(0.7, 0.3, 0.2)),
          name="ball")
    b.add(sh.quad(half=4.0), dict(base_color=(0.6, 0.6, 0.6)), name="floor")
    return dict(env_constant=(0.3, 0.3, 0.3))


def _small_lit(b, sh):
    """The small scene with a lamp, so a frame also runs shadow rays."""
    _lamp(b, sh)
    return _small(b, sh)


def _two_balls(b, sh):
    """Two icosphere(4) (10,244 triangles with the floor and lamp): the
    binary and wide packings fit the budget, the attribute rows do not."""
    b.add(sh.icosphere(4), dict(base_color=(0.7, 0.3, 0.2), roughness=0.7),
          name="left", transform=translate(-1.2, 1.0, 0))
    b.add(sh.icosphere(4), dict(base_color=(0.8, 0.75, 0.6), roughness=0.6),
          name="right", transform=translate(1.2, 1.0, 0))
    b.add(sh.quad(half=4.0), dict(base_color=(0.6, 0.6, 0.6)), name="floor")
    _lamp(b, sh)
    return dict(env_constant=(0.2, 0.25, 0.3))


_SCENES = {"small": _small, "small_lit": _small_lit, "two_balls": _two_balls}


@functools.lru_cache(maxsize=3)
def jax_scene(name: str):
    """The JAX package's scene, built with its default BVH builder (the
    native one when g++ exists, as the port's: the numpy one may split
    ties differently)."""
    b = JaxSceneBuilder()
    return b.build(**_SCENES[name](b, jax_shapes))


def port_built(name: str):
    b = SceneBuilder()
    return b.build(device="cpu", **_SCENES[name](b, shapes))


@functools.lru_cache(maxsize=2)
def small_stream_scenes(name: str = "small"):
    """(JAX scene, port scene) of a small scene with an 8 KB brick layout,
    carried over through convert.py."""
    js = jax_scene(name)
    sd = jax_build_stream_data(js.bvh, js.mesh,
                               brick_budget_bytes=SMALL_BUDGET)
    js = js.replace(trav=js.trav.replace(stream=sd))
    return js, port_scene(js)


def _jax_config5_small():
    return jax_config5_large(3)[0]


def _assert_stream_equal(a, b):
    for f in ("top16", "bricks"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    for f in ("brick_words", "n_bricks", "n_top_rows", "brick_stack",
              "n_tris"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("name,budget", [("small", SMALL_BUDGET),
                                         ("config5", 16 << 10),
                                         ("config5", 96 << 10)])
def test_stream_layout_and_nodes8_match_jax(name, budget):
    if name == "small":
        js, ps = jax_scene("small"), port_built("small")
    else:
        js, ps = (_jax_config5_small(),
                  config5_large(3, device="cpu")[0])
    np.testing.assert_array_equal(ps.trav.nodes8.numpy(),
                                  np.asarray(js.trav.nodes8))
    want = jax_build_stream_data(js.bvh, js.mesh, brick_budget_bytes=budget)
    got = build_stream_data(ps.bvh, ps.mesh, budget, device="cpu")
    _assert_stream_equal(got, want)
    assert got.n_bricks >= 2 and got.bricks.device.type == "cpu"


def _rays(n):
    cam = jax_make_camera((0.0, 1.2, 3.5), (0, 0, 0), (0, 1, 0), 55.0, 1.0)
    o, d, _ = jax_camera_rays(cam, n, n)
    return np.asarray(o), np.asarray(d)


@pytest.mark.parametrize("case", ["plain", "masked", "padded"])
def test_plain_stream_closest_matches_pallas(case):
    """tests/test_stream.py's three cases: 256 rays, 256 rays with every
    third masked, 100 rays (a padded tile) with 7 live."""
    js, ps = small_stream_scenes()
    o, d = _rays(10 if case == "padded" else 16)
    r = o.shape[0]
    t_max = np.full((r,), 1e7, np.float32)
    mask = (None if case == "plain" else
            np.arange(r) % 3 != 0 if case == "masked" else np.arange(r) < 7)
    want = jax_closest_hit_stream(
        js.trav, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        None if mask is None else jnp.asarray(mask), **PALLAS)
    got, stats = trs.closest_hit_stream(
        ps.trav, _v3(o), _v3(d), _t(t_max),
        None if mask is None else torch.from_numpy(mask), with_stats=True)
    _assert_hits_close(got, want, r)
    if mask is not None:
        assert (got.tri.numpy()[~mask] == -1).all()
    assert stats.shape == (4, r) and stats.dtype == torch.int32
    pops, leaf, tris, entered = (s.numpy() for s in stats)
    assert (pops >= leaf).all() and (tris >= leaf).all()
    assert (pops >= entered).all() and (entered[got.valid.numpy()] > 0).all()
    if case != "padded":  # the 7 live padded rays look at the sky
        assert got.valid.numpy().sum() >= 50


def test_plain_stream_any_matches_pallas():
    js, ps = small_stream_scenes()
    o, d = _rays(16)
    rng = np.random.default_rng(2)
    t_max = rng.uniform(0.5, 8.0, o.shape[0]).astype(np.float32)
    mask = np.arange(o.shape[0]) % 3 != 0
    want = jax_any_hit_stream(js.trav, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), jnp.asarray(mask),
                              **PALLAS)
    got = trs.any_hit_stream(ps.trav, _v3(o), _v3(d), _t(t_max),
                             torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().any() and not got.numpy()[~mask].any()

def _with_layout(ps, budget):
    """The port scene's traversal tables with a brick layout of ``budget``
    bytes (built whether or not the scene would route to it)."""
    sd = build_stream_data(ps.bvh, ps.mesh, budget, device="cpu")
    return dataclasses.replace(ps.trav, stream=sd)


@functools.lru_cache(maxsize=4)
def _layout_case(name: str, budget: int):
    ps = (config5_large(3, device="cpu")[0] if name == "config5"
          else port_built(name))
    return _with_layout(ps, budget)


def _walk_rays(kind: str, n: int = 256):
    """(o, d) [n, 3]: the camera's primary rays, or scattered ones from
    random points above the floor toward random directions."""
    if kind == "primary":
        return _rays(16)
    rng = np.random.default_rng(11)
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.05, 4, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


LAYOUTS = [("small", SMALL_BUDGET), ("two_balls", 16 << 10),
           ("config5", 16 << 10), ("config5", 64 << 10)]


@pytest.mark.parametrize("kind", ["primary", "scattered"])
@pytest.mark.parametrize("name,budget", LAYOUTS)
def test_plain_stream_walk_equals_resident_walk(name, budget, kind):
    """One tree, two packings: the stream walk finds the resident wide
    walk's closest t bit for bit (tri may differ only where t ties) and
    its occlusion exactly."""
    trav = _layout_case(name, budget)
    assert trav.stream.n_bricks >= 3
    o, d = _walk_rays(kind)
    r = o.shape[0]
    far = np.full((r,), 1e7, np.float32)
    got, stats = trs.closest_hit_stream(trav, _v3(o), _v3(d), _t(far),
                                        with_stats=True)
    want = trv.closest_hit(trav, _v3(o), _v3(d), _t(far))
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())
    same = got.tri.numpy() == want.tri.numpy()
    assert (~same).sum() <= 2
    for f in ("b1", "b2"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[same],
                                      getattr(want, f).numpy()[same])
    assert got.valid.numpy().sum() >= r // 8
    assert (stats[3].numpy()[got.valid.numpy()] >= 1).all()
    rng = np.random.default_rng(12)
    short = rng.uniform(0.3, 6.0, r).astype(np.float32)
    mask = torch.from_numpy(np.arange(r) % 4 != 0)
    occ = trs.any_hit_stream(trav, _v3(o), _v3(d), _t(short), mask)
    wocc = trv.any_hit(trav, _v3(o), _v3(d), _t(short), mask)
    np.testing.assert_array_equal(occ.numpy(), wocc.numpy())
    assert occ.numpy().any() and not occ.numpy().all()


def _bricks_within_t_max(stream, o, d, t_max):
    """[R] bricks whose boxes each ray reaches within t_max: the top
    tree walked against t_max alone, brick refs counted."""
    ray = trv.Rays.of(_v3(o), _v3(d), _t(t_max))
    r = o.shape[0]
    count = torch.zeros(r, dtype=torch.int64)
    stack = torch.zeros((r, stream.brick_stack), dtype=torch.int32)
    top = torch.ones(r, dtype=torch.int64)
    while True:
        idx = torch.nonzero(top > 0).squeeze(1)
        if idx.numel() == 0:
            return count.numpy()
        top[idx] -= 1
        row = stream.top16[stack[idx, top[idx]].long()]
        near, far, h_near, h_far = trv.order_children(ray, idx, row,
                                                      ray.t_max[idx])
        for c, h in ((far, h_far), (near, h_near)):
            count[idx] += (h & (c < 0)).long()
            trv.push(stack, top, idx, c, h & (c >= 0))


@pytest.mark.parametrize("name,budget", LAYOUTS[:3])
def test_closest_walk_enters_fewer_bricks_than_t_max_reaches(name, budget):
    """Near first and culled by t_best: a ray never enters more bricks
    than its t_max reaches, and over a batch it enters fewer."""
    trav = _layout_case(name, budget)
    o, d = _walk_rays("primary")
    far = np.full((o.shape[0],), 1e7, np.float32)
    _, stats = trs.closest_hit_stream(trav, _v3(o), _v3(d), _t(far),
                                      with_stats=True)
    entered = stats[3].numpy()
    reached = _bricks_within_t_max(trav.stream, o, d, far)
    assert (entered <= reached).all()
    assert 0 < entered.sum() < reached.sum()
    # any mode tests boxes against t_max: it enters those bricks, or
    # stops early at an occluder
    _, stats = trs.any_hit_stream(trav, _v3(o), _v3(d), _t(far),
                                  with_stats=True)
    assert (stats[3].numpy() <= reached).all()


def test_too_deep_layout_raises_on_the_card_only():
    """The kernel's stack holds 64 entries and the nested walk can need
    2 x brick_stack: the check raises for a CUDA call and lets the plain
    version (whose stack follows the layout) run."""
    s = _layout_case("small", SMALL_BUDGET).stream
    assert trs.walk_stack_depth(s) == 2 * s.brick_stack <= trv.KERNEL_STACK
    trs.check_walk_depth(s, torch.device("cuda"))
    ok = dataclasses.replace(s, brick_stack=trv.KERNEL_STACK // 2)
    trs.check_walk_depth(ok, torch.device("cuda"))
    deep = dataclasses.replace(s, brick_stack=trv.KERNEL_STACK // 2 + 1)
    with pytest.raises(ValueError, match="64-entry stack"):
        trs.check_walk_depth(deep, torch.device("cuda"))
    trs.check_walk_depth(deep, torch.device("cpu"))
    trav = dataclasses.replace(_layout_case("small", SMALL_BUDGET),
                               stream=deep)
    o, d = _rays(4)
    hit = trs.closest_hit_stream(trav, _v3(o), _v3(d),
                                 _t(np.full((16,), 1e7, np.float32)))
    assert hit.valid.numpy().any()


def test_default_budget_and_layout_equal_jax():
    """The port cuts bricks by the JAX package's default budget, so the
    default layouts are the same arrays."""
    jax_default = inspect.signature(jax_build_stream_data).parameters[
        "brick_budget_bytes"].default
    port_default = inspect.signature(build_stream_data).parameters[
        "brick_budget_bytes"].default
    assert port_default == BRICK_BUDGET_BYTES == jax_default == 256 << 10
    js = jax_config5_large(5)[0]
    ps = config5_large(5, device="cpu")[0]
    _assert_stream_equal(ps.trav.stream, js.trav.stream)
    _assert_stream_equal(build_stream_data(ps.bvh, ps.mesh, device="cpu"),
                         jax_build_stream_data(js.bvh, js.mesh))
    assert ps.trav.stream.n_bricks >= 2


@pytest.mark.parametrize("case", ["all_masked", "empty"])
def test_stream_walk_masked_and_empty_batches(case):
    trav = _layout_case("small", SMALL_BUDGET)
    o, d = _rays(4)
    if case == "empty":
        o, d = o[:0].copy(), d[:0].copy()
    r = o.shape[0]
    t_max = _t(np.full((r,), 1e7, np.float32))
    mask = torch.zeros(r, dtype=torch.bool)
    hit, stats = trs.closest_hit_stream(trav, _v3(o), _v3(d), t_max, mask,
                                        with_stats=True)
    assert hit.tri.shape == (r,) and stats.shape == (4, r)
    assert (hit.tri.numpy() == -1).all() and int(stats.sum()) == 0
    np.testing.assert_array_equal(hit.t.numpy(), t_max.numpy())
    occ, stats = trs.any_hit_stream(trav, _v3(o), _v3(d), t_max, mask,
                                    with_stats=True)
    assert occ.shape == (r,) and occ.dtype == torch.bool
    assert not occ.numpy().any() and int(stats.sum()) == 0


@pytest.mark.parametrize("seed", [3, 7])
def test_plain_binary_matches_pallas(seed):
    jtrav, ptrav, _, _, o, d, t_max = soup(seed=seed)
    want = closest_hit_pallas(jtrav, o, d, t_max, variant="binary", **PALLAS)
    got, stats = trv.closest_hit(ptrav, _v3(o), _v3(d), _t(t_max),
                                 variant="binary", with_stats=True)
    _assert_hits_close(got, want, 256)
    assert (got.tri.numpy() >= 0).sum() >= 10
    # the same tree walked wide: the same hits, about half the pops
    wide, wstats = trv.closest_hit(ptrav, _v3(o), _v3(d), _t(t_max),
                                   with_stats=True)
    np.testing.assert_array_equal(wide.tri.numpy(), got.tri.numpy())
    assert int(wstats[0].sum()) < int(stats[0].sum())
    short = np.full((256,), 4.0, np.float32)
    mask = np.arange(256) % 5 != 0
    want = any_hit_pallas(jtrav, o, d, jnp.asarray(short), jnp.asarray(mask),
                          variant="binary", **PALLAS)
    occ = trv.any_hit(ptrav, _v3(o), _v3(d), _t(short),
                      torch.from_numpy(mask), variant="binary")
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want))
    assert occ.numpy().any()


def jax_route(trav, kernel_interaction: bool) -> str:
    """The route render/integrator.py:358-384 takes for
    traversal='pallas'."""
    if jax_tp.scene_fits_smem(trav, "binary"):
        attr = (kernel_interaction and trav.tri_attr16 is not None
                and jax_tp.scene_fits_smem(trav, "wide_attr"))
        return "attr" if attr else "wide"
    return "stream" if trav.stream is not None else "packet"


@pytest.mark.parametrize("name,want", [("teapot", "attr"),
                                       ("two_balls", "wide"),
                                       ("config5", "stream")])
def test_route_matches_jax(name, want):
    if name == "teapot":
        js = jax_teapot_night()[0]
    elif name == "two_balls":
        js = jax_scene("two_balls")
    else:  # subdiv 5: 25,604 triangles, over the budget
        js = jax_config5_large(5)[0]
    ps = port_scene(js)
    for ki in (True, False):
        assert route.traversal_route(ps.trav, ki) == jax_route(js.trav, ki)
    assert route.traversal_route(ps.trav, True) == want
    for variant in ("wide", "binary"):
        if jax_tp.scene_fits_smem(js.trav, "binary"):
            assert route.pick_variant(ps.trav, variant) == \
                jax_tp.pick_variant(js.trav, variant)
        assert route._scene_bytes(ps.trav, variant) == \
            jax_tp._scene_bytes(js.trav, variant)
    if name == "config5":
        no_stream = dataclasses.replace(ps.trav, stream=None)
        with pytest.raises(NotImplementedError, match="packet"):
            route.traversal_route(no_stream, True)


def _count_calls(monkeypatch, names):
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(integrator, n)

        def wrapped(*a, _fn=fn, _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(integrator, n, wrapped)
    return calls


def test_attr_rows_over_budget_render_through_make_interaction(monkeypatch):
    """The repaired fault: on a ~10k-triangle scene the attribute rows do
    not fit, so the port renders with kernel_interaction=True through the
    resident closest hit + make_interaction, as the JAX package does, and
    never calls the attribute entry point."""
    js = jax_scene("two_balls")
    ps = port_scene(js)
    assert ps.trav.tri9.shape[0] == 10244
    assert route.scene_fits_smem(ps.trav, "binary")
    assert not route.scene_fits_smem(ps.trav, "wide_attr")

    def no_attr(*a, **k):
        raise AssertionError("the attribute entry point was called")
    monkeypatch.setattr(integrator, "closest_hit_attr", no_attr)
    calls = _count_calls(monkeypatch, ("closest_hit", "any_hit"))
    cam = jax_make_camera((0.0, 2.0, 5.0), (0, 0.8, 0), (0, 1, 0), 45.0, 1.0)
    cfg = dict(width=12, height=12, max_depth=2, sampler="hash")
    got = render_frame(ps, port_camera(cam), RenderConfig(**cfg), 0,
                       device="cpu")
    assert calls == {"closest_hit": 3, "any_hit": 2}
    want = np.asarray(jax_render_frame(
        js, cam, JaxRenderConfig(traversal="packet", **cfg), 0))
    assert_frame_close(got.numpy(), want)


def test_stream_route_frame_matches_jax(monkeypatch):
    """A 12x12 depth-2 frame on the stream route against the JAX
    package's stream route, both forced by patching the budget check
    (tests/test_stream.py:115-146)."""
    js, ps = small_stream_scenes("small_lit")
    monkeypatch.setattr(jax_tp, "scene_fits_smem", lambda *a, **k: False)
    monkeypatch.setattr(route, "scene_fits_smem", lambda *a, **k: False)
    calls = _count_calls(monkeypatch, ("closest_hit_stream", "any_hit_stream",
                                       "closest_hit", "any_hit",
                                       "closest_hit_attr"))
    cam = jax_make_camera((0.0, 1.2, 3.5), (0, 0, 0), (0, 1, 0), 55.0, 1.0)
    cfg = dict(width=12, height=12, max_depth=2, sampler="hash")
    got = render_frame(ps, port_camera(cam), RenderConfig(**cfg), 0,
                       device="cpu")
    assert calls == {"closest_hit_stream": 3, "any_hit_stream": 2,
                     "closest_hit": 0, "any_hit": 0, "closest_hit_attr": 0}
    want = np.asarray(jax_render_frame(
        js, cam, JaxRenderConfig(traversal="pallas", trav_tile=128, **cfg),
        0))
    assert_frame_close(got.numpy(), want)
    assert want.mean() > 0.05


def test_config5_large_builds_a_stream_layout():
    """config5_large at subdiv 5 (25,604 triangles) is over the budget:
    the port builds its stream layout, carries it through convert.py,
    and the plain stream walk agrees with the resident walk."""
    ps, cam = config5_large(5, device="cpu")
    s = ps.trav.stream
    assert ps.trav.tri9.shape[0] == 25604 and s is not None
    assert s.brick_words * 4 <= BRICK_BUDGET_BYTES and s.n_bricks > 1
    assert route.traversal_route(ps.trav, True) == "stream"
    leaves = scene_to_arrays(ps)
    assert int(leaves["stream.n_bricks"]) == s.n_bricks
    o, d, t_max = camera_rays(cam.basis(device="cpu"), 8, 8)
    comps = lambda a: V3(*(a[:, k].contiguous() for k in range(3)))
    o3, d3 = comps(o), comps(d)
    hit = trs.closest_hit_stream(ps.trav, o3, d3, t_max)
    ref = trv.closest_hit(ps.trav, o3, d3, t_max)
    np.testing.assert_array_equal(hit.tri.numpy(), ref.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), ref.t.numpy())
    assert hit.valid.numpy().mean() > 0.3
