"""The benchmark's route-``bvh`` configuration (``pnrt_bench/configs/
bunny_1m.json``: a scene past the packed layout's 2^20 triangles) at a
CPU size, and the walk counters its warm-up frame hands the record.

* The recipe shrunk (the scan's icosphere at subdivision 3, the other
  three at 2: 2,244 triangles, sky 64x128, 16x16, depth 2) and forced outside the packed
  layout as a scene past 2^20 triangles is (``flat_bvh=True``, rendered
  with ``max_leaf_size`` = its triangle count): its route is ``bvh``,
  and the program's ``render_average`` of 2 frames agrees with the
  benchmark's plain reference (``pnrt_bench/reference``) to the
  tolerance of ``pnrt_bench/tests/test_bench_reference.py``.
* Inside a ``collect()`` an eager frame counts each walk's work
  (``walk.closest.*`` / ``walk.shadow.*``: pops, slab tests, triangle
  tests, live queries) by bounce and tile; the counts equal the sums of
  the plain walk's per-ray stats (``accel/traverse.py::
  plain_closest_hit`` / ``plain_any_hit(with_stats=True)``) over the
  same queries (the SAH tree walked without its layout, its leaves of
  at most 4 triangles as the deployed scene's); the frame equals the one
  rendered outside the ``collect()`` bit for bit, and a frame outside it
  asks no walk for its stats.
"""

import dataclasses
import json
import os

import pytest
import torch

from pnrt_bench import port
from pnrt_bench.reference import scene as rscene
from pnrt_bench.reference import tracer
from pnrt_bench.scenes import make_recipe
from pnraytracing_tpu_torch.accel import traverse as bvh_walk
from pnraytracing_tpu_torch.accel import walks
from pnraytracing_tpu_torch.accel.route import traversal_route
from pnraytracing_tpu_torch.render.renderer import (
    render_average,
    render_frame,
)
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBDIV = {"bunny_standin": 3, "chrome": 2, "matte": 2, "glossy": 2}
SIZE, DEPTH = 16, 2
START = port.frames_start(987654321)


def _config():
    with open(os.path.join(ROOT, "pnrt_bench", "configs",
                           "bunny_1m.json")) as f:
        cfg = json.load(f)
    for m in cfg["models"]:
        if m["name"] in SUBDIV:
            m["args"]["subdivisions"] = SUBDIV[m["name"]]
    cfg["env"]["sky"].update(height=64, width=128)
    return cfg


def _scene(recipe, flat: bool):
    b = SceneBuilder()
    for mesh, mat, name, xf in recipe.models:
        b.add(mesh, mat, name=name, transform=xf)
    return b.build(env_image=recipe.env, max_leaf_size=recipe.max_leaf_size,
                   flat_bvh=flat, device="cpu")


@pytest.fixture(scope="module")
def cell():
    """(config, recipe, {"flat": scene, "sah": scene}): the SAH scene is
    built with its layout and walked without it (``trav=None``), as a
    scene past the packed layout is; the flat one has no layout."""
    cfg = _config()
    recipe = make_recipe(cfg)
    scenes = {"flat": _scene(recipe, True),
              "sah": dataclasses.replace(_scene(recipe, False), trav=None)}
    return cfg, recipe, scenes


def _render_cfg(cfg, recipe, flat: bool, **kw):
    leaf = recipe.num_triangles if flat else recipe.max_leaf_size
    return port.render_config(cfg, width=SIZE, height=SIZE,
                              max_depth=DEPTH, max_leaf_size=leaf, **kw)


def test_configuration_is_the_deployed_scene():
    with open(os.path.join(ROOT, "pnrt_bench", "configs",
                           "bunny_1m.json")) as f:
        cfg = json.load(f)
    assert make_recipe(dict(cfg, models=[
        dict(m, args={**m["args"], "subdivisions": 0})
        if m["shape"] == "icosphere" else m for m in cfg["models"]])
    ).num_triangles == 4 * 20 + 4
    n = sum(20 * 4 ** m["args"]["subdivisions"] if m["shape"] == "icosphere"
            else 2 for m in cfg["models"])
    assert n == cfg["triangles"] == 1_372_164 > 1 << 20
    assert cfg["render"] == {"width": 2048, "height": 2048, "max_depth": 8}
    assert sorted(cfg["route"]) == ["any_hit_bvh", "closest_hit_bvh"]


def test_reference_matches_the_program_on_route_bvh(cell):
    cfg, recipe, scenes = cell
    scene = scenes["flat"]
    assert scene.trav is None
    rc = _render_cfg(cfg, recipe, True)
    assert traversal_route(scene.trav, rc.kernel_interaction,
                           rc.traversal) == "bvh"
    ref = rscene.build(recipe, "cpu")
    lit = scene.mesh.positions[scene.mesh.indices[
        scene.lights.tri_index.long()].long()]
    assert torch.equal(lit, ref.p[ref.light_tri])
    got = render_average(scene, port.camera_state(recipe.camera).basis(
        device="cpu"), rc, START, 2, device="cpu").reshape(-1, 3)
    px, py = tracer.pixel_grid(SIZE, SIZE, "cpu")
    want = tracer.render_pixels(ref, recipe.camera, dict(
        width=SIZE, height=SIZE, max_depth=DEPTH), px, py,
        [START, START + 1])
    diff = (got - want).abs().amax(-1)
    # rounding moves a pixel by ~1e-5; no path takes another turn here
    assert float(diff.max()) < 1e-3
    assert float((got - want).abs().mean()) < 1e-5


class _Walks:
    """Records each call of the plain-BVH walks (its
    arguments, the bounce and tile it counts under) and runs it."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name, kind in (("closest_hit_bvh", "closest"),
                           ("any_hit_bvh", "shadow")):
            monkeypatch.setattr(walks, name,
                                self._wrap(getattr(walks, name), kind))

    def _wrap(self, fn, kind):
        def call(*args, **kw):
            rec = profiling._rec
            self.calls.append((kind, rec.bounce, rec.tile, args, kw))
            return fn(*args, **kw)
        return call


def _plain_counts(calls):
    """``(name, bounce, tile, value)`` of the plain walk's stats over each
    recorded call's queries, in the integrator's order."""
    out = []
    for kind, bounce, tile, args, kw in calls:
        plain = (bvh_walk.plain_closest_hit if kind == "closest"
                 else bvh_walk.plain_any_hit)
        kw = {k: v for k, v in kw.items() if k != "with_stats"}
        _, stats = plain(*args, **kw, with_stats=True)
        mask = args[5]
        live = stats.shape[1] if mask is None else int(mask.sum())
        assert int(stats[0].sum()) >= live  # each live query pops the root
        sums = [int(v) for v in stats.sum(dim=1)] + [live]
        out += [(f"walk.{kind}.{n}", bounce, tile, v) for n, v in zip(
            walks.WALK_STATS + ("queries",), sums)]
    return out


def test_walk_counters_are_the_plain_walks_stats(cell, monkeypatch):
    cfg, recipe, scenes = cell
    scene = scenes["sah"]
    # two tiles, so the counters carry their tile
    rc = _render_cfg(cfg, recipe, False, tile_pixels=SIZE * SIZE // 2)
    assert traversal_route(scene.trav, rc.kernel_interaction,
                           rc.traversal) == "bvh"
    cam = port.camera_state(recipe.camera).basis(device="cpu")
    plain_image = render_frame(scene, cam, rc, START, device="cpu")
    walks = _Walks(monkeypatch)
    with profiling.collect() as c:
        image = render_frame(scene, cam, rc, START, device="cpu")
    assert torch.equal(image, plain_image)
    got = [(n, b, t, int(v)) for n, b, t, v in c.counts
           if n.startswith("walk.")]
    # per tile: the camera's closest hit, then each bounce's shadow and
    # continuation walks
    order = [(k, b, t) for t in (0, 1) for k, b in [("closest", None)] + [
        kb for b in range(DEPTH) for kb in (("shadow", b), ("closest", b))]]
    assert [(k, b, t) for k, b, t, _, _ in walks.calls] == order
    assert got == _plain_counts(walks.calls)
    assert sum(v for n, _, _, v in got if n.endswith(".pops")) > 0
    assert any(n == "rays.live" for n, _, _, _ in c.counts)

    walks.calls.clear()
    assert not profiling.collecting()
    assert torch.equal(render_frame(scene, cam, rc, START, device="cpu"),
                       plain_image)
    assert len(walks.calls) == len(order)
    assert not any("with_stats" in kw for *_, kw in walks.calls)
