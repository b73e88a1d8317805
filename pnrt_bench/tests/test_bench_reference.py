"""The reference against the program's CPU path (its plain versions of
the kernels) at 16x16, depth 2, on both configurations' scene
generators, and its light order against the program's light list."""

import json
import os

import numpy as np
import pytest
import torch

from pnrt_bench.reference import scene as rscene
from pnrt_bench.reference import tracer
from pnrt_bench.scenes import make_recipe
from pnrt_bench.tests.conftest import ROOT


def _config(name, **subdiv):
    with open(os.path.join(ROOT, "pnrt_bench", "configs",
                           f"{name}.json")) as f:
        cfg = json.load(f)
    for m in cfg["models"]:
        if m["name"] in subdiv:
            m["args"]["subdivisions"] = subdiv[m["name"]]
    return cfg


def _program_scene(recipe):
    from pnraytracing_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    for mesh, mat, name, xf in recipe.models:
        b.add(mesh, mat, name=name, transform=xf)
    return b.build(env_image=recipe.env, max_leaf_size=recipe.max_leaf_size,
                   device="cpu")


CASES = {"teapot_night": {}, "bunny_class": {"bunny_standin": 3,
                                             "chrome": 2, "matte": 2,
                                             "glossy": 2}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_the_program_on_the_cpu(name):
    from pnrt_bench import port
    from pnraytracing_tpu_torch.render.renderer import render_average

    cfg = _config(name, **CASES[name])
    cfg["env"]["sky"].update(height=64, width=128)
    recipe = make_recipe(cfg)
    scene = _program_scene(recipe)
    rc = port.render_config(cfg, width=16, height=16, max_depth=2)
    start = port.frames_start(987654321)
    got = render_average(scene, port.camera_state(recipe.camera).basis(
        device="cpu"), rc, start, 2, device="cpu").reshape(-1, 3)
    ref = rscene.build(recipe, "cpu")
    px, py = tracer.pixel_grid(16, 16, "cpu")
    want = tracer.render_pixels(ref, recipe.camera, dict(
        width=16, height=16, max_depth=2), px, py, [start, start + 1])
    diff = (got - want).abs().amax(-1)
    # rounding moves a pixel by ~1e-5; no path takes another turn here
    assert float(diff.max()) < 1e-3
    assert float((got - want).abs().mean()) < 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_light_order_is_the_programs(name):
    recipe = make_recipe(_config(name))
    scene = _program_scene(recipe)
    ref = rscene.build(recipe, "cpu")
    lit = scene.mesh.positions[scene.mesh.indices[
        scene.lights.tri_index.long()].long()]
    assert torch.equal(lit, ref.p[ref.light_tri])
    assert torch.equal(scene.lights.prefix_area, ref.prefix_area)


def test_alias_tables_sample_the_pdf():
    p = np.array([0.1, 0.0, 0.5, 0.4])
    prob, alias = rscene.alias_table(p)
    mass = np.zeros(4)
    for j in range(4):
        mass[j] += prob[j] / 4
        mass[alias[j]] += (1 - prob[j]) / 4
    np.testing.assert_allclose(mass, p, atol=1e-7)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import pnrt_bench.reference.tracer, pnrt_bench.reference.scene,"
            " pnrt_bench.reference.accel, pnrt_bench.reference.light_order\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('pnraytracing_tpu_torch', 'pnraytracing_tpu', 'jax', "
            "'jaxlib', 'flax')]\n"
            "assert not bad, bad\n" % ROOT)
    subprocess.run([sys.executable, "-c", code], check=True)
