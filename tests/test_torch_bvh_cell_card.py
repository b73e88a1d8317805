"""The benchmark's route-``bvh`` scene (``pnrt_bench/configs/
bunny_1m.json``: 1,372,164 triangles, past the packed layout) on the
card, and the walk counters of a capture's warm-up frame.  Marked
``gpu``: they skip where ``torch.cuda.is_available()`` is false (decided
inside the fixture, never at import).  On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_bvh_cell_card.py``.

* At 128x128, depth 8: the warm-up frame's counters (``walk.closest.*``
  / ``walk.shadow.*`` by bounce and tile, in the capture's ``counts``)
  equal the sums of the plain walk's per-ray stats
  (``accel/traverse.py::plain_closest_hit`` / ``plain_any_hit``) over
  the warm-up frame's own queries.
* At the deployed 2048x2048, depth 8: the captured graph's node count,
  phases and walk ordinals equal those of a capture whose warm-up
  counts nothing (the collecting test answered False), the launches are
  the configuration's route, and 16 replayed frames of both programs
  and the same frames run eagerly outside any ``collect()`` are equal by
  sha256.
"""

import hashlib
import json
import os
import types

import pytest
import torch

from test_torch_bvh_cell import _plain_counts

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = (2200000022 << 20) & 0xFFFFFFFF  # a bench seed's first frame


@pytest.fixture(scope="module")
def bunny_1m():
    """(scene, camera basis, config) built as the benchmark builds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnrt_bench import port
    from pnrt_bench.scenes import make_recipe

    with open(os.path.join(ROOT, "pnrt_bench", "configs",
                           "bunny_1m.json")) as f:
        config = json.load(f)
    dev = torch.device("cuda")
    recipe = make_recipe(config)
    scene = port.build_scene(recipe, dev, types.SimpleNamespace(setup={}))
    assert scene.trav is None
    cam = port.camera_state(recipe.camera).basis(device=dev)
    return scene, cam, config


def _cfg(config, **kw):
    from pnrt_bench import port

    return port.render_config(config, **kw)


def test_warmup_counters_equal_the_plain_walks_stats(bunny_1m,
                                                     monkeypatch):
    from pnraytracing_tpu_torch.accel import walks
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.utils import profiling

    scene, cam, config = bunny_1m
    cfg = _cfg(config, width=128, height=128, tile_pixels=1 << 13)
    calls = []

    def recorder(fn, kind):
        def call(*args, **kw):
            if not profiling.capturing():
                calls.append((kind, profiling._rec.bounce,
                              profiling._rec.tile, args, kw))
            return fn(*args, **kw)
        return call

    for name, kind in (("closest_hit_bvh", "closest"),
                       ("any_hit_bvh", "shadow")):
        monkeypatch.setattr(walks, name,
                            recorder(getattr(walks, name), kind))
    program.clear_programs()
    prog = program.frame_program(scene, cfg, "cuda")
    prog.capture(cam, START)
    torch.cuda.synchronize()
    # the warm-up frame alone asked for stats: 2 tiles x (1 + 2 x 8)
    assert len(calls) == 2 * (1 + 2 * cfg.max_depth)
    assert all(kw.get("with_stats") for *_, kw in calls)
    got = [(n, b, t, int(v.item() if torch.is_tensor(v) else v))
           for n, b, t, v in prog.counts if n.startswith("walk.")]
    assert got == _plain_counts(calls)
    pops = sum(v for n, _, _, v in got if n.endswith(".pops"))
    queries = sum(v for n, _, _, v in got if n.endswith(".queries"))
    assert pops > queries > 0
    program.clear_programs()


def test_counters_leave_the_graph_and_the_image(bunny_1m, monkeypatch):
    from pnraytracing_tpu_torch.accel import walks
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.renderer import render_average

    scene, cam, config = bunny_1m
    cfg = _cfg(config)
    sha = lambda x: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()

    def captured(count):
        program.clear_programs()
        prog = program.frame_program(scene, cfg, "cuda")
        with monkeypatch.context() as m:
            if not count:
                m.setattr(walks, "collecting", lambda: False)
            prog.capture(cam, START)
        img = render_average(scene, cam, cfg, START, 16)
        torch.cuda.synchronize()
        return prog, sha(img), float(img.mean())

    counted, img_counted, mean = captured(True)
    plain, img_plain, _ = captured(False)
    assert any(n.startswith("walk.") for n, *_ in counted.counts)
    assert not any(n.startswith("walk.") for n, *_ in plain.counts)
    assert counted.nodes is not None
    assert (counted.nodes, counted.phases, counted.walks) == (
        plain.nodes, plain.phases, plain.walks)
    assert counted.launches == plain.launches
    assert sorted(k for k, v in counted.launches.items() if v) == sorted(
        config["route"])
    assert img_counted == img_plain
    program.clear_programs()
    eager = render_average(scene, cam, cfg, START, 16, eager=True)
    assert sha(eager) == img_counted
    assert mean > 0.01
    print(f"bunny_1m 2048x2048 16 frames from {START}: nodes "
          f"{counted.nodes}, sha256 {img_counted}")
