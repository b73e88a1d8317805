"""The frame program's capture layout (``render/program.py``,
``utils/profiling.py``) on the card.  Marked ``gpu``: they skip where
``torch.cuda.is_available()`` is false (decided inside the fixture).  On
the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_profiling_card.py``.

For the flagship and a streamed scene, in one tile and in four:

* one profiled replay shows exactly ``nodes`` device operations; the
  phases' ranges tile ``[0, nodes)`` without overlap, in the frame's
  order; the walk kernels sit at the ``walks`` ordinals and nowhere else;
* ``launches`` equal an eager frame's launches, and the replayed image
  equals the eager frame bit for bit;
* the harness's split of a profiled stretch (``pnrt_bench/replays.py``)
  finds each replay, and the device ms of its phases add up to the union
  of its operations;
* the warm-up frame's counters equal an eager frame's;
* ``chip_smoke.profile_frame``'s idle share lies in [0, 1).
"""

import types

import pytest
import torch

from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.render.program import FrameProgram, launch_counts
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

CFG = dict(width=64, height=64, max_depth=3)
BOUNCE_PHASES = ["shade", "sort", "shadow", "next", "accumulate"]


@pytest.fixture(scope="module")
def scenes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnraytracing_tpu_torch.scene.scenes import (
        config3_teapot_night,
        config5_large,
    )

    out = {}
    for name, make in (("flagship", lambda: config3_teapot_night(
            env_height=64, device="cuda")),
                       ("config5", lambda: config5_large(5, device="cuda"))):
        scene, cam = make()
        out[name] = (scene, cam.basis(device="cuda"))
    return out


def _captured(scenes, case, tile_pixels):
    scene, cam = scenes[case]
    cfg = RenderConfig(tile_pixels=tile_pixels, **CFG)
    before = launch_counts()
    with profiling.collect() as eager_counts:
        eager = render_frame(scene, cam, cfg, 7, eager=True)
    eager_launches = {k: v - before[k] for k, v in launch_counts().items()}
    prog = FrameProgram(scene, cfg)
    prog.capture(cam, 7)
    return prog, eager, eager_launches, eager_counts.counts


@pytest.mark.parametrize("tile_pixels", [1 << 18, 1024])
@pytest.mark.parametrize("case", ["flagship", "config5"])
def test_capture_layout_matches_a_profiled_replay(scenes, case,
                                                  tile_pixels):
    from pnrt_bench import replays, tracing, yardstick

    profiling.reset()
    prog, eager, eager_launches, _ = _captured(scenes, case, tile_pixels)
    assert prog.launches == eager_launches
    trace = tracing.profile(lambda: (prog.graph.replay(), 1)[1],
                            prog.device)
    assert torch.equal(prog.image, eager)
    ops = sorted(trace.ops, key=lambda o: (o[1], o[2]))
    assert len(ops) == prog.nodes
    assert replays.tiles(prog.phases, prog.nodes)
    walks = [i for i, (n, _, _) in enumerate(ops) if yardstick.is_walk(n)]
    assert walks == prog.walks
    assert len(walks) == sum(v for k, v in prog.launches.items()
                             if k != "treelet_entry_key")
    tiles = 64 * 64 // min(tile_pixels, 64 * 64)
    want = [("camera", None, None)]
    for t in range(tiles):
        want += [("camera", None, t)] + [
            (p, b, t) for b in range(CFG["max_depth"])
            for p in BOUNCE_PHASES] + [("image", None, t)]
    assert [p[:3] for p in prog.phases] == want + [("image", None, None)]
    sizes = {p[:3]: p[4] for p in prog.phases}
    assert sizes[("sort", 0, 0)] > 0 and sizes[("sort", 2, 0)] == 0

    cap = profiling.record()["captures"][-1]
    assert (cap["nodes"], cap["phases"], cap["walks"]) == (
        prog.nodes, prog.phases, prog.walks)
    found = replays.replays(types.SimpleNamespace(trace=trace))
    assert found is not None and found[2] == [0]
    by_phase = sum(ops[i][2] - ops[i][1] for p in {p[0] for p in prog.phases}
                   for i in replays.ordinals(cap, p))
    assert by_phase == pytest.approx(tracing.union_length(ops), rel=0.01)


@pytest.mark.parametrize("case", ["flagship", "config5"])
def test_warmup_counts_equal_the_eager_frame(scenes, case):
    prog, _, _, eager_counts = _captured(scenes, case, 1024)
    number = lambda v: v.item() if isinstance(v, torch.Tensor) else v
    got = [(n, b, t, number(v)) for n, b, t, v in prog.counts]
    assert got == [(n, b, t, number(v)) for n, b, t, v in eager_counts]
    assert {(b, t): v for n, b, t, v in got if n == "rays.launched"} == {
        (b, t): 1024 for b in range(CFG["max_depth"]) for t in range(4)}
    live = [v for n, _, _, v in got if n == "rays.live"]
    assert sum(live) > 0 and max(live) <= 1024


def test_profile_frame_idle_is_a_share(scenes):
    """``chip_smoke.profile_frame`` over one replay: busy time is the
    union of the device operations, inside the profiled wall time."""
    from chip_smoke import profile_frame

    prog, _, _, _ = _captured(scenes, "flagship", 1 << 18)
    p = profile_frame(lambda: prog.graph.replay(), 1.0)
    assert 0 < p["device_busy_ms"] <= p["profiled_wall_ms"]
    assert 0 <= p["device_idle_share"] < 1
