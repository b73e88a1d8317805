"""The interaction fill kernel (``interaction_kernel`` of
``csrc/shade.cu``, ``ops/shade.py::fill_interaction``) on the card.
Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is false
(decided inside the fixtures, never at import).  On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_interaction_card.py``.

* The kernel against its plain version (``render/integrator.py::
  make_interaction``) on the hits of real frames: one 262,144-ray tile
  of bunny_class (route ``stream``) and of bunny_1m (route ``bvh``), its
  camera fill and every bounce's.  All six outputs of every lane equal
  bit for bit: hit lanes, missed lanes (``tri`` -1 reads row 0) and the
  masked lanes of the ``next`` phase, and under edits that reach each
  branch: a zero corner normal (the geometric normal stands in), corner
  normals turned inside out (the backface flip), rays reversed (the
  re-test misses: the hit's barycentrics are kept), lanes made misses.
* An eager frame launches the kernel 1 + depth times a tile (144 at
  2048x2048, depth 8); a capture notes it as often and a replay launches
  none; the 16-frame ``render_average`` of both scenes through their
  captured programs equals the same frames run eagerly on the torch path
  (``make_interaction`` and the other plain versions) by sha256.
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
    START,
    _bench,
    _bits,
    _components,
    _forced_torch_path,
    _need_card,
)

ROUTES = {"bunny": "stream", "bunny_1m": "bvh"}
EDIT_SHARE = 0.3  # lanes an edit reaches


@pytest.fixture(scope="module")
def scenes():
    _need_card()
    return {"bunny": _bench("bunny_class"), "bunny_1m": _bench("bunny_1m")}


def _clone(hit, ray_d, ray_o, rows):
    from pnraytracing_tpu_torch.ops.intersect import Hit

    return (Hit(*(getattr(hit, k).clone() for k in ("tri", "t", "b1", "b2"))),
            ray_d.map(torch.clone), ray_o.map(torch.clone), rows)


def _record_fills(scene, cam, cfg, tile):
    """The inputs of the integrator's fill-kernel calls of tile ``tile``
    (the camera phase's, then one a bounce) in one eager frame, whose
    launches are counted."""
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.render import integrator
    from pnraytracing_tpu_torch.render.renderer import render_frame

    real, calls, seen = integrator.fill_interaction, [], [0]
    per_tile = 1 + cfg.max_depth
    first = tile * per_tile

    def call(*args):
        if first <= seen[0] < first + per_tile:
            calls.append(_clone(*args))
        seen[0] += 1
        return real(*args)

    before = shade.LAUNCHES["interaction"]
    integrator.fill_interaction = call
    try:
        render_frame(scene, cam, cfg, START, eager=True)
    finally:
        integrator.fill_interaction = real
    torch.cuda.synchronize()
    tiles = cfg.width * cfg.height // cfg.tile_pixels
    assert seen[0] == tiles * per_tile
    assert shade.LAUNCHES["interaction"] - before == tiles * per_tile
    return calls


@pytest.fixture(scope="module")
def recorded(scenes):
    from pnraytracing_tpu_torch.accel.walks import route_walks

    out = {}
    for name, (scene, cam, cfg, _) in scenes.items():
        assert route_walks(scene, cfg)[0] == ROUTES[name]
        out[name] = _record_fills(scene, cam, cfg, BUNNY_TILE)
    return out


def _some(gen, r):
    return torch.rand(r, generator=gen, device="cuda") < EDIT_SHARE


def _retest_misses(hit, ray_d, ray_o, rows) -> int:
    """Lanes whose re-test of their hit triangle misses."""
    from pnraytracing_tpu_torch.core.math import FLOAT_MAX
    from pnraytracing_tpu_torch.ops.intersect import intersect_triangle_c
    from pnraytracing_tpu_torch.ops.shade import corners

    rr = rows[torch.clamp_min(hit.tri, 0).long()]
    p = [(c.x, c.y, c.z) for c in corners(rr, 0)]
    ok = intersect_triangle_c(*p, ray_o.x, ray_o.y, ray_o.z, ray_d.x,
                              ray_d.y, ray_d.z,
                              torch.full_like(ray_d.x, FLOAT_MAX))[0]
    return int((~ok).sum())


def _edit(case, gen, hit, ray_d, ray_o, rows):
    """The inputs of ``case``: as recorded, or edited to reach a branch
    of the fill on a share of the lanes."""
    from pnraytracing_tpu_torch.core.vec import vwhere

    r = hit.tri.shape[0]
    if case == "zero_normal":  # one corner normal zero on some triangles
        rows = rows.clone()
        pick = torch.clamp_min(hit.tri[_some(gen, r)], 0).long()
        rows[pick, 12:15] = 0.0
    elif case == "inside_out":  # every corner normal reversed
        rows = torch.cat([rows[:, :9], -rows[:, 9:18], rows[:, 18:]], 1)
    elif case == "reversed":  # rays turned back: the re-test misses
        ray_d = vwhere(_some(gen, r), -ray_d, ray_d)
        hit = dataclasses.replace(
            hit, b1=torch.rand(r, generator=gen, device="cuda"),
            b2=torch.rand(r, generator=gen, device="cuda") * 0.5)
    elif case == "misses":  # lanes made misses: row 0
        hit = dataclasses.replace(
            hit, tri=torch.where(_some(gen, r), -1, hit.tri).contiguous())
    return hit, ray_d, ray_o, rows.contiguous()


@pytest.mark.parametrize("which", sorted(ROUTES))
@pytest.mark.parametrize("case", ["frame", "zero_normal", "inside_out",
                                  "reversed", "misses"])
def test_kernel_equals_plain_version(recorded, which, case):
    """Every output of every lane bit for bit, the camera fill and each
    bounce's."""
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.ops.shade import any_zero, corners
    from pnraytracing_tpu_torch.render.integrator import make_interaction

    gen = torch.Generator(device="cuda").manual_seed(13)
    reached = 0
    for k, args in enumerate(recorded[which]):
        hit, ray_d, ray_o, rows = _edit(case, gen, *args)
        before = shade.LAUNCHES["interaction"]
        got = shade.fill_interaction(hit, ray_d, ray_o, rows)
        assert shade.LAUNCHES["interaction"] == before + 1
        want = make_interaction(hit, ray_d, ray_o, rows)
        torch.cuda.synchronize()
        (pos, nrm, (u, v), mat, tex), (wpos, wnrm, (wu, wv), wmat,
                                       wtex) = got, want
        for name, g, w in (("pos", pos, wpos), ("nrm", nrm, wnrm),
                           ("u", u, wu), ("v", v, wv), ("mat_id", mat, wmat),
                           ("tex_id", tex, wtex)):
            for c, (gc, wc) in enumerate(zip(_components(g),
                                             _components(w))):
                assert gc.dtype == wc.dtype and gc.is_contiguous(), name
                bad = _bits(gc) != _bits(wc)
                assert not bool(bad.any()), (
                    f"{which} {case} call {k} {name}[{c}]: "
                    f"{int(bad.sum())} lanes differ, max |d| "
                    f"{float((gc.float() - wc.float()).abs().max())}")
        rr = rows[torch.clamp_min(hit.tri, 0).long()]
        if case == "zero_normal":
            reached += int(any_zero(*corners(rr, 9)).sum())
        elif case == "inside_out":
            n = corners(rr, 9)[0]
            reached += int(((n.x * ray_d.x + n.y * ray_d.y + n.z * ray_d.z)
                            > 0).sum())
        elif case == "reversed":
            reached += _retest_misses(hit, ray_d, ray_o, rows)
        else:
            reached += int((hit.tri < 0).sum())
    assert reached > 10_000, f"{which} {case}: {reached} lanes reached"


@pytest.mark.parametrize("which", sorted(ROUTES))
def test_program_average_equals_torch_path(scenes, which):
    """16 frames through the captured program (the fill, shade and tail
    kernels) against the same 16 frames eagerly on the torch path: equal
    by sha256.  The capture notes the fill kernel 1 + depth times a tile;
    a replay launches none."""
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.renderer import render_average
    from pnraytracing_tpu_torch.utils import profiling

    scene, cam, cfg, _ = scenes[which]
    tiles = cfg.width * cfg.height // cfg.tile_pixels
    program.clear_programs()
    prog = program.frame_program(scene, cfg, "cuda")
    with profiling.collect() as layout:
        prog.capture(cam, START)
    noted = [k for k, _ in layout.kernels if k == "interaction"]
    assert len(noted) == tiles * (1 + cfg.max_depth)
    before = shade.LAUNCHES["interaction"]
    got = render_average(scene, cam, cfg, START, 16)
    torch.cuda.synchronize()
    assert shade.LAUNCHES["interaction"] == before  # replays launch nothing

    forced = _forced_torch_path(scene)
    assert not shade.shade_on_card(forced, "cuda")
    want = render_average(forced, cam, cfg, START, 16, eager=True)
    assert shade.LAUNCHES["interaction"] == before  # the torch path
    sha = lambda x: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
    diff = (got - want).abs()
    assert sha(got) == sha(want), (
        f"{which}: {int((diff > 0).sum())} values differ, max "
        f"{float(diff.max())}")
    assert float(got.mean()) > 0.01
    program.clear_programs()
    print(f"{which} 16 frames from {START}: sha256 {sha(got)}")
