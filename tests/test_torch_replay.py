"""The trace/replay split of the port's integrator (``trace_paths``,
``render_rays_replay``, ``TraceRecords``) on the CPU, against itself and
against the JAX package.

* records: the port's ``trace_paths`` against the JAX package's (its
  packet walk) on one scene, 16x16, depth 3 with Russian roulette.  The
  primary hits follow the walk budget of tests/test_pallas_trav.py::
  _assert_hits_close: at most 2 triangle mismatches, t rtol 1e-6, b1/b2
  rtol 1e-5 atol 1e-6.  Two primary rays through the rim of the floor
  quad are such mismatches: the packet walk misses what the port's walk
  (and the JAX package's Pallas kernel, tests/test_torch_traverse.py)
  hits.  Their pixels are left out of the bounce records, which hold
  the same triangles and occlusion bits; their rays leave each
  package's own shading point, whose rounding differs (XLA contracts
  FMAs), so the hits' t differ by up to 7.0e-6 (observed, at t ~ 1e-4
  next to the origin) and b1/b2 by up to 5.6e-6: bounds atol 1e-5;
* live against replay in the port: the JAX package's
  ``assert_ulp_close`` (tests/test_replay.py: rtol = atol = 2e-6, fewer
  than 25% of values differing), with and without the environment and
  Russian roulette, under ``loop="unroll"`` and ``"scan"``, for a live
  frame that makes its interactions as the replay does; records of a
  scan trace replay under the unrolled loop (the JAX package's
  ``test_scan_record_replay_roundtrip``); the default route's live frame
  (the attribute kernel's fill) against the replay within the image
  bound;
* the port's replay against the JAX package's ``render_rays_replay``
  on the port's records (carried by ``convert.py``): atol 3e-5, at most
  2 pixels over (tests/test_torch_render.py);
* a replay runs no walk and no sort: the walk and key entry points of
  the integrator raise while it runs.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.camera import camera_rays as jax_camera_rays
from pnraytracing_tpu.core.camera import make_camera as jax_make_camera
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.io.hdr import procedural_sky
from pnraytracing_tpu.ops.intersect import Hit as JaxHit
from pnraytracing_tpu.render.integrator import (
    TraceRecords as JaxTraceRecords,
)
from pnraytracing_tpu.render.integrator import (
    render_rays_replay as jax_render_rays_replay,
)
from pnraytracing_tpu.render.integrator import trace_paths as jax_trace_paths
from pnraytracing_tpu.render.renderer import pixel_coords as jax_pixel_coords
from pnraytracing_tpu.scene import shapes
from pnraytracing_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from pnraytracing_tpu.scene.transform import compose, rotate, translate
from pnraytracing_tpu_torch.accel import walks
from pnraytracing_tpu_torch.convert import (
    records_from_arrays,
    records_to_arrays,
)
from pnraytracing_tpu_torch.core.camera import camera_rays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.render import integrator
from pnraytracing_tpu_torch.render.integrator import (
    render_rays,
    render_rays_replay,
    trace_paths,
)
from pnraytracing_tpu_torch.render.renderer import pixel_coords
from tests.test_replay import assert_ulp_close
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    _torch_threads,
    port_camera,
    port_scene,
)

LIVE = RenderConfig(width=16, height=16, max_depth=3, clamp_radiance=False)
LIVE_RR = RenderConfig(width=16, height=16, max_depth=4, rr_start=1,
                       sampler="hash", clamp_radiance=False)


@functools.lru_cache(maxsize=2)
def scenes(with_env: bool = True):
    """(JAX scene, JAX camera, port scene, port camera): the JAX package's
    replay test scene (a ball, a floor, a quad light; the floor at
    metallic 0 and roughness 1, both on a bound of ``sanitized()``),
    built by the JAX package with its numpy BVH builder and carried over
    by ``convert.py``."""
    b = JaxSceneBuilder()
    b.add(shapes.icosphere(2, radius=1.0),
          dict(base_color=(0.7, 0.3, 0.2), roughness=0.4, metallic=0.3),
          name="ball")
    b.add(shapes.quad(half=4.0), dict(base_color=(0.6, 0.6, 0.6),
                                      roughness=1.0),
          name="floor", transform=translate(0, -1.0, 0))
    b.add(shapes.quad(half=0.7), dict(emissive=(6.0, 6.0, 6.0)), name="light",
          transform=compose(translate(0, 3, 1), rotate(180, (0, 0, 1))))
    js = b.build(env_image=procedural_sky(16, 32) if with_env else None,
                 env_constant=None if with_env else (0.25, 0.25, 0.3),
                 use_native_builder=False)
    jcam = jax_make_camera((0, 1, 4), (0, 0, 0), (0, 1, 0), 50.0, 1.0)
    return js, jcam, port_scene(js), port_camera(jcam)


def port_rays(cfg: RenderConfig, cam):
    px, py = pixel_coords(cfg, "cpu")
    o, d, _ = camera_rays(cam, cfg.width, cfg.height)
    return o, d, px, py


def jax_rays(cfg, cam):
    px, py = jax_pixel_coords(cfg)
    o, d, _ = jax_camera_rays(cam, cfg.width, cfg.height)
    return o, d, px, py


def jax_config(cfg: RenderConfig) -> JaxRenderConfig:
    """The JAX package's config of ``cfg``, on its packet walk."""
    keys = ("width", "height", "max_depth", "sampler", "rr_start",
            "clamp_radiance", "loop", "compact_rays", "mis")
    return JaxRenderConfig(traversal="packet",
                           **{k: getattr(cfg, k) for k in keys})


def jax_records(records) -> JaxTraceRecords:
    """The port's records as the JAX package's, through convert.py."""
    a = records_to_arrays(records)
    hit = lambda g: JaxHit(**{f: jnp.asarray(a[f"{g}.{f}"])
                              for f in ("tri", "t", "b1", "b2")})
    opt = lambda k: jnp.asarray(a[k]) if k in a else None
    return JaxTraceRecords(primary=hit("primary"), light_occ=opt("light_occ"),
                           env_occ=opt("env_occ"), bounce=hit("bounce"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_records_match_jax():
    js, jcam, ps, pcam = scenes(True)
    # unsorted scan: the JAX trace compiles one bounce body (records are
    # in the original ray order whatever the sort)
    cfg = dataclasses.replace(LIVE, rr_start=1, loop="scan",
                              compact_rays=False)
    got = trace_paths(ps, *port_rays(cfg, pcam), 5, cfg)
    jcfg = jax_config(cfg)
    want = jax_trace_paths(js, *jax_rays(jcfg, jcam), jnp.uint32(5), jcfg)
    g, w = got.primary, want.primary
    same = _np(g.tri) == _np(w.tri)
    assert (~same).sum() <= 2, f"{(~same).sum()} primary tri mismatches"
    np.testing.assert_allclose(_np(g.t)[same], _np(w.t)[same], rtol=1e-6)
    for f in ("b1", "b2"):
        np.testing.assert_allclose(_np(getattr(g, f))[same],
                                   _np(getattr(w, f))[same],
                                   rtol=1e-5, atol=1e-6)
    assert _np(g.valid).sum() > 100
    # the bounces of the pixels whose primary hits agree
    for name in ("light_occ", "env_occ"):
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert a.shape == (cfg.max_depth, 256)
        np.testing.assert_array_equal(a[:, same], b[:, same])
    gb, wb = got.bounce, want.bounce
    np.testing.assert_array_equal(_np(gb.tri)[:, same], _np(wb.tri)[:, same])
    np.testing.assert_array_equal(_np(gb.valid), _np(gb.tri) >= 0)
    hit = (_np(gb.tri) >= 0) & same[None]
    assert hit.sum() > 50
    np.testing.assert_allclose(_np(gb.t)[hit], _np(wb.t)[hit], rtol=1e-6,
                               atol=1e-5)
    for f in ("b1", "b2"):
        np.testing.assert_allclose(_np(getattr(gb, f))[hit],
                                   _np(getattr(wb, f))[hit], atol=1e-5)


@pytest.mark.parametrize("loop", ["unroll", "scan"])
@pytest.mark.parametrize("with_env", [True, False])
def test_live_matches_replay(with_env, loop):
    """Without a walk or a sort the replay gives the live frame up to
    rounding.  The live frame here makes its interactions as the replay
    does (``make_interaction``, ``kernel_interaction=False``: the JAX
    package's default route); observed: at most 6e-8 apart, ~1% of
    values differing."""
    cfg = dataclasses.replace(LIVE if with_env else LIVE_RR, loop=loop,
                              kernel_interaction=False)
    _, _, ps, pcam = scenes(with_env)
    rays = port_rays(cfg, pcam)
    live = render_rays(ps, *rays, 5, cfg)
    recs = trace_paths(ps, *rays, 5, cfg)
    assert (recs.env_occ is None) == (not with_env)
    assert_ulp_close(live.numpy(), render_rays_replay(ps, *rays, 5, cfg,
                                                      recs).numpy())


@pytest.mark.parametrize("with_env", [True, False])
def test_attr_route_live_matches_replay(with_env):
    """On the default route the attribute kernel fills the live frame's
    interactions, with the hit point ``o + t d`` where the replay
    interpolates the corners (``make_interaction``): the frames agree
    within the image bound (atol 3e-5, at most 2 pixels over) with fewer
    than 25% of values differing (observed: one value of 768 3.6e-6
    apart, rel 1.1e-5; 18% differing)."""
    cfg = LIVE if with_env else LIVE_RR
    assert cfg.kernel_interaction
    _, _, ps, pcam = scenes(with_env)
    rays = port_rays(cfg, pcam)
    live = render_rays(ps, *rays, 5, cfg).numpy()
    replay = render_rays_replay(ps, *rays, 5, cfg,
                                trace_paths(ps, *rays, 5, cfg)).numpy()
    shape = (cfg.height, cfg.width, 3)
    assert_frame_close(live.reshape(shape), replay.reshape(shape))
    assert (live != replay).mean() < 0.25


def test_scan_record_replay_roundtrip():
    """Records of a scan trace replay under either loop."""
    cfg = dataclasses.replace(LIVE, loop="scan", kernel_interaction=False)
    _, _, ps, pcam = scenes(True)
    rays = port_rays(cfg, pcam)
    live = render_rays(ps, *rays, 9, cfg)
    recs = trace_paths(ps, *rays, 9, cfg)
    assert_ulp_close(live.numpy(),
                     render_rays_replay(ps, *rays, 9, cfg, recs).numpy())
    unroll = dataclasses.replace(cfg, loop="unroll")
    assert_ulp_close(live.numpy(),
                     render_rays_replay(ps, *rays, 9, unroll, recs).numpy())


@pytest.mark.parametrize("with_env", [True, False])
def test_replay_matches_jax(with_env):
    """The port's replay against the JAX package's on the port's records
    (scan: the JAX replay compiles one bounce body)."""
    cfg = dataclasses.replace(LIVE if with_env else LIVE_RR, loop="scan",
                              max_depth=2)
    js, jcam, ps, pcam = scenes(with_env)
    recs = trace_paths(ps, *port_rays(cfg, pcam), 3, cfg)
    got = render_rays_replay(ps, *port_rays(cfg, pcam), 3, cfg, recs)
    jcfg = jax_config(cfg)
    want = jax_render_rays_replay(js, *jax_rays(jcfg, jcam), jnp.uint32(3),
                                  jcfg, jax_records(recs))
    shape = (cfg.height, cfg.width, 3)
    assert_frame_close(got.numpy().reshape(shape),
                       np.asarray(want).reshape(shape))
    assert float(got.mean()) > 0.02


def test_replay_runs_no_walk(monkeypatch):
    """Every walk and the sort key stay out of a replay (the JAX
    package's ``test_replay_graph_drops_traversal_loops``), and the
    replay is the same frame as before."""
    _, _, ps, pcam = scenes(True)
    cfg = LIVE
    rays = port_rays(cfg, pcam)
    recs = trace_paths(ps, *rays, 2, cfg)
    want = render_rays_replay(ps, *rays, 2, cfg, recs)

    def refuse(*args, **kw):
        raise AssertionError("a replay launched a walk or a key")

    for name in ("closest_hit", "closest_hit_attr", "any_hit",
                 "closest_hit_stream", "any_hit_stream"):
        monkeypatch.setattr(walks, name, refuse)
    monkeypatch.setattr(integrator, "entry_key", refuse)
    got = render_rays_replay(ps, *rays, 2, cfg, recs)
    assert torch.equal(got, want)
    with pytest.raises(AssertionError, match="a replay launched"):
        render_rays(ps, *rays, 2, cfg)


@pytest.mark.parametrize("with_env", [True, False])
def test_records_carry_over(with_env):
    """records_to_arrays / records_from_arrays keep every record bit for
    bit; a scene without an environment has no env_occ leaf."""
    _, _, ps, pcam = scenes(with_env)
    cfg = dataclasses.replace(LIVE, max_depth=2)
    recs = trace_paths(ps, *port_rays(cfg, pcam), 0, cfg)
    leaves = records_to_arrays(recs)
    assert ("env_occ" in leaves) == with_env
    assert leaves["bounce.tri"].shape == (2, 256)
    back = records_from_arrays(leaves, device="cpu")
    assert sorted(records_to_arrays(back)) == sorted(leaves)
    for k, v in records_to_arrays(back).items():
        np.testing.assert_array_equal(v, leaves[k])
        assert v.dtype == leaves[k].dtype
