"""The ray-ordering and sampling options of the port against the JAX
package: ``compact_rays``, ``sort_rays``, ``sort_key``, ``fuse_shadows``,
``jitter_primary`` and ``loop``.

* unit checks, exact: the prefix scans, ``compact_indices`` (permutation
  and count), ``scatter_back``, both coherence keys on live-like lanes
  (unit normals with zero components, positions on the root box's
  faces), ``primary_jitter``; ``camera_rays`` with jitter within 2 ulp
  (XLA:CPU's FMA contraction, as without jitter);
* frames: the flagship teapot_night that the JAX package built, carried
  over by ``convert``, at 16x16, depth 2 (depth 3 for ``loop="scan"``,
  so that a bounce runs after the JAX scan's sorted prologue), against
  the JAX ``render_frame`` with ``traversal="packet"`` and the same
  option; bound: at most 2 pixels outside atol 3e-5 (the golden
  tolerance, tests/test_golden.py:18);
* the orderings are permutations: every option but the jitter gives the
  default's frame bit for bit on the port.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pnraytracing_tpu.core.camera import camera_rays as jax_camera_rays
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.ops import compaction as jax_compaction
from pnraytracing_tpu.render import renderer as jax_renderer
from pnraytracing_tpu_torch.convert import scene_from_arrays, scene_to_arrays
from pnraytracing_tpu_torch.core.camera import camera_rays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops import compaction
from pnraytracing_tpu_torch.render.renderer import (
    pixel_coords,
    primary_jitter,
    render_frame,
)
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    _torch_threads,
    jax_teapot_night,
    port_camera,
    port_scene,
)

SIZE = dict(width=16, height=16)
OPTIONS = {
    "no_compaction": dict(compact_rays=False),
    "no_sort": dict(sort_rays=False),
    "key_dir": dict(sort_key="dir"),
    "key_pos": dict(sort_key="pos"),
    "unfused_shadows": dict(fuse_shadows=False),
    "jitter": dict(jitter_primary=True),
    "scan": dict(loop="scan"),
}


def _depth(kw) -> int:
    return 3 if kw.get("loop") == "scan" else 2


@functools.lru_cache(maxsize=None)
def _port_flagship():
    js, jcam = jax_teapot_night()
    return port_scene(js), port_camera(jcam.basis())


def _port_frame(kw, frame=0, scene=None, depth=None):
    ps, cam = _port_flagship()
    cfg = RenderConfig(max_depth=depth or _depth(kw), **SIZE, **kw)
    return render_frame(ps if scene is None else scene, cam, cfg, frame,
                        device="cpu")


# ---- unit checks ---------------------------------------------------------

def test_scans_match_jax():
    rng = np.random.default_rng(0)
    for x in (rng.integers(-50, 100, size=1024).astype(np.int32),
              rng.integers(0, 2, size=(37, 5)).astype(np.int32)):
        for fn in ("inclusive_scan", "exclusive_scan"):
            want = np.asarray(getattr(jax_compaction, fn)(jnp.asarray(x)))
            got = getattr(compaction, fn)(torch.from_numpy(x)).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("live", ["random", "sparse", "all", "none", "one"])
def test_compact_indices_matches_jax(live):
    rng = np.random.default_rng(1)
    n = 1000
    mask = {"random": rng.uniform(size=n) < 0.5,
            "sparse": rng.uniform(size=n) < 0.02,
            "all": np.ones(n, bool), "none": np.zeros(n, bool),
            "one": np.arange(n) == 617}[live]
    perm, count = compaction.compact_indices(torch.from_numpy(mask))
    jperm, jcount = jax_compaction.compact_indices(jnp.asarray(mask))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert int(count) == int(jcount) == int(mask.sum())
    x = rng.normal(size=(n, 3)).astype(np.float32)
    gathered = x[perm.numpy()]
    back = compaction.scatter_back(torch.from_numpy(gathered), perm)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_compaction.scatter_back(jnp.asarray(gathered), jperm)))


# the scene forms of the sort's state: (area light, environment map,
# textured, texture LOD, balanced MIS)
STATE_FORMS = {
    "lights_env": (True, True, False, False, False),
    "lights_only": (True, False, False, False, False),
    "env_only": (False, True, False, False, False),
    "textured": (True, True, True, False, False),
    "textured_lod": (True, True, True, True, False),
    "balanced": (True, True, False, False, True),
    "balanced_env_only": (False, True, True, True, True),
}


def _sort_state(form, n=1000):
    """A path state of ``form`` as the integrator holds it at the sort:
    ``(Path, Shade, Lanes)`` with None where the scene has no such term,
    the RNG words including 0 and 0xFFFFFFFF, ids up to 2^24 - 1."""
    from pnraytracing_tpu_torch.ops.shade import Path, Shade

    lights, env, tex, lod, balanced = form
    gen = torch.Generator().manual_seed(7)
    f = lambda: torch.randn(n, generator=gen)
    v = lambda: V3(f(), f(), f())
    ints = lambda hi, dtype: torch.randint(0, hi, (n,), generator=gen,
                                           dtype=dtype)
    seed = ints(1 << 32, torch.int64)
    seed[:2] = torch.tensor([0, 0xFFFFFFFF])
    mat_id = ints(1 << 24, torch.int32)
    mat_id[0] = (1 << 24) - 1
    opt = lambda on, make: make() if on else None
    path = Path(v(), v(), v(), v(), v(), mat_id, opt(tex, f), opt(tex, f),
                opt(tex, lambda: ints(1 << 24, torch.int32) - 1),
                opt(lod, f), f() > 0, seed)
    shaded = Shade(seed, v(), v(), f(), opt(lights, v), opt(lights, f),
                   opt(lights, v), opt(env, v), opt(env, f), opt(env, v),
                   opt(balanced and lights, f), opt(balanced and env, f))
    lanes = compaction.Lanes(torch.arange(n), ints(1 << 24, torch.int64),
                             ints(1 << 24, torch.int64))
    return path, shaded, lanes


class _Ops(TorchDispatchMode):
    """The operators a block runs, by name, with their outputs' shapes."""

    def __init__(self):
        super().__init__()
        self.ran = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ran.append((func.overloadpacket.__name__,
                         tuple(getattr(out, "shape", ()))))
        return out


@pytest.mark.parametrize("form", list(STATE_FORMS))
def test_permute_state_moves_every_live_field_exactly(form):
    """Every field of the state but the dead view direction comes out
    gathered by the permutation, bit for bit and in its dtype (bools,
    int32 ids, int64 slots and pixels, the uint32 RNG word up to
    0xFFFFFFFF), each row contiguous; absent fields stay None; the whole
    state moves as one [C, R] stack and one gather, with the columns the
    integrator's pack always had: 26, 7 more for each NEE class, 3 for
    the uv and texture id, 1 for the path length and 1 for each
    balanced-MIS pdf."""
    lights, env, tex, lod, balanced = STATE_FORMS[form]
    state = _sort_state(STATE_FORMS[form])
    perm = torch.randperm(1000, generator=torch.Generator().manual_seed(3))
    with _Ops() as ops:
        got = compaction.permute_state(perm, state, dead=("v_dir",))
    columns = (26 + 7 * lights + 7 * env + 3 * tex + lod
               + balanced * (lights + env))
    gathers = [shape for op, shape in ops.ran if op == "index_select"]
    stacks = [shape for op, shape in ops.ran if op in ("stack", "cat")]
    assert gathers == stacks == [(columns, 1000)]
    for rec, out in zip(state, got):
        assert type(out) is type(rec)
        for name, x, y in zip(rec._fields, rec, out):
            if name == "v_dir" or x is None:
                assert y is None, name
                continue
            xs = [x.x, x.y, x.z] if isinstance(x, V3) else [x]
            ys = [y.x, y.y, y.z] if isinstance(y, V3) else [y]
            for xc, yc in zip(xs, ys):
                assert yc.dtype == xc.dtype and yc.is_contiguous(), name
                assert torch.equal(yc, xc[perm]), name
    assert got[0].seed is got[1].seed  # one field, moved once


@pytest.mark.parametrize("fault", ["unknown_dead", "two_values", "float64",
                                   "narrow_seed"])
def test_permute_state_refuses_what_it_cannot_move(fault):
    """A dead name no record has, two records holding different values
    under one name, and a field float32 cannot carry exactly are refused,
    not moved stale or rounded."""
    path, shaded, lanes = _sort_state(STATE_FORMS["lights_env"])
    dead = ("v_dir",)
    if fault == "unknown_dead":
        dead = ("v_dir", "view_dir")
    elif fault == "two_values":
        shaded = shaded._replace(seed=shaded.seed.clone())
    elif fault == "float64":
        shaded = shaded._replace(d_pdf=shaded.d_pdf.double())
    else:
        seed = path.seed.to(torch.int32)
        path, shaded = path._replace(seed=seed), shaded._replace(seed=seed)
    with pytest.raises(ValueError, match="permute_state"):
        compaction.permute_state(torch.arange(1000), (path, shaded, lanes),
                                 dead=dead)


def _live_like(seed, root):
    """Unit normals (a third with one or two exact zero components) and
    positions in the root box, a quarter of them on one of its faces."""
    rng = np.random.default_rng(seed)
    n = 4096
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[: n // 6, rng.integers(0, 3)] = 0.0
    nrm[n // 6: n // 3, :2] = 0.0
    nrm[n // 3: n // 3 + 3] = np.eye(3, dtype=np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    lo, hi = root[0:3], root[3:6]
    pos = (lo + rng.uniform(size=(n, 3)) * (hi - lo)).astype(np.float32)
    face = rng.integers(0, 3, n // 4)
    side = rng.integers(0, 2, n // 4)
    pos[np.arange(n // 4), face] = np.where(side == 1, hi[face], lo[face])
    pos[-2:] = np.stack([lo, hi])
    return nrm, pos


@pytest.mark.parametrize("key", ["coherence_key", "coherence_key_pos"])
def test_coherence_keys_match_jax(key):
    js, _ = jax_teapot_night()
    root = np.asarray(js.trav.nodes8[0])
    lo, hi = root[0:3], root[3:6]
    inv_ext = (1.0 / np.maximum(hi - lo, np.float32(1e-6))).astype(np.float32)
    nrm, pos = _live_like(2, root)
    want = np.asarray(getattr(jax_compaction, key)(
        jnp.asarray(nrm), jnp.asarray(pos), jnp.asarray(lo),
        jnp.asarray(inv_ext))).astype(np.int64)
    v3 = lambda a: V3(*(torch.from_numpy(a[:, k].copy()) for k in range(3)))
    got = getattr(compaction, key)(v3(nrm), v3(pos),
                                   torch.from_numpy(lo.copy()),
                                   torch.from_numpy(inv_ext))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < (1 << 15) and len(np.unique(want)) > 50


def test_coherence_keys_of_dead_lanes_stay_in_range():
    """A primary miss leaves pos = eye + d * FLOAT_MAX and a zero normal;
    NaN and infinite lanes too: keys defined, below 2^15."""
    big = torch.tensor([1e7, -3e7, float("nan"), float("inf"), -float("inf"),
                        0.5])
    v = V3(big, big.flip(0), big.roll(2))
    lo, inv = torch.zeros(3), torch.ones(3)
    for fn in (compaction.coherence_key, compaction.coherence_key_pos):
        k = fn(V3(big * 0, big, big), v, lo, inv)
        assert k.dtype == torch.int64 and bool(((k >= 0) & (k < 1 << 15))
                                               .all())


@pytest.mark.parametrize("frame", [0, 5, 4294967295])
def test_primary_jitter_matches_jax(frame):
    jcfg = JaxRenderConfig(jitter_primary=True, **SIZE)
    jpx, jpy = jax_renderer.pixel_coords(jcfg)
    want = np.asarray(jax_renderer.primary_jitter(
        jpx, jpy, jnp.asarray(frame, jnp.uint32), jcfg))
    cfg = RenderConfig(jitter_primary=True, **SIZE)
    px, py = pixel_coords(cfg, "cpu")
    got = primary_jitter(px, py, frame, cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert primary_jitter(px, py, frame, RenderConfig(**SIZE)) is None


def test_camera_rays_with_jitter_match_jax():
    _, jcam = jax_teapot_night()
    jbasis = jcam.basis()
    jitter = np.random.default_rng(4).uniform(size=(256, 2)).astype(
        np.float32)
    jo, jd, _ = jax_camera_rays(jbasis, 16, 16, jitter=jnp.asarray(jitter))
    o, d, _ = camera_rays(port_camera(jbasis), 16, 16,
                          jitter=torch.from_numpy(jitter))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    # 2 ulp, not 1: XLA:CPU contracts the ray's a*b + c into FMAs and the
    # port does not (ROADMAP.md, faults); the rays without jitter differ
    # by 2 ulp as well
    np.testing.assert_array_max_ulp(d.numpy(), np.asarray(jd), maxulp=2)
    jd0 = jax_camera_rays(jbasis, 16, 16)[1]
    d0 = camera_rays(port_camera(jbasis), 16, 16)[1]
    np.testing.assert_array_max_ulp(d0.numpy(), np.asarray(jd0), maxulp=2)
    assert float((d - d0).abs().max()) > 1e-4


def test_sort_key_and_num_pixels():
    for key in ("entry", "dir", "pos"):
        assert RenderConfig(sort_key=key).sort_key == key
    with pytest.raises(ValueError, match="sort_key"):
        RenderConfig(sort_key="x")
    assert RenderConfig(width=24, height=10).num_pixels == 240
    assert RenderConfig().num_pixels == JaxRenderConfig().num_pixels


# ---- frames --------------------------------------------------------------

@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_frame_matches_jax(option):
    kw = OPTIONS[option]
    js, jcam = jax_teapot_night()
    jcfg = JaxRenderConfig(traversal="packet", max_depth=_depth(kw), **SIZE,
                           **kw)
    want = np.asarray(jax_renderer.render_frame(js, jcam.basis(), jcfg, 0))
    got = _port_frame(kw).numpy()
    assert_frame_close(got, want)
    assert want.mean() > 0.05


@pytest.mark.parametrize("option", [o for o in OPTIONS if o != "jitter"])
def test_orderings_give_the_default_frame(option):
    """Pure permutations and one batch for two: the same image bit for
    bit (the JAX package asserts the same of fused shadows,
    tests/test_fused.py)."""
    kw = OPTIONS[option]
    torch.testing.assert_close(_port_frame(kw, 3),
                               _port_frame({}, 3, depth=_depth(kw)),
                               rtol=0, atol=0)


def test_entry_key_falls_back_to_pos_without_treelets():
    """A scene carried over from one without a treelet table sorts by the
    'pos' key, as the JAX package does (render/integrator.py:687-703)."""
    js, _ = jax_teapot_night()
    leaves = scene_to_arrays(js.replace(trav=js.trav.replace(treelets=None)))
    assert "trav.treelets" not in leaves
    bare = scene_from_arrays(leaves, device="cpu")
    assert bare.trav.treelets is None and bare.trav.treelet_tree is None
    before = compaction.LAUNCHES["treelet_entry_key"]
    got = _port_frame({}, 1, scene=bare)
    torch.testing.assert_close(got, _port_frame({"sort_key": "pos"}, 1,
                                                scene=bare), rtol=0, atol=0)
    assert compaction.LAUNCHES["treelet_entry_key"] == before
