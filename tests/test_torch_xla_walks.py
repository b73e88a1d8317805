"""The walks of ``RenderConfig.traversal``'s XLA values on the CPU,
against the JAX package: the layout functions of ``accel/layout.py``,
``ops/intersect.py::triangle_setup_static``, ``accel/loops.py`` and the
plain versions behind ``accel/traverse_packed.py`` (``packed``, ``pop``),
``traverse_packet.py`` and ``traverse_wide.py``.

Inputs are random triangle soups of tests/test_bvh.py (300 triangles,
the JAX package's numpy builder) and 512 seeded rays aimed into them,
made with numpy; both packages walk the same arrays (the port's layout is
packed from the JAX BVH by ``pack_traversal_data``).

Bounds, those of tests/test_torch_bvh.py: XLA on the CPU contracts the
watertight test's products and sums into FMAs where the port (and its
kernels, built with ``--fmad=false``) rounds every operation, so ``t``
moves by a few ulp.  Triangle ids exact outside rim rays (``t`` beyond
rtol 1e-6: a ray through a triangle's rim that one package hits and the
other misses; at most 2% of the rays, none on these soups), ``t`` within
2 ulp on at least 97% of the hits and within rtol 1e-6 on all others
(measured: 3 of ~300 hits at 3-4 ulp), barycentrics within rtol 1e-5 /
atol 1e-6 (near 0 they have no ulp scale), occlusion exact.  Compat:
triangle ids on all but 1% of the rays, occlusion exact (the sheared
test without the permutation is ill conditioned under contraction).
Between the port's own walks, the same triangle gives the same ``t`` and
barycentrics bit for bit.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.accel import layout as jax_layout
from pnraytracing_tpu.accel import traverse_packed as jax_packed
from pnraytracing_tpu.accel import traverse_packet as jax_packet
from pnraytracing_tpu.accel import traverse_wide as jax_wide
from pnraytracing_tpu.accel.traverse_pallas import (
    any_hit_pallas,
    closest_hit_pallas,
)
from pnraytracing_tpu.ops import intersect as jax_intersect
from pnraytracing_tpu_torch.accel import layout
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel import traverse_packed, traverse_packet
from pnraytracing_tpu_torch.accel import traverse_wide
from pnraytracing_tpu_torch.accel.loops import chunked_while
from pnraytracing_tpu_torch.core.math import FLOAT_MAX
from pnraytracing_tpu_torch.core.types import BVH, TriangleMesh
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops import intersect
from tests.test_bvh import make_mesh_and_bvh, random_soup
from tests.test_torch_bvh import _assert_hits_match
from tests.test_torch_scene import _torch_threads  # noqa: F401

N_RAYS = 512
WALKS = {"packed": (jax_packed, traverse_packed),
         "pop": (jax_packed, traverse_packed),
         "packet": (jax_packet, traverse_packet),
         "wide": (jax_wide, traverse_wide)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _v3(a) -> V3:
    a = np.asarray(a, np.float32)
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                for k in range(3)))


def cube_soup(rng, n_cubes):
    """Groups of 6 triangles, each spanning all of one random cube (three
    of its corners with both extremes on every axis): a group has one
    centroid bound, so the builder keeps it as one leaf of 6."""
    corners = np.array(list(itertools.product((0, 1), repeat=3)),
                       np.float32)
    spans = [c for c in itertools.combinations(range(8), 3)
             if all(len(set(corners[list(c), k])) == 2 for k in range(3))]
    pick = corners[np.array([spans[j] for j in rng.choice(
        len(spans), 6, replace=False)])]  # [6, 3, 3]
    base = rng.uniform(-3, 3, (n_cubes, 3)).astype(np.float32)
    size = rng.uniform(0.3, 0.8, (n_cubes, 1)).astype(np.float32)
    tris = (base[:, None, None] + size[:, None, None] * pick[None])
    positions = tris.reshape(-1, 3).astype(np.float32)
    return positions, np.arange(len(positions), dtype=np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def soup(num_tris=300, seed=3, max_leaf_size=4, cubes=False):
    """(JAX TravData, port TravData packed from the same BVH, the JAX BVH
    and mesh, the host BVHArrays): a random soup (with ``cubes``,
    :func:`cube_soup` of ``num_tris // 6`` groups), built with leaves of
    at most ``max_leaf_size`` triangles."""
    rng = np.random.default_rng(seed)
    positions, indices = (cube_soup(rng, num_tris // 6) if cubes
                          else random_soup(rng, num_tris))
    mesh, bvh, built = make_mesh_and_bvh(positions, indices,
                                         max_leaf_size=max_leaf_size)
    jtrav = jax_layout.pack_traversal_data(bvh, mesh)
    pmesh = TriangleMesh(**{k: _t(getattr(mesh, k)) for k in (
        "positions", "normals", "tangents", "bitangents", "uvs", "indices",
        "material_id", "texture_id", "area")})
    pbvh = BVH(**{k: _t(getattr(bvh, k)) for k in (
        "node_min", "node_max", "axis", "right_child", "start", "end")})
    return jtrav, layout.pack_traversal_data(pbvh, pmesh), (bvh, mesh,
                                                            pbvh), built


@functools.lru_cache(maxsize=None)
def rays(seed=1, n=N_RAYS):
    """(o, d, t_max, mask) as numpy: origins around the soup aimed into
    it, a third with a short t_max, a tenth masked out."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    aim = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(n, FLOAT_MAX, np.float32)
    t_max[::3] = rng.uniform(1, 8, len(t_max[::3]))
    return o, d, t_max, rng.uniform(size=n) < 0.9


def _both(o, d, t_max, mask):
    return ((jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
             jnp.asarray(mask)),
            (_v3(o), _v3(d), _t(t_max), _t(mask)))


@pytest.mark.parametrize("num_tris", [1, 2, 5, 300])
def test_layout_functions_match_jax(num_tris):
    """``pack_traversal_data``'s ``nodes8`` / ``tri9``, ``pack_wide_nodes``
    (the JAX ``nodes16``), ``unpack_node_rows``, ``unpack_wide_rows`` and
    ``decode_leaf_info`` equal the JAX package's arrays exactly, leaf
    roots (1 and 2 triangles) included; the port's own rows beside them
    (``tri12``, ``nodes16c``) are made from the same tree."""
    jtrav, ptrav, (bvh, _, pbvh), built = soup(num_tris)
    eq = lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    eq(ptrav.nodes8, jtrav.nodes8)
    eq(ptrav.tri9, jtrav.tri9)
    eq(ptrav.tri12[:, :9], jtrav.tri9)
    assert not ptrav.tri12[:, 9:].any()
    eq(ptrav.nodes16c, jax_layout.pack_wide_nodes_compact(built))
    assert ptrav.bvh_depth == built.max_depth
    assert ptrav.treelets is None and ptrav.w4 is None
    nodes16 = layout.pack_wide_nodes(pbvh)
    eq(nodes16, jtrav.nodes16)
    for got, want in zip(layout.unpack_node_rows(ptrav.nodes8),
                         jax_layout.unpack_node_rows(jtrav.nodes8)):
        eq(got, want)
    for got, want in zip(layout.unpack_wide_rows(nodes16),
                         jax_layout.unpack_wide_rows(jtrav.nodes16)):
        eq(got, want)
    info = layout.unpack_wide_rows(nodes16)[4:6]
    jinfo = jax_layout.unpack_wide_rows(jtrav.nodes16)[4:6]
    for i, ji in zip(info, jinfo):
        for got, want in zip(layout.decode_leaf_info(i),
                             jax_layout.decode_leaf_info(ji)):
            eq(got, want)


def test_triangle_setup_static_matches_jax():
    """The static setup of rays with one dominant axis: ints and shears
    equal to the JAX package's and to the general setup's; the triangle
    test with it equals the test with the general setup bit for bit and
    the JAX test with its static setup within the module's bounds."""
    rng = np.random.default_rng(5)
    n = 4096
    p = rng.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = (p.mean(axis=0) + rng.normal(scale=0.3, size=(n, 3)) - o).astype(
        np.float32)
    t_max = np.full(n, 10.0, np.float32)
    dom = np.argmax(np.abs(d), axis=1)
    for ax in range(3):
        sel = dom == ax
        dt = [_t(d[sel, k]) for k in range(3)]
        dj = [jnp.asarray(d[sel, k]) for k in range(3)]
        got = intersect.triangle_setup_static(ax, *dt)
        want = jax_intersect.triangle_setup_static(ax, *dj)
        general = intersect.triangle_setup_c(*dt)
        assert got[:3] == tuple(want[:3]) == (
            (ax + 1) % 3, (ax + 2) % 3, ax)
        for g, w, c in zip(got[3:], want[3:], general[3:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert torch.equal(g, c)
        for k in range(3):
            assert bool((general[k] == got[k]).all())
        corners = [tuple(_t(p[j][sel, k]) for k in range(3))
                   for j in range(3)]
        ray = [_t(o[sel, k]) for k in range(3)] + dt + [_t(t_max[sel])]
        static = intersect.intersect_triangle_c(*corners, *ray, setup=got)
        dynamic = intersect.intersect_triangle_c(*corners, *ray,
                                                 setup=general)
        for a, b in zip(static, dynamic):
            assert torch.equal(a, b)
        jcorners = [tuple(jnp.asarray(p[j][sel, k]) for k in range(3))
                    for j in range(3)]
        jray = ([jnp.asarray(o[sel, k]) for k in range(3)] + dj
                + [jnp.asarray(t_max[sel])])
        jres = jax_intersect.intersect_triangle_c(*jcorners, *jray,
                                                  setup=want)
        hit, jhit = static[0].numpy(), np.asarray(jres[0])
        assert (hit != jhit).sum() <= 0.001 * sel.sum()
        assert hit.sum() > 0.2 * sel.sum()
        both = hit & jhit
        np.testing.assert_allclose(static[1].numpy()[both],
                                   np.asarray(jres[1])[both], rtol=1e-6)


@pytest.mark.parametrize("chunk", [0, 1, 3, 16])
def test_chunked_while(chunk):
    """``chunked_while`` runs the body until the condition fails, reading
    the condition every ``chunk`` steps; a body that is a no-op once the
    condition fails ends in the plain loop's state."""
    reads = []

    def cond(s):
        reads.append(s)
        return s["i"] < 10

    def body(s):
        return dict(s, i=s["i"] + 1) if s["i"] < 10 else s

    out = chunked_while(cond, body, {"i": 0}, chunk)
    assert out == {"i": 10}
    step = max(chunk, 1)
    assert len(reads) == -(-10 // step) + 1


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("walk", list(WALKS))
def test_walks_match_jax(walk, compat):
    """``closest_hit_<walk>`` / ``any_hit_<walk>`` against the JAX
    functions of the same name on the same rays (tile 128): the module
    docstring's bounds; masked rays miss with ``t_max`` and are not
    occluded."""
    jmod, pmod = WALKS[walk]
    jtrav, ptrav, _, _ = soup()
    o, d, t_max, mask = rays()
    jargs, pargs = _both(o, d, t_max, mask)
    kw = dict(compat=compat, tile_size=128)
    want = getattr(jmod, "closest_hit_" + walk)(jtrav, *jargs, **kw)
    got = getattr(pmod, "closest_hit_" + walk)(ptrav, *pargs, **kw)
    _assert_hits_match(got, want, compat)
    pmask = pargs[3]
    assert not got.valid[~pmask].any()
    assert torch.equal(got.t[~pmask], pargs[2][~pmask])
    occ = getattr(pmod, "any_hit_" + walk)(ptrav, *pargs, **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(
        getattr(jmod, "any_hit_" + walk)(jtrav, *jargs, **kw)))
    assert 0 < int(occ.sum()) < int(pmask.sum()) and not occ[~pmask].any()


def test_walks_agree_with_each_other():
    """The port's five walks (the four XLA values and the pallas route's
    wide walk) find the same triangle at the same ``t`` and barycentrics
    bit for bit, and the same occlusion; the packed walk is the walk
    over the plain BVH (``accel/traverse.py``) bit for bit, stats
    included."""
    from pnraytracing_tpu_torch.accel import traverse as bvh_walk

    _, ptrav, (_, mesh, pbvh), _ = soup()
    _, pargs = _both(*rays(2))
    pmesh = TriangleMesh(**{k: _t(getattr(mesh, k)) for k in (
        "positions", "normals", "tangents", "bitangents", "uvs", "indices",
        "material_id", "texture_id", "area")})
    ref, ref_st = traverse_packed.closest_hit_packed(ptrav, *pargs,
                                                     with_stats=True)
    bvh, bvh_st = bvh_walk.closest_hit(pbvh, pmesh, *pargs, with_stats=True)
    for k in ("tri", "t", "b1", "b2"):
        assert torch.equal(getattr(ref, k), getattr(bvh, k))
    assert torch.equal(ref_st, bvh_st)
    occ_ref = traverse_packed.any_hit_packed(ptrav, *pargs)
    assert torch.equal(occ_ref, bvh_walk.any_hit(pbvh, pmesh, *pargs))
    for walk, (_, pmod) in WALKS.items():
        hit = getattr(pmod, "closest_hit_" + walk)(ptrav, *pargs)
        assert torch.equal(hit.tri, ref.tri), walk
        for k in ("t", "b1", "b2"):
            assert torch.equal(getattr(hit, k), getattr(ref, k)), walk
        assert torch.equal(getattr(pmod, "any_hit_" + walk)(ptrav, *pargs),
                           occ_ref)
    pallas = trv.closest_hit(ptrav, *pargs)
    assert torch.equal(pallas.tri, ref.tri) and torch.equal(pallas.t, ref.t)


@pytest.mark.parametrize("walk", list(WALKS))
def test_tile_and_chunk_do_not_change_answers(walk):
    """Each walk's answers and per-ray stats are the same whether its
    plain version runs all rays at once or in tiles of 100 (a ragged
    last tile), reading its loop condition every step or every 7."""
    _, pmod = WALKS[walk]
    _, ptrav, _, _ = soup()
    _, pargs = _both(*rays(3))
    for name in ("closest_hit_", "any_hit_"):
        fn = getattr(pmod, name + walk)
        base, base_st = fn(ptrav, *pargs, tile_size=None, chunk=1,
                           with_stats=True)
        for tile, chunk in ((100, 1), (None, 7), (100, 7)):
            got, st = fn(ptrav, *pargs, tile_size=tile, chunk=chunk,
                         with_stats=True)
            assert torch.equal(st, base_st)
            if isinstance(got, torch.Tensor):
                assert torch.equal(got, base)
            else:
                for k in ("tri", "t", "b1", "b2"):
                    assert torch.equal(getattr(got, k), getattr(base, k))
        # the plain version the module offers is the CPU branch itself
        plain = traverse_packed.plain(name + walk)
        again = plain(ptrav, *pargs, tile_size=64)
        if isinstance(again, torch.Tensor):
            assert torch.equal(again, base)
        else:
            assert torch.equal(again.t, base.t)


def _assert_same_hits(got, want):
    """The leaf-cap soup's bounds: ``t`` within rtol 1e-6 outside rim
    rays (at most 2%), triangle ids equal on all but 5% (near-ties), most
    rays hitting."""
    t, t_j = got.t.numpy(), np.asarray(want.t)
    tri, tri_j = got.tri.numpy(), np.asarray(want.tri)
    assert (tri >= 0).sum() > len(t) // 2
    rim = np.abs(t - t_j) > 1e-6 * np.abs(t_j)
    assert rim.sum() <= 0.02 * len(t)
    assert (tri != tri_j).sum() <= 0.05 * len(t)


def test_leaf_cap_scene():
    """A soup of 6-triangle leaves (:func:`cube_soup`, built with leaves of
    up to 8 triangles) walked with ``max_leaf_size=4``: every walk tests
    a leaf's first 4 triangles alone, the port's as the JAX package's,
    its Pallas kernels' included (their leaf loop runs ``max_leaf_size``
    times, accel/traverse_pallas.py:185); with a cap of 8 (or the
    kernels' default 15) every triangle is tested, and the rays whose
    ``t`` the cap changes are the same in both packages, and some.
    Bounds: the triangles of a cube cross one another, so a ray often
    hits two of them within an ulp, and XLA's contraction picks the
    other: triangle ids are held on all but 5% of the rays (14 of 512
    measured at a cap of 8, every ``t`` within 1 ulp), ``t`` as in the
    module's bounds; barycentrics not at all, these triangles being
    sheared enough that the contraction moves ``b`` by up to 1e-4
    relative.  The port's walks agree among themselves bit for bit."""
    jtrav, ptrav, _, built = soup(720, 11, 8, cubes=True)
    counts = (built.end - built.start)[built.right_child < 0]
    assert counts.max() == 6
    rng = np.random.default_rng(4)
    o = rng.uniform(-6, 6, (N_RAYS, 3)).astype(np.float32)
    corners = np.asarray(jtrav.tri9)[rng.integers(
        0, jtrav.tri9.shape[0], N_RAYS)].reshape(-1, 3, 3)
    lo, hi = corners.min(axis=1), corners.max(axis=1)  # a cube each
    aim = lo + (hi - lo) * rng.uniform(0.1, 0.9, (N_RAYS, 3))
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    t_max = np.full(N_RAYS, FLOAT_MAX, np.float32)
    jargs, pargs = _both(o, d.astype(np.float32), t_max,
                         rng.uniform(size=N_RAYS) < 0.95)
    hits = {}
    for cap in (4, 8):
        kw = dict(max_leaf_size=cap, tile_size=128)
        for walk, (jmod, pmod) in WALKS.items():
            want = getattr(jmod, "closest_hit_" + walk)(jtrav, *jargs, **kw)
            got = getattr(pmod, "closest_hit_" + walk)(ptrav, *pargs, **kw)
            _assert_same_hits(got, want)
            np.testing.assert_array_equal(
                getattr(pmod, "any_hit_" + walk)(ptrav, *pargs,
                                                 **kw).numpy(),
                np.asarray(getattr(jmod, "any_hit_" + walk)(jtrav, *jargs,
                                                            **kw)))
            hits[walk, cap] = (got, want)
    jp = jtrav.replace(nodes16c=jnp.asarray(
        jax_layout.pack_wide_nodes_compact(built)))
    pallas_kw = dict(tile_size=128, interpret=True, max_leaf_size=4)
    want = closest_hit_pallas(jp, *jargs, **pallas_kw)
    got = trv.closest_hit(ptrav, *pargs, max_leaf_size=4)
    _assert_same_hits(got, want)
    np.testing.assert_array_equal(
        trv.any_hit(ptrav, *pargs, max_leaf_size=4).numpy(),
        np.asarray(any_hit_pallas(jp, *jargs, **pallas_kw)))
    assert torch.equal(got.tri, hits["packed", 4][0].tri)
    every = trv.closest_hit(ptrav, *pargs)  # the kernels' default, 15
    assert torch.equal(every.tri, hits["packed", 8][0].tri)
    moved = lambda a, b: np.abs(a - b) > 1e-6 * np.abs(b)
    differ = moved(every.t.numpy(), got.t.numpy())
    jdiffer = moved(np.asarray(hits["packed", 8][1].t),
                    np.asarray(hits["packed", 4][1].t))
    np.testing.assert_array_equal(differ, jdiffer)
    assert differ.sum() > 0
