"""The port's primitive-sharded placement (``parallel/primitive.py``) on
the CPU, against the JAX package (``pnraytracing_tpu/parallel/
primitive.py`` on its 8 forced CPU devices) and against the unsharded
walk.

* ``build_primitive_shards``: ``nodes8``, ``tri9``, ``tri_map`` and the
  stack depth bit for bit the JAX package's (its native builder, which
  builds the numpy builder's tree on this soup), for 2 and 8 shards of
  ``tests/test_primitive_shard.py::_soup``; ``convert.py``'s round trip;
* the combined closest hit and occlusion of a world of 2 (gloo, one
  shard a rank, the workers of ``tests/test_torch_parallel_workers.py``)
  against the JAX package's on ``make_device_mesh(2)``, default and
  compat: ``tri`` equal on >= 99.9% of rays, occlusion exact, ``t``
  within rtol 1e-5 and atol 1e-5 (tests/test_primitive_shard.py's
  bounds; not in compat, see the test); and bit for bit the same
  combine over 2 shards walked in one process;
* 8 shards walked in one process against the plain binary walk of one
  BVH over the whole soup, default and compat: ``t`` and occlusion
  equal, ``tri`` equal but on exact-``t`` ties, ``b1`` / ``b2`` equal
  where ``tri`` is;
* the leaf cap: shards built with leaves of up to 8 triangles
  (``chip_smoke.leaf_cap_soup``, 6-triangle leaves) walked at the
  default cap of 4 and at a cap of 8, one shard a rank and all in one
  process, against the JAX package's ``max_leaf_size`` on
  ``make_device_mesh(2)``;
* the combine's tie rule (lowest shard) and misses, and what
  ``put_shards`` places.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import leaf_cap_rays, leaf_cap_soup
from pnraytracing_tpu.parallel import primitive as jax_primitive
from pnraytracing_tpu.parallel.mesh import make_device_mesh
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel.layout import pack_tri12
from pnraytracing_tpu_torch.convert import (
    prim_shards_from_arrays,
    prim_shards_to_arrays,
)
from pnraytracing_tpu_torch.parallel import primitive
from pnraytracing_tpu_torch.parallel.mesh import Mesh
from tests import test_torch_parallel_workers as workers
from tests.test_primitive_shard import _rays, _soup
from tests.test_torch_scene import _torch_threads  # noqa: F401

T_MAX = 1e6


@functools.lru_cache(maxsize=4)
def shards(n):
    return primitive.build_primitive_shards(*_soup(), n)


@functools.lru_cache(maxsize=1)
def cap_soup():
    """The leaf-cap soup (150 groups of 6 triangles, 6-triangle leaves
    with ``max_leaf_size=8``) and 2048 rays aimed into its cubes from
    around it, numpy."""
    pos, idx = leaf_cap_soup(150, 5)
    o, d = leaf_cap_rays(pos, 2048)
    return pos, idx, o, d, np.full(len(o), T_MAX, np.float32)


@functools.lru_cache(maxsize=1)
def cap_shards():
    return primitive.build_primitive_shards(*cap_soup()[:2], 2,
                                            max_leaf_size=8)


@functools.lru_cache(maxsize=1)
def rays():
    o, d = _rays()
    return (torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
            torch.full((o.shape[0],), T_MAX))


@pytest.mark.parametrize("n", [2, 8])
def test_shards_equal_jax(n):
    got = shards(n)
    want = jax_primitive.build_primitive_shards(*_soup(), n)
    for f in ("nodes8", "tri9", "tri_map"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.n_shards == want.n_shards == n
    assert got.stack_depth == want.stack_depth == got.bvh_depth + 4
    np.testing.assert_array_equal(
        got.tri12, np.stack([pack_tri12(t) for t in got.tri9]))
    per = (got.tri_map >= 0).sum(axis=1)
    assert per.sum() == 900 and len(np.unique(got.tri_map[got.tri_map >= 0])
                                    ) == 900


def test_prim_shards_arrays_roundtrip():
    """The port's shards through ``convert.py`` and back, and the JAX
    package's carried over: both the port's own build."""
    want = shards(2)
    jax_shards = jax_primitive.build_primitive_shards(*_soup(), 2)
    for src in (want, jax_shards):
        got = prim_shards_from_arrays(prim_shards_to_arrays(src))
        for f in ("nodes8", "tri9", "tri12", "tri_map"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert (got.n_shards, got.bvh_depth, got.stack_depth) == (
            want.n_shards, want.bvh_depth, want.stack_depth)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("prim"))
    np.savez(os.path.join(wd, "shards.npz"), **prim_shards_to_arrays(
        shards(2)))
    o, d, t_max = rays()
    np.savez(os.path.join(wd, "prim_rays.npz"), o=o.numpy(), d=d.numpy(),
             t_max=t_max.numpy())
    np.savez(os.path.join(wd, "cap_shards.npz"), **prim_shards_to_arrays(
        cap_shards()))
    o, d, t_max = cap_soup()[2:]
    np.savez(os.path.join(wd, "cap_rays.npz"), o=o, d=d, t_max=t_max)
    return workers.spawn(workers.primitive_job, 2, wd)


@pytest.mark.parametrize("compat", [False, True])
def test_sharded_hits_match_jax(world2, compat):
    o, d = _rays()
    t_max = jnp.full((o.shape[0],), T_MAX, jnp.float32)
    mesh = make_device_mesh(2)
    js = jax_primitive.put_shards(
        jax_primitive.build_primitive_shards(*_soup(), 2), mesh)
    want = jax_primitive.primitive_sharded_closest_hit(js, o, d, t_max, mesh,
                                                       compat=compat)
    want_occ = np.asarray(jax_primitive.primitive_sharded_any_hit(
        js, o, d, t_max, mesh, compat=compat))
    k = f"compat{int(compat)}."
    for got in world2:
        same = got[k + "tri"] == np.asarray(want.tri)
        assert same.mean() >= 0.999, f"tri mismatch on {(~same).sum()} rays"
        if not compat:
            # compat's t is held against the port's full walk below: the
            # JAX package's jitted walk contracts the sheared compat test
            # into FMAs (ROADMAP.md Faults, "Compat frames depend on the
            # arithmetic's contraction"), which moves a hit's t by up to
            # 8.3e-5 relative here
            np.testing.assert_allclose(got[k + "t"], np.asarray(want.t),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[k + "occ"], want_occ)
    assert 0.05 < want_occ.mean() < 0.95
    # the collective combine is the one-process combine of the same shards
    placed = primitive.place_all(shards(2), "cpu")
    h = primitive.shards_closest_hit(placed, *rays(), compat=compat)
    occ = primitive.shards_any_hit(placed, *rays(), compat=compat)
    for f in ("tri", "t", "b1", "b2"):
        np.testing.assert_array_equal(world2[0][k + f],
                                      getattr(h, f).numpy())
    np.testing.assert_array_equal(world2[1][k + "occ"], occ.numpy())


@pytest.mark.parametrize("cap", [None, 8])
def test_leaf_cap_matches_jax(world2, cap):
    """Shards whose leaves hold 6 triangles (built with
    ``max_leaf_size=8``), queried at the default cap (4, as the JAX
    functions' default) and at a cap of 8, one shard a rank (world two)
    and both shards in one process, against the JAX package's
    ``primitive_sharded_*_hit`` with the same ``max_leaf_size``.
    Occlusion exact; ``t`` within rtol 1e-5 and atol 1e-5 (this module's
    bounds); triangle ids equal except where two triangles of a cube
    cross within an ulp: a ray whose ids differ has both packages' ``t``
    within 1e-6 relative (the leaf-cap soup's rule of
    ``tests/test_torch_xla_walks.py``; 2 ulp at most here).  The cap
    changes ``t`` on a fifth of the rays, so a walk that tests whole
    leaves at the default fails here."""
    pos, idx, o, d, t_max = cap_soup()
    mesh = make_device_mesh(2)
    js = jax_primitive.put_shards(
        jax_primitive.build_primitive_shards(pos, idx, 2, max_leaf_size=8),
        mesh)
    for f in ("nodes8", "tri9", "tri_map"):
        np.testing.assert_array_equal(getattr(cap_shards(), f),
                                      np.asarray(getattr(js, f)), err_msg=f)
    kw = {} if cap is None else {"max_leaf_size": cap}
    jr = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    want = jax_primitive.primitive_sharded_closest_hit(js, *jr, mesh, **kw)
    want_occ = np.asarray(jax_primitive.primitive_sharded_any_hit(
        js, *jr, mesh, **kw))
    placed = primitive.place_all(cap_shards(), "cpu")
    pr = [torch.from_numpy(x) for x in (o, d, t_max)]
    h = primitive.shards_closest_hit(placed, *pr, **kw)
    one = {f: getattr(h, f).numpy() for f in ("tri", "t", "b1", "b2")}
    one["occ"] = primitive.shards_any_hit(placed, *pr, **kw).numpy()
    k = f"cap{cap or 4}."
    for got in (*({f: w[k + f] for f in one} for w in world2), one):
        np.testing.assert_array_equal(got["occ"], want_occ)
        t_j = np.asarray(want.t)
        np.testing.assert_allclose(got["t"], t_j, rtol=1e-5, atol=1e-5)
        tie = np.abs(got["t"] - t_j) <= 1e-6 * np.abs(t_j)
        assert (tie | (got["tri"] == np.asarray(want.tri))).all()
    for f in one:  # the collective combine is the one-process combine
        np.testing.assert_array_equal(world2[0][k + f], one[f])
    assert 0.5 < want_occ.mean() < 1.0
    other = world2[0]["cap8.t" if cap is None else "cap4.t"]
    assert (other != one["t"]).mean() > 0.2


@pytest.mark.parametrize("compat", [False, True])
def test_one_process_combine_matches_full_walk(compat):
    o, d, t_max = rays()
    full = primitive.place_shard(shards(1), 0, "cpu")
    kw = dict(stack_depth=full.stack_depth, compat=compat)
    ov, dv = primitive.ray_components(o, d)
    want = trv.plain_closest_hit_binary(full.trav, ov, dv, t_max, **kw)
    want_tri = torch.where(want.valid, full.tri_map[want.tri.clamp_min(0)
                                                    .long()], -1)
    want_occ = trv.plain_any_hit_binary(full.trav, ov, dv, t_max, **kw)
    placed = primitive.place_all(shards(8), "cpu")
    got = primitive.shards_closest_hit(placed, o, d, t_max, compat=compat)
    occ = primitive.shards_any_hit(placed, o, d, t_max, compat=compat)
    torch.testing.assert_close(got.t, want.t, rtol=0, atol=0)
    same = got.tri == want_tri
    assert int((~same).sum()) <= 2
    for f in ("b1", "b2"):
        torch.testing.assert_close(getattr(got, f)[same],
                                   getattr(want, f)[same], rtol=0, atol=0)
    torch.testing.assert_close(occ, want_occ, rtol=0, atol=0)
    assert 100 < int(got.valid.sum()) < len(t_max)


def test_combine_ties_and_misses():
    """Equal ``t`` on shards 2 and 1 goes to shard 1; a ray missed by
    every shard gets ``t_max``, -1 and zeros; occlusion is the OR."""
    t = torch.tensor([[5.0, 9.0], [2.0, 9.0], [2.0, 9.0]])
    tri = torch.tensor([[10, -1], [20, -1], [30, -1]], dtype=torch.int32)
    b1 = torch.tensor([[0.1, 0.0], [0.2, 0.0], [0.3, 0.0]])
    b2 = b1 * 2
    t_max = torch.tensor([9.0, 9.0])
    hit = primitive.combine_closest(t, tri, b1, b2, [0, 2, 1], 3, t_max,
                                    primitive.local_reduce)
    assert hit.tri.tolist() == [30, -1]
    assert hit.t.tolist() == [2.0, 9.0]
    assert hit.b1.tolist() == [pytest.approx(0.3), 0.0]
    assert hit.b2.tolist() == [pytest.approx(0.6), 0.0]
    occ = torch.tensor([[False, False], [True, False], [False, False]])
    assert primitive.combine_any(occ, primitive.local_reduce).tolist() == [
        True, False]


def test_put_shards_places_only_the_binary_tables():
    got = primitive.put_shards(shards(2), Mesh(group=None, size=2, index=1),
                               device="cpu")
    assert got.shard == 1 and got.n_shards == 2
    np.testing.assert_array_equal(got.trav.nodes8.numpy(),
                                  shards(2).nodes8[1])
    np.testing.assert_array_equal(got.tri_map.numpy(), shards(2).tri_map[1])
    assert got.trav.nodes16c.shape == got.trav.tri_attr16.shape == (0, 16)
    assert got.trav.treelets is None and got.trav.stream is None
    with pytest.raises(ValueError, match="shards on a mesh"):
        primitive.put_shards(shards(2), Mesh(group=None, size=4, index=0),
                             device="cpu")
    with pytest.raises(ValueError, match="not in the mesh"):
        primitive.put_shards(shards(2), Mesh(group=None, size=2, index=-1),
                             device="cpu")
