"""The plain versions of the port's traversal and sort-key kernels against
the JAX package's Pallas kernels (run by the Pallas interpreter, as
tests/test_pallas_trav.py runs them), on random triangle soups and on the
flagship teapot.

Bounds (tests/test_pallas_trav.py::_assert_hits_close): at most 2 tri
mismatches (exact-t ties resolve by visit order, which differs: the port
walks one stack per ray, the Pallas kernel one per tile), t rtol 1e-6, b
rtol 1e-5 / atol 1e-6; attributes: normal and u/v within ~2 ulp (FMA
contraction on the JAX side), material/texture word exact; occlusion and
sort keys exact.  Also the guard that the port never imports JAX.
"""

import dataclasses
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import synthetic_key_rays
from pnraytracing_tpu.accel.layout import pack_tri_attr16 as jax_pack_attr16
from pnraytracing_tpu.accel.layout import (
    pack_wide_nodes_compact as jax_pack_compact,
)
from pnraytracing_tpu.accel.traverse_pallas import (
    any_hit_pallas,
    closest_hit_pallas,
    closest_hit_pallas_attr,
)
from pnraytracing_tpu.core.camera import camera_rays as jax_camera_rays
from pnraytracing_tpu.ops.compaction import (
    treelet_entry_key as jax_treelet_entry_key,
)
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel.bricks import treelet_index_tree
from pnraytracing_tpu_torch.accel.layout import (
    TravData,
    pack_tri12,
    pack_tri_attr16,
)
from pnraytracing_tpu_torch.convert import scene_from_arrays, scene_to_arrays
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops.compaction import (
    entry_key,
    never_enters,
    slab_entry,
    treelet_entry_key,
)
from pnraytracing_tpu_torch.ops.intersect import (
    intersect_aabb_c,
    intersect_triangle_c,
    safe_inv_dir,
)
from tests.test_packet import setup as soup_setup
from tests.test_torch_scene import (  # noqa: F401
    _torch_threads,
    jax_teapot_night,
    port_scene,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = dict(tile_size=128, interpret=True)


def _v3(a) -> V3:
    a = np.asarray(a, np.float32)
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                for k in range(3)))


def _t(a):
    return torch.from_numpy(np.array(a))


def soup(num_tris=120, num_rays=256, seed=3):
    """A random soup with both packages' traversal layouts: the JAX
    TravData gains the compact wide rows and attribute rows of the port's
    layout (copied, so both walk the same table)."""
    mesh, bvh, trav, o, d, t_max = soup_setup(num_tris, num_rays, seed)
    from tests.test_bvh import make_mesh_and_bvh, random_soup

    rng = np.random.default_rng(seed)
    positions, indices = random_soup(rng, num_tris)
    _, _, built = make_mesh_and_bvh(positions, indices)
    jtrav = trav.replace(nodes16c=jnp.asarray(jax_pack_compact(built)),
                         tri_attr16=jax_pack_attr16(mesh))
    ptrav = TravData(tri9=_t(jtrav.tri9),
                     tri12=_t(pack_tri12(np.asarray(jtrav.tri9))),
                     nodes8=_t(jtrav.nodes8),
                     nodes16c=_t(jtrav.nodes16c),
                     tri_attr16=_t(jtrav.tri_attr16),
                     treelets=torch.zeros((1, 6)),
                     treelet_tree=torch.zeros((2, 8)),
                     bvh_depth=built.max_depth)
    return jtrav, ptrav, mesh, built, o, d, t_max


def _assert_hits_close(a, b, n):
    tri_a, tri_b = a.tri.numpy(), np.asarray(b.tri)
    same = tri_a == tri_b
    assert same.sum() >= n - 2, f"{(~same).sum()} tri mismatches"
    np.testing.assert_allclose(a.t.numpy()[same], np.asarray(b.t)[same],
                               rtol=1e-6)
    for pa, pb in ((a.b1, b.b1), (a.b2, b.b2)):
        np.testing.assert_allclose(pa.numpy()[same], np.asarray(pb)[same],
                                   rtol=1e-5, atol=1e-6)
    return same


def _assert_attrs_close(attrs, jattrs, same):
    """Raw normal and u/v within ~2 ulp: XLA contracts the barycentrics
    and the interpolation a*b0 + c*b1 + e*b2 into FMAs, the port does
    not (its kernel is built with --fmad=false to match its plain
    version bit for bit).  The material/texture word is exact."""
    for k in range(5):
        np.testing.assert_allclose(attrs[k].numpy()[same],
                                   np.asarray(jattrs[k])[same], rtol=3e-7,
                                   atol=1e-7)
    np.testing.assert_array_equal(attrs[5].numpy()[same],
                                  np.asarray(jattrs[5])[same])


@pytest.mark.parametrize("seed", [3, 7])
def test_closest_hit_plain_matches_pallas(seed):
    jtrav, ptrav, _, _, o, d, t_max = soup(seed=seed)
    want = closest_hit_pallas(jtrav, o, d, t_max, **PALLAS)
    got = trv.closest_hit(ptrav, _v3(o), _v3(d), _t(t_max))
    _assert_hits_close(got, want, 256)
    assert (got.tri.numpy() >= 0).sum() >= 10  # the soup is actually hit


def test_closest_hit_attr_plain_matches_pallas():
    jtrav, ptrav, _, _, o, d, t_max = soup(seed=5)
    want, jattrs = closest_hit_pallas_attr(jtrav, o, d, t_max, **PALLAS)
    got, attrs = trv.closest_hit_attr(ptrav, _v3(o), _v3(d), _t(t_max))
    same = _assert_hits_close(got, want, 256)
    _assert_attrs_close(attrs, jattrs, same)
    miss = got.tri.numpy() < 0
    assert miss.any()
    np.testing.assert_array_equal(attrs[2].numpy()[miss], 1.0)  # +z normal
    np.testing.assert_array_equal(attrs[5].numpy()[miss], 0)


def test_closest_hit_masked_rays_miss():
    jtrav, ptrav, _, _, o, d, t_max = soup(num_rays=300, seed=11)
    mask = np.arange(300) % 3 != 0
    want = closest_hit_pallas(jtrav, o, d, t_max, jnp.asarray(mask),
                              **PALLAS)
    got, attrs = trv.closest_hit_attr(ptrav, _v3(o), _v3(d), _t(t_max),
                                      torch.from_numpy(mask))
    _assert_hits_close(got, want, 300)
    assert (got.tri.numpy()[~mask] == -1).all()
    np.testing.assert_array_equal(got.t.numpy()[~mask],
                                  np.asarray(t_max)[~mask])
    np.testing.assert_array_equal(attrs[2].numpy()[~mask], 1.0)


@pytest.mark.parametrize("seed", [9, 13])
def test_any_hit_plain_matches_pallas(seed):
    jtrav, ptrav, _, _, o, d, _ = soup(seed=seed)
    short = np.full((256,), 4.0, np.float32)
    mask = np.arange(256) % 5 != 0
    want = any_hit_pallas(jtrav, o, d, jnp.asarray(short),
                          jnp.asarray(mask), **PALLAS)
    got = trv.any_hit(ptrav, _v3(o), _v3(d), _t(short),
                      torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().any() and not got.numpy()[~mask].any()


def test_attr_table_packer_matches_jax():
    """The port's host packer gives the JAX table bit for bit, including
    the geometric-normal fallback (the soup has no vertex normals)."""
    jtrav, _, mesh, _, _, _, _ = soup()
    got = pack_tri_attr16(np.asarray(mesh.positions), np.asarray(
        mesh.normals), np.asarray(mesh.uvs), np.asarray(mesh.indices),
        np.asarray(mesh.material_id), np.asarray(mesh.texture_id))
    np.testing.assert_array_equal(got, np.asarray(jtrav.tri_attr16))


def _teapot_rays():
    js, jcam = jax_teapot_night()
    o, d, t_max = jax_camera_rays(jcam.basis(), 16, 16)
    return js, np.asarray(o), np.asarray(d), np.asarray(t_max)


def test_teapot_primary_attr_matches_pallas():
    js, o, d, t_max = _teapot_rays()
    ps = port_scene(js)
    want, jattrs = closest_hit_pallas_attr(js.trav, jnp.asarray(o),
                                           jnp.asarray(d),
                                           jnp.asarray(t_max), **PALLAS)
    got, attrs, stats = trv.closest_hit_attr(
        ps.trav, _v3(o), _v3(d), _t(t_max), with_stats=True)
    same = _assert_hits_close(got, want, 256)
    _assert_attrs_close(attrs, jattrs, same)
    assert got.valid.numpy().mean() > 0.3
    pops, leaf, tris = (s.numpy() for s in stats)
    assert (pops >= leaf).all() and (tris >= leaf).all() and pops.sum() > 0


def test_teapot_shadow_rays_match_pallas():
    """Unnormalized segments toward the lamp, t_max = 1 - SHADOW_EPS —
    the shape of the integrator's area-light shadow queries."""
    js, o, d, _ = _teapot_rays()
    hit = closest_hit_pallas(js.trav, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(np.full(256, 1e7, np.float32)),
                             **PALLAS)
    t = np.where(np.asarray(hit.tri) >= 0, np.asarray(hit.t), 1.0)
    pos = o + d * t[:, None]
    lamp = np.array([-2.5, 5.0, 0.0], np.float32)
    rng = np.random.default_rng(1)
    target = lamp + rng.uniform(-1, 1, size=(256, 3)).astype(np.float32) * \
        np.array([1, 0, 1], np.float32)
    so = (pos + 1e-3 * (target - pos)).astype(np.float32)
    sd = (target - so).astype(np.float32)
    tm = np.full(256, 1.0 - 1e-4, np.float32)
    mask = np.asarray(hit.tri) >= 0
    want = any_hit_pallas(js.trav, jnp.asarray(so), jnp.asarray(sd),
                          jnp.asarray(tm), jnp.asarray(mask), **PALLAS)
    got = trv.any_hit(port_scene(js).trav, _v3(so), _v3(sd), _t(tm),
                      torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_entry_key_matches_xla_form():
    js, _ = jax_teapot_night()
    ps = port_scene(js)
    rng = np.random.default_rng(4)
    o = rng.uniform(-4, 4, size=(512, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16, 0] = 0.0  # axis-parallel directions
    want = np.asarray(jax_treelet_entry_key(jnp.asarray(o), jnp.asarray(d),
                                            js.trav.treelets))
    got = treelet_entry_key(_v3(o), _v3(d), ps.trav.treelets)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        entry_key(_v3(o), _v3(d), ps.trav.treelets,
                  ps.trav.treelet_tree).numpy(), got.numpy())
    k = got.numpy() // 8
    assert (k < ps.trav.treelets.shape[0]).any() and (k <= 375).all()


def test_wrappers_reject_bad_inputs():
    _, ptrav, _, built, o, d, t_max = soup()
    o3, d3, tm = _v3(o), _v3(d), _t(t_max)
    with pytest.raises(ValueError, match="too shallow"):
        trv.closest_hit(ptrav, o3, d3, tm, stack_depth=built.max_depth - 1)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.from_numpy(np.array(o, np.float32))[:, 0]
        trv.any_hit(ptrav, V3(strided, o3.y, o3.z), d3, tm)
    with pytest.raises(ValueError, match="float32"):
        trv.closest_hit_attr(ptrav, o3, d3, tm.double())
    with pytest.raises(ValueError, match="mask"):
        trv.any_hit(ptrav, o3, d3, tm, torch.ones(256, dtype=torch.int32))


class PerHitFill(trv.WalkState):
    """The walk's state with the interaction fill done at every improving
    triangle test, each overwriting the last: the form the fill had
    inside the walk, kept here to hold the deferred fill against."""

    def __init__(self, ray, attr16):
        super().__init__(ray, "closest")
        z = torch.zeros_like(self.b1)
        self.attr16 = attr16
        self.attrs = [z.clone(), z.clone(), torch.ones_like(z), z.clone(),
                      z.clone(), torch.zeros_like(self.tri)]
        self.fills = torch.zeros_like(self.tri)  # improving hits a ray

    def test_leaves(self, ray, lrows, start, count, fetch_tri):
        before = self.t_best.clone()
        for k in range(int(count.max()) if count.numel() else 0):
            sel = count > k
            super().test_leaves(ray, lrows[sel], start[sel] + k,
                                torch.ones_like(count[sel]), fetch_tri)
            self.stats[1, lrows[sel]] -= 1  # one leaf pop, counted below
            w = torch.nonzero(self.t_best < before).squeeze(1)
            a = self.attr16[self.tri[w].long()]
            b1, b2 = self.b1[w], self.b2[w]
            b0 = 1.0 - b1 - b2
            for j, (c0, c1, c2) in enumerate(
                    ((0, 3, 6), (1, 4, 7), (2, 5, 8), (9, 11, 13),
                     (10, 12, 14))):
                self.attrs[j][w] = a[:, c0] * b0 + a[:, c1] * b1 + a[:, c2] * b2
            self.attrs[5][w] = a[:, 15].to(torch.int32)
            self.fills[w] += 1
            before = self.t_best.clone()
        self.stats[1, lrows] += 1


def _per_hit_walk(trav, o, d, t_max, mask):
    ray = trv.Rays.of(o, d, t_max)
    st = PerHitFill(ray, trav.tri_attr16)
    active = torch.ones_like(st.occ) if mask is None else mask
    trv.wide_walk(ray, st, active, 64, lambda rows, info: trav.nodes16c[info],
                  lambda rows, ti: (trav.tri9[ti], ti))
    return st


def _bounce_rays(trav, o, d, t_max, seed):
    """Rays leaving the primary hits in random directions (misses keep
    their primary ray), and the mask of the rays that hit."""
    hit = trv.plain_closest_hit(trav, _v3(o), _v3(d), _t(t_max))
    valid = hit.valid.numpy()
    t = np.where(valid, hit.t.numpy(), 1.0).astype(np.float32)
    rng = np.random.default_rng(seed)
    nd = rng.normal(size=d.shape).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    bo = np.where(valid[:, None], o + d * t[:, None] + 1e-3 * nd, o)
    bd = np.where(valid[:, None], nd, d)
    return bo.astype(np.float32), bd.astype(np.float32), valid


@pytest.mark.parametrize("rays", ["primary", "bounce", "masked", "missing",
                                  "soup"])
def test_deferred_fill_equals_per_hit_fill(rays):
    """interaction_fill of the walk's winning (tri, b1, b2) gives, bit for
    bit, what filling at every improving hit inside the walk left behind;
    masked and missing rays get the defaults (normal +z, uv 0, word 0)."""
    mask = None
    if rays == "soup":  # overlapping boxes: later hits overwrite earlier
        _, trav, _, _, o, d, t_max = soup(num_tris=300, num_rays=2048, seed=5)
        o, d, t_max = (np.asarray(a) for a in (o, d, t_max))
    else:
        js, o, d, t_max = _teapot_rays()
        trav = port_scene(js).trav
    if rays == "bounce":
        o, d, _ = _bounce_rays(trav, o, d, t_max, seed=2)
    elif rays == "masked":
        o, d, valid = _bounce_rays(trav, o, d, t_max, seed=3)
        mask = torch.from_numpy(valid & (np.arange(len(valid)) % 3 != 0))
    elif rays == "missing":
        d = -d  # away from the scene: nothing is hit
    o3, d3, tm = _v3(o), _v3(d), _t(t_max)
    want = _per_hit_walk(trav, o3, d3, tm, mask)
    hit, attrs, stats = trv.closest_hit_attr(trav, o3, d3, tm, mask,
                                             with_stats=True)
    assert torch.equal(hit.tri, want.tri) and torch.equal(hit.t, want.t_best)
    assert torch.equal(stats, want.stats)
    fill = trv.interaction_fill(trav.tri_attr16, want.tri, want.b1, want.b2)
    for got, got2, ref in zip(attrs, fill, want.attrs):
        assert got.dtype == ref.dtype
        assert torch.equal(got, ref) and torch.equal(got2, ref)
    miss = (hit.tri < 0).numpy()
    if rays == "missing":
        assert miss.all()
    elif rays == "masked":
        assert miss[~mask.numpy()].all() and not miss.all()
    else:
        assert (~miss).sum() >= 16  # and enough rays do hit
    for j, default in enumerate((0.0, 0.0, 1.0, 0.0, 0.0, 0)):
        np.testing.assert_array_equal(attrs[j].numpy()[miss], default)
    if rays == "soup":  # some fills were overwritten
        assert int((want.fills > 1).sum()) >= 3


def _assert_tri12(tri12, tri9):
    assert tri12.shape == (tri9.shape[0], 12) and tri12.dtype == torch.float32
    assert tri12.is_contiguous()
    assert torch.equal(tri12[:, :9], tri9)
    assert not tri12[:, 9:].any()


@pytest.mark.parametrize("source", ["built", "packed", "from_jax",
                                    "round_trip"])
def test_tri12_is_tri9_padded(source):
    """The padded triangle rows hold exactly tri9's values, zeros in the
    pad, wherever they are made: at scene build, by the packer, for a
    scene converted from the JAX package (which has no such table), and
    through a second round trip of convert.py."""
    if source == "built":
        from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

        trav = config3_teapot_night(env_height=16, device="cpu")[0].trav
        assert trav.tri12.shape[0] == 5692
    elif source == "packed":
        tri9 = np.random.default_rng(5).normal(size=(37, 9)).astype(
            np.float32)
        _assert_tri12(_t(pack_tri12(tri9)), _t(tri9))
        assert pack_tri12(tri9[:0]).shape == (0, 12)
        return
    else:
        js, _ = jax_teapot_night()
        assert not hasattr(js.trav, "tri12")
        ps = port_scene(js)
        if source == "round_trip":
            leaves = scene_to_arrays(ps)
            np.testing.assert_array_equal(leaves["trav.tri12"],
                                          ps.trav.tri12.numpy())
            ps = scene_from_arrays(leaves, device="cpu")
        trav = ps.trav
        np.testing.assert_array_equal(trav.tri9.numpy(),
                                      np.asarray(js.trav.tri9))
    _assert_tri12(trav.tri12, trav.tri9)


def test_wrappers_reject_bad_tri12():
    _, ptrav, _, _, o, d, t_max = soup()
    o3, d3, tm = _v3(o), _v3(d), _t(t_max)
    with pytest.raises(ValueError, match="tri12"):
        trv.closest_hit(dataclasses.replace(ptrav, tri12=ptrav.tri9), o3, d3,
                        tm)
    with pytest.raises(ValueError, match="row per row"):
        trv.any_hit(dataclasses.replace(ptrav, tri12=ptrav.tri12[:-1]), o3,
                    d3, tm)


# ---- the key kernel's walk of the union tree --------------------------------

def _key_tables(boxes):
    """(treelets, tree) tensors of [K, 6] boxes given as numpy."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    return _t(boxes), _t(treelet_index_tree(boxes))


def _assert_walk_equals_all_k(o, d, treelets, tree, jax_too=True):
    """The walk's keys equal the all-K plain version's and the JAX
    package's exactly; returns the [2, R] counts."""
    want = treelet_entry_key(_v3(o), _v3(d), treelets)
    key, counts = entry_key(_v3(o), _v3(d), treelets, tree, with_stats=True)
    np.testing.assert_array_equal(key.numpy(), want.numpy())
    assert key.dtype == torch.int32 and counts.dtype == torch.int32
    assert counts.shape == (2, len(o))
    if jax_too:
        jkey = jax_treelet_entry_key(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(treelets.numpy()))
        np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    return counts.numpy()


def _surface_rays(n, seed):
    """Bounce-like rays of config5: origins 1e-4 off its two spheres and
    its floor, directions over the hemisphere."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    which = rng.integers(0, 3, n)
    centre = np.where((which == 0)[:, None], (-1.2, 1.0, 0.0),
                      (1.4, 0.8, -0.5))
    radius = np.where(which == 0, 1.0, 0.8)[:, None]
    pos = centre + radius * nrm
    floor = which == 2
    pos[floor] = rng.uniform(-4, 4, size=(int(floor.sum()), 3)) * (1, 0, 1)
    nrm[floor] = (0.0, 1.0, 0.0)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d *= np.sign((d * nrm).sum(axis=1, keepdims=True))
    return (pos + 1e-4 * nrm).astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("rays", ["primary", "bounce", "config5"])
def test_entry_key_walk_equals_all_k(rays):
    """The pruned walk gives the all-K key of both packages on the
    teapot's camera and bounce rays and on config5's table (K = 388), and
    tests a fraction of the K boxes."""
    if rays == "config5":
        from pnraytracing_tpu_torch.scene.scenes import config5_large

        trav = config5_large(6, device="cpu")[0].trav
        assert trav.treelets.shape == (388, 6)
        o, d = _surface_rays(3000, 11)
    else:
        js, o, d, t_max = _teapot_rays()
        trav = port_scene(js).trav
        if rays == "bounce":
            o, d, _ = _bounce_rays(trav, o, d, t_max, seed=6)
    counts = _assert_walk_equals_all_k(o, d, trav.treelets,
                                       trav.treelet_tree)
    k = trav.treelets.shape[0]
    assert counts.sum(axis=0).mean() < k / 4
    assert counts[0].min() >= 0 and counts.sum(axis=0).min() >= 1


def _random_boxes(rng, k):
    """K boxes that overlap, some nested in their predecessor, some
    exact duplicates of it."""
    lo = rng.uniform(-2, 2, size=(k, 3))
    hi = lo + rng.uniform(0.0, 1.5, size=(k, 3))  # flat boxes too
    for j in range(1, k):
        kind = rng.integers(0, 6)
        if kind == 0:  # a duplicate
            lo[j], hi[j] = lo[j - 1], hi[j - 1]
        elif kind == 1:  # nested in the one before
            a, b = np.sort(rng.uniform(0, 1, size=(2, 3)), axis=0)
            size = hi[j - 1] - lo[j - 1]
            lo[j], hi[j] = lo[j - 1] + a * size, lo[j - 1] + b * size
    return np.concatenate([lo, hi], axis=1).astype(np.float32)


@settings(max_examples=12, deadline=None, derandomize=True)
@given(k=st.sampled_from([1, 2, 3, 7, 8, 9, 31, 32, 33, 375, 512]),
       seed=st.integers(0, 2 ** 16))
def test_entry_key_walk_property(k, seed):
    """pruned == all K on random boxes (overlapping, nested, duplicated)
    and rays from inside, outside, and with zero direction components,
    for K around the tree's powers of two, K = 1 and the cap."""
    rng = np.random.default_rng(seed)
    treelets, tree = _key_tables(_random_boxes(rng, k))
    assert tree.shape == (2 * (1 << (k - 1).bit_length()), 8)
    n = 256
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:32, rng.integers(0, 3)] = 0.0
    d[:8] = 0.0
    o[32:64] = treelets.numpy()[rng.integers(0, k, 32), :3]  # on a corner
    counts = _assert_walk_equals_all_k(o, d, treelets, tree, jax_too=False)
    assert counts.sum(axis=0).max() <= tree.shape[0] - 1


@pytest.mark.parametrize("case", ["identical_boxes", "inside_several",
                                  "enters_none", "zero_direction",
                                  "padded_tail", "single_box",
                                  "non_finite"])
def test_entry_key_walk_constructed(case):
    """The trouble spots of the pruned walk, one by one."""
    unit = np.array([[0, 0, 0, 1, 1, 1]], np.float32)
    o = np.array([[0.5, 0.5, 0.5], [-1.0, 0.5, 0.5], [0.5, 3.0, 0.5]],
                 np.float32)
    d = np.array([[1, 0, 0], [1, 0, 0], [0, -1, 0]], np.float32)
    if case == "identical_boxes":  # the lower index wins, inside and out
        boxes = np.repeat(unit, 5, axis=0)
        boxes[0] += 5.0
        want_k = [1, 1, 1]
    elif case == "inside_several":  # nested: all hold the origin, first wins
        boxes = np.array([[9, 9, 9, 10, 10, 10], [-1, -1, -1, 2, 2, 2],
                          [0, 0, 0, 1, 1, 1], [0.4, 0.4, 0.4, 0.6, 0.6, 0.6]],
                         np.float32)
        want_k = [1, 1, 1]
    elif case == "enters_none":
        boxes = np.repeat(unit, 3, axis=0) + np.float32(7.0)
        want_k = [3, 3, 3]
    elif case == "zero_direction":  # all-zero direction: inside = entered
        boxes = np.concatenate([unit + 4.0, unit])
        d = np.zeros_like(d)
        want_k = [1, 2, 2]
    elif case == "padded_tail":  # K = 5 of P = 8: rays that enter only the
        boxes = np.repeat(unit, 5, axis=0) + 7.0  # last box, or nothing
        boxes[4] = unit[0]
        want_k = [4, 4, 4]
        o = np.concatenate([o, [[0.5, 0.5, -9.0]]]).astype(np.float32)
        d = np.concatenate([d, [[0, 1, 0]]]).astype(np.float32)
        want_k.append(5)
    elif case == "single_box":
        boxes, want_k = unit, [0, 0, 0]
    else:  # non-finite lanes: the all-K plain version is the rule
        boxes = _random_boxes(np.random.default_rng(0), 40)
        o3, d3 = synthetic_key_rays(_t(boxes), "cpu", n=1024, seed=3)
        o = np.stack([c.numpy() for c in (o3.x, o3.y, o3.z)], axis=1)
        d = np.stack([c.numpy() for c in (d3.x, d3.y, d3.z)], axis=1)
        bad = never_enters(o3, d3).numpy()
        assert bad.sum() == 192 and not bad[:640].any()
        want_k = None
    treelets, tree = _key_tables(boxes)
    counts = _assert_walk_equals_all_k(o, d, treelets, tree)
    key = entry_key(_v3(o), _v3(d), treelets, tree).numpy()
    if want_k is not None:
        np.testing.assert_array_equal(key // 8, want_k)
        oct_ = (d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0)
        np.testing.assert_array_equal(key % 8, oct_)
    else:  # a NaN ray enters nothing and walks nothing
        assert (key[bad] // 8 == 40).all() and not counts[:, bad].any()
        assert (key[~bad] // 8 < 40).any()
    if case == "padded_tail":  # ray 1 enters box 4 from outside at t = 1,
        p = tree.shape[0] // 2  # then tests its copy in leaf 5, in vain
        assert torch.equal(tree[p + 5:], tree[p + 4].expand(3, 8))
        assert counts[1, 1] >= 2 and key[1] // 8 == 4


def test_slab_entry_is_monotone_in_the_box():
    """Fact 2 of the key kernel: for a box U that contains a box B, the
    same float32 expression gives t_near(U) <= t_near(B) and t_far(U) >=
    t_far(B) bit for bit, so a ray that misses U misses B."""
    rng = np.random.default_rng(8)
    n = 20000
    lo_u = rng.uniform(-3, 3, size=(n, 3))
    hi_u = lo_u + rng.uniform(0, 3, size=(n, 3))
    a, b = np.sort(rng.uniform(0, 1, size=(2, n, 3)), axis=0)
    a[: n // 4] = 0.0  # shared faces
    lo_b = lo_u + a * (hi_u - lo_u)
    hi_b = lo_u + b * (hi_u - lo_u)
    lo_u, hi_u, lo_b, hi_b = (x.astype(np.float32) for x in
                              (lo_u, hi_u, lo_b, hi_b))
    lo_u, hi_u = np.minimum(lo_u, lo_b), np.maximum(hi_u, hi_b)
    o = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 8, 0] = 0.0
    d[n // 8: n // 4] *= 1e-12  # huge inverses: products overflow to inf
    o[n // 4: n // 4 + 100, 1] = np.inf
    d[n // 4 + 100: n // 4 + 200, 2] = -np.inf
    rows = lambda lo, hi: _t(np.concatenate(
        [lo, np.zeros((n, 1), np.float32), hi, np.zeros((n, 1), np.float32)],
        axis=1))
    o3, d3 = _v3(o), _v3(d)
    assert not never_enters(o3, d3).any()
    inv = [safe_inv_dir(c) for c in (d3.x, d3.y, d3.z)]
    near_u, far_u = slab_entry(rows(lo_u, hi_u), o3.x, o3.y, o3.z, *inv)
    near_b, far_b = slab_entry(rows(lo_b, hi_b), o3.x, o3.y, o3.z, *inv)
    for x in (near_u, far_u, near_b, far_b):
        assert not torch.isnan(x).any()
    assert bool((near_u <= near_b).all()) and bool((far_u >= far_b).all())
    miss_u = ~(far_u >= near_u)
    assert bool(miss_u.any()) and not bool((far_b >= near_b)[miss_u].any())


def test_treelets_come_in_depth_first_order():
    """Fact 1: the treelet boxes are subtree roots in ascending node id
    (depth-first order), so unions of consecutive boxes are tight: far
    smaller than unions of as many boxes picked at random."""
    js, _ = jax_teapot_night()
    ps = port_scene(js)
    tre = ps.trav.treelets.numpy()
    node_min, node_max = ps.bvh.node_min.numpy(), ps.bvh.node_max.numpy()
    nodes = np.concatenate([node_min, node_max], axis=1)
    ids, last = [], -1
    for row in tre:  # the first node after the last one with this box
        match = np.nonzero((nodes == row).all(axis=1))[0]
        assert (match > last).any(), "boxes are not in ascending node id"
        last = int(match[match > last][0])
        ids.append(last)
    assert len(ids) == 375

    def union_volume(order):
        g = tre[order][: len(tre) // 8 * 8].reshape(-1, 8, 6)
        size = g[:, :, 3:].max(axis=1) - g[:, :, :3].min(axis=1)
        return float(np.median(np.prod(size, axis=1)))

    shuffled = np.random.default_rng(0).permutation(len(tre))
    assert union_volume(np.arange(len(tre))) < 0.1 * union_volume(shuffled)


def _assert_tree(tree, treelets):
    k = treelets.shape[0]
    p = 1 << (k - 1).bit_length()
    assert tree.shape == (2 * p, 8) and tree.dtype == torch.float32
    assert tree.is_contiguous()
    np.testing.assert_array_equal(tree.numpy(),
                                  treelet_index_tree(treelets.numpy()))
    t = tree.numpy()
    np.testing.assert_array_equal(t[p:p + k, [0, 1, 2, 4, 5, 6]],
                                  treelets.numpy())
    for i in range(1, p):  # a row holds both rows under it
        assert (t[i, 0:3] <= t[2 * i:2 * i + 2, 0:3]).all()
        assert (t[i, 4:7] >= t[2 * i:2 * i + 2, 4:7]).all()


@pytest.mark.parametrize("source", ["built", "from_jax", "round_trip"])
def test_treelet_tree_belongs_to_treelets(source):
    """The key kernel's union tree is made from ``treelets`` alone,
    wherever the scene comes from: SceneBuilder, a scene converted from
    the JAX package (which has no such table), a second round trip."""
    if source == "built":
        from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

        trav = config3_teapot_night(env_height=16, device="cpu")[0].trav
        assert trav.treelets.shape == (375, 6)
    else:
        js, _ = jax_teapot_night()
        assert not hasattr(js.trav, "treelet_tree")
        ps = port_scene(js)
        if source == "round_trip":
            leaves = scene_to_arrays(ps)
            np.testing.assert_array_equal(leaves["trav.treelet_tree"],
                                          ps.trav.treelet_tree.numpy())
            ps = scene_from_arrays(leaves, device="cpu")
        trav = ps.trav
        np.testing.assert_array_equal(trav.treelets.numpy(),
                                      np.asarray(js.trav.treelets))
    _assert_tree(trav.treelet_tree, trav.treelets)


def test_entry_key_rejects_a_foreign_tree():
    boxes = _random_boxes(np.random.default_rng(1), 20)
    treelets, tree = _key_tables(boxes)
    o = _v3(np.zeros((4, 3), np.float32))
    d = _v3(np.ones((4, 3), np.float32))
    other = _key_tables(_random_boxes(np.random.default_rng(2), 20))[1]
    small = _key_tables(boxes[:10])[1]
    for bad in (other, small, tree[:, :6].contiguous(), tree.double()):
        with pytest.raises(ValueError, match="tree"):
            entry_key(o, d, treelets, bad)
    with pytest.raises(ValueError, match="treelets"):
        entry_key(o, d, treelets[:, :5].contiguous(), tree)
    with pytest.raises(ValueError, match="lo <= hi"):
        treelet_index_tree(boxes[:, [3, 4, 5, 0, 1, 2]] + np.float32(
            [0, 0, 0, -9, 0, 0]))
    with pytest.raises(ValueError, match="finite"):
        treelet_index_tree(np.array([[0, 0, 0, 1, np.inf, 1]], np.float32))


_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|flax|optax|pnraytracing_tpu)\b(?!_torch)"
    r"|from\s+(?:jax|flax|optax|pnraytracing_tpu)\b(?!_torch))")


def _port_sources():
    root = os.path.join(REPO, "pnraytracing_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_never_imports_jax():
    """No module of the port and no line of chip_smoke.py imports jax,
    flax, optax or the JAX package (even its numpy-only modules)."""
    srcs = list(_port_sources())
    assert len(srcs) > 20
    for path in srcs:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                assert not _FORBIDDEN.search(line), f"{path}:{n}: {line}"
                assert "pnraytracing_tpu." not in line.replace(
                    "pnraytracing_tpu_torch", "") or "import" not in line, (
                    f"{path}:{n}: {line}")


@functools.lru_cache(maxsize=1)
def _non_finite_case():
    """The flagship carried over, and 4,096 key-style rays of which 768
    never enter a box (chip_smoke.synthetic_key_rays)."""
    ps = port_scene(jax_teapot_night()[0])
    o, d = synthetic_key_rays(ps.trav.treelets, "cpu")
    return ps.trav, o, d


def test_never_entering_rays_hit_nothing():
    """The rule every walk keeps for rays of ``never_enters`` (walk
    nothing) changes no result: such a ray fails every slab test and
    every triangle test, by brute force over the flagship's triangles."""
    trav, o, d = _non_finite_case()
    bad = never_enters(o, d)
    assert int(bad.sum()) == 768
    ob = V3(o.x[bad], o.y[bad], o.z[bad])
    db = V3(d.x[bad], d.y[bad], d.z[bad])
    tri = trav.tri9
    hit, _, _, _ = intersect_triangle_c(
        (tri[:, 0], tri[:, 1], tri[:, 2]), (tri[:, 3], tri[:, 4], tri[:, 5]),
        (tri[:, 6], tri[:, 7], tri[:, 8]), ob.x[:, None], ob.y[:, None],
        ob.z[:, None], db.x[:, None], db.y[:, None], db.z[:, None],
        torch.full((1, 1), float("inf")))
    assert not bool(hit.any())
    root = trav.nodes8[0]
    assert not bool(intersect_aabb_c(
        root[0:3], root[3:6], ob.x, ob.y, ob.z, safe_inv_dir(db.x),
        safe_inv_dir(db.y), safe_inv_dir(db.z), float("inf")).any())


@pytest.mark.parametrize("walk", ["closest_hit_attr", "closest_hit", "any_hit",
                                  "closest_hit_binary", "any_hit_binary"])
def test_plain_walks_skip_never_entering_rays(walk):
    """Every plain walk gives a ray of ``never_enters`` no pop at all, as
    the kernels do; the other rays walk as before."""
    trav, o, d = _non_finite_case()
    n = o.x.shape[0]
    t_max = torch.full((n,), 1e7)
    fn = getattr(trv, "plain_" + walk)
    out = fn(trav, o, d, t_max, with_stats=True)
    res, stats = out[0], out[-1]
    bad = never_enters(o, d)
    assert not bool(stats[:, bad].any())
    assert bool((stats[0, ~bad] > 0).all())
    if walk.startswith("any_hit"):
        assert not bool(res[bad].any())
    else:
        assert not bool(res.valid[bad].any())
        assert torch.equal(res.t[bad], t_max[bad])
