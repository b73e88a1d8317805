"""The 4-wide collect-then-test walk (``traversal="wide4"``) on the CPU,
against the JAX package: the layout of ``accel/wide4.py``
(``collapse_binary``, ``build_leaf40``, ``pack_wide4``; bit for bit at
widths 4 and 8), the walk of ``accel/traverse_wide4.py``
(``closest_hit_wide4`` / ``any_hit_wide4``; its ``overflow`` flags
exactly, at a 32-slot buffer and at a 2-slot one that overflows, with and
without the pop-walk fallback), the scene builder's layout
(``PNRT_WIDE_WIDTH``) and ``refit_scene``'s repacking.

Inputs: the random soups of tests/test_wide4.py (400 triangles, the JAX
numpy builder) and 512 seeded rays aimed into them.  Hits are held by
tests/test_torch_xla_walks.py's bounds (XLA's FMA contraction moves
``t`` by a few ulp); occlusion and overflow exactly.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnraytracing_tpu.accel import traverse_packed as jax_packed
from pnraytracing_tpu.accel import traverse_wide4 as jax_w4
from pnraytracing_tpu.accel import wide4 as jax_wide4
from pnraytracing_tpu.diff.grad import refit_scene as jax_refit
from pnraytracing_tpu_torch.accel import traverse_packed, traverse_wide4
from pnraytracing_tpu_torch.accel import wide4
from pnraytracing_tpu_torch.diff.grad import refit_scene
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from tests.test_torch_bvh import _assert_hits_match
from tests.test_torch_xla_walks import _both, cube_soup, rays, soup
from tests.test_torch_scene import _torch_threads, port_scene  # noqa: F401


@functools.lru_cache(maxsize=None)
def layouts(num_tris=400, seed=3, width=4):
    """(JAX Wide4Data, the port's) of a soup's tree at ``width``, with
    the soup's port TravData (for the fallback)."""
    jtrav, ptrav, _, built = soup(num_tris, seed)
    tri9 = ptrav.tri9.numpy()
    return (jax_wide4.pack_wide4(built, tri9, width=width),
            wide4.pack_wide4(built, tri9, width=width), jtrav, ptrav)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("num_tris", [1, 5, 400])
def test_pack_wide4_matches_jax(num_tris, width):
    """``collapse_binary``, ``build_leaf40`` and ``pack_wide4`` equal the
    JAX package's bit for bit, leaf roots included; the row is 32 floats
    at width 4 and 56 at width 8."""
    _, ptrav, _, built = soup(num_tris, 3)
    args = (built.node_min, built.node_max, built.right_child, built.start,
            built.end)
    got = wide4.collapse_binary(*args, width=width)
    want = jax_wide4.collapse_binary(*args, width=width)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    tri9 = ptrav.tri9.numpy()
    leaf40 = wide4.build_leaf40(tri9, got[1], got[2])
    np.testing.assert_array_equal(leaf40, jax_wide4.build_leaf40(
        tri9, want[1], want[2]))
    jw, pw = (jax_wide4.pack_wide4(built, tri9, width=width),
              wide4.pack_wide4(built, tri9, width=width))
    assert pw.nodes32.shape[1] == (32 if width == 4 else 56)
    np.testing.assert_array_equal(pw.nodes32.numpy(), np.asarray(jw.nodes32))
    np.testing.assert_array_equal(pw.leaf40.numpy(), np.asarray(jw.leaf40))
    assert (pw.depth4, pw.width) == (jw.depth4, jw.width)


@pytest.mark.parametrize("width,leaf_buffer,compat", [
    (4, 32, False), (4, 2, False), (8, 32, False), (8, 3, False),
    (4, 2, True)])
def test_wide4_matches_jax(width, leaf_buffer, compat):
    """Both walks against JAX's on the same rays, without a fallback (the
    buffered leaves alone) and with the pop-test walk as fallback (each
    package's own): hits within the bounds (compat: triangle ids on all
    but 1% of the rays, tests/test_torch_bvh.py), occlusion and
    ``overflow`` exactly; the small buffers overflow on some rays; masked
    rays walk nothing.  With the fallback the default form's answers
    equal the packed walk's."""
    jw, pw, jtrav, ptrav = layouts(width=width)
    jargs, pargs = _both(*rays(6))
    kw = dict(stack_depth=(width - 1) * pw.depth4 + 4,
              leaf_buffer=leaf_buffer, compat=compat)
    jfb = dict(closest=lambda *a: jax_packed.closest_hit_pop(
        jtrav, *a, compat=compat), any=lambda *a: jax_packed.any_hit_pop(
            jtrav, *a, compat=compat))
    pfb = dict(closest=lambda *a: traverse_packed.closest_hit_pop(
        ptrav, *a, compat=compat), any=lambda *a: traverse_packed.any_hit_pop(
            ptrav, *a, compat=compat))
    ref = traverse_packed.closest_hit_packed(ptrav, *pargs)
    ref_occ = traverse_packed.any_hit_packed(ptrav, *pargs)
    for fallback in (False, True):
        want, jov = jax_w4.closest_hit_wide4(
            jw, *jargs, fallback=jfb["closest"] if fallback else None, **kw)
        got, ov = traverse_wide4.closest_hit_wide4(
            pw, *pargs, fallback=pfb["closest"] if fallback else None, **kw)
        np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
        if fallback:
            _assert_hits_match(got, want, compat)
        elif compat:
            tri = got.tri.numpy()
            assert (tri != np.asarray(want.tri)).sum() <= 0.01 * len(tri)
        else:  # overflowed rays keep the hits of their buffered leaves
            rim = np.abs(got.t.numpy() - np.asarray(want.t)) > 1e-6 * (
                np.abs(np.asarray(want.t)))
            assert rim.sum() <= 0.02 * len(rim)
            np.testing.assert_array_equal(got.tri.numpy()[~rim],
                                          np.asarray(want.tri)[~rim])
        wocc, jaov = jax_w4.any_hit_wide4(
            jw, *jargs, fallback=jfb["any"] if fallback else None, **kw)
        occ, aov = traverse_wide4.any_hit_wide4(
            pw, *pargs, fallback=pfb["any"] if fallback else None, **kw)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
        np.testing.assert_array_equal(aov.numpy(), np.asarray(jaov))
        assert not (ov | aov)[~pargs[3]].any()
        assert (int(ov.sum()) > 0) == (leaf_buffer < 8)
        if fallback and not compat:
            assert torch.equal(got.tri, ref.tri)
            assert torch.equal(got.t, ref.t)
            assert torch.equal(occ, ref_occ)


def test_wide4_stats_chunk_and_masks():
    """The [4, R] stats: masked rays and rays that never enter a box walk
    nothing (zero stats, a miss, no overflow), row 3 is the overflow
    flag, the leaves that passed are at least those buffered; ``chunk``
    changes neither answers nor stats; the plain entry point is the CPU
    branch."""
    _, pw, _, _ = layouts()
    o, d, t_max, mask = (a.copy() for a in rays(7))
    o[0, 1], d[1, 2] = np.nan, np.nan
    o[2, 0], d[2, 0] = np.inf, np.inf
    mask[:3] = True
    _, pargs = _both(o, d, t_max, mask)
    kw = dict(stack_depth=3 * pw.depth4 + 4, leaf_buffer=2,
              with_stats=True)
    hit, ov, st = traverse_wide4.closest_hit_wide4(pw, *pargs, **kw)
    assert st.shape == (4, 512) and st.dtype == torch.int32
    idle = ~pargs[3]
    idle[:3] = True
    assert not st[:, idle].any() and not hit.valid[idle].any()
    assert torch.equal(st[3].bool(), ov) and ov.any()
    assert bool((st[1] >= 0).all()) and bool(st[1][ov].gt(2).all())
    for chunk in (1, 5):
        again = traverse_wide4.closest_hit_wide4(pw, *pargs, chunk=chunk,
                                                 **kw)
        for a, b in zip((again[0].tri, again[0].t, again[1], again[2]),
                        (hit.tri, hit.t, ov, st)):
            assert torch.equal(a, b)
    plain = traverse_wide4.plain_closest_hit_wide4(pw, *pargs, **kw)
    assert torch.equal(plain[0].t, hit.t) and torch.equal(plain[2], st)
    occ, aov, ast = traverse_wide4.any_hit_wide4(pw, *pargs, **kw)
    assert not ast[:, idle].any() and not occ[idle].any()
    assert torch.equal(occ, (hit.valid & ~ov) | (occ & ov))
    assert bool((ast[2] <= st[2]).all())


def _cube_scene(builder):
    b = builder()
    b.add(shapes.cube(0.8), dict(base_color=(0.7, 0.3, 0.3)), name="cube")
    b.add(shapes.icosphere(1), dict(base_color=(0.3, 0.7, 0.3)),
          name="ball")
    return b


def test_builder_width_and_refit(monkeypatch):
    """The scene builder packs the 4-wide layout of a tree whose leaves
    hold at most 4 triangles (none for larger leaves), at
    ``PNRT_WIDE_WIDTH`` (4 without it); ``refit_scene`` repacks it from
    the new tree, equal to the JAX package's refit of the same scene,
    and keeps a scene without one without."""
    from pnraytracing_tpu.scene.build import SceneBuilder as JaxBuilder
    from pnraytracing_tpu.scene import shapes as jax_shapes

    scene = _cube_scene(SceneBuilder).build(device="cpu")
    assert scene.trav.w4 is not None and scene.trav.w4.width == 4
    assert scene.trav.w4.nodes32.shape[1] == 32
    monkeypatch.setenv("PNRT_WIDE_WIDTH", "8")
    wide = _cube_scene(SceneBuilder).build(device="cpu")
    assert wide.trav.w4.width == 8 and wide.trav.w4.nodes32.shape[1] == 56
    monkeypatch.delenv("PNRT_WIDE_WIDTH")
    positions, indices = cube_soup(np.random.default_rng(2), 20)
    big = SceneBuilder().add(
        dict(positions=positions, normals=np.zeros_like(positions),
             uvs=np.zeros((len(positions), 2), np.float32),
             indices=indices), dict(base_color=(0.5, 0.5, 0.5))).build(
        max_leaf_size=8, device="cpu")
    leaf = big.bvh.right_child < 0
    assert int((big.bvh.end - big.bvh.start)[leaf].max()) > 4
    assert big.trav.w4 is None and refit_scene(big).trav.w4 is None

    jb = JaxBuilder()
    jb.add(jax_shapes.cube(0.8), dict(base_color=(0.7, 0.3, 0.3)),
           name="cube")
    jb.add(jax_shapes.icosphere(1), dict(base_color=(0.3, 0.7, 0.3)),
           name="ball")
    js = jb.build()
    moved = js.mesh.positions * jnp.asarray([1.0, 1.5, 1.0], jnp.float32)
    jr = jax_refit(js.replace(mesh=js.mesh.replace(positions=moved)))
    ps = port_scene(js)
    pr = refit_scene(dataclasses.replace(ps, mesh=dataclasses.replace(
        ps.mesh, positions=torch.from_numpy(np.asarray(moved)))))
    np.testing.assert_array_equal(pr.trav.w4.nodes32.numpy(),
                                  np.asarray(jr.trav.w4.nodes32))
    np.testing.assert_array_equal(pr.trav.w4.leaf40.numpy(),
                                  np.asarray(jr.trav.w4.leaf40))
    assert pr.trav.w4.depth4 == jr.trav.w4.depth4
    assert not np.array_equal(pr.trav.w4.nodes32.numpy(),
                              ps.trav.w4.nodes32.numpy())
