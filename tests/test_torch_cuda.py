"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py``.

Bounds: the kernels are built with --fmad=false and repeat their plain
versions op for op, so hits, barycentrics, attributes, occlusion,
keys and the walk stats are equal; a triangle id may differ only on an
exact-t tie.  A frame replayed from its captured CUDA graph
(render/program.py) equals the eager frame bit for bit.  The gradient
path: a trace's records through the kernels equal those of the plain
walks bit for bit; the replay gradient is within 1e-3 (in norm) of the
live one; two runs of one gradient step are equal bit for bit; the
kernels' answers carry no gradient.  The captured gradient step
(diff/program.py) equals the eager step bit for bit, and an
``adam_optimize`` run captures once.  ``parallel/`` in a
world of one on NCCL: the sharded frame equals the eager frame bit for
bit, and the primitive-sharded queries launch kernels 5 and 6 (or their
compat forms) once each and equal the same queries through the plain
versions.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from chip_smoke import Recorder, compat_rays, synthetic_key_rays
from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.accel import traverse_stream_cuda as trs
from pnraytracing_tpu_torch.accel.bricks import treelet_index_tree
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops import compaction
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def flagship():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    scene, cam = config3_teapot_night(env_height=64, device="cuda")
    return scene, cam.basis(device="cuda")


@pytest.fixture(scope="module")
def stream_scene():
    """An icosphere(3) + floor cut into 8 KB bricks, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    b = SceneBuilder()
    b.add(shapes.icosphere(3), dict(base_color=(0.7, 0.3, 0.2)), name="ball")
    b.add(shapes.quad(half=4.0), dict(base_color=(0.6, 0.6, 0.6)),
          name="floor")
    scene = b.build(env_constant=(0.3, 0.3, 0.3), device="cuda")
    from pnraytracing_tpu_torch.accel.bricks import build_stream_data

    scene.trav.stream = build_stream_data(scene.bvh, scene.mesh, 8 << 10,
                                          device="cuda")
    return scene


@pytest.fixture(scope="module")
def many_brick_scene():
    """Two icosphere(4) over a floor (10,244 triangles) cut into 8 KB
    bricks: a few hundred bricks under a deep top tree."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnraytracing_tpu_torch.accel.bricks import build_stream_data
    from pnraytracing_tpu_torch.scene.transform import translate

    b = SceneBuilder()
    b.add(shapes.icosphere(4), dict(base_color=(0.7, 0.3, 0.2)), name="left",
          transform=translate(-1.2, 1.0, 0))
    b.add(shapes.icosphere(4), dict(base_color=(0.8, 0.7, 0.6)),
          name="right", transform=translate(1.2, 1.0, 0))
    b.add(shapes.quad(half=4.0), dict(base_color=(0.6, 0.6, 0.6)),
          name="floor")
    scene = b.build(env_constant=(0.3, 0.3, 0.3), device="cuda")
    scene.trav.stream = build_stream_data(scene.bvh, scene.mesh, 8 << 10,
                                          device="cuda")
    return scene


def _rays(n, seed):
    """Rays from random points above the floor toward random directions,
    plus a mask, on the card."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.05, 4, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    v3 = lambda a: V3(*(cuda(a[:, k]) for k in range(3)))
    t_max = cuda(rng.uniform(0.5, 10, n).astype(np.float32))
    return v3(o), v3(d), t_max, cuda(rng.uniform(size=n) < 0.8)


def test_closest_hit_attr_kernel_matches_plain(flagship):
    scene, _ = flagship
    o, d, t_max, mask = _rays(1 << 16, 0)
    hit, attrs = trv.closest_hit_attr(scene.trav, o, d, t_max, mask)
    want, wattrs = trv.plain_closest_hit_attr(scene.trav, o, d, t_max, mask)
    same = hit.tri == want.tri
    assert int((~same).sum()) <= 1
    for a, b in [(hit.t, want.t), (hit.b1, want.b1), (hit.b2, want.b2),
                 *zip(attrs, wattrs)]:
        assert torch.equal(a[same], b[same])
    assert bool(want.valid.any())


def test_closest_hit_kernel_matches_plain(flagship):
    scene, _ = flagship
    o, d, t_max, mask = _rays(1 << 16, 1)
    hit = trv.closest_hit(scene.trav, o, d, t_max, mask)
    want = trv.plain_closest_hit(scene.trav, o, d, t_max, mask)
    same = hit.tri == want.tri
    assert int((~same).sum()) <= 1
    assert torch.equal(hit.t[same], want.t[same])


def test_any_hit_kernel_matches_plain(flagship):
    scene, _ = flagship
    o, d, t_max, mask = _rays(1 << 16, 2)
    occ = trv.any_hit(scene.trav, o, d, t_max, mask)
    assert torch.equal(occ, trv.plain_any_hit(scene.trav, o, d, t_max, mask))
    assert bool(occ.any()) and not bool(occ[~mask].any())


def test_entry_key_kernel_matches_plain(flagship):
    scene, _ = flagship
    o, d, _, _ = _rays(1 << 16, 3)
    key = compaction.entry_key(o, d, scene.trav.treelets,
                               scene.trav.treelet_tree)
    assert torch.equal(key, compaction.treelet_entry_key(
        o, d, scene.trav.treelets))


def _key_case(case, trav):
    """(o, d, treelets, tree) of one edge case of the key kernel."""
    tre, tree = trav.treelets, trav.treelet_tree
    if case == "synthetic":
        return (*synthetic_key_rays(tre, "cuda"), tre, tree)
    if case in ("one_box", "cap"):  # K = 1 and K = 512 random boxes
        k = 1 if case == "one_box" else 512
        rng = np.random.default_rng(31)
        lo = rng.uniform(-3, 3, size=(k, 3))
        boxes = np.concatenate([lo, lo + rng.uniform(0, 2, size=(k, 3))],
                               axis=1).astype(np.float32)
        tre = torch.from_numpy(boxes).cuda()
        tree = torch.from_numpy(treelet_index_tree(boxes)).cuda()
    n = {"one_ray": 1, "ragged": 256 * 19 + 7}.get(case, 1 << 14)
    o, d, _, _ = _rays(n, 30)
    return o, d, tre, tree


@pytest.mark.parametrize("case", ["random", "one_ray", "ragged", "one_box",
                                  "cap", "synthetic"])
def test_entry_key_kernel_equals_both_plain_versions(flagship, case):
    """The key kernel against the all-K plain version (keys) and the plain
    version of its walk (keys and the [2, R] counts), non-finite lanes
    included."""
    o, d, tre, tree = _key_case(case, flagship[0].trav)
    before = compaction.LAUNCHES["treelet_entry_key"]
    key, counts = compaction.entry_key(o, d, tre, tree, with_stats=True)
    wkey, wcounts = compaction.entry_key_walk(o, d, tree, tre.shape[0])
    assert compaction.LAUNCHES["treelet_entry_key"] == before + 1
    assert key.dtype == torch.int32 and counts.shape == (2, o.x.shape[0])
    assert torch.equal(key, compaction.treelet_entry_key(o, d, tre))
    assert torch.equal(key, wkey) and torch.equal(counts, wcounts)
    assert torch.equal(key, compaction.entry_key(o, d, tre, tree))
    if case == "synthetic":
        bad = compaction.never_enters(o, d)
        assert int(bad.sum()) == 768
        assert bool((key[bad] // 8 == tre.shape[0]).all())
        assert not bool(counts[:, bad].any())
    if case in ("random", "cap"):
        assert bool((key // 8 < tre.shape[0]).any())
        # boxes in depth-first order prune well, boxes in random order less
        frac = 3 if case == "random" else 1
        assert float(counts.sum()) / o.x.shape[0] < tre.shape[0] / frac


def test_entry_key_kernel_info(flagship):
    info = compaction.kernel_info(flagship[0].trav.treelets.shape[0])
    assert info["threads"] == 256 and 0 < info["registers"] <= 64
    assert info["blocks_per_sm"] >= 4 and info["shared_bytes"] == 32768


def test_frame_through_kernels_matches_plain(flagship, monkeypatch):
    from pnraytracing_tpu_torch.accel import walks
    from pnraytracing_tpu_torch.render import integrator

    scene, cam = flagship
    cfg = RenderConfig(width=64, height=64, max_depth=3)
    for counts in (trv.LAUNCHES, compaction.LAUNCHES):
        for k in counts:
            counts[k] = 0
    img = render_frame(scene, cam, cfg, 0, eager=True)
    assert trv.LAUNCHES == dict({k: 0 for k in trv.LAUNCHES},
                                closest_hit_attr=4, any_hit=3)
    assert compaction.LAUNCHES == {"treelet_entry_key": 2}
    monkeypatch.setattr(walks, "closest_hit_attr",
                        trv.plain_closest_hit_attr)
    monkeypatch.setattr(walks, "any_hit", trv.plain_any_hit)
    monkeypatch.setattr(integrator, "entry_key",
                        lambda o, d, treelets, tree:
                        compaction.treelet_entry_key(o, d, treelets))
    want = render_frame(scene, cam, cfg, 0, eager=True)
    off = (img - want).abs().amax(dim=-1) > 3e-5
    assert int(off.sum()) <= 1


def _wide_case(case):
    """(rays, mask) of one edge case of the resident wide kernels."""
    n = {"one_ray": 1, "ragged": 128 * 37 + 5}.get(case, 1 << 14)
    o, d, t_max, mask = _rays(n, 20)
    if case == "t_max_zero":
        t_max = torch.zeros_like(t_max)
    elif case == "t_max_inf":
        t_max = torch.full_like(t_max, float("inf"))
    elif case == "all_masked":
        mask = torch.zeros_like(mask)
    elif case == "no_mask":
        mask = None
    elif case == "one_ray":
        mask = torch.ones_like(mask)
    return o, d, t_max, mask


_CASES = ["random", "no_mask", "t_max_zero", "t_max_inf", "all_masked",
          "one_ray", "ragged"]


@pytest.mark.parametrize("case", _CASES)
def test_binary_kernels_equal_plain_with_stats(flagship, case):
    """Kernels 5-6 (``variant="binary"``) against their plain versions on
    the edge cases of the wide walks: hits, barycentrics, occlusion and
    the [3, R] walk stats all equal."""
    trav = flagship[0].trav
    o, d, t_max, mask = _wide_case(case)
    before = dict(trv.LAUNCHES)
    hit, st = trv.closest_hit(trav, o, d, t_max, mask, variant="binary",
                              with_stats=True)
    want, wst = trv.plain_closest_hit_binary(trav, o, d, t_max, mask,
                                             with_stats=True)
    occ, ast = trv.any_hit(trav, o, d, t_max, mask, variant="binary",
                           with_stats=True)
    wocc, wast = trv.plain_any_hit_binary(trav, o, d, t_max, mask,
                                          with_stats=True)
    torch.cuda.synchronize()
    for a, b in [(hit.tri, want.tri), (hit.t, want.t), (hit.b1, want.b1),
                 (hit.b2, want.b2)]:
        assert torch.equal(a, b)
    assert st.shape == (3, o.x.shape[0]) and torch.equal(st, wst)
    assert torch.equal(occ, wocc) and torch.equal(ast, wast)
    for name in ("closest_hit_binary", "any_hit_binary"):
        assert trv.LAUNCHES[name] == before[name] + 1
    if case in ("t_max_zero", "all_masked"):
        assert not bool(want.valid.any()) and not bool(occ.any())
        assert torch.equal(hit.t, t_max)
    if case == "all_masked":
        assert not bool(st.any()) and not bool(ast.any())
    if case in ("random", "no_mask", "t_max_inf", "ragged"):
        assert bool(want.valid.any()) and bool(occ.any())
        assert int(st[0].max()) > 40


@pytest.mark.parametrize("case", _CASES)
def test_wide_kernels_equal_plain_with_stats(flagship, case):
    """Kernels 1-3 against their plain versions: hits, barycentrics, the
    interaction fill, occlusion and the [3, R] walk stats all equal."""
    trav = flagship[0].trav
    o, d, t_max, mask = _wide_case(case)
    before = dict(trv.LAUNCHES)
    hit, attrs, st = trv.closest_hit_attr(trav, o, d, t_max, mask,
                                          with_stats=True)
    want, wattrs, wst = trv.plain_closest_hit_attr(trav, o, d, t_max, mask,
                                                   with_stats=True)
    hit3, st3 = trv.closest_hit(trav, o, d, t_max, mask, with_stats=True)
    occ, ast = trv.any_hit(trav, o, d, t_max, mask, with_stats=True)
    wocc, wast = trv.plain_any_hit(trav, o, d, t_max, mask, with_stats=True)
    torch.cuda.synchronize()
    for h in (hit, hit3):
        for a, b in [(h.tri, want.tri), (h.t, want.t), (h.b1, want.b1),
                     (h.b2, want.b2)]:
            assert torch.equal(a, b)
    for a, b in zip(attrs, wattrs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert st.shape == (3, o.x.shape[0])
    assert torch.equal(st, wst) and torch.equal(st3, wst)
    assert torch.equal(occ, wocc) and torch.equal(ast, wast)
    for name in ("closest_hit_attr", "closest_hit", "any_hit"):
        assert trv.LAUNCHES[name] == before[name] + 1
    if case in ("t_max_zero", "all_masked"):
        assert not bool(want.valid.any()) and not bool(occ.any())
        assert torch.equal(hit.t, t_max)
        assert bool((attrs[2] == 1.0).all()) and not bool(attrs[5].any())
    if case == "all_masked":
        assert not bool(st.any()) and not bool(ast.any())
    if case in ("random", "no_mask", "t_max_inf", "ragged"):
        assert bool(want.valid.any()) and bool(occ.any())
        assert int(st[0].max()) > 20


@pytest.mark.parametrize("variant", ["wide", "binary"])
def test_wide_wrappers_raise_on_too_deep_bvh(flagship, variant):
    """A BVH deeper than the kernels' 64-entry stack: no stack_depth is
    both deep enough for the scene and within the kernel, so the wrappers
    raise and launch nothing."""
    trav = flagship[0].trav
    deep = dataclasses.replace(trav, bvh_depth=trv.KERNEL_STACK + 1)
    o, d, t_max, mask = _rays(64, 21)
    before = dict(trv.LAUNCHES)
    binary = functools.partial(trv.closest_hit, variant="binary")
    binary_any = functools.partial(trv.any_hit, variant="binary")
    fns = ((binary, binary_any) if variant == "binary" else
           (trv.closest_hit_attr, trv.closest_hit, trv.any_hit))
    for fn in fns:
        with pytest.raises(ValueError, match="too shallow"):
            fn(deep, o, d, t_max, mask)
        with pytest.raises(ValueError, match="64-entry stack"):
            fn(deep, o, d, t_max, mask, stack_depth=trv.KERNEL_STACK + 1)
    assert trv.LAUNCHES == before


def test_wide_kernel_info(flagship):
    info = trv.kernel_info()
    names = {"closest_hit_attr", "closest_hit", "any_hit",
             "closest_hit_binary", "any_hit_binary"}
    assert set(info) == names | {n + "_compat" for n in names}
    for v in info.values():
        assert v["threads"] == 128 and 0 < v["registers"] <= 255
        assert v["blocks_per_sm"] >= 1 and v["local_bytes"] >= 256


def _assert_closest_equal(hit, want, stats=None, wstats=None):
    same = hit.tri == want.tri
    assert int((~same).sum()) <= 1
    for a, b in [(hit.t, want.t), (hit.b1, want.b1), (hit.b2, want.b2)]:
        assert torch.equal(a[same], b[same])
    assert bool(want.valid.any())
    if stats is not None and bool(same.all()):
        assert torch.equal(stats, wstats)


@pytest.mark.parametrize("seed", [4, 5])
def test_binary_kernels_match_plain(flagship, seed):
    scene, _ = flagship
    o, d, t_max, mask = _rays(1 << 15, seed)
    hit, st = trv.closest_hit(scene.trav, o, d, t_max, mask,
                              variant="binary", with_stats=True)
    want, wst = trv.plain_closest_hit_binary(scene.trav, o, d, t_max, mask,
                                             with_stats=True)
    _assert_closest_equal(hit, want, st, wst)
    occ, st = trv.any_hit(scene.trav, o, d, t_max, mask, variant="binary",
                          with_stats=True)
    wocc, wst = trv.plain_any_hit_binary(scene.trav, o, d, t_max, mask,
                                         with_stats=True)
    assert torch.equal(occ, wocc) and torch.equal(st, wst)
    assert trv.LAUNCHES["closest_hit_binary"] > 0
    assert trv.LAUNCHES["any_hit_binary"] > 0


def _assert_stream_equals_plain(trav, o, d, t_max, mask):
    """Both stream kernels against their plain versions (results and the
    [4, R] stats equal) and against the resident walk of the same tree."""
    hit, st = trs.closest_hit_stream(trav, o, d, t_max, mask,
                                     with_stats=True)
    want, wst = trs.plain_closest_hit_stream(trav, o, d, t_max, mask,
                                             with_stats=True)
    assert st.shape == (4, o.x.shape[0])
    _assert_closest_equal(hit, want, st, wst)
    occ, st = trs.any_hit_stream(trav, o, d, t_max, mask, with_stats=True)
    wocc, wst = trs.plain_any_hit_stream(trav, o, d, t_max, mask,
                                         with_stats=True)
    assert torch.equal(occ, wocc) and torch.equal(st, wst)
    # the bricks cover the tree: the resident walk gives the same hits
    res = trv.closest_hit(trav, o, d, t_max, mask)
    assert torch.equal(hit.t, res.t)
    assert int((hit.tri != res.tri).sum()) <= 1
    assert torch.equal(occ, trv.any_hit(trav, o, d, t_max, mask))


@pytest.mark.parametrize("n", [100, 1 << 14])
def test_stream_kernels_match_plain(stream_scene, n):
    _assert_stream_equals_plain(stream_scene.trav, *_rays(n, 6))


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
def test_stream_kernels_many_bricks(many_brick_scene, order):
    """A few hundred 8 KB bricks, with the rays as they come and sorted by
    the treelet their origin enters (neighbouring threads, near bricks)."""
    trav = many_brick_scene.trav
    assert trav.stream.n_bricks >= 100
    o, d, t_max, mask = _rays(1 << 14, 7)
    if order == "sorted":
        perm = torch.argsort(compaction.treelet_entry_key(o, d,
                                                          trav.treelets))
        take = lambda v: V3(*(c[perm].contiguous() for c in (v.x, v.y, v.z)))
        o, d, t_max, mask = take(o), take(d), t_max[perm], mask[perm]
    _assert_stream_equals_plain(trav, o, d, t_max, mask)


def test_stream_wrapper_raises_on_too_deep_layout(stream_scene):
    trav = stream_scene.trav
    deep = dataclasses.replace(trav, stream=dataclasses.replace(
        trav.stream, brick_stack=trv.KERNEL_STACK // 2 + 1))
    o, d, t_max, mask = _rays(64, 8)
    before = dict(trs.LAUNCHES)
    for fn in (trs.closest_hit_stream, trs.any_hit_stream):
        with pytest.raises(ValueError, match="64-entry stack"):
            fn(deep, o, d, t_max, mask)
    assert trs.LAUNCHES == before


@pytest.fixture(scope="module")
def config5_shadow():
    """config5_large on the card (102,404 triangles, streamed) and the
    fused shadow batch of a 128x128 bounce-0 frame, recorded through the
    plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnraytracing_tpu_torch.render import integrator
    from pnraytracing_tpu_torch.scene.scenes import config5_large

    scene, cam = config5_large(device="cuda")
    rec = Recorder(integrator, trv, trs, compaction)
    try:
        render_frame(scene, cam.basis(device="cuda"),
                     RenderConfig(width=128, height=128, max_depth=1), 0,
                     eager=True)
    finally:
        rec.restore()
    _, o, d, t_max, mask = rec.by_name()["any_hit_stream"][0]
    return scene.trav, (o, d, t_max, mask)


def test_any_hit_binary_on_config5_shadow_rays(config5_shadow):
    """Kernel 6 against its plain version on the large scene's fused
    shadow batch over its 7.3 MB of binary rows: occlusion and the
    [3, R] stats equal, and the same occlusion as the stream walk."""
    trav, (o, d, t_max, mask) = config5_shadow
    occ, st = trv.any_hit(trav, o, d, t_max, mask, variant="binary",
                          with_stats=True)
    wocc, wst = trv.plain_any_hit_binary(trav, o, d, t_max, mask,
                                         with_stats=True)
    assert occ.shape == (2 * 128 * 128,)
    assert torch.equal(occ, wocc) and torch.equal(st, wst)
    assert torch.equal(occ, trs.any_hit_stream(trav, o, d, t_max, mask))
    assert bool(occ.any()) and bool((~occ & mask).any())


_WALKS = ["closest_hit_attr", "closest_hit", "any_hit", "closest_hit_binary",
          "any_hit_binary", "closest_hit_stream", "any_hit_stream"]


def _walk_pair(name):
    """(kernel wrapper, plain version) of one walk, both returning
    (result, stats)."""
    binary = name.endswith("_binary")
    base = name.replace("_binary", "")
    mod = trs if name.endswith("_stream") else trv
    kern = getattr(mod, base)
    if binary:
        kern = functools.partial(kern, variant="binary")
    return kern, getattr(mod, "plain_" + name)


@pytest.mark.parametrize("walk", _WALKS)
def test_walks_on_non_finite_rays(flagship, stream_scene, walk):
    """Every walk against its plain version on rays with NaN and infinite
    components (chip_smoke.synthetic_key_rays: outside origins, axis-
    parallel and zero directions, and 3/8 non-finite lanes).  Rays of
    ``never_enters`` walk nothing in both (a miss, zero stats); every
    other result and stat is equal."""
    trav = (stream_scene if walk.endswith("_stream") else flagship[0]).trav
    o, d = synthetic_key_rays(trav.treelets, "cuda")
    n = o.x.shape[0]
    rng = np.random.default_rng(40)
    t_max = torch.from_numpy(rng.uniform(0.5, 10, n).astype(
        np.float32)).cuda()
    mask = torch.from_numpy(rng.uniform(size=n) < 0.9).cuda()
    kern, plain = _walk_pair(walk)
    got = kern(trav, o, d, t_max, mask, with_stats=True)
    want = plain(trav, o, d, t_max, mask, with_stats=True)
    torch.cuda.synchronize()
    res, st, wres, wst = got[0], got[-1], want[0], want[-1]
    assert torch.equal(st, wst)
    bad = compaction.never_enters(o, d)
    assert int(bad.sum()) == 768 and not bool(st[:, bad].any())
    if walk.startswith("any_hit"):
        assert torch.equal(res, wres) and not bool(res[bad].any())
    else:
        for a, b in [(res.tri, wres.tri), (res.t, wres.t), (res.b1, wres.b1),
                     (res.b2, wres.b2)]:
            assert torch.equal(a, b)
        assert not bool(res.valid[bad].any())
        if walk == "closest_hit_attr":
            for a, b in zip(got[1], want[1]):
                assert torch.equal(a, b)
    assert bool((st[0][~bad] > 0).any())  # the other lanes do walk


# ---- the frame as one captured program (render/program.py) -------------

@pytest.fixture(scope="module")
def streamed():
    """config5_large(5) on the card (25,604 triangles, still over the
    resident budget: the stream route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnraytracing_tpu_torch.scene.scenes import config5_large

    scene, cam = config5_large(5, device="cuda")
    return scene, cam.basis(device="cuda")


@pytest.fixture(scope="module")
def textured():
    """config1_triangle and config4_marry on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnraytracing_tpu_torch.scene import scenes

    out = {}
    for name in ("config1_triangle", "config4_marry"):
        scene, cam = getattr(scenes, name)(device="cuda")
        out[name] = (scene, cam.basis(device="cuda"))
    return out


_SMALL = dict(width=64, height=64, max_depth=3)


def _program_case(case, flagship, streamed, textured):
    if case == "flagship":
        return flagship, RenderConfig(**_SMALL)
    if case == "config5":
        return streamed, RenderConfig(**_SMALL)
    if case == "config4_lod":
        return textured["config4_marry"], RenderConfig(
            texture_lod_scale=0.01, **_SMALL)
    return textured[case], RenderConfig(**_SMALL)


@pytest.mark.parametrize("case", ["flagship", "config5", "config1_triangle",
                                  "config4_marry", "config4_lod"])
def test_replay_equals_eager(flagship, streamed, textured, case):
    """Frames f and f + 1 replayed from one captured program: each equals
    the eager frame of its index bit for bit, and the two differ."""
    from pnraytracing_tpu_torch.render.program import FrameProgram

    (scene, cam), cfg = _program_case(case, flagship, streamed, textured)
    prog = FrameProgram(scene, cfg)
    a = prog.replay(cam, 7).clone()
    b = prog.replay(cam, 8).clone()
    torch.cuda.synchronize()
    assert torch.equal(a, render_frame(scene, cam, cfg, 7, eager=True))
    assert torch.equal(b, render_frame(scene, cam, cfg, 8, eager=True))
    assert not torch.equal(a, b)
    assert torch.equal(render_frame(scene, cam, cfg, 7), a)  # the cache


def test_launches_count_at_capture(flagship, streamed):
    """The launch counters count a captured frame's kernels once, at
    capture; replays add nothing."""
    from pnraytracing_tpu_torch.render.program import (
        FrameProgram,
        launch_counts,
    )

    for (scene, cam), want in (
            (flagship, dict(closest_hit_attr=4, any_hit=3,
                            treelet_entry_key=2)),
            (streamed, dict(closest_hit_stream=4, any_hit_stream=3,
                            treelet_entry_key=2))):
        prog = FrameProgram(scene, RenderConfig(**_SMALL))
        prog.capture(cam, 0)
        assert {k: v for k, v in prog.launches.items() if v} == want
        before = launch_counts()
        prog.replay(cam, 1)
        prog.replay(cam, 2)
        torch.cuda.synchronize()
        assert launch_counts() == before


@pytest.mark.parametrize("start", [0, 2**32 - 2])
def test_render_average_equals_eager_sum(flagship, start):
    """render_average on the card: the captured accumulating frame
    replayed spp times equals the eager frames summed from zeros and
    divided by spp, bit for bit (across the frame counter's wrap too)."""
    from pnraytracing_tpu_torch.render.renderer import render_average

    scene, cam = flagship
    cfg = RenderConfig(**_SMALL)
    got = render_average(scene, cam, cfg, start, 4)
    acc = torch.zeros((64, 64, 3), device="cuda")
    for i in range(4):
        acc = acc + render_frame(scene, cam, cfg, (start + i) % 2**32,
                                 eager=True)
    assert torch.equal(got, acc / 4.0)
    assert torch.equal(got, render_average(scene, cam, cfg, start, 4,
                                           eager=True))


def test_session_edit_and_orbit_show_in_replay(flagship):
    """A session's steps replay captured programs; after a material edit
    (in place, no new capture) and after an orbit, each step equals the
    eager frame of the edited scene / moved camera."""
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.session import RenderSession
    from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

    scene, _ = flagship
    _, cam_state = config3_teapot_night(env_height=64, device="cuda")
    cfg = RenderConfig(width=64, height=64, max_depth=2)
    program.clear_programs()
    s = RenderSession(scene, cam_state, cfg)
    eager = lambda c, f: render_frame(s.scene, s.camera.basis(), c, f,
                                      eager=True)
    first = s.step()
    assert torch.equal(first, eager(cfg, 0))
    s.step()
    assert torch.equal(s.accum.total, eager(cfg, 0) + eager(cfg, 1))
    n_programs = len(program._programs)
    s.edit_material(0, base_color=(0.1, 0.9, 0.1), roughness=0.2)
    assert torch.equal(s.step(), eager(s.preview_cfg, 0))  # the preview
    assert torch.equal(s.step(), eager(cfg, 0))
    assert len(program._programs) == n_programs + 1  # the preview's
    s.orbit(10, 5)
    s.step()
    assert torch.equal(s.step(), eager(cfg, 0))
    assert not torch.equal(s.accum.total, first)


def test_program_reads_the_scene_in_place(flagship):
    """A program captures the caller's scene tensors themselves: an
    in-place edit of them shows in the next replay, equal to the eager
    frame of the edited scene; a scene on another device is refused."""
    from pnraytracing_tpu_torch.render.program import FrameProgram

    scene, cam = flagship
    mats = scene.materials
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        mats, base_color=mats.base_color.clone()))
    cfg = RenderConfig(width=32, height=32, max_depth=2)
    prog = FrameProgram(scene, cfg)
    before = prog.replay(cam, 3).clone()
    scene.materials.base_color.mul_(0.5)
    after = prog.replay(cam, 3).clone()
    torch.cuda.synchronize()
    assert torch.equal(after, render_frame(scene, cam, cfg, 3, eager=True))
    assert not torch.equal(after, before)
    with pytest.raises(ValueError, match="not on cuda:0"):
        FrameProgram(scene.to("cpu"), cfg)
    with pytest.raises(ValueError, match="not on cuda:0"):
        render_frame(scene.to("cpu"), cam, cfg, 3)


def test_capture_error_raises(flagship, monkeypatch):
    """A frame that reads the card back while the stream captures fails
    to capture, and the program raises with the CUDA error."""
    from pnraytracing_tpu_torch.render import program

    scene, cam = flagship
    real = program.frame_image

    def body(*args):
        img = real(*args)
        if torch.cuda.is_current_stream_capturing():
            float(img.sum())  # a host read: not allowed in a capture
        return img

    monkeypatch.setattr(program, "frame_image", body)
    prog = program.FrameProgram(scene, RenderConfig(width=16, height=16,
                                                    max_depth=1))
    with pytest.raises(RuntimeError, match="capturing the frame"):
        prog.replay(cam, 0)
    assert prog.graph is None
    monkeypatch.undo()
    torch.cuda.synchronize()
    img = render_frame(scene, cam, RenderConfig(width=16, height=16,
                                                max_depth=1), 0, eager=True)
    assert bool(torch.isfinite(img).all())


# ---- compat mode (RenderConfig.compat_pnrt) -----------------------------

@pytest.mark.parametrize("walk", _WALKS)
@pytest.mark.parametrize("rays", ["random", "compat_rays"])
def test_compat_kernels_equal_plain(flagship, stream_scene, walk, rays):
    """The compat instantiation of each walk kernel against its compat
    plain version, on random rays and on rays with d.z = +-0, 1e-31 and
    subnormal (chip_smoke.compat_rays): results, the interaction fill and
    the per-ray stats all equal; each launch counts under the kernel's
    ``_compat`` name only."""
    trav = (stream_scene if walk.endswith("_stream") else flagship[0]).trav
    if rays == "random":
        o, d, t_max, mask = _rays(1 << 14, 41)
    else:
        o, d = compat_rays(trav.treelets, "cuda")
        n = o.x.shape[0]
        rng = np.random.default_rng(42)
        t_max = torch.from_numpy(rng.uniform(0.5, 10, n).astype(
            np.float32)).cuda()
        mask = torch.from_numpy(rng.uniform(size=n) < 0.9).cuda()
    kern, plain = _walk_pair(walk)
    tables = (trs if walk.endswith("_stream") else trv).LAUNCHES
    before = dict(tables)
    got = kern(trav, o, d, t_max, mask, with_stats=True, compat=True)
    want = plain(trav, o, d, t_max, mask, with_stats=True, compat=True)
    torch.cuda.synchronize()
    key = walk + "_compat"
    assert tables == dict(before, **{key: before[key] + 1})
    assert torch.equal(got[-1], want[-1])
    if walk.startswith("any_hit"):
        assert torch.equal(got[0], want[0])
    else:
        for a, b in [(got[0].tri, want[0].tri), (got[0].t, want[0].t),
                     (got[0].b1, want[0].b1), (got[0].b2, want[0].b2)]:
            assert torch.equal(a, b)
        if walk == "closest_hit_attr":
            for a, b in zip(got[1], want[1]):
                assert torch.equal(a, b)
    assert bool((got[-1][0] > 0).any())


@pytest.mark.parametrize("walk", _WALKS)
def test_default_kernels_unchanged_by_compat(flagship, stream_scene, walk):
    """A default-mode call still launches the default instantiation
    (counted under the kernel's own name, no compat launch) and equals
    the default plain version; on the same rays the compat walk visits
    every node the default walk visits, and more."""
    trav = (stream_scene if walk.endswith("_stream") else flagship[0]).trav
    o, d, t_max, mask = _rays(1 << 14, 43)
    kern, plain = _walk_pair(walk)
    tables = (trs if walk.endswith("_stream") else trv).LAUNCHES
    before = dict(tables)
    got = kern(trav, o, d, t_max, mask, with_stats=True)
    want = plain(trav, o, d, t_max, mask, with_stats=True)
    torch.cuda.synchronize()
    assert tables == dict(before, **{walk: before[walk] + 1})
    assert torch.equal(got[-1], want[-1])
    res, wres = got[0], want[0]
    if walk.startswith("any_hit"):
        assert torch.equal(res, wres)
    else:
        assert torch.equal(res.tri, wres.tri) and torch.equal(res.t, wres.t)
    compat = kern(trav, o, d, t_max, mask, with_stats=True, compat=True)
    pops, cpops = got[-1][0], compat[-1][0]
    if not walk.startswith("any_hit"):  # an occluder may end a walk early
        assert bool((cpops >= pops).all())
    assert int(cpops.sum()) > int(pops.sum())


@pytest.mark.parametrize("case", ["flagship", "config5"])
def test_compat_replay_equals_eager(flagship, streamed, case):
    """A compat frame replayed from its captured program equals the eager
    frame bit for bit, and the capture counts the compat kernels."""
    from pnraytracing_tpu_torch.render.program import FrameProgram

    scene, cam = flagship if case == "flagship" else streamed
    cfg = RenderConfig(compat_pnrt=True, **_SMALL)
    prog = FrameProgram(scene, cfg)
    a = prog.replay(cam, 7).clone()
    torch.cuda.synchronize()
    assert torch.equal(a, render_frame(scene, cam, cfg, 7, eager=True))
    assert not torch.equal(a, render_frame(scene, cam, RenderConfig(
        **_SMALL), 7, eager=True))
    want = (dict(closest_hit_attr_compat=4, any_hit_compat=3)
            if case == "flagship" else
            dict(closest_hit_stream_compat=4, any_hit_stream_compat=3))
    assert {k: v for k, v in prog.launches.items() if v} == dict(
        want, treelet_entry_key=2)


# ---- gradients: the trace's records, the detached walks, the ties -----------

def _frame_rays(camera, size):
    from pnraytracing_tpu_torch.core.camera import camera_rays
    from pnraytracing_tpu_torch.render.renderer import pixel_coords

    cfg = RenderConfig(width=size, height=size, max_depth=2)
    px, py = pixel_coords(cfg, "cuda")
    o, d, _ = camera_rays(camera, size, size)
    return cfg, (o, d, px, py)


@pytest.mark.parametrize("case", ["flagship", "streamed"])
def test_trace_records_equal_plain_walks(flagship, stream_scene, case):
    """``trace_paths`` through the kernels and with every walk routed to
    its plain version on the card: the records bit for bit."""
    from chip_smoke import records_mismatch
    from pnraytracing_tpu_torch.render import integrator
    from pnraytracing_tpu_torch.render.integrator import trace_paths

    scene, camera = flagship
    if case == "streamed":
        scene = stream_scene
    cfg, rays = _frame_rays(camera, 64)
    got = trace_paths(scene, *rays, 3, cfg)
    rec = Recorder(integrator, trv, trs, compaction)
    try:
        want = trace_paths(scene, *rays, 3, cfg)
    finally:
        rec.restore()
    assert rec.calls, "the plain walks were not called"
    bad = records_mismatch(got, want)
    assert not any(bad.values()), bad
    assert int(got.primary.valid.sum()) > 100


def test_replay_gradient_equals_live_gradient(flagship):
    """The trace/replay gradient against the live one on the card
    (materials and env texels, spp 2, 64x64 depth 2): within 1e-3 in
    norm a key (the two passes round the shading in other orders),
    finite and non-zero."""
    from pnraytracing_tpu_torch.diff import grad as dg

    scene, camera = flagship
    cfg, rays = _frame_rays(camera, 64)
    params = dg.extract_params(scene, ("materials", "env_image"))
    target = torch.full((64 * 64, 3), 0.25, device="cuda")
    l0, g0 = dg.loss_and_grad(params, scene, *rays, 3, target, cfg, spp=2)
    l1, g1 = dg.loss_and_grad_replay(params, scene, *rays, 3, target, cfg,
                                     spp=2)
    assert abs(float(l0) - float(l1)) <= 1e-4 * abs(float(l1))
    for k in ("materials", "env_image"):
        a = torch.cat([g.reshape(-1) for g in dg.param_leaves({k: g0[k]})])
        b = torch.cat([g.reshape(-1) for g in dg.param_leaves({k: g1[k]})])
        assert torch.isfinite(b).all() and float(b.abs().max()) > 0, k
        err = torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)
        assert float(err) <= 1e-3, (k, float(err))


def test_gradient_step_reproducible_on_card(flagship):
    """Two runs of one gradient step (materials, env texels and vertex
    positions, spp 2, 64x64 depth 2) give the same loss and gradients
    bit for bit: the gathers' backward sums each row in a fixed order
    (ops/gather.py), where index_add's atomics add in any order."""
    from pnraytracing_tpu_torch.diff import grad as dg

    scene, camera = flagship
    cfg, rays = _frame_rays(camera, 64)
    params = dg.extract_params(scene, ("materials", "env_image",
                                       "positions"))
    target = torch.full((64 * 64, 3), 0.25, device="cuda")
    runs = [dg.loss_and_grad_replay(params, scene, *rays, 3, target, cfg,
                                    spp=2) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    a, b = (dg.param_leaves(g) for _, g in runs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(torch.cat([x.reshape(-1) for x in a]).abs().max()) > 0


@pytest.mark.parametrize("kind", ["replay", "live"])
def test_captured_step_equals_eager(flagship, kind):
    """``loss_and_grad_replay`` / ``loss_and_grad`` on the card replay one
    captured CUDA graph a step (diff/program.py): the loss and every
    gradient leaf (materials, env texels, vertex positions) equal the
    ``eager=True`` step bit for bit, at spp 2 and at another frame; the
    launch counters count the warm-up and the capture, not the
    replays."""
    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.diff import program as sp
    from pnraytracing_tpu_torch.render.program import (
        clear_programs,
        launch_counts,
    )

    scene, camera = flagship
    cfg, rays = _frame_rays(camera, 64)
    params = dg.extract_params(scene, ("materials", "env_image",
                                       "positions"))
    target = torch.full((64 * 64, 3), 0.25, device="cuda")
    fn = dg.loss_and_grad_replay if kind == "replay" else dg.loss_and_grad
    clear_programs()
    captures = sp.CAPTURES["steps"]
    for frame in (3, 9):
        got = fn(params, scene, *rays, frame, target, cfg, spp=2)
        before = launch_counts()
        again = fn(params, scene, *rays, frame, target, cfg, spp=2)
        torch.cuda.synchronize()
        assert launch_counts() == before  # a replay counts nothing
        want = fn(params, scene, *rays, frame, target, cfg, spp=2,
                  eager=True)
        for out in (got, again):
            assert torch.equal(out[0], want[0])
            a, b = dg.param_leaves(out[1]), dg.param_leaves(want[1])
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert sp.CAPTURES["steps"] == captures + 1
    prog = next(iter(sp._programs.values()))
    walk = "closest_hit_attr" if kind == "replay" else "closest_hit"
    assert prog.launches[walk] == 2 * 3  # 2 samples of 1 + depth
    assert prog.launches["any_hit"] == 2 * 2
    assert prog.launches["treelet_entry_key"] == 2 * cfg.sort_max_bounce
    clear_programs()


def test_step_program_replays_equal(flagship):
    """Two replays of one StepProgram at one input give one loss and one
    gradient, bit for bit; the bench's loss (kind "frames") replayed
    equals its eager step."""
    from pnraytracing_tpu_torch.bench import frames_loss_and_grad
    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.diff.program import StepProgram

    scene, camera = flagship
    cfg, rays = _frame_rays(camera, 64)
    params = dg.extract_params(scene, ("materials", "env_image"))
    target = torch.zeros((64 * 64, 3), device="cuda")
    prog = StepProgram("frames", scene, cfg, params, 64 * 64, k=2,
                       replay=True)
    runs = []
    for _ in range(2):
        loss, grads = prog.replay(params, *rays, 4, target)
        runs.append((loss.clone(), [g.clone() for g in
                                    dg.param_leaves(grads)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1]))
    want_loss, want = frames_loss_and_grad(params, scene, *rays, 4, 2,
                                           target, cfg, eager=True)
    assert torch.equal(runs[0][0], want_loss)
    assert all(torch.equal(x, y) for x, y in
               zip(runs[0][1], dg.param_leaves(want)))
    with pytest.raises(ValueError, match="not on cuda:0"):
        StepProgram("frames", scene.to("cpu"), cfg, params, 64 * 64, k=2,
                    replay=True)


def test_adam_optimize_captures_once(flagship):
    """Three ``adam_optimize`` steps on materials and env texels replay
    one captured step: one capture, and the losses and parameters equal
    the eager run's bit for bit."""
    from pnraytracing_tpu_torch.core.types import Materials
    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.diff import program as sp
    from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

    scene, _ = flagship
    _, cam_state = config3_teapot_night(env_height=64, device="cuda")
    cfg = RenderConfig(width=64, height=64, max_depth=2)
    keys = ("materials", "env_image")
    target = torch.full((64, 64, 3), 0.3, device="cuda")
    runs = {}
    for eager in (False, True):
        before = sp.CAPTURES["steps"]
        out, losses = dg.adam_optimize(
            scene, cam_state.basis(device="cuda"), cfg, target, keys=keys,
            steps=3, spp_per_step=2, eager=eager)
        runs[eager] = (out, losses, sp.CAPTURES["steps"] - before)
    assert runs[False][2] == 1 and runs[True][2] == 0
    assert runs[False][1] == runs[True][1]
    assert np.isfinite(runs[False][1]).all()
    a = dg.param_leaves(dg.extract_params(runs[False][0], keys))
    b = dg.param_leaves(dg.extract_params(runs[True][0], keys))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert isinstance(runs[False][0].materials, Materials)
    assert not torch.equal(runs[False][0].materials.base_color,
                           scene.materials.base_color)


@pytest.mark.parametrize("n,r,c", [(4, 262144, 18), (131072, 262144, 3)])
def test_segment_sum_on_card(n, r, c):
    """``segment_sum`` on the card: equal over two calls, and within
    float32 rounding of a float64 ``index_add`` on the host (the material
    rows and the env texel rows of a 512x512 frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnraytracing_tpu_torch.ops.gather import segment_sum

    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, n, (r,), generator=g)
    values = torch.randn(r, c, generator=g)
    got = segment_sum(idx.cuda(), values.cuda(), n)
    assert torch.equal(got, segment_sum(idx.cuda(), values.cuda(), n))
    want = torch.zeros(n, c, dtype=torch.float64).index_add_(
        0, idx, values.double())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def test_walks_carry_no_gradient_on_card(flagship):
    """The kernels' answers have no ``grad_fn``: a loss through them gives
    the rays a zero gradient, as on the CPU."""
    scene, camera = flagship
    _, (o, d, _, _) = _frame_rays(camera, 32)
    ox = o[:, 0].contiguous().requires_grad_(True)
    ov = V3(ox * 1.0, o[:, 1].contiguous(), o[:, 2].contiguous())
    dv = V3(d[:, 0].contiguous(), d[:, 1].contiguous(),
            d[:, 2].contiguous())
    tm = torch.full((32 * 32,), 1e7, device="cuda")
    hit, _ = trv.closest_hit_attr(scene.trav, ov, dv, tm)
    occ = trv.any_hit(scene.trav, ov, dv, tm)
    key = compaction.entry_key(ov, dv, scene.trav.treelets,
                               scene.trav.treelet_tree)
    outs = [hit.t, hit.b1, hit.b2, occ, key]
    assert all(a.grad_fn is None for a in outs)
    assert bool(hit.valid.any())
    loss = hit.t.sum() + hit.b1.sum() + 0.0 * ox.sum()
    (g,) = torch.autograd.grad(loss, ox)
    assert torch.equal(g, torch.zeros_like(g))


def test_sanitized_ties_on_card():
    """``Materials.sanitized()`` on the card splits the gradient at the
    bounds as on the CPU (and as ``jnp.clip`` / ``jnp.maximum``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnraytracing_tpu_torch.core.types import Materials

    vals = [-0.5, 0.0, 0.5, 1.0, 1.5]
    names = [f.name for f in dataclasses.fields(Materials)]
    grads = {}
    for dev in ("cpu", "cuda"):
        col = torch.tensor(vals, device=dev)
        leaves = {n: (col[:, None].repeat(1, 3) if n in ("emissive",
                                                         "base_color")
                      else col.clone()).requires_grad_(True)
                  for n in names}
        s = Materials(**leaves).sanitized()
        sum(getattr(s, n).sum() for n in names).backward()
        grads[dev] = {n: leaves[n].grad.cpu() for n in names}
    for n in names:
        assert torch.equal(grads["cpu"][n], grads["cuda"][n]), n
    assert grads["cuda"]["metallic"].tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]
    assert grads["cuda"]["ior"].tolist() == [0.0, 0.0, 0.0, 0.5, 1.0]


# ---- parallel/ on the card (world 1, NCCL, in this process) -----------------

@pytest.fixture(scope="module")
def nccl_world(flagship):
    """A world of one (NCCL) in this process, for the module; its mesh."""
    import socket

    import torch.distributed as dist

    from pnraytracing_tpu_torch.parallel import distributed, mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"tcp://localhost:{port}", world_size=1, rank=0)
    yield mesh.make_device_mesh()
    dist.destroy_process_group()


def test_sharded_frame_equals_render_frame(flagship, nccl_world):
    from pnraytracing_tpu_torch.parallel.mesh import render_frame_sharded

    scene, cam = flagship
    cfg = RenderConfig(width=128, height=128, max_depth=2)
    want = render_frame(scene, cam, cfg, 3, eager=True)
    tables = (trv.LAUNCHES, compaction.LAUNCHES)
    for t in tables:
        for k in t:
            t[k] = 0
    got = render_frame_sharded(scene, cam, cfg, 3, nccl_world)
    torch.cuda.synchronize()
    assert trv.LAUNCHES["closest_hit_attr"] == 3
    assert trv.LAUNCHES["any_hit"] == 2
    assert compaction.LAUNCHES["treelet_entry_key"] == 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("compat", [False, True])
def test_primitive_queries_run_kernels_5_and_6(flagship, nccl_world, compat):
    """``primitive_sharded_*`` over the flagship's triangles (one shard a
    rank) launch the binary kernels once each, and equal the same query
    through the plain versions (the shard on the CPU); the one-process
    combine over 4 shards on the card equals its plain form too."""
    from pnraytracing_tpu_torch.core.camera import camera_rays
    from pnraytracing_tpu_torch.parallel import primitive as pp

    scene, cam = flagship
    pos, idx = scene.mesh.positions.cpu().numpy(), scene.mesh.indices.cpu(
        ).numpy()
    o, d, _ = camera_rays(cam, 96, 96)
    t_max = torch.full((o.shape[0],), 1e7, device="cuda")
    one = pp.build_primitive_shards(pos, idx, 1)
    placed = pp.put_shards(one, nccl_world)
    for k in trv.LAUNCHES:
        trv.LAUNCHES[k] = 0
    hit = pp.primitive_sharded_closest_hit(placed, o, d, t_max, nccl_world,
                                           compat=compat)
    # occlusion short of and past each primary hit: a mix of both answers
    t_any = (hit.t * torch.linspace(0.25, 1.75, o.shape[0], device="cuda")
             ).contiguous()
    occ = pp.primitive_sharded_any_hit(placed, o, d, t_any, nccl_world,
                                       compat=compat)
    torch.cuda.synchronize()
    suffix = "_compat" if compat else ""
    assert trv.LAUNCHES["closest_hit_binary" + suffix] == 1
    assert trv.LAUNCHES["any_hit_binary" + suffix] == 1
    assert sum(trv.LAUNCHES.values()) == 2

    cpu = lambda x: x.cpu()
    plain = pp.place_all(one, "cpu")
    want = pp.shards_closest_hit(plain, cpu(o), cpu(d), cpu(t_max),
                                 compat=compat)
    want_occ = pp.shards_any_hit(plain, cpu(o), cpu(d), cpu(t_any),
                                 compat=compat)
    same = hit.tri.cpu() == want.tri
    assert int((~same).sum()) <= 1
    assert torch.equal(hit.t.cpu(), want.t)
    assert torch.equal(occ.cpu(), want_occ)
    assert int(hit.valid.sum()) > 0
    assert 0 < int(occ.sum()) < o.shape[0]

    four = pp.build_primitive_shards(pos, idx, 4)
    got4 = pp.shards_closest_hit(pp.place_all(four, "cuda"), o, d, t_max,
                                 compat=compat)
    want4 = pp.shards_closest_hit(pp.place_all(four, "cpu"), cpu(o), cpu(d),
                                  cpu(t_max), compat=compat)
    assert torch.equal(got4.t.cpu(), want4.t)
    assert torch.equal(got4.t.cpu(), want.t)


# ---- the walk over the plain BVH (accel/traverse.py, route 'bvh') ---------

@pytest.fixture(scope="module")
def bvh_scenes():
    """A cube, an icosphere(3), a floor and a lamp on the card, as an SAH
    tree with no traversal layout (route 'bvh') and as one flat leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    from pnraytracing_tpu_torch.scene.transform import (
        compose,
        rotate,
        translate,
    )

    out = {}
    for form in ("sah", "flat"):
        b = SceneBuilder()
        b.add(shapes.cube(0.8), dict(base_color=(0.7, 0.3, 0.3)),
              name="cube", transform=translate(-1.0, 0.8, 0))
        b.add(shapes.icosphere(3), dict(base_color=(0.3, 0.7, 0.3)),
              name="ball", transform=translate(1.2, 1.0, 0))
        b.add(shapes.quad(half=4.0), dict(base_color=(0.6, 0.6, 0.6)),
              name="floor")
        b.add(shapes.quad(half=1.0), dict(emissive=(15.0, 15.0, 15.0)),
              name="lamp", transform=compose(translate(0, 5.0, 0),
                                             rotate(180, (0, 0, 1))))
        scene = b.build(flat_bvh=form == "flat",
                        env_constant=(0.3, 0.3, 0.3), device="cuda")
        out[form] = dataclasses.replace(scene, trav=None)
    return out


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("form", ["sah", "flat"])
def test_bvh_kernels_equal_plain(bvh_scenes, form, compat):
    """The kernel pair of csrc/traverse_bvh.cu against its plain version,
    default and compat, on the SAH tree (max_leaf_size 4) and the flat
    leaf (max_leaf_size = T): hits, t, barycentrics, occlusion and the
    [3, R] stats (pops, slab tests, triangle tests) equal, one launch
    each under its own name, and ``traversal_stats`` the closest walk's
    pops."""
    from pnraytracing_tpu_torch.accel import traverse as trb

    scene = bvh_scenes[form]
    mls = int(scene.mesh.indices.shape[0]) if form == "flat" else 4
    kw = dict(max_leaf_size=mls, compat=compat, with_stats=True)
    o, d, t_max, mask = _rays(1 << 13, 30)
    before = dict(trb.LAUNCHES)
    hit, st = trb.closest_hit(scene.bvh, scene.mesh, o, d, t_max, mask,
                              **kw)
    occ, ast = trb.any_hit(scene.bvh, scene.mesh, o, d, t_max, mask, **kw)
    torch.cuda.synchronize()
    suffix = "_compat" if compat else ""
    assert trb.LAUNCHES["closest_hit_bvh" + suffix] == before[
        "closest_hit_bvh" + suffix] + 1
    assert trb.LAUNCHES["any_hit_bvh" + suffix] == before[
        "any_hit_bvh" + suffix] + 1
    want, wst = trb.plain_closest_hit(scene.bvh, scene.mesh, o, d, t_max,
                                      mask, **kw)
    wocc, wast = trb.plain_any_hit(scene.bvh, scene.mesh, o, d, t_max, mask,
                                   **kw)
    for a, b in ((hit.tri, want.tri), (hit.t, want.t), (hit.b1, want.b1),
                 (hit.b2, want.b2), (occ, wocc), (st, wst), (ast, wast)):
        assert torch.equal(a, b)
    assert 0 < int(hit.valid.sum()) and 0 < int(occ.sum()) < int(mask.sum())
    visits, iters = trb.traversal_stats(scene.bvh, scene.mesh, o, d, t_max,
                                        max_leaf_size=mls, compat=compat)
    _, full = trb.plain_closest_hit(scene.bvh, scene.mesh, o, d, t_max,
                                    **kw)
    assert torch.equal(visits, full[0]) and int(iters) == int(full[0].max())


def test_bvh_kernels_on_non_finite_rays(bvh_scenes):
    """Rays with NaN and infinite components: the kernel equals its plain
    version (a NaN ray pops the root and fails its box: one pop, one slab
    test, no hit)."""
    from pnraytracing_tpu_torch.accel import traverse as trb

    scene = bvh_scenes["sah"]
    o, d, t_max, mask = _rays(1 << 12, 31)
    for c, v in ((o.x, float("nan")), (d.y, float("nan")),
                 (o.z, float("inf")), (d.z, float("inf"))):
        c[::7] = v
    got = trb.closest_hit(scene.bvh, scene.mesh, o, d, t_max, mask,
                          with_stats=True)
    want = trb.plain_closest_hit(scene.bvh, scene.mesh, o, d, t_max, mask,
                                 with_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].tri, want[0].tri)
    assert torch.equal(got[0].t, want[0].t)
    bad = compaction.never_enters(o, d) & mask
    assert int(bad.sum()) > 0
    assert bool((got[1][0][bad] == 1).all()) and not got[0].valid[bad].any()


def test_bvh_route_frame_on_card(bvh_scenes, monkeypatch):
    """A frame of a scene without a traversal layout: 1 + depth closest
    and depth any-hit launches of the new walk and no key kernel (rays
    are only compacted); the frame through the kernels against the plain
    versions; the captured frame equals the eager one bit for bit."""
    from pnraytracing_tpu_torch.accel import traverse as trb
    from pnraytracing_tpu_torch.accel import walks
    from pnraytracing_tpu_torch.render.program import FrameProgram
    from pnraytracing_tpu_torch.scene.scenes import _camera

    scene = bvh_scenes["sah"]
    cam = _camera((0, 2.5, 6), (0, 1.0, 0), 45.0).basis(device="cuda")
    cfg = RenderConfig(width=64, height=64, max_depth=3)
    for table in (trv.LAUNCHES, trs.LAUNCHES, trb.LAUNCHES,
                  compaction.LAUNCHES):
        for k in table:
            table[k] = 0
    img = render_frame(scene, cam, cfg, 0, eager=True)
    assert trb.LAUNCHES == dict({k: 0 for k in trb.LAUNCHES},
                                closest_hit_bvh=4, any_hit_bvh=3)
    assert not any(trv.LAUNCHES.values()) and not any(
        trs.LAUNCHES.values()) and not any(compaction.LAUNCHES.values())
    prog = FrameProgram(scene, cfg, "cuda")
    assert torch.equal(prog.replay(cam, 0), img)
    monkeypatch.setattr(walks, "closest_hit_bvh", trb.plain_closest_hit)
    monkeypatch.setattr(walks, "any_hit_bvh", trb.plain_any_hit)
    want = render_frame(scene, cam, cfg, 0, eager=True)
    off = (img - want).abs().amax(dim=-1) > 3e-5
    assert int(off.sum()) <= 1 and float(img.mean()) > 0.01


def test_bvh_wrapper_raises_on_deep_stack(bvh_scenes):
    from pnraytracing_tpu_torch.accel import traverse as trb

    scene = bvh_scenes["sah"]
    o, d, t_max, mask = _rays(64, 32)
    with pytest.raises(ValueError, match="64-entry stack"):
        trb.closest_hit(scene.bvh, scene.mesh, o, d, t_max, mask,
                        stack_depth=trb.KERNEL_STACK + 1)


# ---- RenderConfig.traversal: the walks of the JAX package's XLA values --

def _random_rays(trav, n, seed=0):
    """``n`` rays from random points of the scene's box in random
    directions, a third with a short t_max, a tenth masked out."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = trav.nodes8[0, :3].cpu(), trav.nodes8[0, 3:6].cpu()
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((n,), 3.4e38)
    t_max[::3] = 0.5
    v3 = lambda a: V3(*(a[:, k].contiguous().cuda() for k in range(3)))
    return (v3(o), v3(d), t_max.cuda(),
            (torch.rand(n, generator=g) < 0.9).cuda())


def _assert_same(got, want):
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, want)
    else:
        for k in ("tri", "t", "b1", "b2"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("walk", ["packed", "pop", "packet", "wide"])
def test_xla_walk_kernels_equal_plain(flagship, walk, compat):
    """The kernel of each XLA value (the packed instantiation of the BVH
    walk; kernels 5 / 6 and 3 / 2 with the leaf cap, here 2, below the
    flagship's leaves) against its plain version: hits, occlusion and
    stats bit for bit, each launch counted once."""
    from pnraytracing_tpu_torch.accel import (
        traverse_packed,
        traverse_packet,
        traverse_wide,
    )

    mod = {"packed": traverse_packed, "pop": traverse_packed,
           "packet": traverse_packet, "wide": traverse_wide}[walk]
    trav = flagship[0].trav
    rays = _random_rays(trav, 1 << 14)
    counter = {"packed": "hit_packed", "pop": "hit_binary",
               "packet": "hit_binary", "wide": "hit"}[walk]
    for q in ("closest", "any"):
        name = f"{q}_hit_{walk}"
        table = (traverse_packed if walk == "packed" else trv).LAUNCHES
        key = f"{q}_{counter}" + ("_compat" if compat else "")
        before = table[key]
        got, st = getattr(mod, name)(trav, *rays, compat=compat,
                                     max_leaf_size=2, with_stats=True)
        want, wst = traverse_packed.plain(name)(
            trav, *rays, compat=compat, max_leaf_size=2, with_stats=True)
        torch.cuda.synchronize()
        assert table[key] == before + 1
        _assert_same(got, want)
        assert torch.equal(st, wst)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("width,leaf_buffer", [(4, 32), (4, 2), (8, 32),
                                               (8, 2)])
def test_wide4_kernel_equals_plain(flagship, width, leaf_buffer, compat):
    """The 4-wide kernel against its plain version at widths 4 and 8:
    hits, occlusion, overflow and the [4, R] stats bit for bit; the
    2-slot buffer overflows; with the pop-walk fallback (kernels 5 / 6,
    launched whatever the overflow) the answers equal the packed walk's
    in the default form.  Not in compat: there phase 1 prunes by the
    clipped slab test (as the JAX walk does), where the compat packed
    walk enters every box the ray's line crosses and so reaches the
    sheared test's hits outside their leaf's box (2 of 16,384 rays)."""
    from pnraytracing_tpu_torch.accel import traverse_packed as trp
    from pnraytracing_tpu_torch.accel import traverse_wide4 as tw4
    from pnraytracing_tpu_torch.accel.wide4 import pack_wide4

    scene = flagship[0]
    trav = scene.trav
    w4 = trav.w4
    if width != w4.width:
        from pnraytracing_tpu_torch.accel.native import bvh_builder

        mesh = scene.mesh
        pos = mesh.positions.cpu().numpy()
        built = bvh_builder()(pos, mesh.indices.cpu().numpy(),
                              max_leaf_size=4)
        assert np.array_equal(built.node_min,
                              scene.bvh.node_min.cpu().numpy())
        w4 = pack_wide4(built, trav.tri9.cpu().numpy(), width=width,
                        device="cuda")
    rays = _random_rays(trav, 1 << 14, seed=1)
    kw = dict(stack_depth=(width - 1) * w4.depth4 + 4,
              leaf_buffer=leaf_buffer, compat=compat, with_stats=True)
    for closest in (True, False):
        q = "closest" if closest else "any"
        got = getattr(tw4, f"{q}_hit_wide4")(w4, *rays, **kw)
        want = getattr(tw4, f"plain_{q}_hit_wide4")(w4, *rays, **kw)
        torch.cuda.synchronize()
        _assert_same(got[0], want[0])
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert bool(got[1].any()) == (leaf_buffer == 2)
        if compat:
            continue
        fb = getattr(tw4, f"{q}_hit_wide4")(
            w4, *rays, **dict(kw, with_stats=False),
            fallback=lambda *a: getattr(trp, f"{q}_hit_pop")(
                trav, *a, compat=compat))[0]
        ref = getattr(trp, f"{q}_hit_packed")(trav, *rays, compat=compat)
        if closest:
            same = fb.tri == ref.tri
            assert int((~same).sum()) <= 1  # an exact-t tie at most
            assert torch.equal(fb.t[same], ref.t[same])
        else:
            assert torch.equal(fb, ref)


def test_pallas_kernels_take_the_cap(flagship, stream_scene):
    """The attribute kernel and the stream kernels with a leaf cap of 1
    against their plain versions (hits, fill, stats bit for bit), and
    with the default cap of 15 as before."""
    trav = flagship[0].trav
    rays = _random_rays(trav, 1 << 13, seed=2)
    for cap in (1, 15):
        got, attrs, st = trv.closest_hit_attr(trav, *rays, max_leaf_size=cap,
                                              with_stats=True)
        want, wattrs, wst = trv.plain_closest_hit_attr(
            trav, *rays, max_leaf_size=cap, with_stats=True)
        _assert_same(got, want)
        assert torch.equal(st, wst)
        assert all(torch.equal(a, b) for a, b in zip(attrs, wattrs))
    srays = _random_rays(stream_scene.trav, 1 << 13, seed=3)
    for cap in (1, 15):
        for q in ("closest", "any"):
            got, st = getattr(trs, f"{q}_hit_stream")(
                stream_scene.trav, *srays, max_leaf_size=cap,
                with_stats=True)
            want, wst = getattr(trs, f"plain_{q}_hit_stream")(
                stream_scene.trav, *srays, max_leaf_size=cap,
                with_stats=True)
            _assert_same(got, want)
            assert torch.equal(st, wst)


@pytest.mark.parametrize("value", ["packed", "pop", "packet", "wide",
                                   "wide4"])
def test_traversal_frame_on_card(flagship, value):
    """A 64x64 depth-2 frame of each XLA value: the captured frame's
    launches are the value's kernels, the replay equals the eager frame
    bit for bit, and the eager frame equals the frame through the plain
    versions (at most 0.02% of pixels outside atol 3e-5) and the
    kernel_interaction=False 'pallas' frame within the same bound."""
    from chip_smoke import record_frame
    from pnraytracing_tpu_torch.accel import traverse_stream_cuda
    from pnraytracing_tpu_torch.render import integrator
    from pnraytracing_tpu_torch.render.program import FrameProgram

    scene, cam = flagship
    cfg = RenderConfig(**_SMALL, traversal=value)
    prog = FrameProgram(scene, cfg)
    rep = prog.replay(cam, 3).clone()
    eager = render_frame(scene, cam, cfg, 3, eager=True)
    torch.cuda.synchronize()
    assert torch.equal(rep, eager)
    d = _SMALL["max_depth"]
    kernels = {"packed": ("closest_hit_packed", "any_hit_packed"),
               "pop": ("closest_hit_binary", "any_hit_binary"),
               "packet": ("closest_hit_binary", "any_hit_binary"),
               "wide": ("closest_hit", "any_hit"),
               "wide4": ("closest_hit_wide4", "any_hit_wide4")}[value]
    want = {kernels[0]: d + 1, kernels[1]: d, "treelet_entry_key": 2}
    if value == "wide4":
        want.update(closest_hit_binary=d + 1, any_hit_binary=d)
    assert {k: v for k, v in prog.launches.items() if v} == want
    plain, _ = record_frame(functools.partial(render_frame, eager=True),
                            scene, cam, cfg, "cuda", integrator, trv,
                            traverse_stream_cuda, compaction)
    eager0 = render_frame(scene, cam, cfg, 0, eager=True)
    ref = render_frame(scene, cam, dataclasses.replace(
        cfg, traversal="pallas", kernel_interaction=False), 0, eager=True)
    limit = int(cfg.width * cfg.height * 2e-4)
    for other in (plain, ref):
        off = (eager0 - other).abs().amax(dim=-1) > 3e-5
        assert int(off.sum()) <= limit


# ---- the entry points (pnraytracing_tpu_torch/bench.py, entry.py) -----------

def test_bench_forward_line_on_card(flagship):
    """``python -m pnraytracing_tpu_torch.bench`` at 128x128 on the card:
    one JSON line of ``bench.py``'s form, the card's ``nvidia-smi`` line
    last on stderr."""
    import json
    import os
    import subprocess
    import sys

    from pnraytracing_tpu_torch.bench import nvidia_smi_line

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "pnraytracing_tpu_torch.bench", "--width",
         "128", "--height", "128", "--frames", "4"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == ("rays/s/chip fwd (128x128, 1spp, 4 bounces, "
                              "teapot_night)")
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert out.stderr.splitlines()[-1] == nvidia_smi_line()


def test_entry_arguments_on_card(flagship):
    """``entry()``: ``render_rays`` on the ``pallas`` route, its arguments
    on the card; one step launches kernels 1, 2 and 4."""
    from pnraytracing_tpu_torch.entry import entry
    from pnraytracing_tpu_torch.render.integrator import render_rays

    fn, args = entry()
    assert fn.func is render_rays
    assert fn.keywords["cfg"].traversal == "pallas"
    scene, o, d, px, py, frame = args
    assert frame == 0
    for t in (o, d, px, py, scene.mesh.positions, scene.trav.nodes16c):
        assert t.is_cuda
    for k in trv.LAUNCHES:
        trv.LAUNCHES[k] = 0
    compaction.LAUNCHES["treelet_entry_key"] = 0
    img = fn(*args)
    torch.cuda.synchronize()
    assert img.shape == (512 * 512, 3) and bool(torch.isfinite(img).all())
    assert trv.LAUNCHES["closest_hit_attr"] == 5
    assert trv.LAUNCHES["any_hit"] == 4
    assert compaction.LAUNCHES["treelet_entry_key"] == 2
