"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  On the card:
``python -m pytest -m gpu tests/test_torch_cuda.py``.

Bounds: the kernels are built with --fmad=false and repeat their plain
versions op for op, so hits, barycentrics, attributes, occlusion,
keys and the walk stats are equal; a triangle id may differ only on an
exact-t tie.  A frame replayed from its captured CUDA graph
(render/program.py) equals the eager frame bit for bit.  The gradient
path: a trace's records through the kernels equal those of the plain
walks bit for bit; the replay gradient is within 1e-3 (in norm) of the
live one; two runs of one gradient step are equal bit for bit; the
kernels' answers carry no gradient.  ``parallel/`` in a
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
    monkeypatch.setattr(integrator, "closest_hit_attr",
                        trv.plain_closest_hit_attr)
    monkeypatch.setattr(integrator, "any_hit", trv.plain_any_hit)
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
