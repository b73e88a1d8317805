"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  On the card:
``python -m pytest -m gpu tests/test_torch_cuda.py``.

Bounds: the kernels are built with --fmad=false and repeat their plain
versions op for op, so hits, barycentrics, attributes, occlusion and
keys are equal; a triangle id may differ only on an exact-t tie.
"""

import numpy as np
import pytest
import torch

from pnraytracing_tpu_torch.accel import traverse_cuda as trv
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.vec import V3
from pnraytracing_tpu_torch.ops import compaction
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def flagship():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    scene, cam = config3_teapot_night(env_height=64, device="cuda")
    return scene, cam.basis(device="cuda")


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
    key = compaction.entry_key(o, d, scene.trav.treelets)
    assert torch.equal(key, compaction.treelet_entry_key(
        o, d, scene.trav.treelets))


def test_frame_through_kernels_matches_plain(flagship, monkeypatch):
    from pnraytracing_tpu_torch.render import integrator

    scene, cam = flagship
    cfg = RenderConfig(width=64, height=64, max_depth=3)
    for counts in (trv.LAUNCHES, compaction.LAUNCHES):
        for k in counts:
            counts[k] = 0
    img = render_frame(scene, cam, cfg, 0)
    assert trv.LAUNCHES == {"closest_hit_attr": 4, "any_hit": 3,
                            "closest_hit": 0}
    assert compaction.LAUNCHES == {"treelet_entry_key": 2}
    monkeypatch.setattr(integrator, "closest_hit_attr",
                        trv.plain_closest_hit_attr)
    monkeypatch.setattr(integrator, "any_hit", trv.plain_any_hit)
    monkeypatch.setattr(integrator, "entry_key",
                        compaction.treelet_entry_key)
    want = render_frame(scene, cam, cfg, 0)
    off = (img - want).abs().amax(dim=-1) > 3e-5
    assert int(off.sum()) <= 1
