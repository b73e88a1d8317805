"""The port's recorder (``utils/profiling.py``) and the spans and counters
of the frame, on the CPU:

* spans nest, and the record keeps each name's count, host seconds and
  first span's seconds;
* a counter takes device tensors and numbers without reading them back:
  only ``record()`` reads them, those of a kept capture; a frame that no
  ``collect()`` watches computes no counter; nested collects each close
  their own;
* an eager 32x32 frame, depth 3, one bounce sorted: under
  ``torch.profiler`` the ``pnrt.phase.*`` spans come in the frame's order,
  once a bounce; its ``rays.live`` a bounce equals the paths still
  unterminated there, recounted from the frame's records
  (``trace_paths``); its image still equals the JAX package's frame, as
  tests/test_torch_render.py holds it (the spans and counters change no
  arithmetic);
* a capture simulated on the CPU (each operator that is not a view
  counts as one graph node): the phases' node ranges tile the frame, in
  order, with their bounces and tiles, and nothing is counted; the
  count walks the capture's chain of nodes, each node once;
* ``chip_smoke.profile_frame``'s busy time is a union of intervals.

The capture on the card: tests/test_torch_profiling_card.py.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.render.renderer import render_frame as jax_render_frame
from pnraytracing_tpu_torch.accel import walks
from pnraytracing_tpu_torch.core.camera import camera_rays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.render import integrator
from pnraytracing_tpu_torch.render.renderer import (
    frame_image,
    pixel_coords,
    render_frame,
)
from pnraytracing_tpu_torch.utils import profiling
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    _torch_threads,
    jax_teapot_night,
    port_camera,
    port_scene,
)

FRAME = dict(width=32, height=32, max_depth=3, sort_max_bounce=1)
BOUNCE_PHASES = ["shade", "sort", "shadow", "next", "accumulate"]


@pytest.fixture(autouse=True)
def _fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def test_spans_nest_and_add_up_by_name():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("frame.outer") as outer:
            with profiling.span("frame.inner") as first:
                torch.ones(64).add_(1.0)
            with profiling.span("frame.inner") as second:
                torch.ones(64).mul_(2.0)
    spans = profiling.record()["spans"]
    assert spans["frame.outer"] == {"count": 1, "seconds": outer.seconds,
                                    "first": outer.seconds}
    assert spans["frame.inner"]["count"] == 2
    assert spans["frame.inner"]["first"] == first.seconds
    assert spans["frame.inner"]["seconds"] == pytest.approx(
        first.seconds + second.seconds)
    assert outer.seconds >= spans["frame.inner"]["seconds"] > 0
    ranges = {}
    for e in prof.events():
        if e.name.startswith("pnrt."):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    (lo, hi), = ranges["pnrt.frame.outer"]
    assert len(ranges["pnrt.frame.inner"]) == 2
    assert all(lo <= s <= e <= hi for s, e in ranges["pnrt.frame.inner"])


def test_counters_are_read_back_only_by_record(monkeypatch):
    reads = []
    for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    profiling.count("rays.live", torch.tensor(9))  # nothing collects it
    with profiling.collect() as mine:
        with profiling.tile(1), profiling.phase("shade", 2):
            profiling.count("rays.live", torch.tensor([True, False,
                                                       True]).sum())
            profiling.count("rays.launched", 3)
        profiling.count("rays.live", torch.tensor(4))
    profiling.keep_capture(dict(nodes=0, phases=[], walks=[],
                                counts=mine.counts))
    assert reads == []
    assert [(n, b, t) for n, b, t, _ in mine.counts] == [
        ("rays.live", 2, 1), ("rays.launched", 2, 1),
        ("rays.live", None, None)]
    rec = profiling.record()
    assert reads
    assert rec["captures"][-1]["counts"] == [
        ("rays.live", 2, 1, 2.0), ("rays.launched", 2, 1, 3.0),
        ("rays.live", None, None, 4.0)]
    assert rec["spans"]["phase.shade"]["count"] == 1


def test_nested_collects_each_close_their_own():
    """Two open collects receive the same counters (their records are
    then equal), and each closes its own: the inner one first, then the
    outer one, whatever the records hold."""
    with profiling.collect() as outer:
        with profiling.collect() as inner:
            profiling.count("rays.launched", 3)
        assert inner == outer and inner is not outer
        assert profiling.collecting()
        profiling.count("rays.launched", 4)
    assert not profiling.collecting()
    assert [v for *_, v in outer.counts] == [3, 4]
    assert [v for *_, v in inner.counts] == [3]


@functools.lru_cache(maxsize=1)
def _eager_frame():
    """The frame under the profiler inside a collect: (image, the
    ``pnrt.phase.*`` span names in order, the collected counters)."""
    js, jcam = jax_teapot_night()
    scene, cam = port_scene(js), port_camera(jcam.basis())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.collect() as mine:
            img = render_frame(scene, cam, RenderConfig(**FRAME), 5,
                               device="cpu")
    events = sorted((e for e in prof.events()
                     if e.name.startswith("pnrt.phase.")),
                    key=lambda e: e.time_range.start)
    return img, [e.name[len("pnrt.phase."):] for e in events], mine.counts


def test_eager_frame_shows_its_phases_in_order():
    _, names, _ = _eager_frame()
    runs = [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n]
    assert runs == ["camera"] + BOUNCE_PHASES * FRAME["max_depth"] + [
        "image"]


def test_eager_frame_counts_its_live_rays():
    """rays.live at the top of bounce b = the paths whose primary hit and
    first b continuation hits all hit, from the frame's own records."""
    _, _, counts = _eager_frame()
    js, jcam = jax_teapot_night()
    scene, cam = port_scene(js), port_camera(jcam.basis())
    cfg = RenderConfig(**FRAME)
    px, py = pixel_coords(cfg, "cpu")
    o, d, _ = camera_rays(cam, cfg.width, cfg.height)
    recs = integrator.trace_paths(scene, o, d, px, py, 5, cfg)
    alive = recs.primary.valid
    want = []
    for b in range(cfg.max_depth):
        want.append(int(alive.sum()))
        alive = alive & (recs.bounce.tri[b] >= 0)
    live = {b: int(v) for n, b, t, v in counts if n == "rays.live"}
    launched = {b: v for n, b, t, v in counts if n == "rays.launched"}
    assert live == dict(enumerate(want))
    assert launched == {b: 32 * 32 for b in range(cfg.max_depth)}
    assert want[0] > want[-1] > 0  # paths end along the way
    assert {t for _, _, t, _ in counts} == {0}


def test_eager_frame_with_spans_matches_jax():
    img, _, _ = _eager_frame()
    js, jcam = jax_teapot_night()
    want = np.asarray(jax_render_frame(
        js, jcam.basis(), JaxRenderConfig(traversal="packet", **FRAME), 5))
    assert_frame_close(img.numpy(), want)
    assert want.mean() > 0.05


class _Sums(TorchDispatchMode):
    """Counts the reductions (``aten.sum``) a body runs."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket is torch.ops.aten.sum
        return func(*args, **(kwargs or {}))


def test_a_frame_nothing_collects_computes_no_counter(monkeypatch):
    """The live-ray counter's reduction runs only inside a ``collect()``:
    one a bounce there, none elsewhere (the CPU frame, ``eager=True``,
    the gradient steps' frames), and nothing reaches the record."""
    js, jcam = jax_teapot_night()
    scene, cam = port_scene(js), port_camera(jcam.basis())
    cfg = RenderConfig(width=16, height=16, max_depth=2, sort_max_bounce=1)
    counted = []
    monkeypatch.setattr(integrator, "count",
                        lambda *a: counted.append(a[0]))
    sums = []
    for watched in (False, True):
        with contextlib.ExitStack() as stack:
            if watched:
                stack.enter_context(profiling.collect())
            mode = stack.enter_context(_Sums())
            render_frame(scene, cam, cfg, 5, device="cpu")
        sums.append(mode.n)
    assert sums[1] - sums[0] == cfg.max_depth
    assert counted == ["rays.live", "rays.launched"] * cfg.max_depth
    assert profiling.record()["captures"] == []


class _Nodes(TorchDispatchMode):
    """Counts every operator that is not a view (nor a span's own
    bookkeeping), as a captured graph would count the kernels it
    launches."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func.namespace != "profiler":
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_phases_tile_a_simulated_capture(monkeypatch):
    js, jcam = jax_teapot_night()
    scene, cam = port_scene(js), port_camera(jcam.basis())
    cfg = RenderConfig(tile_pixels=512, **FRAME)  # two tiles
    nodes = _Nodes()
    monkeypatch.setattr(profiling, "capturing", lambda: True)
    monkeypatch.setattr(integrator, "capturing", lambda: True)
    monkeypatch.setattr(walks, "capturing", lambda: True)
    # node k (1, 2, ...) depends on node k - 1: one chain
    monkeypatch.setattr(profiling, "_last_node", lambda: nodes.n)
    monkeypatch.setattr(profiling, "_walk_back",
                        lambda k, stop: (stop, k - stop))
    acc, frame = torch.zeros(32, 32, 3), torch.tensor(5)
    with profiling.collect() as mine, nodes:
        img = frame_image(scene, cam, cfg, frame)
        with profiling.phase("image"):  # as FrameProgram._body
            acc.add_(img)
        total = mine.nodes()
    assert total == nodes.n
    at = 0
    for _, _, _, first, n in mine.phases:
        assert first == at and n >= 0
        at += n
    assert at == total
    labels = [p[:3] for p in mine.phases]
    want = [("camera", None, None)]
    for t in (0, 1):
        want.append(("camera", None, t))
        want += [(p, b, t) for b in range(cfg.max_depth)
                 for p in BOUNCE_PHASES]
        want.append(("image", None, t))
    want.append(("image", None, None))
    assert labels == want
    sizes = {p[:3]: p[4] for p in mine.phases}
    assert sizes[("sort", 0, 0)] > 0 and sizes[("sort", 1, 0)] == 0
    assert mine.counts == [] and mine.kernels == []  # the walks are plain


def test_capture_count_walks_the_chain(monkeypatch):
    """The node count walks back from the capture's last node through
    each node's one dependency (libcuda's answer faked here), each node
    once; a node with several dependencies ends the layout (``chain``
    False, no counts)."""
    before = {17: [], 3: [17], 99: [3], 42: [99], 5: [42]}  # 17 ... 5
    last, walked = [0], []

    def get_dependencies(node, out, n_ref):
        walked.append(node)
        deps = before[node][:n_ref._obj.value]
        out[:len(deps)] = deps
        n_ref._obj.value = len(deps)
        return 0

    monkeypatch.setattr(profiling, "_last_node", lambda: last[0])
    monkeypatch.setattr(profiling, "_libcuda",
                        lambda: (None, get_dependencies))
    c = profiling.Collected()
    assert c.nodes() == 0
    last[0] = 3
    assert c.nodes() == 2
    last[0] = 42
    assert c.nodes() == 4 and c.nodes() == 4
    last[0] = 5
    assert c.nodes() == 5
    assert walked == [3, 17, 42, 99, 5]
    c.add_phase("shade", 0, 0, 0, 2)
    c.add_phase("shade", 0, 0, 2, 4)  # continued: one range
    c.add_phase("sort", 0, 0, 4, 4)
    assert c.phases == [("shade", 0, 0, 0, 4), ("sort", 0, 0, 4, 0)]
    before[6], before[7] = [5, 99], [6]  # 6 joins two nodes
    last[0] = 7
    assert c.nodes() is None and not c.chain


def test_chip_smoke_busy_time_is_a_union():
    """``chip_smoke.profile_frame``'s busy time: overlapping operations
    count once, so its idle share is never negative."""
    from chip_smoke import union_us

    assert union_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert union_us([(3, 4)]) == 1 and union_us([]) == 0
