"""The frame as one captured program: the port's counterpart of
``jax.jit`` over ``render_rays`` (``pnraytracing_tpu/render/
integrator.py:1091``) and of ``render_average``'s ``lax.fori_loop``
(``render/renderer.py:87-112`` there).

An eager frame is some 8k small device kernels enqueued one by one from
Python, and the card idles through most of it.  A :class:`FrameProgram`
captures one whole frame of ``render_frame`` (camera rays,
``render_rays`` over every tile, the [H, W, 3] image) into a
``torch.cuda.CUDAGraph`` once and then replays it.  Its inputs are
static device buffers, the camera basis and the frame counter, which
:meth:`FrameProgram.replay` copies in.  The scene must already lie on
the program's device (a ValueError otherwise): the graph reads the
caller's own tensors, so an in-place edit of them
(``RenderSession.edit_material``) shows in the next replay without a new
capture, and the program holds them, so no address baked into the graph
is freed and reused while it lives.  The graph ends with ``acc += image;
frame += 1`` on the device: ``render_frame`` reads ``image`` of one
replay, and ``render_average`` replays it ``spp`` times from a zeroed
``acc``.

Capture follows PyTorch's rules: a warm-up frame on a side stream first
(it builds and loads the CUDA kernels and makes every constant the frame
keeps on the device, which must not happen while a stream captures),
then one frame under ``torch.cuda.graph`` with its private memory pool.
A capture that fails raises with the CUDA error; nothing falls back to
eager frames.  The kernels' launch counters (``LAUNCHES`` of the
wrappers) count at capture, not at replay: :attr:`FrameProgram.launches`
keeps the captured frame's counts.  The capture adds nothing to the
graph, but keeps its layout (``utils/profiling.py``), and hands it to
the record: ``nodes``, the graph's node count; ``phases``, ``(phase,
bounce, tile, first_ordinal, n_nodes)`` ranges of the integrator's
phases, in order, which tile ``[0, nodes)``; ``walks``, the node
ordinals of its walk kernels; and ``counts``, the warm-up frame's
counters (live and launched rays by bounce and tile), device tensors
until :func:`profiling.record` reads them.  (A graph that is not one
chain, as one stream's capture always is, keeps no layout.)  Spans:
``capture.warmup``, ``capture.graph``
(:attr:`FrameProgram.capture_seconds`), and ``frame.replay`` (each
``graph.replay()``).

:func:`frame_program` keeps the last :data:`PROGRAM_CACHE_SIZE` programs
by (the scene's tensors, ``cfg``, which fixes the tile shape, device);
:func:`clear_programs` drops them and their memory pools, and those of
every cache registered with :func:`register_cache` (the captured
gradient steps of ``diff/program.py``).
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from pnraytracing_tpu_torch.accel import walks
from pnraytracing_tpu_torch.core.camera import resolve_device
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Camera, Scene, tensors
from pnraytracing_tpu_torch.ops import compaction
from pnraytracing_tpu_torch.ops.sampling import frame_word
from pnraytracing_tpu_torch.render.renderer import frame_image
from pnraytracing_tpu_torch.utils import profiling

PROGRAM_CACHE_SIZE = 4
_LAUNCH_TABLES = walks.LAUNCH_TABLES + (compaction.LAUNCHES,)


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    return {k: v for t in _LAUNCH_TABLES for k, v in t.items()}


class FrameProgram:
    """One frame of ``scene`` under ``cfg`` on a CUDA device, captured as
    a CUDA graph at the first :meth:`replay` (or :meth:`capture`) and
    replayed after it."""

    def __init__(self, scene: Scene, cfg: RenderConfig, device=None):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"a FrameProgram runs on a CUDA device, not "
                             f"{dev}; the CPU renders frames eagerly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        away = sorted({str(t.device) for t in tensors(scene)
                       if t.device != dev})
        if away:
            raise ValueError(
                f"the scene has tensors on {', '.join(away)}, not on {dev}: "
                f"a captured frame reads the scene where it lies, so build "
                f"it on {dev} or move it there once (scene.to(device)) "
                f"before rendering")
        self.device, self.cfg, self.scene = dev, cfg, scene
        z = lambda *shape, dtype=torch.float32: torch.zeros(
            shape, dtype=dtype, device=dev)
        self.camera = Camera(eye=z(3), lower_left=z(3), horizontal=z(3),
                             vertical=z(3))
        self.frame = z(dtype=torch.int64)
        self.acc = z(cfg.height, cfg.width, 3)
        self.graph = None
        self.image = None
        self.launches = None
        self.capture_seconds = None
        self.nodes = None
        self.phases = None
        self.walks = None
        self.counts = None

    def _load(self, camera: Camera, frame) -> None:
        self.camera.copy_(camera)
        if isinstance(frame, torch.Tensor):
            self.frame.copy_(frame.reshape(()))
        else:
            self.frame.fill_(frame_word(frame))

    def _body(self) -> torch.Tensor:
        img = frame_image(self.scene, self.camera, self.cfg, self.frame)
        with profiling.phase("image"):
            self.acc.add_(img)
            self.frame.add_(1)
        return img

    def capture(self, camera: Camera, frame=0) -> None:
        """Run one warm-up frame on a side stream (the span
        ``capture.warmup``), then capture one frame (``capture.graph``).
        Raises with the CUDA error if the capture fails."""
        self._load(camera, frame)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with profiling.span("capture.warmup"), profiling.collect() as warm:
            with torch.cuda.stream(side):
                self._body()
        main.wait_stream(side)
        self._load(camera, frame)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with (profiling.span("capture.graph") as timed,
                  profiling.collect() as layout, torch.cuda.graph(graph)):
                image = self._body()
                nodes = layout.nodes()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the frame as a CUDA graph failed: {e}") from e
        self.capture_seconds = timed.seconds
        self.launches = {k: v - before[k] for k, v in launch_counts().items()}
        self.graph, self.image = graph, image
        self.counts = warm.counts
        if nodes is not None:  # None: the graph is no chain
            walk_keys = {k for t in walks.LAUNCH_TABLES for k in t}
            self.nodes, self.phases = nodes, layout.phases
            self.walks = [n for k, n in layout.kernels if k in walk_keys]
            profiling.keep_capture(dict(
                nodes=self.nodes, phases=self.phases, walks=self.walks,
                counts=self.counts))

    def replay(self, camera: Camera, frame) -> torch.Tensor:
        """The frame's image for this camera and frame counter (an int or
        a 0-d integer tensor).  The image is the program's own buffer,
        which the next replay overwrites."""
        if self.graph is None:
            self.capture(camera, frame)
        self._load(camera, frame)
        with profiling.span("frame.replay"):
            self.graph.replay()
        return self.image

    def average(self, camera: Camera, start_frame, spp: int
                ) -> torch.Tensor:
        """Mean of frames ``start_frame`` .. ``start_frame + spp - 1``:
        the graph replayed ``spp`` times from a zeroed ``acc``."""
        if self.graph is None:
            self.capture(camera, start_frame)
        self._load(camera, start_frame)
        self.acc.zero_()
        for _ in range(spp):
            with profiling.span("frame.replay"):
                self.graph.replay()
        return self.acc / float(spp)


def _leaves(obj):
    """The cache key of a scene: each tensor by identity, every other
    field by value, in field order."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", id(obj))
    if dataclasses.is_dataclass(obj):
        return tuple(_leaves(getattr(obj, f.name))
                     for f in dataclasses.fields(obj))
    return obj


_programs: collections.OrderedDict = collections.OrderedDict()
_caches = [_programs]


def register_cache(cache) -> None:
    """Have :func:`clear_programs` empty ``cache`` too."""
    _caches.append(cache)


def frame_program(scene: Scene, cfg: RenderConfig, device=None
                  ) -> FrameProgram:
    """The cached :class:`FrameProgram` of this scene (by its tensors),
    ``cfg`` (which fixes the tile shape) and device, made on first use.
    The cache keeps
    the :data:`PROGRAM_CACHE_SIZE` most recently used programs; each
    holds its graph's private memory pool (about one frame's peak)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (_leaves(scene), cfg, dev)
    prog = _programs.pop(key, None)
    if prog is None:
        prog = FrameProgram(scene, cfg, dev)
    _programs[key] = prog
    while len(_programs) > PROGRAM_CACHE_SIZE:
        _programs.popitem(last=False)
    return prog


def clear_programs() -> None:
    """Drop every cached program, frame or gradient step (and so its
    graph and memory pool)."""
    for cache in _caches:
        cache.clear()
