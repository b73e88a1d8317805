"""The gradient step as one captured program: the port's counterpart of
``jax.jit`` over ``loss_and_grad`` / ``loss_and_grad_replay``
(``pnraytracing_tpu/diff/grad.py:172, 218``), of the JAX bench's jitted
``--bwd`` steps (``bench.py:155-212``) and of the step that
``adam_optimize`` compiles there.

An eager step enqueues the traces, the forward and autograd's backward
op by op from Python, some tens of thousands of small device kernels,
and the card idles through most of it.  A :class:`StepProgram` captures
one whole step, ``diff/grad.py::step_body`` (the loss
``LOSSES[kind]``: the traces, the replay or live forward, the loss; then
``torch.autograd.grad`` to the param leaves), into a
``torch.cuda.CUDAGraph`` once and then replays it.  Kinds: ``"replay"`` and ``"live"`` (the losses of
``loss_and_grad_replay`` / ``loss_and_grad``, static arguments ``spp``
and ``dual``) and ``"frames"`` (the bench's loss, static arguments
``k`` and ``replay``).

Its inputs are static device buffers, which :meth:`StepProgram.replay`
fills: the param leaves (the program owns them; they require grad and
take the caller's values under ``no_grad``), the frame counter as a 0-d
int64 tensor (as ``FrameProgram.frame``), the rays and the target.  Its
outputs are the loss and the gradient leaves, overwritten by the next
replay.  The scene is read where it lies, as a ``FrameProgram`` reads
it, so it must already be on the program's device (a ValueError
otherwise); :meth:`StepProgram.load_scene` copies a scene of the same
layout (a refit after a positions step) into the program's scene in
place, so the graph goes on reading it without a new capture.

Capture follows PyTorch's rules for whole-network capture:
:data:`WARMUP_STEPS` eager steps on a side stream first (they build the
kernels, make every constant a step keeps on the device, start the
autograd engine's device thread), then one step under
``torch.cuda.graph`` with its private memory pool.  A capture that fails
raises with the CUDA error; nothing falls back to eager steps.  The
kernels' launch counters count the warm-up and the captured step, not
the replays: :attr:`StepProgram.launches` keeps the captured step's
counts, and :data:`CAPTURES` counts the captures.

:func:`step_program` keeps the last :data:`STEP_CACHE_SIZE` programs by
(kind and static arguments, the scene's tensors, ``cfg``, the params'
keys with their shapes, the ray count, device).  The bound is 2 because
each program holds a private pool about the size of one eager step's
peak (6.16-6.33 GB at 512x512, spp 2, depth 4): two of them (the replay
and the live step of one set of inputs) stay beside the frame programs
and an eager step within a card's memory many times over, and a caller
that moves on to a third set frees the oldest pool.
``render/program.py::clear_programs`` drops these programs too.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

from pnraytracing_tpu_torch.core.camera import resolve_device
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Scene, tensors
from pnraytracing_tpu_torch.diff.grad import (
    param_leaves,
    params_like,
    step_body,
)
from pnraytracing_tpu_torch.ops.sampling import frame_word
from pnraytracing_tpu_torch.render import program as frame_programs
from pnraytracing_tpu_torch.render.program import (
    _leaves,
    launch_counts,
)

STEP_CACHE_SIZE = 2
WARMUP_STEPS = 3
STATIC = {"replay": ("spp", "dual"), "live": ("spp", "dual"),
          "frames": ("k", "replay")}
CAPTURES = {"steps": 0}


def _layout(obj):
    """A scene's structure: each tensor by shape, dtype and device, every
    other field by value, in field order."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj):
        return tuple(_layout(getattr(obj, f.name))
                     for f in dataclasses.fields(obj))
    return obj


def _param_layout(params: dict):
    """The params' keys with each leaf's shape and dtype."""
    return tuple((k, tuple((tuple(x.shape), x.dtype)
                           for x in param_leaves({k: params[k]})))
                 for k in sorted(params))


class StepProgram:
    """One gradient step of ``kind`` on ``scene`` under ``cfg`` for
    ``n_rays`` rays on a CUDA device, captured as a CUDA graph at the
    first :meth:`replay` (or :meth:`capture`) and replayed after it."""

    def __init__(self, kind: str, scene: Scene, cfg: RenderConfig,
                 params: dict, n_rays: int, device=None, **static):
        if kind not in STATIC:
            raise ValueError(f"unknown step kind {kind!r}; choose from "
                             f"{sorted(STATIC)}")
        if not set(static) <= set(STATIC[kind]):
            raise ValueError(f"a {kind!r} step takes the static arguments "
                             f"{STATIC[kind]}, not {sorted(static)}")
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"a StepProgram runs on a CUDA device, not "
                             f"{dev}; the CPU runs gradient steps eagerly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        away = sorted({str(t.device) for t in tensors(scene)
                       if t.device != dev})
        if away:
            raise ValueError(
                f"the scene has tensors on {', '.join(away)}, not on {dev}: "
                f"a captured step reads the scene where it lies, so build "
                f"it on {dev} or move it there once (scene.to(device)) "
                f"before the step")
        self.kind, self.static = kind, dict(static)
        self.device, self.cfg, self.scene = dev, cfg, scene
        self.leaves = [torch.zeros(x.shape, dtype=x.dtype, device=dev,
                                   requires_grad=True)
                       for x in param_leaves(params)]
        self.params = params_like(params, self.leaves)
        z = lambda *shape, dtype=torch.float32: torch.zeros(
            shape, dtype=dtype, device=dev)
        self.o, self.d = z(n_rays, 3), z(n_rays, 3)
        self.px = z(n_rays, dtype=torch.int64)
        self.py = z(n_rays, dtype=torch.int64)
        self.target = z(n_rays, 3)
        self.frame = z(dtype=torch.int64)
        self.graph = None
        self.loss = None
        self.grads = None
        self.launches = None
        self.capture_seconds = None

    def _load(self, params: dict, o, d, px, py, frame, target) -> None:
        leaves = param_leaves(params)
        if [(x.shape, x.dtype) for x in leaves] != [
                (x.shape, x.dtype) for x in self.leaves]:
            raise ValueError("the params differ in structure, shape or dtype "
                             "from the ones this step was captured for")
        for name, src in (("o", o), ("d", d), ("px", px), ("py", py),
                          ("target", target)):
            dst = getattr(self, name)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"{name}: a captured step takes {tuple(dst.shape)} "
                    f"{dst.dtype}, not {tuple(src.shape)} {src.dtype}")
            dst.copy_(src)
        with torch.no_grad():
            for dst, src in zip(self.leaves, leaves):
                dst.copy_(src)
        if isinstance(frame, torch.Tensor):
            self.frame.copy_(frame.reshape(()))
        else:
            self.frame.fill_(frame_word(frame))

    def _body(self):
        return step_body(self.kind, self.params, self.leaves, self.scene,
                         self.o, self.d, self.px, self.py, self.frame,
                         self.target, self.cfg, **self.static)

    def capture(self, params: dict, o, d, px, py, frame, target) -> None:
        """Run :data:`WARMUP_STEPS` eager steps on a side stream, then
        capture one step.  Raises with the CUDA error if the capture
        fails."""
        self._load(params, o, d, px, py, frame, target)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._body()
        main.wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                loss, grads = self._body()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the gradient step as a CUDA graph failed: {e}"
            ) from e
        self.capture_seconds = time.perf_counter() - t0
        self.launches = {k: v - before[k] for k, v in launch_counts().items()}
        self.graph, self.loss, self.grads = graph, loss, grads
        CAPTURES["steps"] += 1

    def replay(self, params: dict, o, d, px, py, frame, target):
        """``(loss, grads)`` of the step at ``params`` (a dict of the
        captured structure), rays ``o, d, px, py``, frame counter
        ``frame`` (an int or a 0-d integer tensor) and ``target``:
        ``grads`` of ``params``' structure.  Both are the program's own
        buffers, which the next replay overwrites."""
        if self.graph is None:
            self.capture(params, o, d, px, py, frame, target)
        self._load(params, o, d, px, py, frame, target)
        self.graph.replay()
        return self.loss, params_like(self.params, self.grads)

    def load_scene(self, scene: Scene) -> bool:
        """Copy ``scene``'s tensors into the program's scene in place and
        return True when the two have one layout (every tensor's shape,
        dtype and device, every other field's value); else change
        nothing and return False (the caller captures a new program).
        The program's scene must be the caller's to overwrite."""
        if _layout(scene) != _layout(self.scene):
            return False
        with torch.no_grad():
            for dst, src in zip(tensors(self.scene), tensors(scene)):
                if dst is not src:
                    dst.copy_(src)
        return True


_programs: collections.OrderedDict = collections.OrderedDict()
frame_programs.register_cache(_programs)


def step_program(kind: str, scene: Scene, cfg: RenderConfig, params: dict,
                 n_rays: int, device=None, **static) -> StepProgram:
    """The cached :class:`StepProgram` of this kind and static arguments,
    scene (by its tensors), ``cfg``, params layout, ray count and device,
    made on first use.  The cache keeps the :data:`STEP_CACHE_SIZE` most
    recently used programs."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (kind, tuple(sorted(static.items())), _leaves(scene), cfg,
           _param_layout(params), int(n_rays), dev)
    prog = _programs.pop(key, None)
    if prog is None:
        prog = StepProgram(kind, scene, cfg, params, n_rays, dev, **static)
    _programs[key] = prog
    while len(_programs) > STEP_CACHE_SIZE:
        _programs.popitem(last=False)
    return prog
