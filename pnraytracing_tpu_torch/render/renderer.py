"""Frame rendering and progressive accumulation.

PyTorch counterpart of ``pnraytracing_tpu/render/renderer.py`` (the
frame loop of main.cpp:569-630): ``pixel_coords``, ``primary_jitter``,
``render_frame``, ``render``, ``render_average``, ``AccumState`` and
``accum_add``.  The GLSL running average ``mix(prev, color,
1/(frameCount+1))`` (ray_tracing.comp:989-991) is kept as an exact (sum,
count) pair.

Where the JAX package compiles a frame into one program (``jax.jit``),
the port captures it once as a CUDA graph and replays it
(``render/program.py``): ``render_frame`` and ``render_average`` on a
CUDA device replay a cached :class:`FrameProgram`, which reads the camera
and the frame counter from its static buffers and the scene where it
lies (so the scene must already be on that device).  ``eager=True`` runs
the frame op by op instead, as the CPU always does.  Entry points take
``device=None``, which means the card; the CPU runs only when the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import torch

from pnraytracing_tpu_torch.core.camera import camera_rays, resolve_device
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Camera, Scene
from pnraytracing_tpu_torch.ops.sampling import frame_word, pixel_seed, rand01
from pnraytracing_tpu_torch.render.integrator import render_rays
from pnraytracing_tpu_torch.utils import profiling


def pixel_coords(cfg: RenderConfig, device=None):
    """Per-ray pixel coordinates (int64) in the reference's GL convention
    (x = column, y = row from the bottom), in :func:`camera_rays` order
    (row-major from the top row)."""
    dev = resolve_device(device)
    xs = torch.arange(cfg.width, dtype=torch.int64, device=dev)
    ys = torch.arange(cfg.height, dtype=torch.int64, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx.reshape(-1), (cfg.height - 1 - gy).reshape(-1)


def primary_jitter(px: torch.Tensor, py: torch.Tensor, frame,
                   cfg: RenderConfig):
    """[P, 2] sub-pixel offsets in [0, 1) when ``cfg.jitter_primary``,
    else None: two draws from the pixel's stream seed salted with
    0x9E3779B9 (uint32 words in int64, ops/sampling.py), so they are
    decorrelated from the path's RNG; ``frame`` (an int or a 0-d tensor)
    counts as uint32, as in :func:`pixel_seed`."""
    if not cfg.jitter_primary:
        return None
    s = pixel_seed(px, py, frame) ^ 0x9E3779B9
    s, jx = rand01(s)
    _, jy = rand01(s)
    return torch.stack([jx, jy], dim=-1)


def frame_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                frame) -> torch.Tensor:
    """One frame op by op: camera rays, ``render_rays`` over every tile,
    the [H, W, 3] image (the phases ``camera`` and ``image`` around the
    integrator's, each tile's under its index: ``utils/profiling.py``).
    ``scene``, ``camera`` and a tensor ``frame`` lie on one device.  The
    body of a captured frame (render/program.py) and the eager frame."""
    dev = camera.eye.device
    with profiling.phase("camera"):
        px, py = pixel_coords(cfg, dev)
        o, d, _ = camera_rays(camera, cfg.width, cfg.height,
                              jitter=primary_jitter(px, py, frame, cfg))
    p = o.shape[0]
    tile = min(cfg.tile_pixels, p)
    if p % tile != 0:
        tile = p  # one batch for awkward sizes
    chunks = []
    for i, lo in enumerate(range(0, p, tile)):
        with profiling.tile(i):
            chunks.append(render_rays(scene, o[lo:lo + tile],
                                      d[lo:lo + tile], px[lo:lo + tile],
                                      py[lo:lo + tile], frame, cfg))
    with profiling.phase("image"):
        color = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
        return color.reshape(cfg.height, cfg.width, 3)


def _on(frame, dev):
    return frame.to(dev) if isinstance(frame, torch.Tensor) else frame


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame, device=None, eager: bool = False) -> torch.Tensor:
    """One 1-spp sample image [H, W, 3] for frame index ``frame`` (an int
    or a 0-d integer tensor, modulo 2^32).  On a CUDA device it replays
    the frame's captured program (``render/program.py::frame_program``,
    captured at the first call for this scene's tensors, ``cfg`` and
    device) and returns a copy of its image; with ``eager=True``, and
    always on the CPU, it runs the frame op by op.  Both give the same
    image bit for bit."""
    dev = resolve_device(device)
    if eager or dev.type != "cuda":
        return frame_image(scene.to(dev), camera.to(dev), cfg,
                           _on(frame, dev))
    from pnraytracing_tpu_torch.render.program import frame_program

    return frame_program(scene, cfg, dev).replay(camera, frame).clone()


def render(scene: Scene, camera: Camera, cfg: RenderConfig,
           spp: int | None = None, start_frame: int = 0,
           device=None) -> torch.Tensor:
    """Mean of ``spp`` (default ``cfg.spp``) progressive samples
    [H, W, 3]: :func:`render_average`."""
    n = cfg.spp if spp is None else spp
    return render_average(scene, camera, cfg, start_frame, n, device=device)


def render_average(scene: Scene, camera: Camera, cfg: RenderConfig,
                   start_frame, spp: int, device=None,
                   eager: bool = False) -> torch.Tensor:
    """Mean of the ``spp`` samples of frames ``start_frame`` ..
    ``start_frame + spp - 1`` [H, W, 3], summed from zeros in frame
    order and divided by ``spp`` (``lax.fori_loop`` in the JAX package).
    On a CUDA device the frame's captured program (the one
    :func:`render_frame` replays, which ends with ``acc += image; frame +=
    1``) is replayed ``spp`` times; with ``eager=True``, and on
    the CPU, the frames run op by op.  Both give the same image bit for
    bit."""
    dev = resolve_device(device)
    if not (eager or dev.type != "cuda"):
        from pnraytracing_tpu_torch.render.program import frame_program

        return frame_program(scene, cfg, dev).average(camera, start_frame,
                                                      spp)
    scene, camera = scene.to(dev), camera.to(dev)
    start = frame_word(_on(start_frame, dev))
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=dev)
    for i in range(spp):
        acc = acc + frame_image(scene, camera, cfg, start + i)
    return acc / float(spp)


@dataclasses.dataclass
class AccumState:
    """Progressive accumulation buffer, the persistent state of the
    reference (output image + frameCount, main.cpp:556-559, 628):
    ``total`` [H, W, 3] float32, the sum of samples, and ``count`` a 0-d
    int32 tensor on the same device, the number of frames in it (fed to
    the next frame as its counter without a host read)."""

    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, cfg: RenderConfig, device=None) -> "AccumState":
        dev = resolve_device(device)
        return cls(total=torch.zeros((cfg.height, cfg.width, 3),
                                     dtype=torch.float32, device=dev),
                   count=torch.zeros((), dtype=torch.int32, device=dev))

    def add(self, sample_image: torch.Tensor) -> "AccumState":
        return AccumState(total=self.total + sample_image,
                          count=self.count + 1)

    def reset(self) -> "AccumState":
        return AccumState(total=torch.zeros_like(self.total),
                          count=torch.zeros_like(self.count))

    def resolve(self) -> torch.Tensor:
        return self.total / torch.clamp_min(self.count, 1).to(torch.float32)


def accum_add(acc: AccumState, sample_image: torch.Tensor) -> AccumState:
    """The accumulation step in place, the port's counterpart of the JAX
    package's donating ``accum_add``: ``total`` and ``count`` keep their
    storage (a 2048^2 sum would otherwise be reallocated every frame);
    returns ``acc`` itself, updated."""
    acc.total.add_(sample_image)
    acc.count.add_(1)
    return acc
