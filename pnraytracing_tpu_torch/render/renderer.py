"""Frame rendering and progressive averaging.

PyTorch counterpart of ``render_frame``, ``render``, ``pixel_coords`` and
``primary_jitter`` of ``pnraytracing_tpu/render/renderer.py`` (the frame loop of
main.cpp:569-630).  Entry points take ``device=None``, which means the
card; the CPU runs only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.core.camera import camera_rays, resolve_device
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Camera, Scene
from pnraytracing_tpu_torch.ops.sampling import pixel_seed, rand01
from pnraytracing_tpu_torch.render.integrator import render_rays


def pixel_coords(cfg: RenderConfig, device=None):
    """Per-ray pixel coordinates (int64) in the reference's GL convention
    (x = column, y = row from the bottom), in :func:`camera_rays` order
    (row-major from the top row)."""
    dev = resolve_device(device)
    xs = torch.arange(cfg.width, dtype=torch.int64, device=dev)
    ys = torch.arange(cfg.height, dtype=torch.int64, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx.reshape(-1), (cfg.height - 1 - gy).reshape(-1)


def primary_jitter(px: torch.Tensor, py: torch.Tensor, frame: int,
                   cfg: RenderConfig):
    """[P, 2] sub-pixel offsets in [0, 1) when ``cfg.jitter_primary``,
    else None: two draws from the pixel's stream seed salted with
    0x9E3779B9 (uint32 words in int64, ops/sampling.py), so they are
    decorrelated from the path's RNG; ``frame`` counts as uint32, as in
    :func:`pixel_seed`."""
    if not cfg.jitter_primary:
        return None
    s = pixel_seed(px, py, frame) ^ 0x9E3779B9
    s, jx = rand01(s)
    _, jy = rand01(s)
    return torch.stack([jx, jy], dim=-1)


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig,
                 frame: int, device=None) -> torch.Tensor:
    """One 1-spp sample image [H, W, 3] for frame index ``frame``."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    px, py = pixel_coords(cfg, dev)
    o, d, _ = camera_rays(camera, cfg.width, cfg.height,
                          jitter=primary_jitter(px, py, frame, cfg))
    p = o.shape[0]
    tile = min(cfg.tile_pixels, p)
    if p % tile != 0:
        tile = p  # one batch for awkward sizes
    chunks = [render_rays(scene, o[lo:lo + tile], d[lo:lo + tile],
                          px[lo:lo + tile], py[lo:lo + tile], frame, cfg)
              for lo in range(0, p, tile)]
    color = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
    return color.reshape(cfg.height, cfg.width, 3)


def render(scene: Scene, camera: Camera, cfg: RenderConfig,
           spp: int | None = None, start_frame: int = 0,
           device=None) -> torch.Tensor:
    """Mean of ``spp`` progressive samples [H, W, 3]."""
    n = cfg.spp if spp is None else spp
    acc = None
    for f in range(start_frame, start_frame + n):
        img = render_frame(scene, camera, cfg, f, device=device)
        acc = img if acc is None else acc + img
    return acc / float(n)
