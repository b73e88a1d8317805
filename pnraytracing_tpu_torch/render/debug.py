"""Single-pixel debug probe.

PyTorch counterpart of ``pnraytracing_tpu/render/debug.py``: the
reference dumps per-pixel intermediates through a debug buffer
(main.cpp:561-564; ray_tracing.comp:201-203, 897-906, 940-948); here one
pixel's primary ray is traced again and its radiance and primary-hit
record come back as a dict of tensors.
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.accel.traverse import closest_hit
from pnraytracing_tpu_torch.accel.walks import ray_components
from pnraytracing_tpu_torch.core.camera import camera_rays, resolve_device
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.math import FLOAT_MAX
from pnraytracing_tpu_torch.core.types import Camera, Scene
from pnraytracing_tpu_torch.render.integrator import render_rays


def probe_pixel(scene: Scene, camera: Camera, cfg: RenderConfig, x: int,
                y_gl: int, frame: int = 0, device=None) -> dict:
    """Render the single pixel (x, y_gl) (GL convention: y from the
    bottom) as a 1-ray batch through ``render_rays``, seeded as the full
    frame seeds that pixel, so its radiance equals that pixel of
    ``render_frame`` bit for bit (without ``jitter_primary``, which the
    probe does not apply, as in the JAX package).  The primary hit comes
    from the walk over the plain BVH (``accel/traverse.py::closest_hit``
    over ``scene.bvh`` / ``scene.mesh``, ``cfg.max_leaf_size``, its
    compat form under ``cfg.compat_pnrt``) on every scene, as in the JAX
    package.  Returns ``color`` [3], ``primary_tri``,
    ``primary_t``, ``primary_bary`` [3] (b0, b1, b2), ``ray_origin`` and
    ``ray_dir`` [3]; ``device=None`` means the card."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    o_all, d_all, _ = camera_rays(camera, cfg.width, cfg.height)
    idx = (cfg.height - 1 - y_gl) * cfg.width + x
    o = o_all[idx:idx + 1].contiguous()
    d = d_all[idx:idx + 1].contiguous()
    px = torch.tensor([x], dtype=torch.int64, device=dev)
    py = torch.tensor([y_gl], dtype=torch.int64, device=dev)

    color = render_rays(scene, o, d, px, py, frame, cfg)
    hit = closest_hit(scene.bvh, scene.mesh, *ray_components(o, d),
                      torch.full((1,), FLOAT_MAX, dtype=torch.float32,
                                 device=dev),
                      stack_depth=cfg.stack_depth,
                      max_leaf_size=cfg.max_leaf_size,
                      compat=cfg.compat_pnrt)
    return {
        "color": color[0],
        "primary_tri": hit.tri[0],
        "primary_t": hit.t[0],
        "primary_bary": torch.stack([1.0 - hit.b1[0] - hit.b2[0],
                                     hit.b1[0], hit.b2[0]]),
        "ray_origin": o[0],
        "ray_dir": d[0],
    }
