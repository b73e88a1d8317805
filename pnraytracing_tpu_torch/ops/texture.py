"""Base-color texture fetch from the stacked atlas.

PyTorch counterpart of ``pnraytracing_tpu/ops/texture.py``.  The
reference binds each texture to its own GL sampler unit (max 20,
main.cpp:527-554) and overrides ``material.baseColor`` at shade time
(ray_tracing.comp:870-872).  Here all textures live in one padded
[K, H, W, 3] tensor; the fetch is a batched gather with repeat wrapping
and bilinear filtering (trilinear over the mip strip with
``RenderConfig.texture_lod_scale``).  Plain PyTorch on the card too: no
Pallas kernel stands behind these functions.  :func:`build_atlas` is the
JAX package's numpy code, so both packages build the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from pnraytracing_tpu_torch.core.camera import resolve_device
from pnraytracing_tpu_torch.core.types import TextureAtlas
from pnraytracing_tpu_torch.ops.gather import gather_row


def _box_down2(im: np.ndarray) -> np.ndarray:
    """2x box downsample (glGenerateMipmap-style); odd dims floor-halve."""
    h, w = im.shape[0] & ~1, im.shape[1] & ~1
    im = im[:h, :w]
    return 0.25 * (im[0::2, 0::2] + im[1::2, 0::2]
                   + im[0::2, 1::2] + im[1::2, 1::2])


def build_atlas(images: list[np.ndarray], mips: bool = True,
                device=None) -> TextureAtlas | None:
    """Stack variable-size [h, w, 3] float images (values in [0, 1]) into
    a padded atlas on ``device`` (None = cuda); None for an empty list.
    ``mips=True`` also bakes the box-filtered mip strip (main.cpp:541-546):
    level l lives at rows [h - (h >> (l-1)), h - (h >> l)), width w >> l
    of the ``mips`` plane."""
    if not images:
        return None
    max_h = max(im.shape[0] for im in images)
    max_w = max(im.shape[1] for im in images)
    data = np.zeros((len(images), max_h, max_w, 3), np.float32)
    strip = np.zeros((len(images), max_h, max_w, 3), np.float32)
    sizes = np.zeros((len(images), 2), np.int32)
    for k, im in enumerate(images):
        h, w = im.shape[0], im.shape[1]
        data[k, :h, :w] = im[..., :3]
        sizes[k] = (w, h)
        if mips:
            level = np.asarray(im[..., :3], np.float32)
            lvl = 1
            while (h >> lvl) >= 1 and (w >> lvl) >= 1:
                level = _box_down2(level)
                y0 = h - (h >> (lvl - 1))
                strip[k, y0:y0 + level.shape[0], :level.shape[1]] = level
                lvl += 1
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, device=dev)
    return TextureAtlas(data=t(data), sizes=t(sizes),
                        mips=t(strip) if mips else None)


def _bilinear_level(atlas: TextureAtlas, tid, u, v, level):
    """Bilinear fetch at mip ``level`` ([R] int, 0 = the base plane).
    Level l >= 1 reads the mip strip at rows [h-(h>>(l-1)), +h>>l), width
    w>>l.  Repeat wrap inside the level's region."""
    wh = atlas.sizes[tid]
    wi = torch.clamp_min(wh[..., 0] >> level, 1)
    hi = torch.clamp_min(wh[..., 1] >> level, 1)
    y_off = torch.where(
        level > 0, wh[..., 1] - (wh[..., 1] >> torch.clamp_min(level - 1, 0)),
        0)
    fx = u * wi.to(torch.float32) - 0.5
    fy = v * hi.to(torch.float32) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), wi)
    x1i = torch.remainder(x0i + 1, wi)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    y1i = torch.remainder(y0i + 1, hi)
    tl = tid.long()

    def texel(plane, yy, xx):  # one row gather from the flattened plane
        _, ph, pw, ch = plane.shape
        flat = (tl * ph + yy.long()) * pw + xx.long()
        return gather_row(flat.reshape(-1), plane.reshape(-1, ch)).reshape(
            *flat.shape, ch)

    def tap(yy, xx):  # the base plane or the strip, per ray
        base = texel(atlas.data, yy, xx)
        if atlas.mips is None:
            return base
        strip = texel(atlas.mips, y_off + yy, xx)
        return torch.where((level > 0)[..., None], strip, base)

    c00 = tap(y0i, x0i)
    c10 = tap(y0i, x1i)
    c01 = tap(y1i, x0i)
    c11 = tap(y1i, x1i)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def fetch_base_color_trilinear(atlas: TextureAtlas, texture_id: torch.Tensor,
                               uv: torch.Tensor, base_color: torch.Tensor,
                               lod: torch.Tensor) -> torch.Tensor:
    """Trilinear (GL_LINEAR_MIPMAP_LINEAR, main.cpp:541-546) fetch:
    bilinear at floor(lod) and floor(lod)+1, mixed by the fraction;
    ``lod`` [R] float, clamped per texture to its levels.  ``base_color``
    [R, 3] where ``texture_id`` < 0."""
    tid = torch.clamp_min(texture_id, 0)
    wh = atlas.sizes[tid.long()].to(torch.float32)
    max_l = torch.floor(torch.log2(torch.clamp_min(
        torch.minimum(wh[..., 0], wh[..., 1]), 1.0)))
    lod = torch.clamp(lod, torch.zeros_like(max_l), max_l)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.minimum(l0 + 1, max_l.to(torch.int32))
    frac = (lod - l0.to(torch.float32))[..., None]
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    c0 = _bilinear_level(atlas, tid, u, v, l0)
    c1 = _bilinear_level(atlas, tid, u, v, l1)
    color = c0 * (1 - frac) + c1 * frac
    return torch.where((texture_id >= 0)[..., None], color, base_color)


def fetch_base_color(atlas: TextureAtlas, texture_id: torch.Tensor,
                     uv: torch.Tensor, base_color: torch.Tensor
                     ) -> torch.Tensor:
    """``base_color`` [R, 3] with a bilinear fetch at ``uv`` [R, 2]
    (repeat wrap) where ``texture_id`` [R] >= 0."""
    tid = torch.clamp_min(texture_id, 0)
    u = uv[..., 0] - torch.floor(uv[..., 0])  # repeat wrap
    v = uv[..., 1] - torch.floor(uv[..., 1])
    color = _bilinear_level(atlas, tid, u, v, torch.zeros_like(tid))
    return torch.where((texture_id >= 0)[..., None], color, base_color)
