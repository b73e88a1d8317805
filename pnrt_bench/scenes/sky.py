"""The procedural HDR sky (a frozen copy of the port's
``io/hdr.py::procedural_sky``): a gradient with a sun disc and glow,
[height, width, 3] float32, row 0 the top (+y)."""

from __future__ import annotations

import numpy as np


def procedural_sky(height: int = 256, width: int = 512,
                   sun_dir=(0.4, 0.6, 0.3), sun_intensity: float = 50.0,
                   sky_tint=(0.35, 0.5, 0.85), horizon=(0.9, 0.75, 0.6),
                   ground=(0.18, 0.14, 0.12)) -> np.ndarray:
    sun = np.asarray(sun_dir, np.float64)
    sun /= np.linalg.norm(sun)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    phi = 2 * np.pi * (uu - 0.5)
    theta = np.pi * (0.5 - vv)
    d = np.stack([np.cos(theta) * np.cos(phi), np.sin(theta),
                  np.cos(theta) * np.sin(phi)], axis=-1)
    up = np.clip(d[..., 1], -1, 1)
    sky = np.asarray(sky_tint) * (0.35 + 0.65 * np.clip(up, 0, 1))[..., None]
    hor = np.asarray(horizon) * np.exp(-np.abs(up) * 4.0)[..., None]
    gnd = np.asarray(ground) * np.clip(-up, 0, 1)[..., None]
    cos_sun = np.clip(np.einsum("...i,i->...", d, sun), -1, 1)
    disc = sun_intensity * np.exp((cos_sun - 1.0) * 2500.0)
    glow = 0.4 * np.exp((cos_sun - 1.0) * 12.0)
    img = sky + hor + gnd + (disc + glow)[..., None] * np.array(
        [1.0, 0.9, 0.75])
    return img.astype(np.float32)
