"""Pinhole camera: construction and batched primary-ray generation.

PyTorch counterpart of ``pnraytracing_tpu/core/camera.py``
(camera.hpp:11-31; CameraGetRay, ray_tracing.comp:205-211).
"""

from __future__ import annotations

import dataclasses
import math as pymath

import numpy as np
import torch

from pnraytracing_tpu_torch.core.math import FLOAT_MAX
from pnraytracing_tpu_torch.core.types import Camera


def resolve_device(device) -> torch.device:
    """The port's device rule: ``None`` means the card; the CPU runs only
    when a caller asks for it."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass
class CameraState:
    """Host-side camera rig (eye/center/up/fov, camera.hpp:64-76) and its
    interaction ops (camera.hpp:33-62), in the JAX package's float64 host
    arithmetic."""

    eye: np.ndarray
    center: np.ndarray
    up: np.ndarray
    fov_deg: float
    aspect: float

    def basis(self, device=None) -> Camera:
        return make_camera(self.eye, self.center, self.up, self.fov_deg,
                           self.aspect, device=device)

    def orbit(self, phi_deg: float, theta_deg: float) -> None:
        """Orbit eye around center (camera.hpp:33-44)."""
        w, u, v = _wuv(self.eye, self.center, self.up)
        phi = pymath.radians(phi_deg * 0.6)
        theta = pymath.radians(theta_deg * 0.6)
        nv = (w * pymath.cos(phi) * pymath.cos(theta)
              + u * pymath.sin(phi) * pymath.cos(theta)
              + v * pymath.sin(theta))
        if abs(float(np.dot(self.up, nv))) > 0.9995:
            return
        dist = float(np.linalg.norm(self.eye - self.center))
        self.eye = self.center + nv * dist

    def pan(self, dx: float, dy: float) -> None:
        """Translate eye and center in the view plane (camera.hpp:46-54)."""
        _, u, v = _wuv(self.eye, self.center, self.up)
        delta = 0.05 * (dx * u + dy * v)
        self.eye = self.eye + delta
        self.center = self.center + delta

    def zoom_fov(self, delta_deg: float) -> None:
        """Fov zoom with the reference's (1, 89) degree clamp
        (camera.hpp:56-62)."""
        nfov = self.fov_deg + delta_deg
        if 1.0 < nfov < 89.0:
            self.fov_deg = nfov


def _wuv(eye, center, up):
    w = np.asarray(eye, np.float64) - np.asarray(center, np.float64)
    w = w / np.linalg.norm(w)
    u = np.cross(np.asarray(up, np.float64), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    return w, u, v


def _normalize_rows(a: torch.Tensor) -> torch.Tensor:
    x, y, z = a[..., 0:1], a[..., 1:2], a[..., 2:3]
    return a * torch.rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20))


def make_camera(eye, center, up, fov_deg: float, aspect: float,
                device=None) -> Camera:
    """Ray-gen basis (camera.hpp:11-31): screen plane at distance 1 along
    -w, half-extent tan(fov/2) * (aspect, 1)."""
    dev = resolve_device(device)
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
    eye, center, up = f32(eye), f32(center), f32(up)
    half_h = torch.tan(torch.deg2rad(f32(fov_deg)) * 0.5)
    half_w = f32(aspect) * half_h
    w = _normalize_rows(eye - center)
    u = _normalize_rows(torch.linalg.cross(up, w))
    v = torch.linalg.cross(w, u)
    lower_left = eye - half_w * u - half_h * v - w
    return Camera(eye=eye, lower_left=lower_left,
                  horizontal=2.0 * half_w * u, vertical=2.0 * half_h * v)


def camera_rays(camera: Camera, width: int, height: int,
                jitter: torch.Tensor | None = None):
    """One primary ray per pixel through the pixel corner
    (s, t) = (x/W, y/H), y = 0 at the bottom row (comp:980).  Returns
    (origins [P,3], dirs [P,3], t_max [P]); pixel order is row-major from
    the top row, so reshape(H, W, 3) is a top-down image.  ``jitter``:
    optional [P, 2] sub-pixel offsets in [0, 1), added to (x, y) before
    the division (``RenderConfig.jitter_primary``)."""
    dev = camera.eye.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    gy = float(height - 1) - gy
    px = gx.reshape(-1)
    py = gy.reshape(-1)
    if jitter is not None:
        px = px + jitter[:, 0]
        py = py + jitter[:, 1]
    s = px / float(width)
    t = py / float(height)
    d = (camera.lower_left[None, :] + s[:, None] * camera.horizontal[None, :]
         + t[:, None] * camera.vertical[None, :] - camera.eye[None, :])
    d = _normalize_rows(d)
    o = camera.eye[None, :].expand(d.shape)
    t_max = torch.full((d.shape[0],), FLOAT_MAX, dtype=torch.float32,
                       device=dev)
    return o, d, t_max
