"""Struct-of-component vectors: the per-ray layout of the shading code.

PyTorch counterpart of ``pnraytracing_tpu/core/vec.py``.  A ``V3`` holds
three flat ``[R]`` tensors (or Python scalars, which broadcast), which is
also the layout the traversal kernels read and write, so shading and
traversal hand rays over without packing an ``[R, 3]`` array.  The helpers
keep the JAX package's op order (dot = x*x + y*y + z*z, left to right).
"""

from __future__ import annotations

import torch

from pnraytracing_tpu_torch.core.math import (
    INV_PI,
    fast_asin,
    fast_atan2,
    maximum,
    safe_sqrt,
)


class V3:
    """A 3-vector field over a ray batch: three component tensors."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x = x
        self.y = y
        self.z = z

    @classmethod
    def of(cls, a: torch.Tensor) -> "V3":
        """From a trailing-axis-3 tensor [..., 3]."""
        return cls(a[..., 0], a[..., 1], a[..., 2])

    def rows(self) -> torch.Tensor:
        """To a trailing-axis-3 tensor [..., 3]."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def max_component(self) -> torch.Tensor:
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    def map(self, fn) -> "V3":
        return V3(fn(self.x), fn(self.y), fn(self.z))


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def vlength(a: V3):
    return safe_sqrt(vdot(a, a))


def select_small(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[M] table fetch by ids ``idx`` through an M-way compare-select
    chain (no gather; M is a handful)."""
    out = table[0].expand(idx.shape)
    for k in range(1, int(table.shape[0])):
        out = torch.where(idx == k, table[k], out)
    return out


def vnormalize(a: V3, eps: float = 1e-20) -> V3:
    return a * torch.rsqrt(maximum(vdot(a, a), eps))


def vwhere(m: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
              torch.where(m, a.z, b.z))


def vcat(a: V3, b: V3) -> V3:
    return V3(torch.cat([a.x, b.x]), torch.cat([a.y, b.y]),
              torch.cat([a.z, b.z]))


def vreflect(v: V3, h: V3) -> V3:
    """2 (v.h) h - v (ray_tracing.comp:694)."""
    return h * (2.0 * vdot(v, h)) - v


def vmix(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


def vluminance(rgb: V3):
    """Disney luminance weights 0.3/0.6/0.1 (ray_tracing.comp:799)."""
    return 0.3 * rgb.x + 0.6 * rgb.y + 0.1 * rgb.z


def build_tangent_space_v(n: V3) -> tuple[V3, V3]:
    """BuildTangentSpace (ray_tracing.comp:629-634): t = n x +z, or +x
    when n is (anti)parallel to +z; b = n x t."""
    near_z = torch.abs(n.z) > 0.9999995
    t_general = vnormalize(vcross(n, V3(0.0, 0.0, 1.0)))
    one = torch.ones_like(n.x)
    zero = torch.zeros_like(n.x)
    t = vwhere(near_z, V3(one, zero, zero), t_general)
    b = vcross(n, t)
    return t, b


def tangent_to_world_v(t: V3, b: V3, n: V3, v: V3) -> V3:
    """Local (x,y,z) -> world via frame columns (ray_tracing.comp:637-639)."""
    return t * v.x + b * v.y + n * v.z


def spherical_uv_v(v: V3):
    """Direction -> equirect (u, v) (toSphericalCoord, comp:181-188)."""
    u = fast_atan2(v.z, v.x) * (0.5 * INV_PI) + 0.5
    w = fast_asin(v.y) * INV_PI + 0.5
    return u, 1.0 - w
