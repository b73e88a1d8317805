"""Scalar constants and elementwise math shared by the shading code.

PyTorch counterpart of ``pnraytracing_tpu/core/math.py``: the same
constants and the same op order, on float32 tensors, and the JAX
module's array forms over ``[..., 3]`` tensors (``dot``, ``cross``,
``normalize``, ``build_tangent_space``, ...).  Python float
operands are rounded to float32 by torch exactly as JAX rounds its weak
scalars, so the polynomial approximations below give the same bits.

Kinks differentiate as in JAX: :func:`maximum`, :func:`minimum`,
:func:`clip` and :func:`absolute` stand for ``jnp.maximum`` /
``jnp.minimum`` / ``jnp.clip`` / ``jnp.abs`` against a constant.  Their
values are those of ``torch.clamp*`` / ``torch.abs``, bit for bit; where
the operand carries a gradient they give JAX's derivative at the kink:
half at a tie of ``maximum`` / ``minimum`` / ``clip`` (``torch.clamp``
passes all of it) and +1 at 0 for ``absolute`` (``torch.abs`` gives 0).
A material parameter at its default of exactly 0 (or a roughness of 1)
sits on such a kink.  Without a gradient they run the ``torch.clamp*``
call itself, so the live frame launches what it did.
"""

from __future__ import annotations

import torch

PI = 3.14159265358979323846
INV_PI = 0.31830988618379067154
TWO_PI = 2.0 * PI
FLOAT_MAX = 1.0e7  # the shader's FLOAT_MAX (ray_tracing.comp:5)
SHADOW_EPS = 1.0e-4  # ShadowEpsilon (ray_tracing.comp:9)


def _grad(x) -> bool:
    return isinstance(x, torch.Tensor) and x.requires_grad


def maximum(x, c: float):
    """``jnp.maximum(x, c)``: ``torch.clamp_min``'s values, half the
    gradient at a tie."""
    return torch.maximum(x, x.new_full((), c)) if _grad(x) else \
        torch.clamp_min(x, c)


def minimum(x, c: float):
    """``jnp.minimum(x, c)``: ``torch.clamp_max``'s values, half the
    gradient at a tie."""
    return torch.minimum(x, x.new_full((), c)) if _grad(x) else \
        torch.clamp_max(x, c)


def clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)`` (``minimum(maximum(x, lo), hi)``):
    ``torch.clamp``'s values, half the gradient at either bound."""
    if _grad(x):
        return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                             x.new_full((), hi))
    return torch.clamp(x, lo, hi)


class _Absolute(torch.autograd.Function):
    """|x| with JAX's derivative: +1 where x >= 0 (so at 0), else -1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def absolute(x):
    """``jnp.abs(x)``: ``torch.abs``'s values, derivative +1 at 0."""
    return _Absolute.apply(x) if _grad(x) else torch.abs(x)


def safe_sqrt(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt(max(x, eps)): finite everywhere, like the JAX twin."""
    return torch.sqrt(maximum(x, eps))


def sqr(x):
    return x * x


def mix(a, b, t):
    """GLSL mix(): a + (b - a) * t."""
    return a + (b - a) * t


def fast_atan(t: torch.Tensor) -> torch.Tensor:
    """Minimax odd polynomial atan on [-1, 1] (max error ~2e-6 rad)."""
    s = t * t
    p = torch.full_like(s, -0.0117212)
    p = p * s + 0.05265332
    p = p * s + -0.11643287
    p = p * s + 0.19354346
    p = p * s + -0.33262347
    p = p * s + 0.99997726
    return t * p


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2 with jnp.arctan2's quadrant semantics."""
    ax = absolute(x)
    ay = absolute(y)
    big = torch.maximum(ax, ay)
    t = torch.minimum(ax, ay) / maximum(big, 1e-30)
    r = fast_atan(t)
    r = torch.where(ay > ax, 0.5 * PI - r, r)
    r = torch.where(x < 0, PI - r, r)
    return torch.where(y < 0, -r, r)


def fast_asin(v: torch.Tensor) -> torch.Tensor:
    """asin via atan2(v, sqrt(1 - v^2)); input clipped to [-1, 1]."""
    v = clip(v, -1.0, 1.0)
    return fast_atan2(v, torch.sqrt(maximum(1.0 - v * v, 0.0)))


# ---- array forms over [..., 3] tensors --------------------------------------
# The JAX package's trailing-axis-3 functions; the shading path uses the
# component forms of core/vec.py, which keep the same op order.

def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, keepdims dropped."""
    return torch.sum(a * b, dim=-1)


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, keepdims kept."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the trailing axis, component by component (the order
    of core/vec.py::vcross)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    return safe_sqrt(dot(a, a))


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """a / |a| with a tiny clamp against 0/0 (rsqrt, as the JAX twin)."""
    return a * torch.rsqrt(maximum(vdot(a, a), eps))


def reflect(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Mirror v about h: ``2 (v.h) h - v`` (ray_tracing.comp:694)."""
    return 2.0 * vdot(v, h) * h - v


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Disney-BRDF luminance weights 0.3/0.6/0.1 (ray_tracing.comp:799)."""
    return 0.3 * rgb[..., 0] + 0.6 * rgb[..., 1] + 0.1 * rgb[..., 2]


def hdr_luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Env-CDF luminance weights 0.2/0.7/0.1 (shader.hpp:153)."""
    return 0.2 * rgb[..., 0] + 0.7 * rgb[..., 1] + 0.1 * rgb[..., 2]


def build_tangent_space(n: torch.Tensor):
    """Shading frame (t, b) of normals ``n`` [..., 3] (BuildTangentSpace,
    ray_tracing.comp:629-634): t = n x +z (or +x when n is (anti)parallel
    to +z), b = n x t."""
    up = n.new_tensor((0.0, 0.0, 1.0)).expand(n.shape)
    x = n.new_tensor((1.0, 0.0, 0.0)).expand(n.shape)
    near_z = torch.abs(n[..., 2:3]) > 0.9999995
    t = torch.where(near_z, x, normalize(cross(n, up)))
    return t, cross(n, t)


def tangent_to_world(t: torch.Tensor, b: torch.Tensor, n: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Local (x, y, z) -> world via frame columns
    (ray_tracing.comp:637-639)."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def spherical_uv(v: torch.Tensor) -> torch.Tensor:
    """Direction [..., 3] -> equirect uv [..., 2] (toSphericalCoord,
    ray_tracing.comp:181-188): u = atan2(z, x)/2pi + .5, v = 1 - (asin(y)
    /pi + .5), by the polynomial atan2 / asin above."""
    u = fast_atan2(v[..., 2], v[..., 0]) * (0.5 * INV_PI) + 0.5
    w = fast_asin(v[..., 1]) * INV_PI + 0.5
    return torch.stack([u, 1.0 - w], dim=-1)


def mon2lin(x: torch.Tensor) -> torch.Tensor:
    """sRGB-ish decode pow(x, 2.2) (ray_tracing.comp:682-684)."""
    return torch.pow(maximum(x, 0.0), 2.2)
