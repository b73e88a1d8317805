"""Scalar constants and elementwise math shared by the shading code.

PyTorch counterpart of ``pnraytracing_tpu/core/math.py``: the same
constants and the same op order, on float32 tensors.  Python float
operands are rounded to float32 by torch exactly as JAX rounds its weak
scalars, so the polynomial approximations below give the same bits.
"""

from __future__ import annotations

import torch

PI = 3.14159265358979323846
INV_PI = 0.31830988618379067154
TWO_PI = 2.0 * PI
FLOAT_MAX = 1.0e7  # the shader's FLOAT_MAX (ray_tracing.comp:5)
SHADOW_EPS = 1.0e-4  # ShadowEpsilon (ray_tracing.comp:9)


def safe_sqrt(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sqrt(max(x, eps)): finite everywhere, like the JAX twin."""
    return torch.sqrt(torch.clamp_min(x, eps))


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
    ax = torch.abs(x)
    ay = torch.abs(y)
    big = torch.maximum(ax, ay)
    t = torch.minimum(ax, ay) / torch.clamp_min(big, 1e-30)
    r = fast_atan(t)
    r = torch.where(ay > ax, 0.5 * PI - r, r)
    r = torch.where(x < 0, PI - r, r)
    return torch.where(y < 0, -r, r)


def fast_asin(v: torch.Tensor) -> torch.Tensor:
    """asin via atan2(v, sqrt(1 - v^2)); input clipped to [-1, 1]."""
    v = torch.clamp(v, -1.0, 1.0)
    return fast_atan2(v, torch.sqrt(torch.clamp_min(1.0 - v * v, 0.0)))
