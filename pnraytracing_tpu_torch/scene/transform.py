"""4x4 affine transform helpers (the glm subset the reference's scene code
uses: translate/rotate/scale compositions, main.cpp:198-347)."""

from __future__ import annotations

import numpy as np


def translate(x, y, z) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def scale(x, y=None, z=None) -> np.ndarray:
    if y is None:
        y = z = x
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def rotate(angle_deg: float, axis) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = np.cos(a), np.sin(a)
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )
    m = np.eye(4)
    m[:3, :3] = r
    return m


def compose(*ms: np.ndarray) -> np.ndarray:
    """compose(A, B, C) = A @ B @ C (apply C first)."""
    out = np.eye(4)
    for m in ms:
        out = out @ m
    return out
