"""How ``correct`` is decided: the numbers a cell's check compares, each
against its limit from ``limits/<cell>.json``.

An image the program delivered is held against the reference at a
sample of its pixels drawn from the seed: a pixel *mismatches* when any
channel differs by more than ``pixel_tol`` (the radiance is clamped to
[0, 1] per sample, so the tolerance is absolute).  Rounding moves a
pixel by ~1e-5; a path that takes another turn (a ray that grazes an
edge, a shadow ray from a point moved by an ulp) moves it by a sample's
share of its radiance, and those are what the mismatch share counts.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def sample_pixels(seed: int, width: int, height: int, n: int) -> np.ndarray:
    """``n`` distinct flat row-major pixel indices drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    return np.sort(rng.choice(width * height, size=min(n, width * height),
                              replace=False))


def mismatch_share(got: np.ndarray, want: np.ndarray, tol: float) -> float:
    """Share of pixels ([P, 3]) where a channel differs by more than
    ``tol`` (a non-finite value always mismatches)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bad = ~(diff <= tol).all(axis=-1)
    return float(bad.mean())


class Checks:
    """The numbers compared in one run: name -> (value, limit); a number
    passes when it is finite and at most its limit."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values: dict = {}

    def add(self, name: str, value: float) -> None:
        self.values[name] = float(value)

    def passed(self, name: str) -> bool:
        v = self.values[name]
        return bool(np.isfinite(v)) and v <= self.limits[name]

    @property
    def ok(self) -> bool:
        return bool(self.values) and all(self.passed(k) for k in self.values)

    def table(self) -> dict:
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in self.values.items()}
