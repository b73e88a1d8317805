"""Tests of the benchmark harness (run from the repo root:
``python -m pytest pnrt_bench/tests -q``).  They import no JAX: the
repo's ``tests/conftest.py`` is not on this path."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
