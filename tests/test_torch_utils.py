"""The port's ``utils/`` (``image.py``, ``profiling.py``, ``cache.py``) on
the CPU against the JAX package's ``utils/``.

* ``tonemap`` and ``mse`` equal the JAX functions' (numpy and tensors);
* the port's PNG (written with zlib + struct, no image library), decoded
  by the JAX package's own reader (``pnraytracing_tpu/io/png.py``),
  holds the pixels of the JAX ``save_png``'s file;
* ``wallclock`` and ``host_cpu_tag`` behave as the JAX package's;
  ``trace`` writes a Chrome trace, the program's spans in it (the
  recorder itself: tests/test_torch_profiling.py);
* ``enable_compile_cache`` moves the kernels' build directory.
"""

import json
import os

import numpy as np
import pytest
import torch

from pnraytracing_tpu.io.png import read_png_rgb
from pnraytracing_tpu.utils import cache as jax_cache
from pnraytracing_tpu.utils import image as jax_image
from pnraytracing_tpu.utils import profiling as jax_profiling
from pnraytracing_tpu_torch import cuda_build
from pnraytracing_tpu_torch.utils import cache, image, profiling


def _image(seed=0, shape=(9, 13, 3)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 2.0, size=shape).astype(np.float32)


@pytest.mark.parametrize("gamma,exposure", [(2.2, 1.0), (1.0, 0.7),
                                            (0.0, 2.0)])
def test_tonemap_matches_jax(gamma, exposure):
    img = _image()
    want = jax_image.tonemap(img, gamma=gamma, exposure=exposure)
    for x in (img, torch.from_numpy(img)):
        got = image.tonemap(x, gamma=gamma, exposure=exposure)
        np.testing.assert_array_equal(got, want)


def test_mse_matches_jax():
    a, b = _image(1), _image(2)
    assert image.mse(a, b) == jax_image.mse(a, b)
    assert image.mse(torch.from_numpy(a), b) == jax_image.mse(a, b)


@pytest.mark.parametrize("shape", [(9, 13, 3), (1, 1, 3), (64, 40, 3)])
def test_png_matches_jax(tmp_path, shape):
    img = _image(3, shape)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    image.save_png(ours, torch.from_numpy(img))
    jax_image.save_png(theirs, img)
    np.testing.assert_array_equal(read_png_rgb(ours), read_png_rgb(theirs))
    assert read_png_rgb(ours).shape == shape


def test_save_png_refuses_other_channel_counts(tmp_path):
    with pytest.raises(ValueError, match="H, W, 3"):
        image.save_png(str(tmp_path / "x.png"), _image(0, (4, 4, 4)))


def test_step_timer_and_wallclock_match_jax():
    """``wallclock`` prints the JAX package's line (the port has no
    ``StepTimer``: a mean of chunks that nothing read)."""
    lines = {}
    for name, mod in (("port", profiling), ("jax", jax_profiling)):
        with mod.wallclock("build", sink=lambda s, n=name: lines.setdefault(
                n, s)):
            pass
    for s in lines.values():
        assert s.startswith("build: ") and s.endswith(" ms")


def test_host_cpu_tag_matches_jax():
    assert cache.host_cpu_tag() == jax_cache.host_cpu_tag()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        with profiling.span("frame.test"):
            torch.ones(8).add_(1.0)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)
    assert any(e.get("name") == "pnrt.frame.test" for e in events)


def test_enable_compile_cache_moves_the_build_dir(tmp_path):
    try:
        cache.enable_compile_cache(str(tmp_path / "kernels"))
        assert cuda_build.BUILD_DIR == str(tmp_path / "kernels")
        assert os.path.dirname(cuda_build._lib_path("traverse")) == str(
            tmp_path / "kernels")
    finally:
        cache.enable_compile_cache()
    assert cuda_build.BUILD_DIR == cuda_build.DEFAULT_BUILD_DIR

