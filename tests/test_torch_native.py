"""The port's native C++ library (``utils/nativelib.py``: the repo's
``csrc/*.cpp`` built with g++ into the port's build directory), its
bindings (``io/native.py``, ``accel/native.py``), the ``io`` dispatchers
and ``config4_marry``'s asset branches, on the CPU.  Mirrors the JAX
package's tests/test_native_io.py; every input is written in
``tmp_path``.

* native IO against the port's pure-Python paths and against the JAX
  package's native functions on the same files: HDR (flat and RLE),
  PNG, OBJ, equal arrays (the PNG decoded by ``io/png.py``);
* the native SAH builder: the same tree as the JAX package's native
  builder, and the numpy builders of both packages the same tree; the
  native and numpy trees equal on the teapot, while on icospheres they
  split ties otherwise (both valid trees, ``chip_smoke.check_bvh``);
  ``SceneBuilder.build(use_native_builder=...)`` with the JAX semantics;
* the dispatchers choose by whether g++ exists: with ``PATH`` emptied
  the pure-Python path runs; a compile error in the native build raises
  with the compiler's output, where the JAX loader falls back silently;
* ``config4_marry(marry_dir=...)``: the OBJ branch and the MTL-only
  branch (assets written by ``chip_smoke.write_marry``) against the JAX
  function's branches, reached by pointing its hardcoded directory at
  ``tmp_path`` (the JAX package is not edited): scene arrays equal, and a
  16x16 frame within the textured tests' tolerance
  (tests/test_torch_texture.py: at most 2 pixels outside atol 3e-5)
  outside the pixels where the same scenes without their textures
  already differ beyond it (the control: the two packages' shading
  roundings, FMA contraction and libm, grown through the lamp and the
  glossy sphere; at most 2% of the pixels).  Depth 2 for the MTL branch
  (no such pixel); depth 1 for the OBJ branch, as
  tests/test_torch_texture.py holds config 4, with 3 such pixels (up to
  8.3e-5, the same with or without textures), 6 at depth 2.
"""

import dataclasses
import functools
import os
import shutil
import types
from unittest import mock

import numpy as np
import pytest

from chip_smoke import check_bvh, write_marry
from pnraytracing_tpu.accel.bvh import build_bvh as jax_build_bvh
from pnraytracing_tpu.accel.native import build_bvh_native as jax_native_bvh
from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.io import native as jax_nio
from pnraytracing_tpu.render.renderer import render_frame as jax_render_frame
from pnraytracing_tpu.scene import scenes as jax_scenes
from pnraytracing_tpu_torch import cuda_build
from pnraytracing_tpu_torch import io as pio
from pnraytracing_tpu_torch.accel import native as anative
from pnraytracing_tpu_torch.accel.bvh import build_bvh
from pnraytracing_tpu_torch.convert import scene_to_arrays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.io import hdr as py_hdr
from pnraytracing_tpu_torch.io import native as nio
from pnraytracing_tpu_torch.io import obj as py_obj
from pnraytracing_tpu_torch.io.png import read_png_rgb
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.scene import scenes, shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.utils import nativelib
from pnraytracing_tpu_torch.utils.image import tonemap
from tests.test_native_io import _write_demo
from tests.test_torch_render import assert_frame_close
from tests.test_torch_scene import (  # noqa: F401
    _assert_leaves_equal,
    _torch_threads,
    port_camera,
)

if nativelib.compiler() is None:  # the JAX tests' rule: g++ is in the image
    pytest.skip("no g++ on this machine", allow_module_level=True)

BVH_FIELDS = ("node_min", "node_max", "axis", "right_child", "start", "end",
              "order")


@pytest.fixture()
def rng():
    return np.random.default_rng(7)


# ---- the library ------------------------------------------------------------

def test_library_builds_into_the_port_build_dir():
    """Built once from the repo's csrc/*.cpp (the JAX loader's list) into
    ``cuda_build.BUILD_DIR``, named by the sources' hash: never the JAX
    package's build/libpnrt_native.so."""
    lib = nativelib.get_lib()
    srcs = nativelib.sources()
    assert [os.path.basename(s) for s in srcs] == [
        "bvh_builder.cpp", "image_io.cpp", "obj_loader.cpp"]
    path = nativelib.lib_path(srcs)
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith("pnrt_native-")
    assert lib._name == path and os.path.exists(path)
    assert nativelib.get_lib() is lib
    assert nio.native_io_available() and anative.native_available()


# ---- HDR / PNG / OBJ against the Python paths and the JAX natives -------------

def test_hdr_native_reads_python_written(tmp_path, rng):
    img = (rng.random((37, 64, 3)) * 10.0).astype(np.float32)
    img[5, 5] = 0.0  # the zero-exponent case
    p = str(tmp_path / "flat.hdr")
    py_hdr.write_hdr(p, img)
    out = nio.read_hdr_native(p)
    np.testing.assert_array_equal(out, py_hdr.read_hdr(p))
    np.testing.assert_array_equal(out, jax_nio.read_hdr_native(p))


@pytest.mark.parametrize("rle", [False, True])
def test_hdr_native_written_reads_back(tmp_path, rng, rle):
    img = np.zeros((24, 128, 3), np.float32)
    img[:, :64] = 3.25  # long runs for the RLE path
    img[:, 64:] = (rng.random((24, 64, 3)) * 5.0).astype(np.float32)
    p, pj = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    nio.write_hdr_native(p, img, rle=rle)
    jax_nio.write_hdr_native(pj, img, rle=rle)
    with open(p, "rb") as f, open(pj, "rb") as g:
        assert f.read() == g.read()
    out = nio.read_hdr_native(p)
    np.testing.assert_array_equal(out, py_hdr.read_hdr(p))
    bound = img.max(axis=-1, keepdims=True) / 128.0 + 1e-6
    assert np.all(np.abs(out - img) <= bound)


def test_png_native_is_pixel_exact(tmp_path, rng):
    img = rng.random((21, 45, 3)).astype(np.float32)
    p, pj = str(tmp_path / "n.png"), str(tmp_path / "j.png")
    nio.save_png_native(p, img, gamma=2.2)
    jax_nio.save_png_native(pj, img, gamma=2.2)
    with open(p, "rb") as f, open(pj, "rb") as g:
        assert f.read() == g.read()
    want = (tonemap(img, gamma=2.2) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(read_png_rgb(p), want / np.float32(255.0))


@pytest.mark.parametrize("flip_v", [True, False])
def test_obj_native_equals_python_and_jax(tmp_path, flip_v):
    from tests.test_torch_io import assert_same

    path = _write_demo(tmp_path)
    nat = nio.load_obj_native(path, flip_v=flip_v)
    assert_same(nat, jax_nio.load_obj_native(path, flip_v=flip_v))
    py = py_obj.load_obj(path, flip_v=flip_v)
    assert len(py) == len(nat) == 2
    for (pm, pd, pt, pn), (nm, nd, nt, nn) in zip(py, nat):
        assert pn == nn and pt is None and nt is None
        assert set(pd) == set(nd)
        for k, v in pd.items():  # float32 storage in the native path
            np.testing.assert_allclose(nd[k], v, rtol=1e-6)
        for k in ("positions", "normals", "uvs", "indices"):
            np.testing.assert_array_equal(pm[k], nm[k], err_msg=k)


# ---- the BVH builders ----------------------------------------------------

def _geometry(name):
    if name == "config5_small":
        s, _ = scenes.config5_large(3, device="cpu")
        return s.mesh.positions.numpy(), s.mesh.indices.numpy()
    m = getattr(shapes, name.split(":")[0])(
        *map(int, name.split(":")[1:]))
    return (np.asarray(m["positions"], np.float32),
            np.asarray(m["indices"], np.int32))


def _same_tree(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in BVH_FIELDS)


@pytest.mark.parametrize("name", ["teapot", "icosphere:3", "config5_small"])
def test_native_bvh_equals_jax(name):
    """The port's native tree is the JAX package's native tree, and the
    two numpy builders agree; native and numpy agree on the teapot, and
    where they split ties otherwise (icospheres) both are valid trees."""
    pos, idx = _geometry(name)
    nat = anative.build_bvh_native(pos, idx)
    assert _same_tree(nat, jax_native_bvh(pos, idx))
    num = build_bvh(pos, idx)
    assert _same_tree(num, jax_build_bvh(pos, idx))
    if name == "teapot":
        assert _same_tree(nat, num)
    for tree in (nat, num):
        check_bvh(name, tree, pos, idx)


def test_use_native_builder_semantics(monkeypatch, tmp_path):
    """None takes the native builder where g++ exists, True requires it,
    False takes numpy: the JAX package's ``SceneBuilder.build``."""
    def built(flag):
        b = SceneBuilder()
        b.add(shapes.icosphere(3), {}, name="ball")
        return b.build(env_constant=(0.1, 0.1, 0.1), device="cpu",
                       use_native_builder=flag)

    pos, idx = _geometry("icosphere:3")
    nat, num = anative.build_bvh_native(pos, idx), build_bvh(pos, idx)
    assert not _same_tree(nat, num)
    for flag, want in ((None, nat), (True, nat), (False, num)):
        assert np.array_equal(built(flag).bvh.axis.numpy(), want.axis)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    assert anative.bvh_builder(None) is build_bvh
    assert np.array_equal(built(None).bvh.axis.numpy(), num.axis)
    with pytest.raises(RuntimeError, match="unavailable"):
        built(True)


# ---- the dispatchers ------------------------------------------------------

def test_dispatchers_take_python_without_gxx(monkeypatch, tmp_path, rng):
    """``PATH`` without g++: every dispatcher runs the pure-Python path
    (the native functions are never called), as the JAX package does."""
    monkeypatch.setenv("PATH", str(tmp_path))
    assert nativelib.get_lib() is None and not nio.native_io_available()
    for fn in ("read_hdr_native", "write_hdr_native", "save_png_native",
               "load_obj_native"):
        monkeypatch.setattr(nio, fn, mock.Mock(side_effect=AssertionError))
    img = (rng.random((8, 16, 3)) * 4).astype(np.float32)
    p = str(tmp_path / "w.hdr")
    pio.write_hdr(p, img)
    np.testing.assert_array_equal(pio.read_hdr(p), py_hdr.read_hdr(p))
    path = _write_demo(tmp_path)
    from tests.test_torch_io import assert_same

    assert_same(pio.load_obj(path), py_obj.load_obj(path))
    pio.save_png(str(tmp_path / "w.png"), img)
    assert read_png_rgb(str(tmp_path / "w.png")).shape == (8, 16, 3)


def test_dispatchers_take_native_with_gxx(tmp_path, rng):
    """With g++ the dispatchers run the native functions."""
    img = (rng.random((8, 16, 3)) * 4).astype(np.float32)
    p = str(tmp_path / "w.hdr")
    with mock.patch.object(nio, "write_hdr_native",
                           wraps=nio.write_hdr_native) as w, \
            mock.patch.object(nio, "read_hdr_native",
                              wraps=nio.read_hdr_native) as r:
        pio.write_hdr(p, img)
        out = pio.read_hdr(p)
    assert w.called and r.called
    np.testing.assert_array_equal(out, py_hdr.read_hdr(p))


def test_broken_native_build_raises(monkeypatch, tmp_path):
    """A compile error in the native sources raises with g++'s message
    from ``get_lib`` and from every dispatcher; it never falls back."""
    src = tmp_path / "csrc"
    src.mkdir()
    for s in nativelib.sources():
        shutil.copy(s, src)
    with open(src / "image_io.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(nativelib, "CSRC_DIR", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        nativelib.get_lib()
    assert "image_io.cpp" in str(err.value) and "error" in str(err.value)
    path = _write_demo(tmp_path)
    for call in (lambda: pio.load_obj(path),
                 lambda: pio.read_hdr(str(tmp_path / "x.hdr")),
                 lambda: SceneBuilder().add(shapes.quad(), {}).build(
                     device="cpu")):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()
    assert not os.listdir(tmp_path / "build")  # no library was left


# ---- config4_marry's asset branches ----------------------------------------------

def _jax_config4(marry_dir):
    """The JAX package's ``config4_marry()`` with its hardcoded asset
    directory read as ``marry_dir``: its module's ``os.path.join`` (for
    the two asset names) and ``os.path.exists`` are patched, not the
    package."""
    def join(a, *rest):
        assets = rest in (("marry.obj",), ("Marry.mtl",))
        return os.path.join(marry_dir if assets else a, *rest)

    fake = types.SimpleNamespace(path=types.SimpleNamespace(
        join=join, exists=os.path.exists))
    with mock.patch.object(jax_scenes, "os", fake):
        return jax_scenes.config4_marry()


@functools.lru_cache(maxsize=None)
def _marry_pair(branch, root):
    d = os.path.join(root, branch)
    os.makedirs(d, exist_ok=True)
    write_marry(d)
    if branch == "mtl":
        os.remove(os.path.join(d, "marry.obj"))
    return _jax_config4(d), scenes.config4_marry(device="cpu", marry_dir=d)


@pytest.fixture(scope="module")
def marry_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("marry"))


@pytest.mark.parametrize("branch", ["obj", "mtl"])
def test_config4_asset_branch_equals_jax(marry_root, branch):
    (js, jcam), (ps, pcam) = _marry_pair(branch, marry_root)
    _assert_leaves_equal(scene_to_arrays(js), scene_to_arrays(ps))
    assert ps.textures.count == 2  # the map_Kd PNG and the floor's
    assert int((ps.mesh.texture_id == 0).sum()) > 0
    # the stand-in branch is the scene of old, without the directory
    if branch == "obj":
        a, _ = scenes.config4_marry(device="cpu",
                                    marry_dir=os.path.join(marry_root, "x"))
        b, _ = jax_scenes.config4_marry()
        _assert_leaves_equal(scene_to_arrays(b), scene_to_arrays(a))


@pytest.mark.parametrize("branch", ["obj", "mtl"])
def test_config4_asset_frame_matches_jax(marry_root, branch):
    (js, jcam), (ps, _) = _marry_pair(branch, marry_root)
    size = dict(width=16, height=16, max_depth=2 if branch == "mtl" else 1)
    cam = port_camera(jcam.basis())

    def frames(jscene, pscene):
        want = np.asarray(jax_render_frame(
            jscene, jcam.basis(), JaxRenderConfig(traversal="packet",
                                                  **size), 0))
        return render_frame(pscene, cam, RenderConfig(**size), 0,
                            device="cpu").numpy(), want

    got, want = frames(js, ps)
    plain, plain_want = frames(js.replace(textures=None),
                               dataclasses.replace(ps, textures=None))
    control = np.abs(plain - plain_want).max(axis=-1) > 3e-5
    print(f"{branch}: {int(control.sum())} pixels differ without the "
          f"textures")
    assert control.sum() <= 0.02 * control.size
    assert_frame_close(np.where(control[..., None], want, got), want)
    assert want.mean() > 0.02
    assert float(np.abs(plain - got).max()) > 0.05  # the texture shows
