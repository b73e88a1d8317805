"""The port's pure-Python asset loaders (``io/obj.py``, ``io/png.py``,
``io/ply.py``, ``io/gltf.py``, ``io/fbx.py`` and the ``load_model``
dispatcher) against the JAX package's, on the CPU.  Mirrors the JAX
package's tests/test_io.py, test_fbx.py and test_ply_gltf.py: every input
is written in ``tmp_path`` (by those tests' writers, by PIL where the JAX
tests use it, and by the asset writers of ``chip_smoke.py``, which the
card's run loads), and the port's result is held **equal** to the JAX
function's on the same file: the same structure, strings and numbers,
and arrays of the same dtype, shape and values (these are host numpy
code in both packages).  Files written from arrays also load back to
those arrays.
"""

import base64
import json
import os
import struct

import numpy as np
import pytest

from chip_smoke import (
    first_use_order,
    write_fbx_binary,
    write_glb,
    write_obj,
    write_ply_binary,
)
from pnraytracing_tpu import io as jax_io
from pnraytracing_tpu.io import fbx as jax_fbx
from pnraytracing_tpu.io import gltf as jax_gltf
from pnraytracing_tpu.io import obj as jax_obj
from pnraytracing_tpu.io import ply as jax_ply
from pnraytracing_tpu.io import png as jax_png
from pnraytracing_tpu.scene.build import SceneBuilder as JaxSceneBuilder
from pnraytracing_tpu_torch import io as pio
from pnraytracing_tpu_torch.convert import scene_to_arrays
from pnraytracing_tpu_torch.io import fbx, gltf, obj, ply, png
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scene.build import SceneBuilder
from pnraytracing_tpu_torch.utils.image import save_png
from tests.test_fbx import ASCII_FBX, _pivot_ascii, _write_fbx
from tests.test_io import MTL as QUAD_MTL
from tests.test_io import OBJ as QUAD_OBJ
from tests.test_native_io import _MTL as DEMO_MTL
from tests.test_native_io import _OBJ as DEMO_OBJ
from tests.test_ply_gltf import (
    _gltf_binary_payload,
    _gltf_doc,
    _write_ply_ascii,
    _write_ply_binary,
)
from tests.test_torch_scene import _assert_leaves_equal


def assert_same(a, b, where="result"):
    """``a`` and ``b`` equal all the way down: containers of one type and
    length, dicts with one key set, arrays of one dtype, shape and
    values, everything else ``==``."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), where
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), where
        for k in b:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _mesh(subdiv=2):
    """An icosphere's positions, normals and indices, its vertices in
    first-use order (as an OBJ round trip returns them)."""
    m = shapes.icosphere(subdiv)
    pos, nrm, idx = first_use_order(m["indices"], m["positions"],
                                    m["normals"])
    return pos.astype(np.float32), nrm.astype(np.float32), idx


# ---- OBJ / MTL -------------------------------------------------------------

def _textured_obj(tmp_path):
    """An OBJ of two groups whose MTL names a PNG ``map_Kd``."""
    pos, nrm, idx = _mesh(1)
    uvs = (pos[:, :2] * 0.5 + 0.5).astype(np.float32)
    write_obj(str(tmp_path / "tex.obj"),
              [("body", pos, nrm, uvs, idx),
               ("plain", pos + 3.0, nrm, None, idx)], mtllib="tex.mtl")
    (tmp_path / "tex.mtl").write_text(
        "newmtl body\nKd 0.5 0.4 0.3\nNs 10\nmap_Kd skin.png\n"
        "newmtl plain\nKd 0.9 0.9 0.9\nKe 1 2 3\n")
    rng = np.random.default_rng(0)
    save_png(str(tmp_path / "skin.png"),
             rng.random((9, 13, 3)).astype(np.float32), gamma=1.0)
    return str(tmp_path / "tex.obj")


def _write_text(tmp_path, name, obj_text, mtl_name=None, mtl_text=None):
    (tmp_path / name).write_text(obj_text)
    if mtl_name:
        (tmp_path / mtl_name).write_text(mtl_text)
    return str(tmp_path / name)


OBJ_FILES = {
    "quad": lambda p: _write_text(p, "test.obj", QUAD_OBJ, "test.mtl",
                                  QUAD_MTL),
    "negative": lambda p: _write_text(p, "n.obj",
                                      "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                      "f -3 -2 -1\n"),
    "demo": lambda p: _write_text(p, "demo.obj", DEMO_OBJ, "demo.mtl",
                                  DEMO_MTL),
    "textured": _textured_obj,
}


@pytest.mark.parametrize("flip_v", [True, False])
@pytest.mark.parametrize("name", list(OBJ_FILES))
def test_load_obj_equals_jax(tmp_path, name, flip_v):
    path = OBJ_FILES[name](tmp_path)
    got = obj.load_obj(path, flip_v=flip_v)
    assert_same(got, jax_obj.load_obj(path, flip_v=flip_v))
    if name == "textured":
        assert got[0][2] is not None and got[0][2].shape == (9, 13, 3)
        assert got[1][1]["emissive"] == (1.0, 2.0, 3.0)


def test_load_obj_round_trips_written_arrays(tmp_path):
    pos, nrm, idx = _mesh(3)
    write_obj(str(tmp_path / "s.obj"), [(None, pos, nrm, None, idx)])
    (mesh, mat, tex, name), = obj.load_obj(str(tmp_path / "s.obj"))
    assert (mat, tex, name) == ({}, None, "s")
    for k, want in (("positions", pos), ("normals", nrm), ("indices", idx)):
        np.testing.assert_array_equal(mesh[k], want, err_msg=k)


def test_load_mtl_equals_jax(tmp_path):
    for text in (QUAD_MTL, DEMO_MTL):
        (tmp_path / "m.mtl").write_text(text)
        path = str(tmp_path / "m.mtl")
        assert_same(obj.load_mtl(path), jax_obj.load_mtl(path))
    assert obj.load_mtl(str(tmp_path / "nope.mtl")) == {}


# ---- PNG and textures ------------------------------------------------------

def _png_files(tmp_path):
    """The first-party writer's file and PIL-written ones (real scanline
    filters; rgb, gray, rgba and palette color types)."""
    rng = np.random.default_rng(3)
    out = {}
    p = str(tmp_path / "rt.png")
    save_png(p, rng.random((33, 47, 3)).astype(np.float32), gamma=1.0)
    out["writer"] = p
    PIL = pytest.importorskip("PIL.Image")
    g = np.linspace(0, 255, 64)[:, None] + rng.integers(0, 40, (64, 96))
    base = np.clip(g, 0, 255).astype(np.uint8)
    arrays = {"rgb": np.stack([base, base[::-1], base[:, ::-1]], -1),
              "gray": base,
              "rgba": np.stack([base, base[::-1], base[:, ::-1],
                                np.full_like(base, 200)], -1)}
    for name, arr in arrays.items():
        out[name] = str(tmp_path / f"{name}.png")
        PIL.fromarray(arr).save(out[name])
    out["palette"] = str(tmp_path / "pal.png")
    PIL.fromarray(arrays["rgb"]).quantize(colors=17).save(out["palette"])
    return out


def test_png_reader_equals_jax(tmp_path):
    for name, p in _png_files(tmp_path).items():
        assert_same(png.read_png(p), jax_png.read_png(p), name)
        assert_same(png.read_png_rgb(p), jax_png.read_png_rgb(p), name)


def test_load_texture_equals_jax(tmp_path):
    """PNG through io/png.py; another format through PIL (None without
    it); a missing file is None."""
    paths = list(_png_files(tmp_path).values())
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    bmp = str(tmp_path / "t.bmp")
    PIL.fromarray(rng.integers(0, 255, (5, 7, 3), dtype=np.uint8)).save(bmp)
    for p in paths + [bmp, str(tmp_path / "missing.png")]:
        assert_same(obj.load_texture(p), jax_obj.load_texture(p), p)


# ---- PLY -------------------------------------------------------------------

def _ply_files(tmp_path):
    out = {"ascii": str(tmp_path / "a.ply"), "le": str(tmp_path / "le.ply"),
           "be": str(tmp_path / "be.ply"), "mesh": str(tmp_path / "m.ply")}
    _write_ply_ascii(out["ascii"])
    _write_ply_binary(out["le"], big=False)
    _write_ply_binary(out["be"], big=True)
    write_ply_binary(out["mesh"], *_mesh(3))
    return out


def test_load_ply_equals_jax(tmp_path):
    for name, p in _ply_files(tmp_path).items():
        assert_same(ply.load_ply(p), jax_ply.load_ply(p), name)
    pos, nrm, idx = _mesh(3)
    got = ply.load_ply(str(tmp_path / "m.ply"))
    for k, want in (("positions", pos), ("normals", nrm), ("indices", idx)):
        np.testing.assert_array_equal(got[k], want, err_msg=k)


# ---- glTF ------------------------------------------------------------------

def _gltf_files(tmp_path):
    buf = _gltf_binary_payload()
    uri = ("data:application/octet-stream;base64,"
           + base64.b64encode(buf).decode())
    out = {"data_uri": str(tmp_path / "quad.gltf"),
           "external": str(tmp_path / "ext.gltf"),
           "glb": str(tmp_path / "quad.glb"),
           "mesh": str(tmp_path / "mesh.glb")}
    with open(out["data_uri"], "w") as f:
        json.dump(_gltf_doc(uri, len(buf)), f)
    (tmp_path / "quad.bin").write_bytes(buf)
    with open(out["external"], "w") as f:
        json.dump(_gltf_doc("quad.bin", len(buf)), f)
    doc = _gltf_doc(None, len(buf))
    del doc["buffers"][0]["uri"]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    binp = buf + b"\0" * (-len(buf) % 4)
    glb = struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(binp))
    glb += struct.pack("<II", len(js), 0x4E4F534A) + js
    glb += struct.pack("<II", len(binp), 0x004E4942) + binp
    with open(out["glb"], "wb") as f:
        f.write(glb)
    write_glb(out["mesh"], *_mesh(3))
    return out


def test_load_gltf_equals_jax(tmp_path):
    for name, p in _gltf_files(tmp_path).items():
        assert_same(gltf.load_gltf(p), jax_gltf.load_gltf(p), name)
    pos, nrm, idx = _mesh(3)
    (mesh, *_), = gltf.load_gltf(str(tmp_path / "mesh.glb"))
    for k, want in (("positions", pos), ("normals", nrm), ("indices", idx)):
        np.testing.assert_array_equal(mesh[k], want, err_msg=k)


def test_add_gltf_to_builder_equals_jax(tmp_path):
    """Every primitive registered with its world transform: the built
    scene's arrays equal the JAX builder's."""
    p = _gltf_files(tmp_path)["data_uri"]
    kw = dict(env_constant=(0.1, 0.1, 0.1))
    port = gltf.add_gltf_to_builder(SceneBuilder(), p).build(device="cpu",
                                                            **kw)
    want = jax_gltf.add_gltf_to_builder(JaxSceneBuilder(), p).build(**kw)
    _assert_leaves_equal(scene_to_arrays(port), scene_to_arrays(want))
    assert float(port.mesh.positions[:4, 2].min()) >= 3.0 - 1e-5


# ---- FBX -------------------------------------------------------------------

def _fbx_files(tmp_path):
    out = {"binary": str(tmp_path / "quad.fbx"),
           "ascii": str(tmp_path / "quad_ascii.fbx")}
    _write_fbx(out["binary"])
    (tmp_path / "quad_ascii.fbx").write_text(ASCII_FBX)
    pivots = {
        "pivot": 'P: "RotationPivot", "Vector3D", "", "A", 1, 0, 0\n'
                 'P: "PreRotation", "Vector3D", "", "A", 0, 0, 90\n',
        "xyz": 'P: "Lcl Rotation", "Lcl Rotation", "", "A", 90, 90, 0\n',
        "zyx": 'P: "Lcl Rotation", "Lcl Rotation", "", "A", 90, 90, 0\n'
               'P: "RotationOrder", "enum", "", "A", 5\n'}
    for name, props in pivots.items():
        out[name] = str(tmp_path / f"{name}.fbx")
        (tmp_path / f"{name}.fbx").write_text(_pivot_ascii(props))
    for version in (7400, 7500):  # 32- and 64-bit record offsets
        out[f"mesh{version}"] = str(tmp_path / f"m{version}.fbx")
        write_fbx_binary(out[f"mesh{version}"], *_mesh(2), version=version)
    return out


def test_load_fbx_equals_jax(tmp_path):
    for name, p in _fbx_files(tmp_path).items():
        assert_same(fbx.load_fbx(p), jax_fbx.load_fbx(p), name)
    pos, nrm, idx = _mesh(2)
    for version in (7400, 7500):
        (mesh, _, _, name, m), = fbx.load_fbx(
            str(tmp_path / f"m{version}.fbx"))
        assert name == "asset"
        np.testing.assert_array_equal(mesh["positions"],
                                      pos[idx].reshape(-1, 3))
        np.testing.assert_array_equal(mesh["normals"],
                                      nrm[idx].reshape(-1, 3))
        np.testing.assert_array_equal(
            mesh["indices"], np.arange(3 * len(idx)).reshape(-1, 3))
        np.testing.assert_array_equal(m, np.eye(4))


# ---- the load_model dispatcher ----------------------------------------------

def test_load_model_equals_jax(tmp_path):
    """Each extension to its loader, as the JAX package's ``load_model``
    (OBJ through the native library in both, where g++ exists)."""
    paths = [OBJ_FILES["demo"](tmp_path), _ply_files(tmp_path)["mesh"],
             _gltf_files(tmp_path)["glb"], _fbx_files(tmp_path)["binary"]]
    for p in paths:
        assert_same(pio.load_model(p), jax_io.load_model(p), p)
    with pytest.raises(ValueError, match="unsupported"):
        pio.load_model(os.path.join(str(tmp_path), "x.stl"))
