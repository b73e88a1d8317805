"""The port's command lines (``pnraytracing_tpu_torch/scripts/``) on the
CPU: each script's ``main(argv)`` with ``--cpu`` at 8x8, one or two
samples, depth 1-2.  The render CLI's PNG equals the ``save_png`` of the
port's ``render_average`` of the same frames (named scene, ``--model``
and ``--sharded`` in a world of one on gloo); ``optimize``,
``interactive`` (its commands on stdin) and ``gallery`` write their
files.  Against the JAX build's ``scripts/render.py``, without a JAX
render: ``build_scene`` of every catalog name and ``scene_from_file`` on
one OBJ hold their scene arrays (``convert.py::scene_to_arrays``) and
camera to the JAX scripts' own, integers exactly and floats within
1e-6.
"""

import functools
import io
import os

import numpy as np
import pytest

from chip_smoke import first_use_order, write_obj
from pnraytracing_tpu_torch.convert import scene_to_arrays
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.io.png import read_png_rgb
from pnraytracing_tpu_torch.parallel.distributed import free_port
from pnraytracing_tpu_torch.render.renderer import render_average
from pnraytracing_tpu_torch.scene import shapes
from pnraytracing_tpu_torch.scripts import gallery, interactive, optimize
from pnraytracing_tpu_torch.scripts import render as cli
from pnraytracing_tpu_torch.utils.image import save_png
from scripts import render as jax_cli
from tests.test_torch_scene import _torch_threads  # noqa: F401

SMALL = ["--width", "8", "--height", "8", "--spp", "2", "--depth", "2"]


def reference_png(tmp_path, scene, cam_state, spp=2, depth=2, size=8,
                  **cfg_kw):
    """The PNG ``save_png`` writes from the port's in-process
    ``render_average`` of frames 0 .. spp-1 (``cfg_kw``: more fields of
    the config), decoded."""
    cfg = RenderConfig(width=size, height=size, max_depth=depth, **cfg_kw)
    cam_state.aspect = 1.0
    img = render_average(scene, cam_state.basis(device="cpu"), cfg, 0, spp,
                         device="cpu")
    path = str(tmp_path / "reference.png")
    save_png(path, img)
    return read_png_rgb(path)


@functools.lru_cache(maxsize=1)
def obj_mesh():
    m = shapes.icosphere(2)
    pos, nrm, idx = first_use_order(m["indices"], m["positions"],
                                    m["normals"])
    return pos.astype(np.float32), nrm.astype(np.float32), idx


@pytest.fixture
def obj_path(tmp_path):
    path = str(tmp_path / "ball.obj")
    write_obj(path, [(None, *obj_mesh()[:2], None, obj_mesh()[2])])
    return path


def test_render_named_scene(tmp_path):
    out = str(tmp_path / "cornell.png")
    assert cli.main(["--cpu", "--scene", "cornell", *SMALL,
                     "--out", out]) == 0
    want = reference_png(tmp_path, *cli.build_scene("cornell", 1.0,
                                                    device="cpu"))
    np.testing.assert_array_equal(read_png_rgb(out), want)


def test_render_list(capsys):
    assert cli.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == cli.SCENES == jax_cli.SCENES


def test_render_model(tmp_path, obj_path):
    out = str(tmp_path / "model.png")
    assert cli.main(["--cpu", "--model", obj_path, *SMALL,
                     "--out", out]) == 0
    want = reference_png(tmp_path, *cli.scene_from_file(obj_path, 1.0,
                                                        device="cpu"))
    np.testing.assert_array_equal(read_png_rgb(out), want)


def test_render_sharded_world_of_one(tmp_path, monkeypatch):
    """``--sharded`` as ``torchrun`` starts it (the environment names
    the world), on gloo: the PNG equals the unsharded one."""
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT",
                                                str(free_port())),
                 ("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    paths = [str(tmp_path / f"{n}.png") for n in ("plain", "sharded")]
    args = ["--cpu", "--scene", "flat", *SMALL]
    assert cli.main([*args, "--out", paths[0]]) == 0
    assert cli.main([*args, "--sharded", "--out", paths[1]]) == 0
    np.testing.assert_array_equal(read_png_rgb(paths[1]),
                                  read_png_rgb(paths[0]))


def test_optimize(tmp_path, capsys):
    out = str(tmp_path / "opt")
    assert optimize.main(["--cpu", "--size", "8", "--steps", "2",
                          "--depth", "1", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "loss: " in text and "recovered base_color" in text
    for name in ("target", "initial", "optimized"):
        assert read_png_rgb(f"{out}/{name}.png").shape == (8, 8, 3)


def test_interactive(tmp_path, monkeypatch, capsys):
    ckpt, out = str(tmp_path / "s.npz"), str(tmp_path / "i.png")
    script = ["spp 2", "orbit 10 0", "mat 0 base_color 1 0 0",
              f"save {ckpt}", f"load {ckpt}", "status", "", "zoom x",
              "quit"]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(script) + "\n"))
    assert interactive.main(["--cpu", "--size", "8", "--depth", "1",
                             "--out", out]) == 0
    text = capsys.readouterr().out
    for line in ("2 samples -> frame 2", "material 0.base_color updated",
                 f"checkpoint -> {ckpt}", "restored frame 0",
                 "frames 2, accumulated 0", "frame 1 ", "bad arguments"):
        assert line in text, line
    assert read_png_rgb(out).shape == (8, 8, 3)
    assert os.path.exists(ckpt)


def test_gallery(tmp_path):
    out = str(tmp_path / "g")
    assert gallery.main(["--cpu", "--size", "8", "--spp", "1", "--depth",
                         "1", "--scenes", "cornell", "--out", out]) == 0
    want = reference_png(tmp_path, *cli.build_scene("cornell", 1.0,
                                                    device="cpu"),
                         spp=1, depth=1)
    np.testing.assert_array_equal(read_png_rgb(f"{out}/cornell_8_1spp.png"),
                                  want)


def assert_same_scene(port, jax):
    """Scene arrays: the same leaves, dtypes and shapes, integers equal,
    floats within 1e-6; the camera states equal."""
    (ps, pcam), (js, jcam) = port, jax
    a, b = scene_to_arrays(ps), scene_to_arrays(js)
    assert sorted(a) == sorted(b)
    for k in a:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
        if np.issubdtype(a[k].dtype, np.floating):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for f in ("eye", "center", "up"):
        np.testing.assert_array_equal(getattr(pcam, f), getattr(jcam, f))
    assert (pcam.fov_deg, pcam.aspect) == (jcam.fov_deg, jcam.aspect)


@pytest.mark.parametrize("name", cli.SCENES)
def test_build_scene_matches_jax(name):
    assert_same_scene(cli.build_scene(name, 1.5, device="cpu"),
                      jax_cli.build_scene(name, 1.5))


def test_scene_from_file_matches_jax(obj_path):
    assert_same_scene(cli.scene_from_file(obj_path, 1.5, device="cpu"),
                      jax_cli.scene_from_file(obj_path, 1.5))
