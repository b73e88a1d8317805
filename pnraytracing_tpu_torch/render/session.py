"""Interactive render session and checkpointing.

PyTorch counterpart of ``RenderSession`` and ``SessionStats`` of
``pnraytracing_tpu/render/session.py`` (the frame-loop semantics of
main.cpp:569-630):

* progressive accumulation of 1 spp per frame;
* any interaction (camera orbit / pan / zoom, material edit) switches to
  a 1-bounce preview and resets the accumulation (main.cpp:589-601);
* a material edit writes into the session's material tensors in place
  (the ImGui editor's ``glTexSubImage1D`` live update,
  ImGuiLayer.hpp:73-83; the session copies the caller's materials once,
  so the caller's scene stays as it was), and the captured frame
  program (``render/program.py``) reads the new values at its next
  replay without a new capture: the JAX session's "no re-jit".  The preview config (``max_depth=preview_depth``,
  ``compact_rays=False``) is a second program.

The frame counter of each step is the accumulation count, a device
tensor, so a step reads nothing back from the card but its timing.
Checkpoints are npz files with the JAX session's keys, so one written by
either package loads in the other.  The optimizer checkpoints of an
inverse-rendering run (:func:`save_optimizer_checkpoint`) are the JAX
module's npz form (orbax is not a dependency of the port): ``leaf_i`` in
the JAX flatten order of ``(params, optax.adam state, step)``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from pnraytracing_tpu_torch.core.camera import CameraState, resolve_device
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import Scene
from pnraytracing_tpu_torch.render.renderer import (
    AccumState,
    accum_add,
    render_frame,
)

_MATERIAL_KEYS = ("emissive", "base_color", "subsurface", "metallic",
                  "specular", "specular_tint", "roughness", "anisotropic",
                  "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss",
                  "ior", "transmission")


@dataclasses.dataclass
class SessionStats:
    frames: int = 0
    last_frame_ms: float = 0.0
    rays_per_s: float = 0.0


class RenderSession:
    """Progressive renderer with interaction semantics on ``device``
    (None = the card; the scene is moved there once, its materials
    copied)."""

    def __init__(self, scene: Scene, camera: CameraState, cfg: RenderConfig,
                 preview_depth: int = 1, device=None):
        self.device = resolve_device(device)
        scene = scene.to(self.device)
        mats = scene.materials
        self.scene = dataclasses.replace(scene, materials=dataclasses.replace(
            mats, **{k: getattr(mats, k).clone() for k in _MATERIAL_KEYS}))
        self.camera = camera
        self.cfg = cfg
        # the reference's interactive mode (main.cpp:593-596): one
        # bounce, and no coherence sort at that depth
        self.preview_cfg = dataclasses.replace(
            cfg, max_depth=preview_depth, compact_rays=False)
        self.accum = AccumState.create(cfg, device=self.device)
        self.interacting = False
        self.stats = SessionStats()

    # --- interactions (all reset accumulation) -------------------------
    def _dirty(self):
        self.accum = self.accum.reset()
        self.interacting = True

    def orbit(self, dphi: float, dtheta: float):
        self.camera.orbit(dphi, dtheta)
        self._dirty()

    def pan(self, dx: float, dy: float):
        self.camera.pan(dx, dy)
        self._dirty()

    def zoom(self, dfov: float):
        self.camera.zoom_fov(dfov)
        self._dirty()

    def edit_material(self, index: int, **fields):
        """Live material patch (ImGuiLayer.hpp:60-83), in place."""
        mats = self.scene.materials
        for key, val in fields.items():
            arr = getattr(mats, key)
            arr[index] = torch.as_tensor(val, dtype=arr.dtype)
        self._dirty()

    # --- stepping --------------------------------------------------------
    def step(self) -> torch.Tensor:
        """Render one sample; returns the resolved progressive image.
        The first step after an interaction renders the 1-bounce preview
        and does not advance the accumulation (redraw=1 semantics)."""
        cfg = self.preview_cfg if self.interacting else self.cfg
        t0 = time.perf_counter()
        img = render_frame(self.scene, self.camera.basis(device=self.device),
                           cfg, self.accum.count, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.stats.frames += 1
        self.stats.last_frame_ms = dt * 1e3
        self.stats.rays_per_s = cfg.num_pixels * (1 + 3 * cfg.max_depth) / dt
        if self.interacting:
            self.interacting = False  # the next step resumes converging
            return img
        self.accum = accum_add(self.accum, img)
        return self.accum.resolve()

    def converge(self, spp: int) -> torch.Tensor:
        out = None
        for _ in range(spp):
            out = self.step()
        return out

    # --- checkpoint / resume -------------------------------------------
    def save(self, path: str) -> None:
        """Persist the accumulation state, camera and materials (the
        mutable part of the scene), under the JAX session's npz keys."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        host = lambda t: t.detach().cpu().numpy()
        mats = self.scene.materials
        np.savez(
            path,
            total=host(self.accum.total), count=host(self.accum.count),
            eye=self.camera.eye, center=self.camera.center,
            up=self.camera.up, fov=self.camera.fov_deg,
            aspect=self.camera.aspect,
            **{f"mat_{k}": host(getattr(mats, k)) for k in _MATERIAL_KEYS})

    def load(self, path: str) -> None:
        """Restore a checkpoint of :meth:`save` (of either package); the
        materials are written into the scene's tensors in place."""
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        dev = lambda a, dt=None: torch.as_tensor(np.array(a, dt),
                                                 device=self.device)
        self.accum = AccumState(total=dev(data["total"], np.float32),
                                count=dev(data["count"], np.int32))
        self.camera = CameraState(
            eye=data["eye"], center=data["center"], up=data["up"],
            fov_deg=float(data["fov"]), aspect=float(data["aspect"]))
        mats = self.scene.materials
        for k in data.files:
            if k.startswith("mat_"):
                arr = getattr(mats, k[4:])
                val = torch.as_tensor(data[k])
                if val.shape != arr.shape:
                    raise ValueError(f"{k}: the checkpoint holds "
                                     f"{tuple(val.shape)}, the scene "
                                     f"{tuple(arr.shape)}")
                arr.copy_(val)
        self.interacting = False


def save_optimizer_checkpoint(path: str, params: dict, opt_state,
                              step: int) -> None:
    """Write ``<path>.npz`` for an inverse-rendering run: ``params`` (a
    params dict, ``diff/grad.py``), ``opt_state`` (the
    ``torch.optim.Adam`` over ``param_leaves(params)``) and ``step``, as
    the leaves ``leaf_i`` of the JAX package's fallback: the params'
    leaves in its flatten order, then optax's Adam count (int32), mu and
    nu (leaf by leaf), then ``step``.  A checkpoint of either package
    resumes in the other."""
    from pnraytracing_tpu_torch.diff.grad import param_leaves

    host = lambda t: t.detach().cpu().numpy()
    leaves = param_leaves(params)
    states = [opt_state.state.get(p, {}) for p in leaves]
    count = int(states[0]["step"]) if "step" in states[0] else 0
    moment = lambda k: [host(st[k]) if k in st else np.zeros(p.shape,
                                                             np.float32)
                        for p, st in zip(leaves, states)]
    arrays = ([host(p) for p in leaves] + [np.asarray(count, np.int32)]
              + moment("exp_avg") + moment("exp_avg_sq")
              + [np.asarray(step)])
    np.savez(path + ".npz", **{f"leaf_{i}": a for i, a in enumerate(arrays)})


def load_optimizer_checkpoint(path: str, like):
    """Restore a checkpoint of :func:`save_optimizer_checkpoint` (or the
    JAX package's npz fallback) into ``like = (params, opt_state,
    step)``: the params' tensors and the Adam moments are written in
    place; returns ``(params, opt_state, step)``."""
    from pnraytracing_tpu_torch.diff.grad import param_leaves

    params, opt, _ = like
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves = param_leaves(params)
    n = len(leaves)
    arrays = [data[f"leaf_{i}"] for i in range(3 * n + 2)]
    for p, a in zip(leaves, arrays[:n]):
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"the checkpoint holds a leaf of shape "
                             f"{a.shape} where the params hold "
                             f"{tuple(p.shape)}")
    count = int(arrays[n])
    dev = lambda a, p: torch.as_tensor(np.array(a), dtype=p.dtype,
                                       device=p.device)
    with torch.no_grad():
        for i, p in enumerate(leaves):
            p.copy_(dev(arrays[i], p))
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": dev(arrays[n + 1 + i], p),
                            "exp_avg_sq": dev(arrays[2 * n + 1 + i], p)}
    return params, opt, int(arrays[3 * n + 1])
