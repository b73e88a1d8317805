"""Render CLI of the port, the app-orchestration layer (the reference's
``main()`` without a window: scene selection, progressive accumulation,
PNG output), after the JAX build's ``scripts/render.py``.

Usage:
  python -m pnraytracing_tpu_torch.scripts.render --scene cornell --spp 64 --out out/cornell.png
  python -m pnraytracing_tpu_torch.scripts.render --scene teapot_night --width 512 --height 512
  python -m pnraytracing_tpu_torch.scripts.render --cpu --scene cornell --width 48 --height 48 --spp 2 --depth 2
  python -m pnraytracing_tpu_torch.scripts.render --model asset.obj
  python -m pnraytracing_tpu_torch.scripts.render --scene teapot_night --traversal wide4
  torchrun --standalone --nproc_per_node 4 -m pnraytracing_tpu_torch.scripts.render --sharded
  python -m pnraytracing_tpu_torch.scripts.render --list

Frames render on the card unless ``--cpu`` is given.  On the card each
sample renders in a worker process (``utils/resilience.py::
ResilientRenderLoop``) and accumulates here on the host: a lost card,
or a killed worker, costs the sample in flight, which a fresh worker
renders again.  ``--sharded`` runs one process a card under
``torchrun`` (``parallel/distributed.py::initialize``, then
``parallel/mesh.py::render_frame_sharded`` in process, rank 0 writing
the PNG); there a sticky CUDA error or a lost rank ends the job, since
an NCCL communicator cannot be rebuilt in place.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from pnraytracing_tpu_torch.core.config import TRAVERSALS


def build_scene(name: str, aspect: float, device=None):
    """(scene on ``device``, camera state) of a catalog name (None = the
    card)."""
    from pnraytracing_tpu_torch.scene import scenes

    if name == "cornell":
        builder, cam = scenes.cornell_box(aspect)
        return builder.build(env_constant=(0.0, 0.0, 0.0),
                             device=device), cam
    if name == "flat":
        builder, cam = scenes.scene_flat(aspect)
        return builder.build(env_constant=(0.03, 0.03, 0.05),
                             device=device), cam
    if name == "teapot":
        builder, cam = scenes.teapot_scene(aspect)
        return builder.build(env_image=scenes.night_hdr(),
                             device=device), cam
    if name == "config1":
        return scenes.config1_triangle(device=device)
    if name == "config2":
        return scenes.config2_teapot(device=device)
    if name == "teapot_night" or name == "config3":
        return scenes.config3_teapot_night(device=device)
    if name == "marry" or name == "config4":
        return scenes.config4_marry(aspect, device=device)
    if name == "config5":
        return scenes.config5_large(device=device)
    raise SystemExit(f"unknown scene {name!r} (use --list)")


SCENES = ["cornell", "flat", "teapot", "teapot_night", "marry",
          "config1", "config2", "config3", "config4", "config5"]


def scene_from_file(path: str, aspect: float, device=None):
    """Studio setup around a model file (OBJ/PLY/glTF/GLB/FBX): the
    asset auto-framed on a floor under an area light and a sky, the CLI
    counterpart of the reference's ``Model(path, modelMatrix, ...)``
    scene functions (main.cpp:198-347).  Returns (scene on ``device``,
    camera state)."""
    import numpy as np

    from pnraytracing_tpu_torch.core.camera import CameraState
    from pnraytracing_tpu_torch.io import load_model
    from pnraytracing_tpu_torch.scene import shapes
    from pnraytracing_tpu_torch.scene.build import SceneBuilder
    from pnraytracing_tpu_torch.scene.transform import (
        compose,
        rotate,
        translate,
    )

    b = SceneBuilder()
    groups = load_model(path)
    if isinstance(groups, dict):  # PLY: bare mesh
        b.add(groups, dict(base_color=(0.75, 0.71, 0.68), roughness=0.5),
              name=os.path.basename(path))
    else:
        for g in groups:
            if len(g) == 4:  # OBJ: (mesh, material, texture, name)
                mesh, mat, tex, name = g
                b.add(mesh, mat, name=name, texture=tex)
            elif len(g) == 5:  # FBX: (mesh, material, None, name, transform)
                mesh, mat, tex, name, m = g
                b.add(mesh, mat, name=name, transform=m, texture=tex)
            else:  # glTF: (mesh, material, texture, name, transform, key)
                mesh, mat, tex, name, m, tex_key = g
                b.add(mesh, mat, name=name, transform=m, texture=tex,
                      texture_key=tex_key)

    # auto-frame: bounding box of everything added so far (float64)
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for e in b.entries:
        p = np.asarray(e.mesh["positions"], np.float64)
        if e.transform is not None:
            p = p @ e.transform[:3, :3].T + e.transform[:3, 3]
        lo = np.minimum(lo, p.min(axis=0))
        hi = np.maximum(hi, p.max(axis=0))
    center = (lo + hi) / 2
    extent = float(max(hi - lo))

    b.add(shapes.quad(extent * 4), dict(base_color=(0.6, 0.6, 0.6),
                                        roughness=0.8),
          name="floor", transform=translate(center[0], lo[1], center[2]))
    b.add(shapes.quad(extent * 0.6), dict(emissive=(10.0, 10.0, 10.0)),
          name="key_light",
          transform=compose(translate(center[0], hi[1] + extent * 1.2,
                                      center[2]),
                            rotate(180, (0, 0, 1))))
    scene = b.build(env_constant=(0.25, 0.28, 0.32), device=device)
    eye = center + np.array([0.0, extent * 0.45, extent * 1.6])
    cam = CameraState(eye=np.asarray(eye, np.float64),
                      center=np.asarray(center, np.float64),
                      up=np.array([0.0, 1.0, 0.0]), fov_deg=45.0,
                      aspect=aspect)
    return scene, cam


def _sharded_frames(scene, camera, cfg, spp, cpu, log):
    """Frames of the tile-sharded render on this rank, each retried in
    process by ``run_resilient``; yields (frame index, host image)."""
    from pnraytracing_tpu_torch.parallel.distributed import rank_device
    from pnraytracing_tpu_torch.parallel.mesh import (
        make_device_mesh,
        render_frame_sharded,
    )
    from pnraytracing_tpu_torch.utils.resilience import run_resilient

    mesh = make_device_mesh()
    dev = rank_device("cpu" if cpu else None)
    log(f"mesh: {mesh.size} rank(s), this rank {mesh.index} on {dev}")
    scene, camera = scene.to(dev), camera.to(dev)
    for f in range(spp):
        def one(frame=f, scene=None):
            return render_frame_sharded(scene, camera, cfg, frame, mesh,
                                        device=dev).cpu().numpy()

        yield f, run_resilient(one, reupload={"scene": scene},
                               log=lambda m: log(f"[resilience] {m}"))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell", choices=SCENES)
    ap.add_argument("--model", default=None, metavar="PATH",
                    help="render an OBJ/PLY/glTF/GLB/FBX (binary) file in "
                    "a studio setup instead of a named scene")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sampler", default="sobol", choices=["sobol", "hash"])
    ap.add_argument("--loop", default="unroll", choices=["unroll", "scan"],
                    help="bounce-loop construction of the integrator")
    ap.add_argument("--compat", action="store_true",
                    help="reproduce the reference's quirks exactly")
    ap.add_argument("--traversal", default=None, choices=TRAVERSALS,
                    help="the walk (default: RenderConfig's, 'pallas'; "
                    "the others are the walks of the JAX package's XLA "
                    "values, each a CUDA kernel here)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the card)")
    ap.add_argument("--sharded", action="store_true",
                    help="one process a card under torchrun; the frame's "
                    "rays split over the ranks")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(SCENES))
        return 0

    import numpy as np

    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.utils.image import save_png
    from pnraytracing_tpu_torch.utils.resilience import ResilientRenderLoop

    overrides = {}
    if args.traversal:
        overrides["traversal"] = args.traversal
    cfg = RenderConfig(
        width=args.width, height=args.height, max_depth=args.depth,
        sampler=args.sampler, compat_pnrt=args.compat, loop=args.loop,
        **overrides)
    aspect = args.width / args.height
    # built on the host: the worker (or the rank) moves it to its card
    if args.model:
        scene, cam_state = scene_from_file(args.model, aspect, device="cpu")
    else:
        scene, cam_state = build_scene(args.scene, aspect, device="cpu")
    cam_state.aspect = aspect
    camera = cam_state.basis(device="cpu")

    rank0 = True
    log = lambda m: print(m, flush=True)
    if args.sharded:
        import torch.distributed as dist

        from pnraytracing_tpu_torch.parallel.distributed import initialize

        initialize(device="cpu" if args.cpu else None)
        rank0 = dist.get_rank() == 0
        if not rank0:
            log = lambda m: None
    log(f"scene {args.scene}: {int(scene.mesh.indices.shape[0])} tris, "
        f"{scene.lights.count} light tris, "
        f"env={'hdr' if scene.env is not None else 'const'}")

    def rays_per_s(dt):
        n = cfg.num_pixels * (1 + 3 * cfg.max_depth) * (args.spp - 1)
        log(f"{args.spp - 1} frames in {dt:.2f}s -> {n / dt:,.0f} rays/s")

    t0 = time.perf_counter()
    if args.sharded:
        try:
            acc = 0.0
            for f, sample in _sharded_frames(scene, camera, cfg, args.spp,
                                             args.cpu, log):
                acc = acc + sample
                if f == 0:
                    log(f"first frame: "
                        f"{time.perf_counter() - t0:.1f}s")
                    t0 = time.perf_counter()
            img = acc / args.spp
        finally:
            dist.destroy_process_group()
    else:
        with ResilientRenderLoop(
                scene, camera, cfg, device="cpu" if args.cpu else None,
                log=lambda m: log(f"[resilience] {m}")) as loop:
            loop.render(1)
            log(f"first frame (incl. worker start and capture): "
                f"{time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            img = loop.render(args.spp - 1)
            if loop.worker is not None:
                log("worker launches: " + json.dumps(
                    {"first_reply": loop.worker.launches,
                     "captured_frame": loop.worker.frame_launches}))
    if args.spp > 1:
        rays_per_s(time.perf_counter() - t0)
    if not rank0:
        return 0
    out = args.out or (f"out/{args.scene}_{args.width}x{args.height}_"
                       f"{args.spp}spp.png")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_png(out, np.asarray(img, np.float32))
    log(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
