"""Inverse-rendering demo of the port, after the JAX build's
``scripts/optimize.py``: recover material parameters (and optionally
environment texels or vertex positions) from a target image by gradient
descent through the renderer (``diff/grad.py::adam_optimize``).

Example:
  python -m pnraytracing_tpu_torch.scripts.optimize --steps 48
  python -m pnraytracing_tpu_torch.scripts.optimize --cpu --size 16 --steps 8
renders a target with known materials (the ball's base colour
(0.15, 0.55, 0.8)), starts from a wrong guess (0.8, 0.3, 0.2) and
optimizes back; on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--spp-per-step", type=int, default=2)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--keys", default="materials",
                    help="comma list of materials,env_image,positions")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--out", default="out/optimize")
    args = ap.parse_args(argv)

    import numpy as np

    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.diff.grad import adam_optimize
    from pnraytracing_tpu_torch.render.renderer import render
    from pnraytracing_tpu_torch.scene import shapes
    from pnraytracing_tpu_torch.scene.build import SceneBuilder
    from pnraytracing_tpu_torch.scene.scenes import _camera
    from pnraytracing_tpu_torch.scene.transform import translate
    from pnraytracing_tpu_torch.utils.image import save_png

    dev = "cpu" if args.cpu else None
    # env-lit, no hard area light: low-variance renders so the MSE gradient
    # is signal, not sampling noise
    cfg = RenderConfig(width=args.size, height=args.size, max_depth=args.depth,
                       sampler="hash", clamp_radiance=True)

    def build(base_color):
        b = SceneBuilder()
        b.add(shapes.icosphere(3), dict(base_color=base_color, roughness=0.6),
              name="ball", transform=translate(0, 1.0, 0))
        b.add(shapes.quad(6.0), dict(base_color=(0.6, 0.6, 0.6), roughness=0.9),
              name="floor")
        return b.build(env_constant=(0.85, 0.85, 0.85), device=dev)

    camera = _camera((3.2, 2.6, 3.2), (0, 0.9, 0), 45.0).basis(device=dev)

    true_color = (0.15, 0.55, 0.8)
    target = render(build(true_color), camera, cfg, spp=8, device=dev)
    scene0 = build((0.8, 0.3, 0.2))  # wrong initial guess

    keys = tuple(args.keys.split(","))
    scene_opt, losses = adam_optimize(
        scene0, camera, cfg, target, keys=keys, steps=args.steps, lr=args.lr,
        spp_per_step=args.spp_per_step, log_every=1, device=dev,
    )
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f} "
          f"({losses[0] / max(losses[-1], 1e-12):.1f}x reduction)")
    got = scene_opt.materials.base_color[0].cpu().numpy()
    print(f"recovered base_color: {np.round(got, 3)} (true {true_color})")

    os.makedirs(args.out, exist_ok=True)
    save_png(f"{args.out}/target.png", target)
    save_png(f"{args.out}/initial.png",
             render(scene0, camera, cfg, spp=8, device=dev))
    save_png(f"{args.out}/optimized.png",
             render(scene_opt, camera, cfg, spp=8, device=dev))
    print(f"saved {args.out}/{{target,initial,optimized}}.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
