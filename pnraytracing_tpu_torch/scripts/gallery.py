"""Render the gallery, after the JAX build's ``scripts/gallery.py``: the
reference's ``photos/`` equivalent (README.md screenshots), the catalog
scenes at presentation quality through ``render_average``.  On the card
unless ``--cpu`` is given; ``--small`` renders 128px at 8 spp.

Example:
  python -m pnraytracing_tpu_torch.scripts.gallery --small --scenes cornell,flat
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="out/gallery")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--small", action="store_true", help="128px, 8 spp")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the card)")
    ap.add_argument("--scenes", default="cornell,flat,teapot_night,marry")
    args = ap.parse_args(argv)
    if args.small:
        args.size, args.spp = 128, 8

    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.render.renderer import render_average
    from pnraytracing_tpu_torch.scripts.render import build_scene
    from pnraytracing_tpu_torch.utils.image import save_png

    dev = "cpu" if args.cpu else None
    os.makedirs(args.out, exist_ok=True)
    # traversal 'pallas', the card's counterpart of the JAX gallery's
    # accelerator choice
    cfg = RenderConfig(width=args.size, height=args.size,
                       max_depth=args.depth, traversal="pallas")
    for name in args.scenes.split(","):
        t0 = time.perf_counter()
        scene, cam_state = build_scene(name, 1.0, device=dev)
        cam_state.aspect = 1.0
        img = render_average(scene, cam_state.basis(device=dev), cfg, 0,
                             args.spp, device=dev)
        path = f"{args.out}/{name}_{args.size}_{args.spp}spp.png"
        save_png(path, img)
        print(f"{name}: {time.perf_counter()-t0:.1f}s -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
