"""Interactive progressive renderer of the port, after the JAX build's
``scripts/interactive.py``: the reference's windowed app (main.cpp frame
loop + camera callbacks + ImGui material editor) as a terminal REPL on
``render/session.py::RenderSession``.  Renders a sample a step, writes
the latest progressive image to a PNG, and accepts edit commands between
samples; on the card unless ``--cpu`` is given.

Commands (stdin):
  (empty line)            render one sample
  orbit <dphi> <dtheta>   rotate camera around the target (degrees)
  pan <dx> <dy>           translate in the view plane
  zoom <dfov>             change fov
  mat <idx> <field> <v..> edit a material (e.g. mat 0 base_color 1 0 0)
  spp <n>                 render n more samples then pause
  save <path> / load <path>   checkpoint accumulation + materials
  status                  print frame stats
  quit
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--out", default="out/interactive.png")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.render.session import RenderSession
    from pnraytracing_tpu_torch.scripts.render import build_scene
    from pnraytracing_tpu_torch.utils.image import save_png

    cfg = RenderConfig(width=args.size, height=args.size, max_depth=args.depth)
    # built on the host; the session moves it to its device once
    scene, cam_state = build_scene(args.scene, 1.0, device="cpu")
    cam_state.aspect = 1.0
    session = RenderSession(scene, cam_state, cfg,
                            device="cpu" if args.cpu else None)

    print(f"interactive: {args.scene} at {args.size}px; commands: orbit/pan/"
          f"zoom/mat/spp/save/load/status/quit", flush=True)

    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            img = session.step()
            save_png(args.out, img)
            print(f"frame {int(session.accum.count)}  "
                  f"{session.stats.last_frame_ms:.0f} ms  "
                  f"{session.stats.rays_per_s/1e6:.0f} M rays/s -> {args.out}")
            continue
        parts = line.split()
        cmd = parts[0]
        try:
            if cmd == "quit":
                break
            elif cmd == "orbit":
                session.orbit(float(parts[1]), float(parts[2]))
            elif cmd == "pan":
                session.pan(float(parts[1]), float(parts[2]))
            elif cmd == "zoom":
                session.zoom(float(parts[1]))
            elif cmd == "mat":
                idx = int(parts[1])
                field = parts[2]
                vals = [float(v) for v in parts[3:]]
                session.edit_material(
                    idx, **{field: vals if len(vals) > 1 else vals[0]}
                )
                print(f"material {idx}.{field} updated; accumulation reset")
            elif cmd == "spp":
                n = int(parts[1])
                for _ in range(n):
                    img = session.step()
                save_png(args.out, img)
                print(f"{n} samples -> frame {int(session.accum.count)}")
            elif cmd == "save":
                session.save(parts[1])
                print(f"checkpoint -> {parts[1]}")
            elif cmd == "load":
                session.load(parts[1])
                print(f"restored frame {int(session.accum.count)}")
            elif cmd == "status":
                print(f"frames {session.stats.frames}, accumulated "
                      f"{int(session.accum.count)}, last "
                      f"{session.stats.last_frame_ms:.0f} ms")
            else:
                print(f"unknown command {cmd!r}")
        except (IndexError, ValueError) as e:
            print(f"bad arguments: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
