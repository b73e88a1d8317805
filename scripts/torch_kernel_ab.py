"""Time the port's walk kernels 1-3, 5, 6, 7c and 7a of one checkout on
seeded rays, for an A/B of two checkouts on one card.

Usage, on the machine with the card, from the root of each checkout in
turn (e.g. the parent unpacked by ``git archive`` into a git-ignored
directory), parent, change, change, parent:

    python3 scripts/torch_kernel_ab.py <label>

Rays: 262,144 (closest) and 524,288 (any) from seeded random points of
the scene's box in random directions, half of them with t_max 2, a fifth
masked out, over the flagship (kernels 1-3, 5, 6) and config5 (7c, 7a).
Each kernel's mean device ms over 30 launches after 3 (chip_smoke.py's
``time_ms``).  Prints one JSON line ``{"tree": label, "ms": {...}}``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def rays(trav, n, seed, dev):
    import torch

    from pnraytracing_tpu_torch.core.vec import V3

    g = torch.Generator().manual_seed(seed)
    lo, hi = trav.nodes8[0, :3].cpu(), trav.nodes8[0, 3:6].cpu()
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((n,), 3.4e38)
    t_max[::2] = 2.0
    v3 = lambda a: V3(*(a[:, k].contiguous().to(dev) for k in range(3)))
    return (v3(o), v3(d), t_max.to(dev),
            (torch.rand(n, generator=g) < 0.8).to(dev))


def main() -> int:
    import torch

    from chip_smoke import time_ms
    from pnraytracing_tpu_torch import cuda_build
    from pnraytracing_tpu_torch.accel import traverse_cuda as trv
    from pnraytracing_tpu_torch.accel import traverse_stream_cuda as trs
    from pnraytracing_tpu_torch.scene.scenes import (
        config3_teapot_night,
        config5_large,
    )

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    cuda_build.build_all(("traverse", "traverse_stream"))
    dev = torch.device("cuda")
    flag, _ = config3_teapot_night(env_height=64, device=dev)
    c5, _ = config5_large(device=dev)
    fr, fs = rays(flag.trav, 262144, 0, dev), rays(flag.trav, 524288, 1, dev)
    cr, cs = rays(c5.trav, 262144, 2, dev), rays(c5.trav, 524288, 3, dev)
    walks = {
        "1": lambda: trv.closest_hit_attr(flag.trav, *fr),
        "3": lambda: trv.closest_hit(flag.trav, *fr),
        "2": lambda: trv.any_hit(flag.trav, *fs),
        "5": lambda: trv.closest_hit(flag.trav, *fr, variant="binary"),
        "6": lambda: trv.any_hit(flag.trav, *fs, variant="binary"),
        "7c": lambda: trs.closest_hit_stream(c5.trav, *cr),
        "7a": lambda: trs.any_hit_stream(c5.trav, *cs),
    }
    ms = {k: time_ms(fn, 30, warmup=3) for k, fn in walks.items()}
    print(json.dumps({"tree": sys.argv[1] if len(sys.argv) > 1 else "",
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
