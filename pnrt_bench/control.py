"""The lower-precision control of a cell's check, on the card.

    python3 pnrt_bench/control.py --workload <cell> --seeds 1 2 3

For each seed it puts the plain reference, computed in bfloat16 (the
precision below the float32 the configurations state), in the
program's place, and prints the numbers the cell's check compares, each
beside its limit, one JSON line a seed.  A limit is sound only where
every seed's control fails at least one of them.  The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from pnrt_bench import bench, check

    _, config, traffic = bench.find_cell(bench.benchmark(ROOT), args.workload,
                                         ROOT)
    limits = check.load_limits(args.workload)
    control = bench.loop_module(traffic["kind"]).control
    dev = torch.device("cuda")
    for seed in args.seeds:
        numbers = control(config, traffic, limits, seed, dev)
        fails = sorted(k for k, v in numbers.items()
                       if not v <= limits["limits"][k])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": numbers, "limits": limits["limits"],
                          "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
