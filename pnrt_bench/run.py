"""Run one cell of the port's benchmark once and print its result line.

    python3 pnrt_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  It runs on the machine it is started on
and needs as many CUDA cards as the cell asks for; without them it
exits with code 2 and prints no result.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and
last ``checks``: each number the check compared with its limit); the
same numbers end standard error.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from pnrt_bench import bench

    cell = {c["name"]: c for c in bench.benchmark(ROOT)["workloads"]}.get(
        args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = bench.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), ROOT, T_PROCESS)
    found = bench.forbidden_modules()
    if found:
        print("modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
