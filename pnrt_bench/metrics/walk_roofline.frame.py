"""walk_roofline.frame: the least time the frame's walks could take over
the walk kernels' device time a frame, in %, against the bytes side of
the card (``yardstick.HBM_BYTES_PER_S``; the walks' operations depend on
the tree and are not counted).  The work is counted as the repo's bench
counts queries, so it is the same whatever implements the walk: per
pixel 1 + depth closest queries and 2 x depth shadow queries; each
query's origin, direction and t_max read once (28 B) and its answer
written once (closest: t, triangle, two barycentrics, 16 B; shadow: 4
B); each triangle's 9 floats read once per round of queries (1 + depth
closest rounds, depth shadow rounds).  Moves ``frame_ms``; silent when
no walk kernel ran in the stretch."""

from pnrt_bench import yardstick as ys

RAY_BYTES = 28
CLOSEST_BYTES = 16
SHADOW_BYTES = 4
TRIANGLE_BYTES = 36


def walk_bytes(pixels: int, depth: int, triangles: int) -> int:
    closest = pixels * (1 + depth) * (RAY_BYTES + CLOSEST_BYTES)
    shadow = pixels * 2 * depth * (RAY_BYTES + SHADOW_BYTES)
    return closest + shadow + triangles * TRIANGLE_BYTES * (1 + 2 * depth)


def read(run):
    if run.trace is None:
        return None
    walk_us = sum(e - s for n, s, e in run.trace.ops if ys.is_walk(n))
    if not walk_us:
        return None
    r = run.config["render"]
    least_s = walk_bytes(r["width"] * r["height"], r["max_depth"],
                         run.config["triangles"]) / ys.HBM_BYTES_PER_S
    return 100.0 * least_s / ys.per_unit(run, walk_us * 1e-6)
