"""Benchmark harness of the port: rays/s/chip on the flagship
configuration, the counterpart of the JAX package's ``bench.py``.

Run from the root of a checkout:

    python -m pnraytracing_tpu_torch.bench                # forward
    python -m pnraytracing_tpu_torch.bench --bwd          # fwd + bwd
    python -m pnraytracing_tpu_torch.bench --bwd --no-replay
    python -m pnraytracing_tpu_torch.bench --cpu --width 16 --height 16

Scene: config 3 (teapot + area light + night HDR env, full Disney BRDF
with light / env / BRDF MIS) at 512x512, 1 spp, 4 bounces.  Metric:
traced rays a second on one card, counting every query a pixel's path
issues (primary + per bounce: light shadow + env shadow + continuation),
rays/pixel = 1 + 3 * depth, as ``bench.py`` counts them.  ``--bwd``
times the forward + backward step (gradients to the materials and the
env texels) instead: on the card one replayed CUDA graph a step
(``diff/program.py``), captured by the first warm-up call.

Method: a call of the forward bench is ``render_average`` of
``--frames-per-call`` frames, which on the card replays the frame's
captured CUDA graph (``render/program.py``) once a frame: the
counterpart of the JAX bench's multi-frame compiled call.  The warm-up
calls come first (the first one captures the program); then the timed
calls are dispatched and the clock is closed by fetching the last
call's scalar, as ``bench.py`` does.  The card runs a stream's work in
order, so that fetch bounds every timed call.

Runs on the card; ``--cpu`` runs the plain versions on the host, and
without a card and without ``--cpu`` the bench raises.  Prints exactly
one JSON line on stdout:

  {"metric": ..., "value": N, "unit": "rays/s/chip", "vs_baseline": N}

and, unless ``--quiet``, ``[bench +   x.xs]`` phase lines on stderr
followed by the card's ``nvidia-smi --query-gpu=name,power.limit`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from pnraytracing_tpu_torch.core.config import TRAVERSALS

# vs_baseline anchor: the HBM roofline of the flagship's query mix on an
# NVIDIA H100 SXM (spec HBM3 bandwidth 3.35 TB/s), so the ratio reads
# "fraction of roofline", as the JAX bench's does for its own chip.
# Bytes a query, counted as BASELINE.md counts the TPU layout (rows
# visited x row bytes + triangles tested x triangle bytes), over the
# port's own layouts: a wide node row of ``nodes16c`` is 64 B, a
# ``tri12`` row 48 B, a ``tri_attr16`` row 64 B (read once by a closest
# hit; counted for every one).  Rows and tests a ray: the flagship's
# walk figures on the H100 (``chip_smoke.py``, ``walk_figures``; PERF.md
# section 6): the closest-hit walk 9.52 rows and 1.10 triangle tests,
# the shadow walk 7.35 and 0.48.  Of the 13 queries a pixel at 4 bounces
# 5 are closest hits and 8 shadow rays:
#   closest 9.52 * 64 + 1.10 * 48 + 64 = 726.08 B
#   shadow  7.35 * 64 + 0.48 * 48      = 493.44 B
#   mix     (5 * 726.08 + 8 * 493.44) / 13 = 582.92 B a query
#   3.35e12 / 582.92 = 5.747e9 rays/s
HBM_BYTES_PER_S = 3.35e12
BYTES_PER_QUERY = (5 * (9.52 * 64 + 1.10 * 48 + 64)
                   + 8 * (7.35 * 64 + 0.48 * 48)) / 13
BASELINE_RAYS_PER_S = HBM_BYTES_PER_S / BYTES_PER_QUERY

PARAM_KEYS = ("materials", "env_image")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m pnraytracing_tpu_torch.bench",
        description="rays/s/chip of the flagship configuration")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--frames", type=int, default=8,
                    help="total timed frames (1 spp each)")
    ap.add_argument("--frames-per-call", type=int, default=1,
                    help="frames accumulated by one call (replays of the "
                    "captured frame; with --bwd, frames of one step)")
    ap.add_argument("--warmup", type=int, default=1, help="warmup calls")
    ap.add_argument("--bwd", action="store_true",
                    help="benchmark forward+backward instead of forward")
    ap.add_argument("--no-replay", action="store_true",
                    help="with --bwd: differentiate the live integrator "
                    "instead of the trace/replay split")
    ap.add_argument("--env-height", type=int, default=256)
    ap.add_argument("--loop", default="unroll", choices=["unroll", "scan"],
                    help="bounce-loop construction")
    ap.add_argument("--trav-tile", type=int, default=None,
                    help="traversal tile size; 0 = untiled; default = "
                    "RenderConfig default")
    ap.add_argument("--traversal", default="pallas", choices=TRAVERSALS,
                    help="the walk (default 'pallas': the resident wide "
                    "kernels)")
    ap.add_argument("--trav-chunk", type=int, default=None,
                    help="traversal loop chunk; default = RenderConfig "
                    "default")
    ap.add_argument("--no-compact", action="store_true")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable fused NEE shadow rays")
    ap.add_argument("--sort-rays", action="store_true",
                    help="coherence-sort live rays when compacting")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions "
                    "(smoke testing)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress phase-progress lines on stderr")
    return ap.parse_args(argv)


def render_config(args: argparse.Namespace):
    """The bench's ``RenderConfig``: the flags' overrides of the
    defaults, as ``bench.py`` builds them."""
    from pnraytracing_tpu_torch.core.config import RenderConfig

    overrides = {"traversal": args.traversal}
    if args.trav_tile is not None:
        overrides["trav_tile"] = args.trav_tile if args.trav_tile > 0 else None
    if args.trav_chunk is not None:
        overrides["trav_chunk"] = args.trav_chunk
    if args.no_compact:
        overrides["compact_rays"] = False
    if args.no_fuse:
        overrides["fuse_shadows"] = False
    if args.sort_rays:
        overrides["sort_rays"] = True
    return RenderConfig(width=args.width, height=args.height,
                        max_depth=args.depth, loop=args.loop, **overrides)


def frames_loss_and_grad(params: dict, scene, o, d, px, py, start: int,
                         k: int, target: torch.Tensor, cfg,
                         replay: bool = True, eager: bool = False):
    """``(loss, grads)`` of the JAX bench's ``--bwd`` step: the mean over
    frames ``start`` .. ``start + k - 1`` of each frame's
    ``mean((img - target) ** 2)``, summed in frame order, and its
    gradient to ``params`` (``diff/grad.py::frames_loss``).
    ``diff/grad.py``'s other losses are another quantity for ``k >= 2``
    (the dual-buffer estimator, or the squared error of the mean of the
    frames), so the step is built from its parts, as ``bench.py`` builds
    it.  ``replay``: the walks run once a frame, forward only
    (``trace_paths``), then one backward through the walk-free
    ``render_rays_replay``; else the live integrator
    (``render_image_from_params``) is differentiated.  On the card the
    step replays its captured program (``diff/program.py``, captured at
    the first call), the counterpart of the JAX bench's jitted step;
    ``eager=True``, and the CPU, run it op by op."""
    from pnraytracing_tpu_torch.diff.grad import step_loss_and_grad

    return step_loss_and_grad("frames", params, scene, o, d, px, py, start,
                              target, cfg, eager, k=k, replay=replay)


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]


def main(argv=None) -> int:
    args = parse_args(argv)
    t_start = time.perf_counter()

    def phase(msg: str) -> None:
        """Crash forensics: the last phase line says which call was in
        flight when a run dies."""
        if not args.quiet:
            print(f"[bench +{time.perf_counter() - t_start:7.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "false); pass --cpu to run on the host")
    dev = torch.device("cpu" if args.cpu else "cuda")

    from pnraytracing_tpu_torch.core.camera import camera_rays
    from pnraytracing_tpu_torch.render.renderer import (
        pixel_coords,
        render_average,
    )
    from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

    k = max(1, args.frames_per_call)
    n_calls = max(1, args.frames // k)
    frames = n_calls * k
    cfg = render_config(args)
    scene, cam_state = config3_teapot_night(env_height=args.env_height,
                                            device=dev)
    cam_state.aspect = args.width / args.height
    camera = cam_state.basis(device=dev)
    phase(f"scene on device ({dev.type})")

    if args.bwd:
        from pnraytracing_tpu_torch.diff.grad import extract_params

        px, py = pixel_coords(cfg, dev)
        o, d, _ = camera_rays(camera, cfg.width, cfg.height)
        params = extract_params(scene, PARAM_KEYS)
        target = torch.zeros((cfg.num_pixels, 3), dtype=torch.float32,
                             device=dev)

        def run(call_idx):
            # a fetch of the loss waits for the whole step: the stream runs
            # in order and the fetch is enqueued last (on the card after
            # the step's graph and the copy of its loss)
            loss, _ = frames_loss_and_grad(params, scene, o, d, px, py,
                                           call_idx * k, k, target, cfg,
                                           replay=not args.no_replay)
            return loss
    else:

        def run(call_idx):
            return render_average(scene, camera, cfg, call_idx * k, k,
                                  device=dev).sum()

    from pnraytracing_tpu_torch.render.program import launch_counts

    def launched_since(before: dict) -> dict:
        return {k: v - before.get(k, 0) for k, v in launch_counts().items()
                if v != before.get(k, 0)}

    start = launch_counts()
    for i in range(args.warmup):
        phase(f"warmup call {i} (the first captures the frame or the step "
              "on the card)")
        float(run(0).item())
        phase(f"warmup call {i} fetched")

    warm = launch_counts()
    t0 = time.perf_counter()
    for i in range(n_calls):
        out = run(i)
    phase(f"{n_calls} timed calls dispatched; fetching")
    out.item()
    dt = time.perf_counter() - t0
    rays_total = cfg.num_pixels * (1 + 3 * cfg.max_depth) * frames
    phase(f"timed fetch complete: {rays_total} rays in {dt!r} s")
    # the kernels' launch counters (a captured frame or step counts at
    # its capture in the first warm-up call; its replays count nothing)
    phase(f"launches: warm-up {json.dumps(launched_since(start))}; timed "
          f"{json.dumps(launched_since(warm))}")
    if not args.quiet:
        print(nvidia_smi_line() if dev.type == "cuda" else "cpu",
              file=sys.stderr, flush=True)

    rays_per_s = rays_total / dt
    mode = "fwd+bwd" if args.bwd else "fwd"
    metric = (f"rays/s/chip {mode} ({args.width}x{args.height}, 1spp, "
              f"{args.depth} bounces, teapot_night)")
    print(json.dumps({
        "metric": metric,
        "value": round(rays_per_s, 1),
        "unit": "rays/s/chip",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
    }), flush=True)
    return 0


def _main_with_retry(argv=None) -> int:
    """A lost card poisons the process's CUDA context, so the only clean
    retry is a fresh process: after ``utils/resilience.wait_for_device``
    the bench re-execs itself once (guard ``PNRT_BENCH_RETRIED``).  Only
    a device loss (``is_device_loss``) is retried; any other error
    surfaces at once with its traceback."""
    from pnraytracing_tpu_torch.utils.resilience import (
        is_device_loss,
        wait_for_device,
    )

    try:
        return main(argv)
    except Exception as e:
        if not is_device_loss(e):
            raise
        msg = f"{type(e).__name__}: {e}"
        if os.environ.get("PNRT_BENCH_RETRIED"):
            print(f"bench failed twice: {msg}", file=sys.stderr)
            return 1
        print(f"bench attempt failed ({msg}); waiting for the card and "
              "retrying once in a fresh process", file=sys.stderr,
              flush=True)
        wait_for_device(log=lambda s: print(s, file=sys.stderr, flush=True))
        os.environ["PNRT_BENCH_RETRIED"] = "1"
        argv = sys.argv[1:] if argv is None else list(argv)
        os.execv(sys.executable, [sys.executable, "-m",
                                  "pnraytracing_tpu_torch.bench", *argv])
        return 1  # not reached: execv replaces the process


if __name__ == "__main__":
    sys.exit(_main_with_retry())
