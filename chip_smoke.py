#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Drives the port's paths through ``render_frame`` — the flagship
teapot_night forward frame (512x512, 1 spp, 4 bounces, resident
kernels), the large config5 frame (102,404 triangles, brick-streaming
kernels) and config5 at 1,638,404 triangles (outside the packed layout:
the walk over the plain BVH), each eager and as one captured CUDA graph
replayed — then the gradient path and the multi-process paths of
``parallel/``, and holds every CUDA kernel against its plain PyTorch
version.  Each phase prints one JSON line; any failure raises and the
script exits non-zero without printing a result.  Phases:

1. device: the card's name and ``nvidia-smi`` name/power limit;
2. build: every ``csrc/*.cu`` compiled by ``nvcc`` in parallel, with the
   registers and spills ``-Xptxas -v`` reports;
3. scene: the flagship scene built by the port on the card, with the
   registers, local memory and blocks an SM of the resident wide kernels;
4. kernel parity: each kernel against its plain version on the rays one
   plain-path frame hands it (primary rays, the bounce-0 sort-key rays,
   the bounce-0 fused shadow batch and continuation rays): results, the
   interaction fill and the per-ray walk stats equal; the key kernel
   against the all-K plain version and against the plain version of its
   own walk (keys and test counts) on the bounce-0 and bounce-1 key rays
   and on a synthetic set (origins outside the scene, axis-parallel and
   zero directions, rays that enter nothing, non-finite lanes), then
   ``key_figures`` lines: union and member tests a ray and a warp, the
   share of rays that end at an entry of 0 or enter no box;
5. frame parity: a 128x128 depth-4 frame through the kernels and through
   the plain versions;
6. flagship: launch counts of one frame (counters zeroed just before),
   ms/frame and rays/s over 10 frames after 2 warm-up frames, each
   kernel's time by CUDA events at its path shapes beside its plain
   version's time and its bound, and peak device memory; a
   ``walk_figures`` line says how the wide walks run on those rays
   (pops, leaf pops and triangle tests a ray, SIMT efficiency, the share
   of warp iterations with lanes in both branches, bytes touched);
7. profile: one flagship frame under torch.profiler — device busy time,
   the top device kernels, and the idle share: busy time over the
   unprofiled ms/frame of phase 6 (the profiler slows the host);
8. program: the flagship frame captured once as a CUDA graph
   (render/program.py) and replayed: launches at capture, replays equal
   the eager frames bit for bit, capture seconds and pool bytes, ms/frame
   eager and replayed in alternating rounds (with the SM clock,
   temperature and power draw before and after), one replayed frame under
   the profiler (``program_profile``), ``render_average`` with spp=8
   against the eager mean, device memory with the programs alive;
9. session: a ``RenderSession`` on the flagship, each step against the
   eager frame it stands for (samples, a material edit, an orbit, the
   previews), and the steps' times; then ``app`` (utils/resilience.py
   and scripts/): ``app/probe`` (``probe_device`` on the card),
   ``app/resilient`` (a ``ResilientRenderLoop`` on the flagship at
   512x512 depth 4, 8 samples, its worker SIGKILLed with sample 2 in
   flight: one loss recovered, the image bit for bit an uninterrupted
   loop's and within 1e-6 of ``render_average``, each worker's captured
   frame 5 / 4 / 2 launches of kernels 1, 2, 4; worker start and
   recovery seconds, ms a sample through the worker beside in process),
   ``app/cli`` (the render CLI on the flagship, its PNG equal to
   ``render_average``'s; ``--model`` on a written OBJ and ``--sharded``
   under torchrun, PNGs equal; ``--model`` with ``--traversal wide4``,
   its worker's frame through the 4-wide kernels; ``optimize``,
   ``interactive`` on a
   command script, ``gallery``; all at once, each one's seconds and
   return code) and ``app/sticky`` (a device-side assert in a process
   of its own: not a device loss, raised by ``run_resilient`` after one
   call, the next op of that process failing, a fresh process working);
   then ``grad``, the gradient path
   (diff/grad.py) on the flagship at 512x512 depth 4: ``trace_paths``
   through kernels 1, 2, 4 (launches counted) with its records equal
   bit for bit to those of the plain walks on the card, the replay
   against the eager live frame (max difference, share differing), the
   replay gradient of materials and env texels at spp 2 (trace, replay
   forward and backward ms, peak memory, gradient norms; finite and
   non-zero; ``grad_profile``: one replay forward and one backward
   under the profiler, the backward's device busy ms beside its budget
   ``BACKWARD_BUDGET_MS``); the step as one captured CUDA graph
   (diff/program.py, ``captured_replay``): launches at capture, capture
   seconds and pool bytes, the replayed step against the eager step
   (loss and every gradient leaf bit for bit; wall ms, device busy ms
   and idle share of both); two runs of one step (materials, env texels
   and vertex positions) equal bit for bit and equal to the eager step,
   the live gradient (kernels 3, 2, 4; captured and eager as the
   replay's, ``captured_live``; its gradient within 1e-4 in norm of the
   replay's on the same route, ``kernel_interaction=False``; the default
   route's distance beside it), one positions step with
   ``refit_scene`` (host ms; the refit scene traced through the same
   kernels and captured anew) and three ``adam_optimize`` steps (one
   capture, losses and parameters equal to the eager run's, step ms;
   a positions run's captures); ``grad_stream`` at the end of phase 16 traces
   config5 at 128x128 depth 2 through the stream kernels, records equal
   to the plain stream walks';
10. binary: the binary pop-test kernels (the ``variant="binary"`` entry
   point, which the integrator never routes to) against their plain
   versions on the flagship rays of phase 4, stats included, timed;
    then ``compat_kernels`` and ``compat`` for the flagship: the compat
   instantiation of each resident walk kernel against its compat plain
   version on the bounce-0 continuation / shadow rays of a 512x512
   compat frame and on synthetic rays with d.z = +-0, 1e-31 and
   subnormal (results and stats equal), timed beside the default
   instantiation with pops a ray and bound; a 128x128 depth-4 compat
   frame against the plain versions, replayed against eager, and
   ``probe_pixel`` against its pixel; the 512x512 depth-4 compat frame's
   launches at capture (5 / 4 / 2), replay equal to eager, ms/frame,
   one replayed compat frame under the profiler (``compat_profile``);
11. options: each ray-ordering and sampling option of ``RenderConfig``
   (``compact_rays``, ``sort_rays``, ``sort_key``, ``fuse_shadows``,
   ``jitter_primary``, ``loop``) on the flagship: a 128x128 depth-2
   frame through the kernels against the plain versions and replayed
   against eager, the launches of its 512x512 frame against the expected
   table, and for the default and four options ms/frame eager and
   replayed (two rounds of opposite order) and one profiled frame's
   device busy time and port kernels' sum;
12. catalog: each untextured catalog scene (``cornell_box`` with both
   centerpieces, ``scene_flat``, ``teapot_scene``, ``config2_teapot``)
   built on the card, the launches of one 128x128 depth-2 frame and that
   frame through the kernels against the plain versions;
13. textures: ``config1_triangle`` and ``config4_marry`` (and config 4
   with ``texture_lod_scale``) the same way, and replayed against eager;
14. stream_scene: config5_large built by the port on the card, with its
   default brick layout and the registers, block size and blocks an SM
   of the stream kernels;
15. stream_parity: the stream kernels against their plain versions on
   the rays of one plain-path config5 frame (primary, bounce-0
   continuation, bounce-0 fused shadows): results and per-ray walk stats
   equal; the resident wide kernels on the same rays (the bricks
   cover the tree); the binary kernels against their plain versions,
   stats included; the key kernel on config5's bounce-0 key rays;
16. stream_frame: launch counts of one config5 512x512 depth-4 frame, a
   128x128 depth-4 frame through the kernels against the plain versions,
   ms/frame and rays/s, peak memory, the stream kernels' times beside
   the resident kernel's and beside their own on a 96 KB brick layout of
   the same tree, the resident wide and the binary kernels' times and
   ``walk_figures`` on config5's rays, and one profiled frame; then
   ``compat_kernels`` and ``compat`` for config5 (the stream kernels'
   compat forms, launches 5 + 4 + 2) and phase 8 for config5;
17. parallel (``parallel/`` on ``torch.distributed``, after the
   gradient phases, with config5 from phase 14): in this process a world
   of one (NCCL) runs the sharded flagship frame (bit for bit the eager
   frame), the data-parallel gradient replayed and live (bit for bit
   the single-process step, whose second run must equal the first; a
   lost rank's chunk must read above ``DP_REL``),
   the primitive-sharded closest and any hit over config5's 102,404
   triangles (kernels 5, 6 and 5*, 6*; ``t`` and occlusion equal to the
   unsharded binary walk's), the same combine over 8 shards walked in
   this process (default and compat), kernels 5, 6, 5* and 6* against
   their plain versions at those shapes, and config5's 128x128 depth-2
   sharded frame (kernel 7); then a world of two processes on the one card (gloo:
   NCCL refuses two ranks on one device) runs the same paths with 2
   shards, each result equal to world one's (frames bit for bit); and
   the leaf cap of the primitive walks: shards of 6-triangle leaves
   (``leaf_cap_soup`` built with ``max_leaf_size=8``) walked by kernels
   5 / 6 at the default cap of 4, equal to their plain versions at that
   cap, and the caps 4 and 8 giving other hits.  Each
   path's launches are counted with the counters zeroed just before it;
   ms of each sharded call and of its collective alone, the dp step's
   trace / forward / backward / all-reduce ms, the primitive walks' ms
   beside the unsharded walk's.  No scaling figure: both ranks share one
   card;
18. assets (between phases 16 and 17): everything loaded is written
   first into a temporary directory.  ``config4_marry`` through its OBJ
   branch, then its MTL-only branch (``marry.obj`` with two MTL
   materials and a ``map_Kd`` PNG): route ``wide``, kernels 3, 2, 4
   launched 5 + 4 + 2 times a 512x512 depth-4 frame, eager and replayed
   ms/frame, the 128x128 depth-2 frame against the plain versions;
   config5's 102,404 triangles written as .obj (with its MTL), binary
   .ply, .glb and binary .fbx, each loaded by ``io.load_model`` into the
   written arrays, the native and the pure-Python OBJ loaders timed side
   by side, the native and numpy BVH builders on that geometry (seconds,
   the numpy one in a worker process beside the frames; both trees
   valid and equal), and the scene built from
   the OBJ through route ``stream`` (kernels 7c, 7a, 4) the same way as
   config 4's; the native library must be built (g++ exists wherever
   nvcc does) and every ``io`` dispatcher runs it, timed beside its
   pure-Python path with equal results;
19. bvh (after phase 18, before 17): scenes outside the packed layout.
   ``config5_large(subdiv=8)`` (1,638,404 triangles > 2^20) built on the
   host: no traversal layout, route ``bvh``; the walk over the plain BVH
   (csrc/traverse_bvh.cu, default and compat) against its plain version
   on 65,536 of its 512x512 bounce-0 continuation and fused shadow rays
   (tri mismatches <= 0.001%, t / b equal bit for bit where tri is,
   occlusion and [3, R] stats exact), timed on all of them; its 512x512
   depth-4 frame (5 + 4 launches of the new walk, no key kernel), phase
   8 on it, its 128x128 depth-2 frame against the plain versions;
   ``config2_teapot(flat_bvh=True)`` (max_leaf_size = its triangle
   count) at 128x128 depth 2 against the packed-route frame of
   ``config2_teapot()``; route ``binary``: config5 (subdiv 6) without its
   stream layout through kernels 5 / 6, launches and 128x128 parity.

20. traversal (after phase 19, before 17): ``RenderConfig.traversal``'s
   six values (``pallas``, ``packed``, ``pop``, ``packet``, ``wide``,
   ``wide4``) on the flagship at 512x512 depth 4: each value's launches
   (its kernels: the packed walk of csrc/traverse_bvh.cu, kernels 5 / 6,
   3 / 2 with the leaf cap, the 4-wide walk of csrc/traverse_wide4.cu
   with kernels 5 / 6 as its fallback), ms/frame eager and replayed,
   replay = eager bit for bit, the image within atol 3e-5 of the
   ``pallas`` frame with ``kernel_interaction=False`` on all but 0.02%
   of pixels; compat frames under ``packed`` and ``wide4``; the packed
   and 4-wide kernels (default and compat) against their plain versions
   on the flagship's bounce-0 rays (tri mismatches <= 0.001%, t / b
   equal where tri is, occlusion, overflow and stats exact; the 4-wide
   walk at 32 and 4 buffer slots, and with its fallback against the
   packed walk), timed with bounds and what holds them back; config5
   under ``packed`` and ``wide4`` (launches, eager and replayed ms,
   against its ``pallas`` frame) and ``collapse_binary``'s seconds on
   its tree; a scene of 6-triangle leaves at 128x128 depth 2 under
   ``pop``, ``wide`` and ``pallas`` against the plain versions (the cap
   of 4 changes its image).

21. bench (after phase 17): the repo's entry points as the port has
   them.  ``python -m pnraytracing_tpu_torch.bench`` forward, ``--bwd
   --frames 2`` and ``--bwd --no-replay --frames 2``, each a process of
   its own, one after another: one JSON line of ``bench.py``'s form,
   the card's ``nvidia-smi`` line last on stderr; ``entry()``'s step
   twice, bit for bit, and equal to the replayed flagship frame, its
   launches of kernels 1, 2, 4; ``dryrun_multichip(2,
   backend="gloo")``, two processes on the one card, each rank's
   launches of kernels 5 / 6 (the ``packet`` walk).

Phases 1-7 and 10-20 run the eager frame (``render_frame(...,
eager=True)``), whose launch counters count each frame.

Then the ``{"kernels": [...]}`` line (each row with its launches on
phase 17's paths by world and path: ``parallel_launches``, and
``primitive_launches`` for the primitive queries; ``assets_launches``
on phase 18's scenes; ``bench_launches``, ``entry()``'s step and each
dryrun rank (phase 21); ``app_launches``, a captured flagship frame in
the resilient loop's worker and in the render CLI's (phase app);
kernels 5 / 6 their ``binary_route_launches`` and
the new walk its ``probe_pixel_launches`` of phase 10; every row its
``traversal_launches``, one flagship frame under each value of phase
20), the nvidia-smi
line,
and last the ``{"ok": true, "device": ...}`` line.  Imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations per test, counted from csrc/traverse.cu and entry_key.cu:
# slab test 6 sub + 6 mul + 11 min/max + 2 compares; watertight triangle
# test 9+6+3+2+2 add/sub, 6+3+6+3+1 mul, 1 div, ~8 compares.  The fp32
# rate counts an FMA as two operations; the kernels are built without
# FMAs, so the time to dispatch their instructions is about twice this
# bound.
OPS_AABB = 25
OPS_TRIANGLE = 50
OPS_ENTRY_BOX = 25
ROW_BYTES = 64  # one wide row
TRI_BYTES = 36  # one triangle's nine corner words (tri9, the bricks)
TRI12_BYTES = 48  # one padded triangle row (tri12, the resident wide walks)
ATTR_BYTES = 64  # one tri_attr16 row, read once per ray that hits

RAY_IN = 4 * 7 + 1  # bytes in per ray: ox..dz, t_max (f32) + mask (bool)

WIDTH = HEIGHT = 512
DEPTH = 4
QUERIES_PER_FRAME = WIDTH * HEIGHT * (1 + 3 * DEPTH)  # as bench.py counts
PARITY_SIZE = 128
# depth of the option, catalog and textured parity frames: both sorted
# bounces (sort_max_bounce=2), past which the ordering and sampling
# options run the default's kernels; the flagship's and config5's parity
# frames and those of FULL_DEPTH_OPTIONS keep DEPTH
PARITY_DEPTH = 2
# the flagship gradient's backward (phase grad) took 46.4 ms of device time
# when the gathers' backward was index_select's atomic index_add (PERF.md,
# section 5); its fixed-order sums (ops/gather.py) may take up to 25% more
BACKWARD_BUDGET_MS = 1.25 * 46.4


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``elapsed_s``)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gpu_clocks() -> str:
    """The card's SM clock, temperature and power draw now, as
    ``nvidia-smi --query-gpu=clocks.sm,temperature.gpu,power.draw``
    gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Swaps the walk wrappers (``accel/walks.py``) and the integrator's
    key and shade choice for recording versions that clone their inputs
    and compute with the plain versions, so one frame yields the path's
    real kernel inputs without launching a kernel."""

    def __init__(self, integrator, traverse, stream, compaction):
        from pnraytracing_tpu_torch.accel import traverse as bvh_walk
        from pnraytracing_tpu_torch.accel import traverse_packed as trp
        from pnraytracing_tpu_torch.accel import traverse_wide4 as tw4
        from pnraytracing_tpu_torch.accel import walks

        def by_variant(wide, binary):  # the resident walks' variant=
            return lambda *a, variant="wide", **kw: (
                binary if variant == "binary" else wide)(*a, **kw)

        plain = {
            "closest_hit_attr": traverse.plain_closest_hit_attr,
            "closest_hit": by_variant(traverse.plain_closest_hit,
                                      traverse.plain_closest_hit_binary),
            "any_hit": by_variant(traverse.plain_any_hit,
                                  traverse.plain_any_hit_binary),
            "closest_hit_stream": stream.plain_closest_hit_stream,
            "any_hit_stream": stream.plain_any_hit_stream,
            "closest_hit_bvh": bvh_walk.plain_closest_hit,
            "any_hit_bvh": bvh_walk.plain_any_hit,
            # the walks of the XLA traversal values (the 4-wide walk's
            # fallback is the recorded pop walk)
            **{f"{q}_hit_{v}": trp.plain(f"{q}_hit_{v}")
               for q in ("closest", "any")
               for v in ("packed", "pop", "packet", "wide")},
            "closest_hit_wide4": tw4.plain_closest_hit_wide4,
            "any_hit_wide4": tw4.plain_any_hit_wide4,
        }
        own = {
            # the all-K plain version keys from the boxes alone
            "entry_key": lambda o, d, treelets, tree:
                compaction.treelet_entry_key(o, d, treelets),
            # the shade phase's plain version (ops/shade.py::shade_plain)
            "shade_on_card": lambda *a, **kw: False,
        }
        swaps = [(walks, n, fn) for n, fn in plain.items()] + [
            (integrator, n, fn) for n, fn in own.items()]
        self.saved = [(mod, n, getattr(mod, n)) for mod, n, _ in swaps]
        self.calls: list[tuple[str, tuple]] = []
        for mod, n, fn in swaps:
            setattr(mod, n, self._recording(n, fn))

    def _recording(self, name, fn):
        def call(*args, **kw):
            self.calls.append((name, _clone(args)))
            return fn(*args, **kw)
        return call

    def restore(self):
        for mod, n, f in self.saved:
            setattr(mod, n, f)

    def by_name(self) -> dict:
        out = {}
        for name, args in self.calls:
            out.setdefault(name, []).append(args)
        return out


def record_frame(render_frame, scene, camera, cfg, dev, *modules):
    """Run one frame with every kernel replaced by its plain version;
    returns (image, the recorded kernel inputs by wrapper name)."""
    rec = Recorder(*modules)
    try:
        img = render_frame(scene, camera, cfg, 0, device=dev)
    finally:
        rec.restore()
    return img, rec.by_name()


def zero_counts(*tables) -> None:
    for counts in tables:
        for k in counts:
            counts[k] = 0


def bound(bytes_, ops):
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over the fp32 rate, and which side it is."""
    b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def trav_ops(stats, binary=False):
    """Operations of a walk from its per-ray stats: slab tests (two per
    internal pop of a wide walk, one per pop of the binary walk) and
    triangle tests."""
    pops, leaf, tris = (int(s.sum()) for s in stats[:3])
    slabs = pops if binary else 2 * (pops - leaf)
    return OPS_AABB * slabs + OPS_TRIANGLE * tris


def spread(x) -> dict:
    """mean, median, 99th percentile and maximum of a per-ray count."""
    import torch

    xf = x.to(torch.float32)
    q = torch.quantile(xf[:: max(1, xf.numel() // (1 << 20))],
                       torch.tensor([0.5, 0.99], device=x.device))
    return {"mean": float(xf.mean()), "p50": float(q[0]),
            "p99": float(q[1]), "max": int(x.max())}


def walk_figures(st, tri_bytes=TRI12_BYTES, fills=0) -> dict:
    """What a walk's per-ray stats ([>=3, R]: pops, leaf pops, triangle
    tests) say about how it runs, with rays grouped 32 by 32 in launch
    order as the warps take them:

    * ``simt_efficiency``: sum(x) / (32 * sum over warps of max(x in the
      warp)) for pops and for triangle tests: the share of lane slots
      that do work while a warp runs as long as its longest ray;
      ``pops_packed`` is the same with the idle rays (``idle_share``: no
      pop at all, so masked) taken out and the rest kept in order, which
      says how much of the loss is masked lanes and how much divergence;
    * ``both_branches``: the share of a warp's iterations (max pops in
      the warp) in which some lane pops a leaf while another pops a row.
      Per-ray counts do not give the order of pops, so three figures:
      ``lower`` = (max leaf pops + max row pops - iterations)+, ``upper``
      = min(iterations, sum of leaf pops, sum of row pops), both summed
      over warps and divided by the iterations, and ``estimate``, which
      places each lane's leaf and row pops uniformly at random among the
      warp's iterations: 1 - P(no leaf lane) - P(no row lane) +
      P(neither), averaged with the iterations as weights;
    * ``longest_warp_pops``: the most iterations any warp runs, and
      ``mean_warp_pops`` the mean over warps;
    * ``touched_bytes``: 64 B a row pop + ``tri_bytes`` a triangle test +
      64 B for each of ``fills`` attribute rows, and ``touched_hbm_ms``,
      those bytes at the HBM rate (they come from L1/L2: the tables are
      far smaller)."""
    import torch

    pops, leaf, tris = (s.to(torch.int64) for s in st[:3])
    r = pops.numel()
    pad = (-r) % 32
    warp = lambda x: torch.nn.functional.pad(x, (0, pad)).view(-1, 32)
    wp, wl, wt = warp(pops), warp(leaf), warp(tris)
    wn = wp - wl  # row pops
    iters = wp.amax(dim=1)  # iterations a warp runs
    tot = max(int(iters.sum()), 1)
    eff_t = int(tris.sum()) / max(32 * int(wt.amax(dim=1).sum()), 1)
    busy = pops[pops > 0]
    packed = torch.nn.functional.pad(busy, (0, (-busy.numel()) % 32))
    eff_packed = int(busy.sum()) / max(
        32 * int(packed.view(-1, 32).amax(dim=1).sum()), 1)
    lower = (wl.amax(dim=1) + wn.amax(dim=1) - iters).clamp(min=0)
    upper = torch.minimum(iters, torch.minimum(wl.sum(dim=1), wn.sum(dim=1)))
    w = iters.clamp(min=1).to(torch.float64)[:, None]
    p_leaf, p_row = wl / w, wn / w  # a lane's chance to be in that branch
    no_leaf = (1 - p_leaf).prod(dim=1)
    no_row = (1 - p_row).prod(dim=1)
    neither = (1 - p_leaf - p_row).clamp(min=0).prod(dim=1)
    both = (1 - no_leaf - no_row + neither).clamp(min=0)
    rows_b = ROW_BYTES * int((pops - leaf).sum())
    bytes_ = rows_b + tri_bytes * int(tris.sum()) + ATTR_BYTES * int(fills)
    return {
        "rays": r, "pops": spread(pops), "leaf_pops": spread(leaf),
        "tri_tests": spread(tris),
        "idle_share": 1.0 - busy.numel() / max(r, 1),
        "simt_efficiency": {"pops": int(pops.sum()) / (32 * tot),
                            "pops_packed": eff_packed, "tri_tests": eff_t},
        "both_branches": {"lower": int(lower.sum()) / tot,
                          "estimate": float((both * iters).sum()) / tot,
                          "upper": int(upper.sum()) / tot},
        "longest_warp_pops": int(iters.max()),
        "mean_warp_pops": tot / iters.numel(),
        "touched_bytes": bytes_,
        "touched_hbm_ms": bytes_ / HBM_BYTES_PER_S * 1e3}


def key_figures(counts, key, o, d, tree, k_total) -> dict:
    """What the key walk's per-ray counts ([2, R]: union tests, member
    tests) say about how it runs: tests a ray; ``warp_tests``, the tests
    a warp of 32 consecutive rays executes (one test an iteration, so as
    many as its longest lane); ``simt_efficiency`` = sum(tests) / (32 *
    sum of warp_tests); the share of rays that end at a best entry of 0
    (the winning box holds the origin) and the share that enter no box
    (key ``K*8 + octant``)."""
    import torch

    from pnraytracing_tpu_torch.ops.compaction import slab_entry
    from pnraytracing_tpu_torch.ops.intersect import safe_inv_dir

    unions, members = counts[0].to(torch.int64), counts[1].to(torch.int64)
    tot = unions + members
    r = tot.numel()
    p = tree.shape[0] // 2
    per_warp = torch.nn.functional.pad(tot, (0, (-r) % 32)).view(
        -1, 32).amax(dim=1)
    k = (key // 8).to(torch.int64)
    none = k >= k_total
    t_near, _ = slab_entry(tree[p + k.clamp(max=k_total - 1)], o.x, o.y, o.z,
                           safe_inv_dir(d.x), safe_inv_dir(d.y),
                           safe_inv_dir(d.z))
    return {"rays": r, "union_tests": spread(unions),
            "member_tests": spread(members), "tests": spread(tot),
            "warp_tests": spread(per_warp),
            "simt_efficiency": int(tot.sum()) / max(
                32 * int(per_warp.sum()), 1),
            "ends_at_zero_share": float(((t_near == 0) & ~none).sum()) / r,
            "enters_none_share": float(none.sum()) / r}


def synthetic_key_rays(treelets, device, n=4096, seed=0):
    """``(o, d)`` of ``n`` key rays (a multiple of 8) that the frames do
    not send, in eighths: origins outside the scene's box aimed into it;
    axis-parallel directions (one and two zero components) from inside;
    rays aimed away that enter nothing; origins on box corners; all-zero
    directions; then three eighths of rays from inside with one
    non-finite component each (a NaN or an infinity in the origin or the
    direction, and both infinite on one axis)."""
    import torch

    from pnraytracing_tpu_torch.core.vec import V3

    g = torch.Generator().manual_seed(seed)
    tre = treelets.detach().cpu()
    lo, hi = tre[:, :3].amin(dim=0), tre[:, 3:].amax(dim=0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2 + 1e-3
    m = n // 8
    unit = lambda v: v / v.norm(dim=1, keepdim=True)
    rand = lambda k: torch.rand((k, 3), generator=g) * 2 - 1
    inside = lambda k: mid + rand(k) * half
    shell = lambda k: mid + unit(rand(k)) * half.norm() * 3
    o_out = shell(m)
    d_in = unit(inside(m) - o_out)
    d_axis = unit(rand(m))
    d_axis[torch.arange(m), torch.randint(0, 3, (m,), generator=g)] = 0.0
    d_axis[: m // 2, 0] = 0.0
    o_away = shell(m)
    corner = tre[torch.randint(0, tre.shape[0], (m,), generator=g)]
    pick = torch.rand((m, 3), generator=g) < 0.5
    o_corner = torch.where(pick, corner[:, :3], corner[:, 3:])
    o_bad, d_bad = inside(3 * m), unit(rand(3 * m))
    inf, nan = float("inf"), float("nan")
    row = torch.arange(3 * m)
    col = torch.randint(0, 3, (3 * m,), generator=g)
    kind = row % 6
    for j, (tensor, value) in enumerate(((o_bad, nan), (d_bad, nan),
                                         (o_bad, inf), (d_bad, -inf),
                                         (o_bad, -inf), (d_bad, inf))):
        sel = kind == j
        tensor[row[sel], col[sel]] = value
    both = kind == 4  # an infinite origin AND direction on that axis
    d_bad[row[both], col[both]] = inf
    o = torch.cat([o_out, inside(m), o_away, o_corner, inside(m), o_bad])
    d = torch.cat([d_in, d_axis, unit(o_away - mid), unit(rand(m)),
                   torch.zeros((m, 3)), d_bad])
    v3 = lambda a: V3(*(a[:, k].contiguous().to(device) for k in range(3)))
    return v3(o.float()), v3(d.float())


def compat_rays(treelets, device, n=4096, seed=1):
    """``(o, d)`` of ``n`` rays (a multiple of 8) from inside the scene's
    box in random directions, of which one eighth each has d.z = +0,
    d.z = -0 (the compat watertight test swaps its axes), d.z = 1e-31 (it
    keeps z, and its shears overflow to NaN) and a subnormal d.z (1 / d.z
    is inf)."""
    import torch

    from pnraytracing_tpu_torch.core.vec import V3

    g = torch.Generator().manual_seed(seed)
    tre = treelets.detach().cpu()
    lo, hi = tre[:, :3].amin(dim=0), tre[:, 3:].amax(dim=0)
    o = lo + torch.rand((n, 3), generator=g) * (hi - lo)
    d = torch.randn((n, 3), generator=g)
    m = n // 8
    d[:4 * m, 2] = 0.0
    d = d / d.norm(dim=1, keepdim=True)
    for k, dz in enumerate((0.0, -0.0, 1e-31, -1e-39)):
        d[k * m:(k + 1) * m, 2] = dz
    v3 = lambda a: V3(*(a[:, k].contiguous().to(device) for k in range(3)))
    return v3(o.float()), v3(d.float())


def check_key(name, compaction, o, d, treelets, tree) -> dict:
    """The key kernel on these rays against the all-K plain version
    (keys) and against the plain version of its own walk (keys and
    counts): 0 mismatches demanded."""
    import torch

    key, counts = compaction.entry_key(o, d, treelets, tree, with_stats=True)
    want = compaction.treelet_entry_key(o, d, treelets)
    wkey, wcounts = compaction.entry_key_walk(o, d, tree, treelets.shape[0])
    out = {"rays": int(key.numel()),
           "mismatch_all_k": int((key != want).sum()),
           "mismatch_walk": int((key != wkey).sum()),
           "counts_equal": bool(torch.equal(counts, wcounts)),
           "tests_per_ray": float(counts.sum()) / max(key.numel(), 1)}
    if out["mismatch_all_k"] or out["mismatch_walk"] or not (
            out["counts_equal"] and counts.shape == (2, key.numel())):
        raise AssertionError(f"entry_key/{name}: {out}: the kernel must "
                             "equal both plain versions, counts included")
    return out


def record_inputs(render_frame, scene, camera, cfg, dev, module,
                  name="entry_key"):
    """The inputs of every call of ``module``'s ``name`` wrapper (the
    integrator's, or a walk of ``accel/walks.py``) in one frame through
    the kernels."""
    saved, calls = getattr(module, name), []

    def call(*args, **kw):
        calls.append(_clone(args))
        return saved(*args, **kw)

    setattr(module, name, call)
    try:
        render_frame(scene, camera, cfg, 0, device=dev)
    finally:
        setattr(module, name, saved)
    return calls


def check_stats(name, got, want) -> None:
    """A kernel's per-ray walk stats against its plain version's."""
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: walk stats differ from the plain "
                             "version")


def port_kernel_name(key: str):
    """The LAUNCHES name of one of the port's kernels from its profiler
    key (demangled "closest_hit_kernel<true, false>" or mangled
    "...ILb1ELb0EE"), else None.  The walk kernels' last boolean template
    flag is the compat one; the resident closest kernel's, the stream
    kernel's, the BVH walk's and the 4-wide walk's first says attr /
    closest; the BVH walk over the packed rows (layout PackedRows) is
    the packed walk."""
    m = re.search(r"(closest_hit_binary|any_hit_binary|closest_hit|any_hit"
                  r"|entry_key|stream|bvh_walk|wide4_walk)_kernel"
                  r"(?:<([^>]*)>|I((?:Lb[01]E)+))?", key)
    if not m:
        return None
    base = m.group(1)
    if base == "entry_key":
        return "treelet_entry_key"
    flags = ([a.strip() == "true" for a in m.group(2).split(",")
              if a.strip() in ("true", "false")]
             if m.group(2) is not None else
             [f == "1" for f in re.findall(r"Lb([01])E", m.group(3) or "")])
    compat = "_compat" if flags and flags[-1] and (
        len(flags) == 2
        or base not in ("closest_hit", "stream", "bvh_walk",
                        "wide4_walk")) else ""
    first = bool(flags) and flags[0]
    q = "closest_hit" if first else "any_hit"
    if base == "closest_hit":
        base = "closest_hit_attr" if first else "closest_hit"
    elif base == "stream":
        base = q + "_stream"
    elif base == "bvh_walk":
        base = q + ("_packed" if "PackedRows" in key else "_bvh")
    elif base == "wide4_walk":
        base = q + "_wide4"
    return base + compat


def _clone(args):
    from pnraytracing_tpu_torch.core.vec import V3

    out = []
    for a in args:
        if isinstance(a, V3):
            a = V3(a.x.clone(), a.y.clone(), a.z.clone())
        elif hasattr(a, "clone"):
            a = a.clone()
        out.append(a)
    return tuple(out)


def ptxas_entry(lines, marker: str) -> list:
    """The ``-Xptxas -v`` lines of the entry function whose mangled name
    holds ``marker`` (its registers, stack and spills)."""
    out, keep = [], False
    for ln in lines:
        if "Compiling entry function" in ln:
            keep = marker in ln
        if keep:
            out.append(ln)
    return out


# bytes the shade kernel moves (csrc/shade.cu): every lane reads its live
# flag and seed and writes its outputs (the seed and `rows` floats, zeros
# on a dead lane); a live lane reads its other state (position, normal,
# view: 36; material id 4; pixel 16); the tables it gathers from
# (shade_table_bytes) are read once each, since they stay in L2
SHADE_LANE_BYTES = 1 + 8 + 8
SHADE_LIVE_BYTES = 36 + 4 + 16


def shade_table_bytes(scene, mat_rows) -> int:
    """Bytes of the tables the shade kernel gathers from, each once: the
    material rows, the lights' triangle ids, prefix areas, total and
    interaction rows (26 floats), the environment's alias rows and fat
    rows, and the Sobol directions (8 x 32 int64)."""
    n = 4 * mat_rows.numel() + 8 * 32 * 8
    lights = scene.lights.count
    n += lights * (4 + 4 + 26 * 4) + 4
    if scene.env is not None:
        n += 4 * scene.env.alias_x.numel() + 4 * scene.env.alias_fat.numel()
    return n


def elementwise_per_lane(fn, r: int) -> int:
    """Operations a lane of ``fn()``: the elements over ``r`` of every
    result of each ATen operation it runs that is not a view (a torch
    kernel writes them; each is one operation a lane at least)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    total = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor) and t.numel() >= r:
                        total[0] += t.numel() // r
            return out

    with Count():
        fn()
    return total[0]


def shade_row(render_frame, scene, camera, dev, integrator, built,
              path_launches) -> dict:
    """The shade kernel's row: one launch over the flagship's 262,144
    bounce-0 rays (teapot's flags: lights, environment, Sobol, the
    reference MIS), equal to the plain version on live lanes, timed
    beside it, with its bound, registers, spills and blocks an SM.
    ``path_launches`` holds what ``shade.LAUNCHES`` read on each path
    (the counted flagship frame, and the program's capture, added when
    phase ``program`` runs); ``launches`` is its eager frame's count."""
    import torch

    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.ops import shade

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    calls = record_inputs(render_frame, scene, camera, cfg, dev, integrator,
                          name="shade_bounce")
    if len(calls) != DEPTH:
        raise AssertionError(f"shade: {len(calls)} calls a frame, "
                             f"expected {DEPTH}")
    args = calls[0]
    state, active = args[3:], args[6]
    tbl = scene.materials.sanitized()
    got = shade.shade_bounce(*args)
    want = shade.shade_plain(scene, tbl, args[2], *state)
    bad = 0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise AssertionError("shade: the kernel and the plain version "
                                 "return other outputs")
        if g is None:
            continue
        for gc, wc in ([(g.x, w.x), (g.y, w.y), (g.z, w.z)]
                       if hasattr(g, "x") else [(g, w)]):
            bits = lambda x: (x.view(torch.int32)
                              if x.dtype == torch.float32 else x)
            bad += int((bits(gc[active]) != bits(wc[active])).sum())
    if bad:
        raise AssertionError(f"shade: {bad} live values differ from the "
                             "plain version")
    r, live = int(active.shape[0]), int(active.sum())
    n_out = sum(3 if hasattr(g, "x") else 1 for g in got[1:]
                if g is not None)
    table_bytes = shade_table_bytes(args[0], args[1])
    ops_lane = elementwise_per_lane(
        lambda: shade.shade_plain(scene, tbl, args[2], *state), r)
    bnd, by = bound(r * (SHADE_LANE_BYTES + 4 * n_out)
                    + live * SHADE_LIVE_BYTES + table_bytes,
                    live * ops_lane)
    ptx = ptxas_entry(built.get("shade", {}).get("ptxas", []),
                      "shade_bounce_kernelILb1ELb1ELb1ELb0E")
    return dict(
        name="shade", source="pnraytracing_tpu_torch/csrc/shade.cu",
        replaces="none: phase 1 of render/integrator.py::_render_rays",
        launches=path_launches["eager_frame"],
        path_launches=path_launches, rays=r, live_rays=live,
        mismatches=bad,
        ms=time_ms(lambda: shade.shade_bounce(*args), 50),
        plain_ms=time_ms(lambda: shade.shade_plain(scene, tbl, args[2],
                                                   *state), 5),
        bound_ms=bnd, bound_by=by, table_bytes=table_bytes,
        ops_per_live_lane=ops_lane,
        bound_formula=(f"max((R * ({SHADE_LANE_BYTES} + 4 * {n_out}) + "
                       f"live * {SHADE_LIVE_BYTES} + {table_bytes}) B / "
                       f"3.35 TB/s, live * {ops_lane} / 67 TFLOP/s)"),
        ptxas=ptx, **shade.kernel_info())


# bytes the tail kernel moves (csrc/shade.cu accumulate_bounce_kernel):
# every lane reads its live flag, radiance, throughput, sampled direction,
# position, normal and material id (1 + 5 x 12 + 4) and writes the state
# it rolls (15 floats, the material id, the live flag: 65); a live lane
# reads the NEE terms and flags, the sample's weight and pdf and its hit's
# triangle (55); a hit its interaction (normal, position, material id:
# 28) and its 12-byte emission row; an escaped ray its 48-byte quad row
TAIL_LANE_BYTES = 65 + 65
TAIL_LIVE_BYTES = 55
TAIL_HIT_BYTES = 28 + 12
TAIL_MISS_BYTES = 48


def accumulate_row(render_frame, scene, camera, dev, integrator, built,
                   path_launches) -> dict:
    """The tail kernel's row: one launch over the flagship's 262,144
    bounce-0 rays (teapot's flags: lights, environment, the reference
    MIS), every lane equal to the plain version bit for bit, timed beside
    it, with its byte bound (the per-lane bytes above, the material rows
    once), registers, spills and blocks an SM.  ``path_launches`` holds
    what ``shade.LAUNCHES["accumulate"]`` read on each path."""
    import torch

    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.ops import shade

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    calls = record_inputs(render_frame, scene, camera, cfg, dev, integrator,
                          name="accumulate_bounce")
    if len(calls) != DEPTH:
        raise AssertionError(f"accumulate: {len(calls)} calls a frame, "
                             f"expected {DEPTH}")
    args = calls[0]
    plain_args = (args[0], *args[2:])
    got = shade.accumulate_bounce(*args)
    want = shade.accumulate_plain(*plain_args)
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    bad = 0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise AssertionError("accumulate: the kernel and the plain "
                                 "version return other outputs")
        if g is None:
            continue
        for gc, wc in ([(g.x, w.x), (g.y, w.y), (g.z, w.z)]
                       if hasattr(g, "x") else [(g, w)]):
            bad += int((bits(gc) != bits(wc)).sum())
    if bad:
        raise AssertionError(f"accumulate: {bad} values differ from the "
                             "plain version")
    path, hit = args[5], args[10][0]
    r, live = int(path.active.shape[0]), int(path.active.sum())
    hits = int((path.active & hit.valid).sum())
    table_bytes = 4 * args[1].numel()
    ops_lane = elementwise_per_lane(
        lambda: shade.accumulate_plain(*plain_args), r)
    bnd, by = bound(r * TAIL_LANE_BYTES + live * TAIL_LIVE_BYTES
                    + hits * TAIL_HIT_BYTES
                    + (live - hits) * TAIL_MISS_BYTES + table_bytes,
                    live * ops_lane)
    ptx = ptxas_entry(built.get("shade", {}).get("ptxas", []),
                      "accumulate_bounce_kernelILb1ELb1ELb0ELb0E")
    return dict(
        name="accumulate", source="pnraytracing_tpu_torch/csrc/shade.cu",
        replaces="none: the NEE combine and the accumulate phase of "
                 "render/integrator.py::_render_rays",
        launches=path_launches["eager_frame"],
        path_launches=path_launches, rays=r, live_rays=live,
        hit_rays=hits, mismatches=bad,
        ms=time_ms(lambda: shade.accumulate_bounce(*args), 50),
        plain_ms=time_ms(lambda: shade.accumulate_plain(*plain_args), 5),
        bound_ms=bnd, bound_by=by, table_bytes=table_bytes,
        ops_per_live_lane=ops_lane,
        bound_formula=(f"max((R * {TAIL_LANE_BYTES} + live * "
                       f"{TAIL_LIVE_BYTES} + hits * {TAIL_HIT_BYTES} + "
                       f"misses * {TAIL_MISS_BYTES} + {table_bytes}) B / "
                       f"3.35 TB/s, live * {ops_lane} / 67 TFLOP/s)"),
        ptxas=ptx, **shade.accumulate_kernel_info())


# bytes the fill kernel moves (csrc/shade.cu interaction_kernel): every
# lane reads its hit (triangle, barycentrics: 12), its ray (24) and its
# triangle's row of the interaction table (104), and writes its
# position, normal, uv and two ids (40); what these inputs need reads
# each row once (every missed lane reads row 0)
FILL_ROW_BYTES = 104
FILL_LANE_BYTES = 12 + 24 + FILL_ROW_BYTES + 40


def interaction_row(render_frame, scene, camera, dev, integrator, built,
                    path_launches) -> dict:
    """The fill kernel's row: one launch over config5's 262,144 bounce-0
    continuation rays (route ``stream``: kernel 7c's hits), every lane
    equal to ``make_interaction`` bit for bit, timed beside it, with its
    byte bound (``R x 180 B``), registers, spills and blocks an SM.
    ``path_launches`` holds what ``shade.LAUNCHES["interaction"]`` read
    on each path."""
    import torch

    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.ops import shade

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    calls = record_inputs(render_frame, scene, camera, cfg, dev, integrator,
                          name="fill_interaction")
    if len(calls) != 1 + DEPTH:
        raise AssertionError(f"interaction: {len(calls)} calls a frame, "
                             f"expected {1 + DEPTH}")
    args = calls[1]  # bounce 0's continuation hits (calls[0]: the camera)
    got = shade.fill_interaction(*args)
    want = integrator.make_interaction(*args)
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    flat = lambda x: [x[0].x, x[0].y, x[0].z, x[1].x, x[1].y, x[1].z,
                      *x[2], x[3], x[4]]
    bad = sum(int((bits(g) != bits(w)).sum())
              for g, w in zip(flat(got), flat(want)))
    if bad:
        raise AssertionError(f"interaction: {bad} values differ from "
                             "make_interaction")
    hit = args[0]
    r, hits = int(hit.tri.shape[0]), int(hit.valid.sum())
    rows_read = int(torch.unique(torch.clamp_min(hit.tri, 0)).numel())
    ops_lane = elementwise_per_lane(
        lambda: integrator.make_interaction(*args), r)
    bnd, by = bound(r * FILL_LANE_BYTES, r * ops_lane)
    need = bound(r * (FILL_LANE_BYTES - FILL_ROW_BYTES)
                 + rows_read * FILL_ROW_BYTES, r * ops_lane)[0]
    ptx = ptxas_entry(built.get("shade", {}).get("ptxas", []),
                      "interaction_kernel")
    return dict(
        name="interaction", source="pnraytracing_tpu_torch/csrc/shade.cu",
        replaces="none: render/integrator.py::make_interaction after a "
                 "closest walk (every route but attr)",
        launches=path_launches["eager_frame"],
        path_launches=path_launches, rays=r, hit_rays=hits,
        mismatches=bad,
        ms=time_ms(lambda: shade.fill_interaction(*args), 50),
        plain_ms=time_ms(lambda: integrator.make_interaction(*args), 5),
        bound_ms=bnd, bound_by=by, ops_per_lane=ops_lane,
        bound_formula=(f"max(R * {FILL_LANE_BYTES} B / 3.35 TB/s, "
                       f"R * {ops_lane} / 67 TFLOP/s)"),
        rows_read=rows_read, needed_bound_ms=need,
        ptxas=ptx, **shade.interaction_kernel_info())


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` by CUDA events over ``reps`` calls.  A
    ~10 ms device sleep is queued first, so the host enqueues the calls
    while the card is still busy and the events time the kernels, not the
    Python wrapper between launches (calls that synchronise inside, like
    the plain versions, are timed with their host work)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_frame(fn, frame_ms: float, top: int = 8) -> dict:
    """Where one frame's time goes: torch.profiler over one call of
    ``fn`` — device busy time (the union of the device operations'
    intervals: overlapping kernels count once), the number of device
    kernels, the profiled wall time and the top kernels by device time.
    The device's idle share is 1 - busy / the profiled wall time, both on
    the profiler's clock; ``frame_ms``, the unprofiled time of the same
    frame, is reported beside it (the profiler's own host work stretches
    the profiled wall time).  Device fields are None when the profiler
    records no device activity on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("profiled_frame"):
            fn()
            torch.cuda.synchronize()
    from torch.autograd import DeviceType

    events = prof.events()
    wall = [e.time_range for e in events if e.name == "profiled_frame"
            and e.device_type == DeviceType.CPU][0]
    profiled_wall_ms = (wall.end - wall.start) / 1e3
    # device operations only; a record_function range shows on the device
    # too, as an annotation over its kernels
    device_ops = [(e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name != "profiled_frame"]
    busy_ms = union_us(device_ops) / 1e3
    dev_us = lambda e: getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0)
    # device-side kernel records only (the CPU-side aten ops that launch
    # them carry the same time and would count it twice)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kernels:
        return {"profiled_wall_ms": profiled_wall_ms, "frame_ms": frame_ms,
                "device_busy_ms": None,
                "device_idle_share": None, "top_kernels": None}
    kernels.sort(key=dev_us, reverse=True)
    ours = {}
    for e in kernels:
        name = port_kernel_name(e.key)
        if name:
            ours[name] = {"calls": e.count, "device_ms": dev_us(e) / 1e3}
    return {
        "profiled_wall_ms": profiled_wall_ms, "frame_ms": frame_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / profiled_wall_ms,
        "device_kernel_calls": sum(e.count for e in kernels),
        "port_kernels": ours,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": dev_us(e) / 1e3} for e in
                        kernels[:top]],
    }


def check_closest(name, got, want, r, attrs=None):
    """Kernel vs plain closest hits: tri may differ only on exact-t ties
    (visit order), bounded at 0.001% of the rays; t/b within the JAX
    package's test bounds on the rest; attributes to 1 ulp (normals) and
    exact (uv, word)."""
    import torch

    same = got.tri == want.tri
    n_bad = int((~same).sum())
    limit = max(1, int(r * 1e-5))
    t_err = float((got.t - want.t)[same].abs().max()) if r else 0.0
    ok = n_bad <= limit and torch.allclose(
        got.t[same], want.t[same], rtol=1e-6, atol=0.0) and torch.allclose(
        got.b1[same], want.b1[same], rtol=1e-5, atol=1e-6) and \
        torch.allclose(got.b2[same], want.b2[same], rtol=1e-5, atol=1e-6)
    err = t_err
    if attrs is not None:
        ga, wa = attrs
        m = same & want.valid
        for j in range(3):
            diff = (ga[j] - wa[j])[m].abs()
            ulp = torch.finfo(torch.float32).eps * wa[j][m].abs().clamp_min(
                torch.finfo(torch.float32).tiny)
            ok = ok and bool((diff <= ulp).all())
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        for j in (3, 4, 5):
            ok = ok and torch.equal(ga[j][m], wa[j][m])
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({n_bad} tri mismatches of {r}, "
                             f"max |dt| {t_err})")
    return n_bad, err


def frame_parity(render_frame, scene, camera, cfgp, dev, modules) -> dict:
    """A frame through the kernels against the same frame through the
    plain versions: at most 0.02% of pixels outside atol 3e-5."""
    import torch

    img_k = render_frame(scene, camera, cfgp, 0, device=dev)
    img_p, _ = record_frame(render_frame, scene, camera, cfgp, dev, *modules)
    px_err = (img_k - img_p).abs().amax(dim=-1)
    n_out = int((px_err > 3e-5).sum())
    limit = int(cfgp.width * cfgp.height * 2e-4)
    finite = bool(torch.isfinite(img_k).all())
    out = {"pixels": cfgp.width * cfgp.height, "depth": cfgp.max_depth,
           "outside_atol_3e-5": n_out, "limit": limit,
           "max_abs_err": float(px_err.max()), "finite": finite,
           "mean": float(img_k.mean())}
    if n_out > limit or not finite:
        raise AssertionError(f"frame parity failed: {out}")
    return out


def check_occ(name, got, want) -> int:
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} occlusion mismatches")
    return bad


def rays_of(args):
    """(o, d, t_max, mask) of a recorded traversal call."""
    return args[1], args[2], args[3], (args[4] if len(args) > 4 else None)


def binary_parity(trv, trav, cont, shadow, scene: str) -> dict:
    """Kernels 5 and 6 against their plain versions on one scene's
    bounce-0 continuation rays and fused shadow batch: hits, occlusion
    and the [3, R] stats equal, and the resident wide walk's results."""
    import torch

    o, d, tm, mask = rays_of(cont)
    r = o.x.shape[0]
    got, st = trv.closest_hit(trav, o, d, tm, mask, variant="binary",
                              with_stats=True)
    want, wst = trv.plain_closest_hit_binary(trav, o, d, tm, mask,
                                             with_stats=True)
    bad, err = check_closest(f"closest_hit_binary/{scene}", got, want, r)
    check_stats(f"closest_hit_binary/{scene}", st, wst)
    so, sd, stm, smask = rays_of(shadow)
    occ, ast = trv.any_hit(trav, so, sd, stm, smask, variant="binary",
                           with_stats=True)
    wocc, wast = trv.plain_any_hit_binary(trav, so, sd, stm, smask,
                                          with_stats=True)
    occ_bad = check_occ(f"any_hit_binary/{scene}", occ, wocc)
    check_stats(f"any_hit_binary/{scene}", ast, wast)
    check_occ(f"any_hit_binary_vs_wide/{scene}", occ,
              trv.any_hit(trav, so, sd, stm, smask))
    torch.cuda.synchronize()
    per_ray = lambda x, n: float(x.to(torch.int64).sum()) / n
    rs = so.x.shape[0]
    return {"tri_mismatch": bad, "err": err, "any_hit_mismatch": occ_bad,
            "stats_equal": True,
            "closest_pops_per_ray": per_ray(st[0], r),
            "closest_tri_tests_per_ray": per_ray(st[2], r),
            "any_pops_per_ray": per_ray(ast[0], rs),
            "any_leaf_pops_per_ray": per_ray(ast[1], rs),
            "any_tri_tests_per_ray": per_ray(ast[2], rs)}


def binary_phase(trv, trav, cont, shadow, primary, launches) -> list:
    """Phase 8: the binary kernels against their plain versions on the
    flagship rays, and their rows of the kernels line.  The integrator
    never routes to them (the binary packing is 8 B larger than the wide
    one), so their launches on the flagship frame are 0; the primitive
    queries of phase 17 run them."""
    import torch

    r = primary[1].x.shape[0]
    info = trv.kernel_info()
    res = {}
    for label, args in (("primary", primary), ("bounce0", cont)):
        o, d, tm, mask = rays_of(args)
        got, st = trv.closest_hit(trav, o, d, tm, mask, variant="binary",
                                  with_stats=True)
        want, wst = trv.plain_closest_hit_binary(trav, o, d, tm, mask,
                                                 with_stats=True)
        bad, err = check_closest("closest_hit_binary/" + label, got, want, r)
        check_stats("closest_hit_binary/" + label, st, wst)
        # the same tree as the wide walk: the same hits
        wide_bad, _ = check_closest("closest_hit_binary_vs_wide/" + label,
                                    got, trv.closest_hit(trav, o, d, tm,
                                                         mask), r)
        res[label] = {"tri_mismatch": bad, "err": err,
                      "tri_mismatch_vs_wide": wide_bad}
    so, sd, stm, smask = rays_of(shadow)
    occ, st = trv.any_hit(trav, so, sd, stm, smask, variant="binary",
                          with_stats=True)
    wocc, wst = trv.plain_any_hit_binary(trav, so, sd, stm, smask,
                                         with_stats=True)
    occ_bad = check_occ("any_hit_binary", occ, wocc)
    check_stats("any_hit_binary", st, wst)
    check_occ("any_hit_binary_vs_wide", occ,
              trv.any_hit(trav, so, sd, stm, smask))
    torch.cuda.synchronize()

    scene_bytes = 4 * (trav.nodes8.numel() + trav.tri9.numel())
    o, d, tm, mask = rays_of(cont)
    _, st = trv.closest_hit(trav, o, d, tm, mask, variant="binary",
                            with_stats=True)
    bnd_c = bound(r * (RAY_IN + 16) + scene_bytes, trav_ops(st, binary=True))
    pops_c = int(st[0].sum())
    rs = so.x.shape[0]
    _, st = trv.any_hit(trav, so, sd, stm, smask, variant="binary",
                        with_stats=True)
    bnd_a = bound(rs * (RAY_IN + 1) + scene_bytes, trav_ops(st, binary=True))
    per_ray_a = {"pops_per_ray": float(st[0].sum()) / rs,
                 "leaf_pops_per_ray": float(st[1].sum()) / rs,
                 "tri_tests_per_ray": float(st[2].sum()) / rs}
    rows = [
        dict(name="closest_hit_binary",
             source="pnraytracing_tpu_torch/csrc/traverse.cu",
             replaces="pnraytracing_tpu/accel/traverse_pallas.py:144",
             launches=launches["closest_hit_binary"],
             max_abs_err=max(v["err"] for v in res.values()),
             tri_mismatch=sum(v["tri_mismatch"] for v in res.values()),
             ms=time_ms(lambda: trv.closest_hit(trav, o, d, tm, mask,
                                                variant="binary"), 20),
             plain_ms=time_ms(lambda: trv.plain_closest_hit_binary(
                 trav, o, d, tm, mask), 2),
             wide_ms=time_ms(lambda: trv.closest_hit(trav, o, d, tm, mask),
                             20),
             pops=pops_c, pops_per_ray=pops_c / r,
             bound_ms=bnd_c[0], bound_by=bnd_c[1],
             **info["closest_hit_binary"]),
        dict(name="any_hit_binary",
             source="pnraytracing_tpu_torch/csrc/traverse.cu",
             replaces="pnraytracing_tpu/accel/traverse_pallas.py:233",
             launches=launches["any_hit_binary"], max_abs_err=float(occ_bad),
             mismatches=occ_bad,
             ms=time_ms(lambda: trv.any_hit(trav, so, sd, stm, smask,
                                            variant="binary"), 20),
             plain_ms=time_ms(lambda: trv.plain_any_hit_binary(
                 trav, so, sd, stm, smask), 2),
             wide_ms=time_ms(lambda: trv.any_hit(trav, so, sd, stm, smask),
                             20),
             bound_ms=bnd_a[0], bound_by=bnd_a[1], **per_ray_a,
             **info["any_hit_binary"]),
    ]
    emit({"phase": "binary", "rays": r, "shadow_rays": rs, "closest": res,
          "any_hit_mismatch": occ_bad, "stats_equal": True,
          "ms": {row["name"]: row["ms"] for row in rows},
          "wide_ms": {row["name"]: row["wide_ms"] for row in rows}})
    return rows


# the launches of one compat probe_pixel call, by scene (compat phases)
PROBE_LAUNCHES: dict = {}

# the compat forms of the walk kernels: (name, module attribute of the
# entry point, its keyword arguments, plain version, closest?, fills?,
# source, the TPU kernel it replaces); "trv" the resident walks, "trs" the
# stream walks
COMPAT_WALKS = {
    "resident": [
        ("closest_hit_attr", "trv", "closest_hit_attr", {},
         "plain_closest_hit_attr", True, True, "traverse.cu",
         "traverse_pallas.py:488"),
        ("closest_hit", "trv", "closest_hit", {}, "plain_closest_hit", True,
         False, "traverse.cu", "traverse_pallas.py:340"),
        ("any_hit", "trv", "any_hit", {}, "plain_any_hit", False, False,
         "traverse.cu", "traverse_pallas.py:668"),
        ("closest_hit_binary", "trv", "closest_hit", {"variant": "binary"},
         "plain_closest_hit_binary", True, False, "traverse.cu",
         "traverse_pallas.py:144"),
        ("any_hit_binary", "trv", "any_hit", {"variant": "binary"},
         "plain_any_hit_binary", False, False, "traverse.cu",
         "traverse_pallas.py:233"),
    ],
    "stream": [
        ("closest_hit_stream", "trs", "closest_hit_stream", {},
         "plain_closest_hit_stream", True, False, "traverse_stream.cu",
         "traverse_stream.py:87"),
        ("any_hit_stream", "trs", "any_hit_stream", {},
         "plain_any_hit_stream", False, False, "traverse_stream.cu",
         "traverse_stream.py:87"),
    ],
}


def compat_kernel_rows(label, mods, trav, cont, shadow, walks, smi) -> list:
    """Each compat walk kernel of ``walks`` against its compat plain
    version on one scene's bounce-0 continuation rays (closest walks) or
    fused shadow batch (any-hit walks) of the compat frame, and on the
    synthetic set of :func:`compat_rays`: results and per-ray stats
    equal (tri mismatches <= 0.001% of rays, occlusion exact); then its
    time, its plain version's time (the parity call; kernel 3 is held
    against kernel 1's plain walk, the same walk, and reports its time),
    its bound from this run's stats, pops / leaf pops / tests a ray
    beside the default instantiation's on the same rays, and its
    registers.  Returns the kernels line's rows (launches filled in by
    the caller)."""
    import torch

    info = {**mods["trv"].kernel_info(), **mods["trs"].kernel_info(trav)}
    synth_o, synth_d = compat_rays(trav.treelets, trav.tri9.device)
    n_s = synth_o.x.shape[0]
    g = torch.Generator().manual_seed(2)
    synth_t = (torch.rand(n_s, generator=g) * 10 + 0.5).to(trav.tri9.device)
    synth_mask = (torch.rand(n_s, generator=g) < 0.9).to(trav.tri9.device)
    rows, res, walked = [], {}, {}
    for (name, mod, fn, kw, plain, closest, fills, src,
         replaces) in walks:
        kern = functools.partial(getattr(mods[mod], fn), **kw)
        pfn = getattr(mods[mod], plain)
        o, d, tm, mask = rays_of(cont if closest else shadow)
        r = o.x.shape[0]
        got = kern(trav, o, d, tm, mask, compat=True, with_stats=True)
        torch.cuda.synchronize()
        if name == "closest_hit" and "closest_hit_attr" in walked:
            want, plain_ms = walked["closest_hit_attr"]
            want = (want[0], want[-1])
        else:
            t0 = time.perf_counter()
            want = pfn(trav, o, d, tm, mask, compat=True, with_stats=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            walked[name] = (want, plain_ms)
        st, wst = got[-1], want[-1]
        cname = name + "_compat"
        check_stats(cname, st, wst)
        if closest:
            bad, err = check_closest(cname, got[0], want[0], r,
                                     (got[1], want[1]) if fills else None)
        else:
            bad = check_occ(cname, got[0], want[0])
            err = float(bad)
        sg = kern(trav, synth_o, synth_d, synth_t, synth_mask, compat=True,
                  with_stats=True)
        sw = pfn(trav, synth_o, synth_d, synth_t, synth_mask, compat=True,
                 with_stats=True)
        check_stats(cname + "/synthetic", sg[-1], sw[-1])
        if closest:
            check_closest(cname + "/synthetic", sg[0], sw[0], n_s)
        else:
            check_occ(cname + "/synthetic", sg[0], sw[0])
        default_st = kern(trav, o, d, tm, mask, with_stats=True)[-1]
        binary = name.endswith("_binary")
        if mod == "trs":
            s = trav.stream
            tables = 4 * (s.top16.numel() + s.bricks.numel())
        else:
            tables = 4 * ((trav.nodes8 if binary else trav.nodes16c).numel()
                          + trav.tri12.numel()
                          + (trav.tri_attr16.numel() if fills else 0))
        per_ray_out = 40 if fills else (16 if closest else 1)
        bnd = bound(r * (RAY_IN + per_ray_out) + tables,
                    trav_ops(st, binary=binary))
        per_ray = lambda x: float(x.to(torch.int64).sum()) / max(r, 1)
        row = dict(
            name=cname, source="pnraytracing_tpu_torch/csrc/" + src,
            replaces="pnraytracing_tpu/accel/" + replaces,
            max_abs_err=err, mismatches=bad,
            ms=time_ms(lambda: kern(trav, o, d, tm, mask, compat=True), 10),
            default_ms=time_ms(lambda: kern(trav, o, d, tm, mask), 10),
            plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
            rays=r, pops_per_ray=per_ray(st[0]),
            leaf_pops_per_ray=per_ray(st[1]),
            tri_tests_per_ray=per_ray(st[2]),
            default_pops_per_ray=per_ray(default_st[0]),
            default_tri_tests_per_ray=per_ray(default_st[2]),
            max_pops=int(st[0].max()),
            **info.get(cname, {}))
        if mod == "trs":
            row["bricks_per_ray"] = per_ray(st[3])
            row["default_bricks_per_ray"] = per_ray(default_st[3])
        rows.append(row)
        res[cname] = {"rays": r, "mismatches": bad, "synthetic_rays": n_s,
                      "stats_equal": True}
    emit({"phase": "compat_kernels", "scene": label, "parity": res,
          "ms": {row["name"]: row["ms"] for row in rows},
          "default_ms": {row["name"]: row["default_ms"] for row in rows},
          "card": smi})
    return rows


def compat_phase(label, render_frame, RenderConfig, scene, camera, dev,
                 modules, tables, counts, expected, walks, smi) -> list:
    """Phase ``compat``: ``RenderConfig(compat_pnrt=True)`` on one path.
    The bounce-0 continuation and shadow rays of a 512x512 compat frame
    through the kernels (recorded); :func:`compat_kernel_rows` on them; a
    128x128 depth-4 compat frame through the kernels against the plain
    versions and replayed against eager; ``probe_pixel`` against that
    frame's pixel; then the 512x512 depth-4 compat frame captured (the
    counters zeroed just before the capture and read just after: the
    compat kernels ``expected`` once in the graph, twice with the
    warm-up), a replay equal to the eager frame bit for bit, and ms/frame
    replayed and eager in two rounds.  Returns the kernels line's rows,
    their launches those of the captured frame."""
    import torch

    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.debug import probe_pixel
    from pnraytracing_tpu_torch.render.renderer import (
        render_frame as replayed_frame,
    )

    from pnraytracing_tpu_torch.accel import walks as walk_mod

    _, trv, trs, _ = modules
    trav = scene.trav
    stream = "closest_hit_stream_compat" in expected
    closest_name = "closest_hit_stream" if stream else "closest_hit_attr"
    shadow_name = "any_hit_stream" if stream else "any_hit"
    cfg1 = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=1,
                        compat_pnrt=True)
    cont = record_inputs(render_frame, scene, camera, cfg1, dev, walk_mod,
                         closest_name)[1]
    shadow = record_inputs(render_frame, scene, camera, cfg1, dev,
                           walk_mod, shadow_name)[0]
    rows = compat_kernel_rows(label, {"trv": trv, "trs": trs}, trav, cont,
                              shadow, walks, smi)

    cfgp = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                        max_depth=DEPTH, compat_pnrt=True)
    parity = frame_parity(render_frame, scene, camera, cfgp, dev, modules)
    replay = replay_parity(scene, camera, cfgp, dev)
    img = render_frame(scene, camera, cfgp, 5, device=dev)
    zero_counts(*tables)
    probe = probe_pixel(scene, camera, cfgp, 64, 64, frame=5, device=dev)
    torch.cuda.synchronize()
    probe_launches = {k: v for k, v in counts().items() if v}
    PROBE_LAUNCHES[label] = probe_launches
    probe_err = float((probe["color"] - img[PARITY_SIZE - 1 - 64, 64])
                      .abs().max())
    if probe_err > 3e-5:
        raise AssertionError(f"{label}: probe_pixel differs from its frame's "
                             f"pixel by {probe_err}")

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH,
                       compat_pnrt=True)
    program.clear_programs()
    zero_counts(*tables)
    prog = program.frame_program(scene, cfg, dev)
    t0 = time.perf_counter()
    prog.capture(camera, 1)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    got = counts()
    want = dict({k: 0 for k in got}, **expected)
    if prog.launches != want or got != {k: 2 * v for k, v in want.items()}:
        raise AssertionError(f"{label} compat: launches at capture "
                             f"{prog.launches} (counters {got}), expected "
                             f"{want} (and twice that with the warm-up)")
    eager = lambda f: render_frame(scene, camera, cfg, f, device=dev)
    replayed = lambda f: replayed_frame(scene, camera, cfg, f, device=dev)
    a = replayed(2)
    torch.cuda.synchronize()
    if not torch.equal(a, eager(2)):
        raise AssertionError(f"{label} compat: the replayed frame differs "
                             "from the eager one")
    check_image(label + " compat", a, cfg)
    ms = {"eager": [], "replayed": []}
    for rnd in range(2):
        for mode in (("eager", "replayed") if rnd == 0
                     else ("replayed", "eager")):
            fn, n = (eager, 2) if mode == "eager" else (replayed, 5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in range(n):
                fn(3 + f)
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) * 1e3 / n)
    prof = profile_frame(lambda: prog.replay(camera, 12),
                         sum(ms["replayed"]) / 2)
    program.clear_programs()
    launches = {k: v for k, v in prog.launches.items() if v}
    for row in rows:
        row["launches"] = want.get(row["name"], 0)
    emit({"phase": "compat", "scene": label, "width": WIDTH,
          "height": HEIGHT, "depth": DEPTH, "parity_128": parity,
          "replay_128": replay, "probe_pixel_err": probe_err,
          "probe_pixel_launches": probe_launches,
          "capture_s": capture_s, "launches_at_capture": launches,
          "replay_equals_eager": True, "ms_per_frame": ms,
          "eager_ms": sum(ms["eager"]) / 2,
          "replayed_ms": sum(ms["replayed"]) / 2,
          "mean": float(a.mean()), "card": smi})
    emit(dict(phase="compat_profile", scene=label, **prof))
    return rows


# RenderConfig options of the options phase, by name; the first five are
# also timed
OPTIONS = {
    "default": {},
    "compact_rays=False": dict(compact_rays=False),
    "sort_rays=False": dict(sort_rays=False),
    "sort_key=pos": dict(sort_key="pos"),
    "fuse_shadows=False": dict(fuse_shadows=False),
    "sort_key=dir": dict(sort_key="dir"),
    "jitter_primary=True": dict(jitter_primary=True),
    "loop=scan": dict(loop="scan"),
}
TIMED_OPTIONS = tuple(OPTIONS)[:5]
# the options whose kernel mix differs from the default's at every bounce
# (no compaction: the walks see every lane; unfused shadows: two any-hit
# launches a bounce), so their parity frames run all DEPTH bounces
FULL_DEPTH_OPTIONS = ("compact_rays=False", "fuse_shadows=False")


def frame_launches(render_frame, scene, camera, cfg, dev, tables, counts):
    """(image, launches) of one frame, the counters zeroed just before."""
    import torch

    zero_counts(*tables)
    img = render_frame(scene, camera, cfg, 1, device=dev)
    torch.cuda.synchronize()
    return img, counts()


def check_image(name, img, cfg) -> None:
    import torch

    if not (img.shape == (cfg.height, cfg.width, 3)
            and torch.isfinite(img).all() and float(img.min()) >= 0.0
            and float(img.max()) <= 1.0):
        raise AssertionError(f"{name}: the frame is not a finite [0,1] "
                             "image")


def replay_parity(scene, camera, cfg, dev, frames=(3, 4)) -> dict:
    """A frame program of ``scene`` under ``cfg`` replayed at two frame
    indices: each replay equals the eager frame of its index bit for bit,
    and the two differ."""
    import torch

    from pnraytracing_tpu_torch.render.program import FrameProgram
    from pnraytracing_tpu_torch.render.renderer import render_frame

    prog = FrameProgram(scene, cfg, dev)
    got = [prog.replay(camera, f).clone() for f in frames]
    want = [render_frame(scene, camera, cfg, f, device=dev, eager=True)
            for f in frames]
    torch.cuda.synchronize()
    out = {"frames": list(frames),
           "equal": [bool(torch.equal(g, w)) for g, w in zip(got, want)],
           "frames_differ": not torch.equal(got[0], got[1]),
           "capture_s": prog.capture_seconds}
    if not (all(out["equal"]) and out["frames_differ"]):
        raise AssertionError(f"replayed frames against eager: {out}")
    return out


def shade_per_frame(cfg) -> int:
    """The shade kernel's launches in a frame: one a bounce a tile (the
    tiles of render/renderer.py::frame_image)."""
    p = cfg.width * cfg.height
    tile = min(cfg.tile_pixels, p)
    return cfg.max_depth * (p // tile if p % tile == 0 else 1)


def fill_per_frame(scene, cfg) -> int:
    """The fill kernel's launches in a frame: one a tile in the camera
    phase and one a bounce a tile, off route ``attr`` (whose walk
    fills); none on it."""
    from pnraytracing_tpu_torch.accel.walks import route_walks

    if route_walks(scene, cfg)[0] == "attr":
        return 0
    return shade_per_frame(cfg) // cfg.max_depth * (1 + cfg.max_depth)


def program_phase(label, scene, camera, cfg, dev, expected, tables, counts,
                  smi) -> dict:
    """The frame of ``scene`` under ``cfg`` as one captured CUDA graph
    (render/program.py).  The counters are zeroed just before the
    program is captured and read just after: its warm-up frame and its
    capture each count ``expected`` once (the graph's own counts are
    ``expected``; the shade kernel, read apart, ``shade_per_frame``
    each), and replays count nothing.  Then: replays at frames 1
    and 2 against the eager frames (bit for bit, and the two differ);
    capture seconds and the bytes the program keeps reserved (its
    graph's private pool and its static buffers); ms/frame of
    ``render_frame`` eager and replayed in three alternating rounds of
    5 frames after a warm-up; one replayed frame under the profiler;
    ``render_average`` with spp=8 (ms a sample) against the eager frames
    summed from zeros in frame order and divided by 8, bit for bit; the
    host time of ``replay`` until it returns beside the frame's time
    until the card is done, for 5 single replays after the timed rounds
    and again at the end (``replay_split``); and the device memory with
    the programs alive."""
    import torch

    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.renderer import (
        render_average,
        render_frame,
    )

    eager = lambda f: render_frame(scene, camera, cfg, f, device=dev,
                                   eager=True)
    replayed = lambda f: render_frame(scene, camera, cfg, f, device=dev)
    program.clear_programs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    zero_counts(*tables)
    prog = program.frame_program(scene, cfg, dev)
    t0 = time.perf_counter()
    prog.capture(camera, 1)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    got = counts()
    want = dict({k: 0 for k in got}, **expected)
    shade_n = shade.LAUNCHES["shade"]
    tail_n = shade.LAUNCHES["accumulate"]
    fill_n = shade.LAUNCHES["interaction"]
    fill_want = 2 * fill_per_frame(scene, cfg)
    if (prog.launches != want or got != {k: 2 * v for k, v in want.items()}
            or shade_n != 2 * shade_per_frame(cfg)
            or tail_n != 2 * shade_per_frame(cfg) or fill_n != fill_want):
        raise AssertionError(f"{label}: launches at capture "
                             f"{prog.launches} (counters {got}, shade "
                             f"{shade_n}, accumulate {tail_n}, interaction "
                             f"{fill_n}), expected {want} (and twice that "
                             f"with the warm-up), shade and accumulate "
                             f"twice {shade_per_frame(cfg)}, interaction "
                             f"{fill_want}")
    torch.cuda.empty_cache()  # the warm-up's blocks; the pool stays
    pool_bytes = torch.cuda.memory_reserved() - reserved0
    a = replayed(1)
    b = replayed(2)
    torch.cuda.synchronize()
    shade_replays = shade.LAUNCHES["shade"] - shade_n  # the two replays'
    tail_replays = shade.LAUNCHES["accumulate"] - tail_n
    fill_replays = shade.LAUNCHES["interaction"] - fill_n
    if counts() != got or shade_replays or tail_replays or fill_replays:
        raise AssertionError(f"{label}: a replay counted launches")
    equal = [bool(torch.equal(a, eager(1))), bool(torch.equal(b, eager(2)))]
    if not (all(equal) and not torch.equal(a, b)):
        raise AssertionError(f"{label}: replayed frames 1, 2 equal the eager "
                             f"ones {equal}, differ {not torch.equal(a, b)}")
    check_image(label, a, cfg)
    ms = {"eager": [], "replayed": []}
    clocks = {"eager": [], "replayed": []}  # read as each round ends
    for rnd in range(3):
        for mode in (("eager", "replayed") if rnd % 2 == 0
                     else ("replayed", "eager")):
            fn = eager if mode == "eager" else replayed
            fn(3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in range(5):
                fn(4 + f)
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) * 1e3 / 5)
            clocks[mode].append(gpu_clocks())
    mean = lambda x: sum(x) / len(x)

    def split():
        out = {"submit_ms": [], "frame_ms": []}
        for f in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog.replay(camera, 20 + f)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out["submit_ms"].append((t1 - t0) * 1e3)
            out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    splits = {"after_rounds": split()}
    prof = profile_frame(lambda: prog.replay(camera, 12), mean(ms["replayed"]))
    spp = 8
    render_average(scene, camera, cfg, 100, spp, device=dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = render_average(scene, camera, cfg, 100, spp, device=dev)
    torch.cuda.synchronize()
    avg_ms = (time.perf_counter() - t0) * 1e3 / spp
    acc = torch.zeros_like(avg)
    for i in range(spp):
        acc = acc + eager(100 + i)
    if not torch.equal(avg, acc / float(spp)):
        raise AssertionError(f"{label}: render_average differs from the "
                             "eager frames' mean")
    splits["at_end"] = split()
    out = {"phase": "program", "scene": label, "width": cfg.width,
           "height": cfg.height, "depth": cfg.max_depth,
           "capture_s": capture_s, "graph_capture_s": prog.capture_seconds,
           "pool_bytes": pool_bytes,
           "launches_at_capture": {k: v for k, v in prog.launches.items()
                                   if v},
           # the shade kernel (not in prog.launches): its warm-up frame
           # and its capture, then the two replays checked above
           "shade_launches": {"program_capture": shade_n,
                              "program_replays": shade_replays},
           "tail_launches": {"program_capture": tail_n,
                             "program_replays": tail_replays},
           "fill_launches": {"program_capture": fill_n,
                             "program_replays": fill_replays},
           "replay_equals_eager": equal, "ms_per_frame": ms,
           "sm_mhz_celsius_watts": clocks, "replay_split": splits,
           "eager_ms": mean(ms["eager"]), "replayed_ms": mean(ms["replayed"]),
           "replayed_rays_per_s": QUERIES_PER_FRAME / (
               mean(ms["replayed"]) / 1e3),
           "render_average": {"spp": spp, "ms_per_sample": avg_ms,
                              "equals_eager_sum": True},
           "programs_alive": len(program._programs),
           "memory_allocated": torch.cuda.memory_allocated(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "memory_reserved": torch.cuda.memory_reserved(),
           "card": smi}
    emit(out)
    emit(dict(phase="program_profile", scene=label, **prof))
    return out


def session_phase(RenderConfig, scene, cam_state, dev, smi) -> None:
    """A ``RenderSession`` on the flagship at 512x512 depth 4: each step
    (a replayed program) against the eager frame it stands for, bit for
    bit: the first sample, the sum of two, then after a material edit
    (written in place: no new capture of the converging program) and
    after an orbit, the 1-bounce preview and the next converging step;
    the steps' own times."""
    import torch

    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.renderer import render_frame
    from pnraytracing_tpu_torch.render.session import RenderSession

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    s = RenderSession(scene, dataclasses.replace(cam_state), cfg, device=dev)
    eager = lambda c, f: render_frame(s.scene, s.camera.basis(device=dev),
                                      c, f, device=dev, eager=True)
    checks = {"sample0": torch.equal(s.step(), eager(cfg, 0))}
    first_ms = s.stats.last_frame_ms  # captures the program
    s.step()
    checks["sum_of_two"] = torch.equal(s.accum.total,
                                       eager(cfg, 0) + eager(cfg, 1))
    step_ms = []
    for _ in range(4):
        s.step()
        step_ms.append(s.stats.last_frame_ms)
    n_programs = len(program._programs)
    s.edit_material(0, base_color=(0.2, 0.4, 0.9), roughness=0.5)
    checks["edit_preview"] = torch.equal(s.step(), eager(s.preview_cfg, 0))
    preview_first_ms = s.stats.last_frame_ms  # captures the preview
    checks["edit"] = torch.equal(s.step(), eager(cfg, 0))
    checks["programs_added"] = len(program._programs) - n_programs
    s.orbit(15.0, 5.0)
    checks["orbit_preview"] = torch.equal(s.step(), eager(s.preview_cfg, 0))
    preview_ms = s.stats.last_frame_ms
    checks["orbit"] = torch.equal(s.step(), eager(cfg, 0))
    if not all(checks[k] for k in checks if k != "programs_added") or \
            checks["programs_added"] != 1:
        raise AssertionError(f"session steps against eager frames: {checks}")
    emit({"phase": "session", "width": WIDTH, "height": HEIGHT,
          "depth": DEPTH, "checks": checks, "frames": s.stats.frames,
          "first_step_ms": first_ms, "step_ms": step_ms,
          "preview_first_step_ms": preview_first_ms,
          "preview_step_ms": preview_ms,
          "rays_per_s": s.stats.rays_per_s, "card": smi})


# ---- phase app: the resilient render loop and the command lines ------------

APP_SPP = 8  # samples of the resilient loop
APP_KILL_FRAME = 2  # the sample in flight when its worker is SIGKILLed
APP_ROUNDS = 3  # alternating timing rounds, worker against in process
APP_ROUND_SAMPLES = 4
APP_MAX_ABS = 1e-6  # the loop against render_average of the same frames
APP_CLI_SIZE, APP_CLI_SPP = 128, 2  # the --model and --sharded renders
APP_FLAGSHIP_SPP = 4  # the render CLI on the flagship

# the sticky fact: a device-side assert (an out-of-range index_select) in
# a process of its own, classified, run through run_resilient (it must
# propagate after one call), then one more CUDA op in that process
STICKY_CODE = r"""
import json
import os
import torch
from pnraytracing_tpu_torch.utils import resilience
calls, out = [], {}
def trigger():
    calls.append(1)
    x = torch.ones(4, device="cuda")
    torch.index_select(x, 0, torch.tensor([1 << 20], device="cuda"))
    torch.cuda.synchronize()
try:
    resilience.run_resilient(trigger)
except Exception as e:
    out.update(error_type=type(e).__name__,
               message=str(e).strip().splitlines()[0],
               is_device_loss=resilience.is_device_loss(e))
out["run_resilient_calls"] = len(calls)
try:
    float(torch.ones(2, device="cuda").sum())
    out["next_op_fails"] = False
except Exception as e:
    out.update(next_op_fails=True,
               next_message=str(e).strip().splitlines()[0])
print(json.dumps(out), flush=True)
os._exit(0)  # no teardown in a poisoned context
"""

INTERACTIVE_SCRIPT = ("spp 2", "orbit 10 0", "mat 0 base_color 1 0 0",
                      "save {work}/s.npz", "load {work}/s.npz", "status",
                      "quit")


def _start(name, module_args, work, stdin=None):
    """Start one command of the app layer as a subprocess of the repo's
    root, its output in ``work/<name>.log``."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    log = open(os.path.join(work, name + ".log"), "w")
    proc = subprocess.Popen(
        [sys.executable, *module_args], cwd=root, env=env, stdout=log,
        stderr=subprocess.STDOUT,
        stdin=subprocess.PIPE if stdin is not None else subprocess.DEVNULL,
        text=True)
    if stdin is not None:
        proc.stdin.write(stdin)
        proc.stdin.close()
    return {"proc": proc, "log": log, "t0": time.perf_counter()}


def _wait_all(runs, work, timeout=600) -> dict:
    """Wait for every started command: each one's wall seconds from its
    start to its exit, return code and output; raises with the output's
    tail of one that failed or did not end within ``timeout``."""
    import os

    ends, deadline = {}, time.perf_counter() + timeout
    while len(ends) < len(runs) and time.perf_counter() < deadline:
        for name, run in runs.items():
            if name not in ends and run["proc"].poll() is not None:
                ends[name] = time.perf_counter()
        time.sleep(0.05)
    done = {}
    for name, run in runs.items():
        if name not in ends:
            run["proc"].kill()
        rc = run["proc"].wait()
        run["log"].close()
        with open(os.path.join(work, name + ".log")) as f:
            text = f.read()
        if name not in ends or rc != 0:
            raise AssertionError(f"app/cli {name}: rc {rc} (ended: "
                                 f"{name in ends}):\n{text[-4000:]}")
        done[name] = {"rc": rc, "seconds": ends[name] - run["t0"],
                      "text": text}
    return done


def _worker_facts(w, expected) -> dict:
    """A worker's start and its launch tables after its first reply,
    gated: the captured frame launches kernels 1, 2, 4 as ``expected``
    says (5 / 4 / 2), and its first reply counts the warm-up frame and
    the captured one."""
    twice = {k: 2 * v for k, v in expected.items()}
    if w.frame_launches != expected or w.launches != twice:
        raise AssertionError(f"worker launches {w.frame_launches} / first "
                             f"reply {w.launches}, expected {expected} / "
                             f"{twice}")
    return {"start_s": w.start_seconds, **w.timings,
            "captured_frame_launches": {k: v for k, v in
                                        w.frame_launches.items() if v}}


def app_phase(RenderConfig, dev, expected, smi) -> dict:
    """``utils/resilience.py`` and ``scripts/`` on the card: ``probe``,
    ``sticky``, ``resilient`` (a ``ResilientRenderLoop`` on the flagship
    at 512x512 depth 4, 8 samples, its worker SIGKILLed with sample 2 in
    flight: one loss recovered, the image equal to an uninterrupted
    loop's bit for bit and within ``APP_MAX_ABS`` of ``render_average``;
    the worker's start, the recovery seconds and the ms a sample through
    the worker beside in process) and ``cli`` (each command line as a
    subprocess on the card, all at once).  Returns the kernels' launches
    a frame by path (the workers' captured frames)."""
    import os
    import shutil
    import signal

    import numpy as np
    import torch

    from pnraytracing_tpu_torch.io.png import read_png_rgb
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.renderer import (
        render_average,
        render_frame,
    )
    from pnraytracing_tpu_torch.scene import shapes
    from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night
    from pnraytracing_tpu_torch.utils import resilience
    from pnraytracing_tpu_torch.utils.image import save_png

    t_phase = time.perf_counter()
    work = os.path.abspath(os.path.join("build", "app_smoke"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # ---- probe: a fresh process on the card
    t0 = time.perf_counter()
    if not resilience.probe_device():
        raise AssertionError("app/probe: probe_device() is False on the card")
    emit({"phase": "app/probe", "ok": True,
          "seconds": time.perf_counter() - t0})

    # ---- resilient: the loop's worker killed with sample 2 in flight
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    scene_h, cam_state = config3_teapot_night(env_height=256, device="cpu")
    cam_h = cam_state.basis(device="cpu")
    logs, marks = [], {}
    with resilience.ResilientRenderLoop(scene_h, cam_h, cfg, device=dev,
                                        log=logs.append) as loop:
        real = loop._render_one

        def kill_in_flight(frame, scene):
            if frame == APP_KILL_FRAME and "kill" not in marks:
                w = loop.worker
                w.request(frame)
                os.kill(w.process.pid, signal.SIGKILL)
                marks["kill"] = time.perf_counter()
                return w.reply()  # raises WorkerLost
            img = real(frame, scene)
            if frame == APP_KILL_FRAME:
                marks["back"] = time.perf_counter()
            return img

        loop._render_one = kill_in_flight
        loop.render(APP_KILL_FRAME)
        first = _worker_facts(loop.worker, expected)
        img = loop.render(APP_SPP - APP_KILL_FRAME)
        second = _worker_facts(loop.worker, expected)
    if loop.count != APP_SPP or loop.losses_recovered != 1:
        raise AssertionError(f"app/resilient: count {loop.count}, losses "
                             f"recovered {loop.losses_recovered}: {logs}")
    with resilience.ResilientRenderLoop(scene_h, cam_h, cfg,
                                        device=dev) as plain_loop:
        want = plain_loop.render(APP_SPP)
        scene_d, cam_d = scene_h.to(dev), cam_h.to(dev)
        ref = render_average(scene_d, cam_d, cfg, 0, APP_SPP,
                             device=dev).cpu().numpy()
        max_abs = float(np.abs(img - ref).max())
        if not np.array_equal(img, want) or max_abs > APP_MAX_ABS:
            raise AssertionError(
                f"app/resilient: recovered loop equal to the uninterrupted "
                f"one: {np.array_equal(img, want)}, max abs from "
                f"render_average {max_abs} (gate {APP_MAX_ABS})")

        def in_process(start):
            acc = np.zeros((HEIGHT, WIDTH, 3), np.float32)
            for f in range(start, start + APP_ROUND_SAMPLES):
                acc += render_frame(scene_d, cam_d, cfg, f,
                                    device=dev).cpu().numpy()

        worker_ms, process_ms = [], []
        for r in range(APP_ROUNDS):
            sides = [(worker_ms, lambda: plain_loop.render(
                APP_ROUND_SAMPLES)), (process_ms, lambda: in_process(
                    100 + r * APP_ROUND_SAMPLES))]
            for out, fn in (sides if r % 2 == 0 else sides[::-1]):
                t0 = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t0) * 1e3
                           / APP_ROUND_SAMPLES)
    emit({"phase": "app/resilient", "width": WIDTH, "height": HEIGHT,
          "depth": DEPTH, "spp": APP_SPP, "count": loop.count,
          "losses_recovered": loop.losses_recovered,
          "equal_to_uninterrupted": True, "max_abs_vs_render_average":
          max_abs, "first_worker": first, "replacement_worker": second,
          "recovery_s": marks["back"] - marks["kill"],
          "ms_per_sample_worker": worker_ms,
          "ms_per_sample_in_process": process_ms,
          "image_bytes": int(img.nbytes), "log": logs, "card": smi})

    # ---- cli: every command line at once, and the sticky subprocess;
    # first the flagship PNG the render CLI must write
    ref_png = os.path.join(work, "render_average.png")
    save_png(ref_png, render_average(scene_d, cam_d, cfg, 0,
                                     APP_FLAGSHIP_SPP, device=dev))
    m = shapes.teapot()
    obj = os.path.join(work, "teapot.obj")
    pos, nrm, idx = first_use_order(m["indices"], m["positions"],
                                    m["normals"])
    write_obj(obj, [(None, pos, nrm, None, idx)])
    render = ["-m", "pnraytracing_tpu_torch.scripts.render"]
    small = ["--model", obj, "--width", str(APP_CLI_SIZE), "--height",
             str(APP_CLI_SIZE), "--spp", str(APP_CLI_SPP)]
    out = lambda name: os.path.join(work, name)
    runs = {
        "render": _start("render", [*render, "--scene", "teapot_night",
                                    "--width", str(WIDTH), "--height",
                                    str(HEIGHT), "--spp",
                                    str(APP_FLAGSHIP_SPP), "--depth",
                                    str(DEPTH), "--out", out("render.png")],
                         work),
        "render_model": _start("render_model", [*render, *small, "--out",
                                                out("model.png")], work),
        "render_wide4": _start("render_wide4", [
            *render, *small, "--traversal", "wide4", "--out",
            out("model_wide4.png")], work),
        "render_sharded": _start("render_sharded", [
            "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", *render, "--sharded", *small,
            "--out", out("model_sharded.png")], work),
        "optimize": _start("optimize", [
            "-m", "pnraytracing_tpu_torch.scripts.optimize", "--size", "32",
            "--steps", "4", "--out", out("optimize")], work),
        "interactive": _start("interactive", [
            "-m", "pnraytracing_tpu_torch.scripts.interactive", "--out",
            out("interactive.png")], work, stdin="\n".join(
                INTERACTIVE_SCRIPT).format(work=work) + "\n"),
        "gallery": _start("gallery", [
            "-m", "pnraytracing_tpu_torch.scripts.gallery", "--small",
            "--scenes", "cornell,flat", "--out", out("gallery")], work),
        "sticky": _start("sticky", ["-c", STICKY_CODE], work),
    }
    done = _wait_all(runs, work)
    sticky = json.loads(next(ln for ln in done.pop("sticky")["text"]
                             .splitlines()[::-1] if ln.startswith("{")))
    t0 = time.perf_counter()
    sticky["fresh_process_probe"] = resilience.probe_device()
    sticky["probe_s"] = time.perf_counter() - t0
    emit(dict(phase="app/sticky", **sticky))
    if (sticky.get("is_device_loss") is not False
            or sticky["run_resilient_calls"] != 1
            or not sticky["fresh_process_probe"]):
        raise AssertionError(f"app/sticky: a device-side assert must be "
                             f"classified a programming error, raised "
                             f"after one call, and leave the card usable "
                             f"to a fresh process: {sticky}")

    checks = {}
    png = lambda name: read_png_rgb(out(name))
    checks["render_png_equals_render_average"] = bool(np.array_equal(
        png("render.png"), read_png_rgb(ref_png)))
    line = next((ln for ln in done["render"]["text"].splitlines()
                 if ln.startswith("worker launches: ")), None)
    if line is None:
        raise AssertionError("app/cli: the render CLI printed no worker "
                             "launches")
    cli_launches = json.loads(line[len("worker launches: "):])
    checks["render_launches"] = cli_launches["captured_frame"] == expected
    # --traversal wide4: the 4-wide kernels in the worker's frame
    line = next((ln for ln in done["render_wide4"]["text"].splitlines()
                 if ln.startswith("worker launches: ")), "{}")
    wide4_launches = json.loads(line[len("worker launches: "):] or "{}")
    frame = wide4_launches.get("captured_frame", {})
    checks["wide4_launches"] = (frame.get("closest_hit_wide4", 0) > 0
                                and frame.get("any_hit_wide4", 0) > 0
                                and frame.get("closest_hit_attr", 1) == 0)
    checks["wide4_png_shape"] = png("model_wide4.png").shape == (
        APP_CLI_SIZE, APP_CLI_SIZE, 3)
    checks["sharded_png_equals_unsharded"] = bool(np.array_equal(
        png("model_sharded.png"), png("model.png")))
    checks["model_png_shape"] = png("model.png").shape == (
        APP_CLI_SIZE, APP_CLI_SIZE, 3)
    losses = re.search(r"loss: ([0-9.e+-]+) -> ([0-9.e+-]+)",
                       done["optimize"]["text"])
    checks["optimize_loss_falls"] = float(losses[2]) < float(losses[1])
    checks["interactive"] = (png("interactive.png").shape == (256, 256, 3)
                             and os.path.exists(out("s.npz"))
                             and "restored frame" in
                             done["interactive"]["text"])
    checks["gallery"] = all(
        png(f"gallery/{s}_128_8spp.png").shape == (128, 128, 3)
        for s in ("cornell", "flat"))
    emit({"phase": "app/cli", "checks": checks,
          "seconds": {k: v["seconds"] for k, v in done.items()},
          "rc": {k: v["rc"] for k, v in done.items()},
          "optimize_losses": [float(losses[1]), float(losses[2])],
          "render_launches": cli_launches,
          "render_wide4_launches": wide4_launches, "card": smi})
    if not all(checks.values()):
        raise AssertionError(f"app/cli: {checks}")
    program.clear_programs()  # the phase's captured frames
    torch.cuda.synchronize()
    emit({"phase": "app", "seconds": time.perf_counter() - t_phase,
          "card": smi})
    return {"resilient_worker": second["captured_frame_launches"],
            "cli_render": {k: v for k, v in
                           cli_launches["captured_frame"].items() if v}}


def host_ms(fn, reps: int = 3):
    """(median ms, last result) of ``fn`` by the host clock, each call
    closed by ``torch.cuda.synchronize()``."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def records_mismatch(a, b) -> dict:
    """Per record of two ``TraceRecords``: how many values differ in
    their bits."""
    import numpy as np

    from pnraytracing_tpu_torch.convert import records_to_arrays

    ra, rb = records_to_arrays(a), records_to_arrays(b)
    if sorted(ra) != sorted(rb):
        raise AssertionError(f"records of other fields: {sorted(ra)} / "
                             f"{sorted(rb)}")
    bits = lambda x: x.view(np.int32) if x.dtype == np.float32 else x
    return {k: int((bits(ra[k]) != bits(rb[k])).sum()) for k in ra}


def trace_parity(label, scene, rays, frame, cfg, modules, tables, counts,
                 expected) -> dict:
    """``trace_paths`` through the kernels (launches counted from 0,
    against ``expected``) and with every walk routed to its plain version
    on the card: the records bit for bit."""
    from pnraytracing_tpu_torch.render.integrator import trace_paths

    zero_counts(*tables)
    recs = trace_paths(scene, *rays, frame, cfg)
    launches = counts()
    want = dict({k: 0 for k in launches}, **expected)
    if launches != want:
        raise AssertionError(f"{label}: trace launched {launches}, "
                             f"expected {want}")
    rec = Recorder(*modules)
    try:
        plain = trace_paths(scene, *rays, frame, cfg)
    finally:
        rec.restore()
    bad = records_mismatch(recs, plain)
    if any(bad.values()):
        raise AssertionError(f"{label}: trace records through the kernels "
                             f"differ from the plain walks': {bad}")
    return {"launches": {k: v for k, v in launches.items() if v},
            "records_mismatch": bad,
            "valid_primary": int(recs.primary.valid.sum())}


def layout_changes(a, b, path="scene") -> list:
    """The fields of two scenes whose layout differs (a tensor's shape,
    dtype or device, another field's value), by path."""
    import dataclasses

    from pnraytracing_tpu_torch.diff.program import _layout

    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return [c for f in dataclasses.fields(a) for c in layout_changes(
            getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")]
    return [] if _layout(a) == _layout(b) else [path]


def captured_step(label, call, tables, counts, expected):
    """A gradient entry point on the card as one captured program
    (diff/program.py): ``call(eager=False)`` replays the step's program,
    ``call(eager=True)`` runs it op by op.  The programs are cleared and
    the counters zeroed just before the first call, which captures
    (``WARMUP_STEPS`` warm-up steps and the capture each count
    ``expected``; the program keeps ``expected``), and read just after;
    the pool bytes are what the program keeps reserved.  Then replays
    against eager steps, loss and every gradient leaf bit for bit (a
    replay counts no launch), wall ms of each (3 eager, 5 replayed), one
    of each under the profiler (device busy ms, idle share) and each
    one's peak memory.  Returns ``(figures, the replayed step's (loss,
    grads), its median ms)``."""
    import torch

    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.diff import program as sp
    from pnraytracing_tpu_torch.render.program import clear_programs

    clear_programs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    captures0 = sp.CAPTURES["steps"]
    zero_counts(*tables)
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    got = counts()
    (prog,) = sp._programs.values()
    want = dict({k: 0 for k in got}, **expected)
    n = sp.WARMUP_STEPS + 1
    if (prog.launches != want or sp.CAPTURES["steps"] != captures0 + 1
            or got != {k: n * v for k, v in want.items()}):
        raise AssertionError(f"{label}: launches at capture {prog.launches} "
                             f"(counters {got}), expected {want} ({n} "
                             f"times with the warm-up)")
    torch.cuda.empty_cache()  # the warm-up's blocks; the pool stays
    pool_bytes = torch.cuda.memory_reserved() - reserved0
    figures = {"capture_s": capture_s,
               "graph_capture_s": prog.capture_seconds,
               "pool_bytes": pool_bytes, "warmup_steps": sp.WARMUP_STEPS,
               "launches_at_capture": {k: v for k, v in
                                       prog.launches.items() if v}}
    results = {}
    for mode, eager, reps in (("eager", True, 3), ("captured", False, 5)):
        got = counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms, results[mode] = host_ms(lambda: call(eager=eager), reps=reps)
        peak = torch.cuda.max_memory_allocated() - base
        prof = profile_frame(lambda: call(eager=eager), ms, top=5)
        figures[mode] = {"wall_ms": ms, "max_memory_allocated": peak,
                         "device_busy_ms": prof["device_busy_ms"],
                         "device_idle_share": prof["device_idle_share"],
                         "device_kernel_calls": prof.get(
                             "device_kernel_calls")}
    if counts() != got:  # since the eager steps
        raise AssertionError(f"{label}: a replay counted launches")
    (lc, gc), (le, ge) = results["captured"], results["eager"]
    equal = {"loss": bool(torch.equal(lc, le))}
    for k in gc:
        equal[k] = all(torch.equal(a, b) for a, b in zip(
            dg.param_leaves({k: gc[k]}), dg.param_leaves({k: ge[k]})))
    if not all(equal.values()):
        raise AssertionError(f"{label}: the captured step differs from the "
                             f"eager step: {equal}")
    figures["captured_equals_eager"] = equal
    return figures, results["captured"], figures["captured"]["wall_ms"]


def grad_phase(RenderConfig, scene, camera, dev, modules, tables, counts,
               smi, size=WIDTH, depth=DEPTH) -> dict:
    """The gradient path on the flagship at ``size``^2, depth ``depth``,
    default ``RenderConfig``: the trace (kernels 1, 2, 4; records against
    the plain walks bit for bit), the replay against the eager live
    frame, the replay gradient (materials and env texels, spp 2, dual
    loss: trace, replay forward and backward timed apart, peak memory,
    norms), the live gradient (kernel 3 instead of 1; its gradient
    against the replay's), each step also as one captured program
    against its eager step (:func:`captured_step`), one positions step
    with ``refit_scene`` (and the refit scene's trace and captured
    frame), three ``adam_optimize`` steps captured and eager (one
    capture; equal losses and parameters) and three positions steps
    (captures reported).  Returns the launches of the trace, of the live
    gradient and of the captured steps for the kernels line."""
    import torch

    from pnraytracing_tpu_torch.core.camera import camera_rays
    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.render.integrator import (
        render_rays,
        render_rays_replay,
        trace_paths,
    )
    from pnraytracing_tpu_torch.render.renderer import (
        pixel_coords,
        render_frame,
    )

    cfg = RenderConfig(width=size, height=size, max_depth=depth)
    px, py = pixel_coords(cfg, dev)
    o, d, _ = camera_rays(camera, size, size)
    rays = (o, d, px, py)
    r = size * size
    spp, keys = 2, ("materials", "env_image")
    trace_expected = dict(closest_hit_attr=1 + depth, any_hit=depth,
                          treelet_entry_key=cfg.sort_max_bounce)
    out = {"phase": "grad", "width": size, "height": size, "depth": depth,
           "spp": spp, "keys": list(keys)}

    # 1. the trace: the kernels' records against the plain walks'
    out["trace"] = trace_parity("grad/flagship", scene, rays, 3, cfg,
                                modules, tables, counts, trace_expected)
    trace_ms, recs = host_ms(lambda: trace_paths(scene, *rays, 3, cfg))

    # 2. the replay against the eager live frame of the same sample
    live = render_rays(scene, *rays, 3, cfg)
    replay = render_rays_replay(scene, *rays, 3, cfg, recs)
    if not (torch.isfinite(replay).all() and replay.shape == (r, 3)):
        raise AssertionError("the replayed frame is not finite [R, 3]")
    out["replay_vs_live"] = {
        "max_abs_diff": float((replay - live).abs().max()),
        "share_differing": float((replay != live).float().mean()),
        "pixels_off_3e-5": int(((replay - live).abs().amax(dim=-1)
                                > 3e-5).sum())}

    # 3. the replay gradient, its phases timed apart on one sample
    target = torch.full((r, 3), 0.25, device=dev)
    params = dg.extract_params(scene, keys)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in dg.param_leaves(params)]
    p = dg.params_like(params, leaves)

    def forward():
        img = render_rays_replay(dg.apply_params(scene, p), *rays, 3, cfg,
                                 recs)
        return torch.mean((img - target) ** 2)

    fwd_ms, _ = host_ms(forward)
    bwd = []
    for _ in range(3):
        loss = forward()
        bwd.append(host_ms(lambda: torch.autograd.grad(
            loss, leaves, allow_unused=True),
                           reps=1)[0])
    loss = forward()
    bwd_profile = profile_frame(lambda: torch.autograd.grad(
        loss, leaves, allow_unused=True), sorted(bwd)[1], top=10)
    emit({"phase": "grad_profile", "width": size, "height": size,
          "depth": depth, "replay_forward": profile_frame(
              forward, fwd_ms, top=10), "backward": bwd_profile})
    del loss
    busy = bwd_profile["device_busy_ms"]
    out["backward_budget"] = {
        "device_busy_ms": busy, "wall_ms": sorted(bwd)[1],
        "device_kernel_calls": bwd_profile.get("device_kernel_calls"),
        "budget_ms": BACKWARD_BUDGET_MS,
        "within_budget": busy is not None and busy <= BACKWARD_BUDGET_MS}
    # the step as one captured program (diff/program.py): its capture
    # (launches counted), then the captured step against the eager step,
    # loss and every gradient leaf bit for bit, timed and profiled
    replay_step = lambda p_, eager=False: dg.loss_and_grad_replay(
        p_, scene, *rays, 3, target, cfg, spp=spp, eager=eager)
    out["captured_replay"], (loss_r, g_r), step_ms = captured_step(
        "replay", lambda eager=False: replay_step(params, eager),
        tables, counts, {k: spp * v for k, v in trace_expected.items()})
    peak_r = out["captured_replay"]["eager"]["max_memory_allocated"]
    norms = {k: float(torch.linalg.vector_norm(torch.cat([
        g.reshape(-1) for g in dg.param_leaves({k: g_r[k]})])))
        for k in keys}
    finite = all(torch.isfinite(g).all() for g in dg.param_leaves(g_r))
    if not finite or not all(v > 0 for v in norms.values()):
        raise AssertionError(f"replay gradient not finite and non-zero: "
                             f"{norms}")
    # the gate: two runs of one step give the same gradient bit for bit
    # (ops/gather.py: the gathers' backward sums each row in a fixed
    # order), for materials, env texels and vertex positions; the step
    # replayed from its program, each run a copy of the program's
    # outputs, and both equal to the eager step
    all_keys = ("materials", "env_image", "positions")
    p_all = dg.extract_params(scene, all_keys)
    runs = [replay_step(p_all) for _ in range(2)] + [replay_step(p_all,
                                                                 True)]
    same = {k: all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(*(dg.param_leaves({k: r_[1][k]})
                                        for r_ in runs))) for k in all_keys}
    same["loss"] = (torch.equal(runs[0][0], runs[1][0])
                    and torch.equal(runs[0][0], runs[2][0]))
    if not all(same.values()):
        raise AssertionError(f"two runs of one gradient step, or a run and "
                             f"the eager step, differ: {same}")
    out["reproducible"] = same
    del runs
    out["replay_gradient"] = {
        "loss": float(loss_r), "trace_ms": trace_ms,
        "replay_forward_ms": fwd_ms,
        "backward_ms": sorted(bwd)[1], "loss_and_grad_ms": step_ms,
        "max_memory_allocated": peak_r, "grad_norms": norms}

    # 4. the live gradient: the walks inside the differentiated pass
    zero_counts(*tables)
    dg.loss_and_grad(params, scene, *rays, 3, target, cfg, spp=spp,
                     eager=True)
    live_launches = counts()
    want = dict({k: 0 for k in live_launches}, closest_hit=spp * (1 + depth),
                any_hit=spp * depth,
                treelet_entry_key=spp * cfg.sort_max_bounce)
    if live_launches != want:
        raise AssertionError(f"loss_and_grad launched {live_launches}, "
                             f"expected {want}")
    out["captured_live"], (loss_l, g_l), live_ms = captured_step(
        "live", lambda eager=False: dg.loss_and_grad(
            params, scene, *rays, 3, target, cfg, spp=spp, eager=eager),
        tables, counts, {k: v for k, v in want.items() if v})
    peak_l = out["captured_live"]["eager"]["max_memory_allocated"]
    # gate: the live gradient against the replay gradient of a trace on
    # the live pass's own route (kernel_interaction off: kernel 3 and
    # make_interaction, so the same rays and records): per key within
    # 1e-4 in norm (the backward's atomics sum in another order).  The
    # default replay's trace runs kernel 1, whose hit point o + t d
    # starts the next bounce an ulp or so away from make_interaction's:
    # some paths then part, and its distance to the live gradient is
    # reported beside it (not gated), with the records that differ.
    cfg_live = dataclasses.replace(cfg, kernel_interaction=False)
    _, g_same = dg.loss_and_grad_replay(params, scene, *rays, 3, target,
                                        cfg_live, spp=spp, eager=True)

    def versus(g_a, g_b):
        out_ = {}
        for k in keys:
            a = torch.cat([g.reshape(-1)
                           for g in dg.param_leaves({k: g_a[k]})])
            b = torch.cat([g.reshape(-1)
                           for g in dg.param_leaves({k: g_b[k]})])
            big = b.abs() > 1e-3 * b.abs().max()
            out_[k] = {
                "rel_norm_err": float(torch.linalg.vector_norm(a - b)
                                      / torch.linalg.vector_norm(b)),
                "max_rel_err": float(((a - b).abs() / b.abs())[big].max()),
                "max_abs_err_over_max": float((a - b).abs().max()
                                              / b.abs().max())}
        return out_

    agree = versus(g_l, g_same)
    if not all(v["rel_norm_err"] <= 1e-4 for v in agree.values()):
        raise AssertionError(f"live and replay gradients differ: {agree}")
    routes = records_mismatch(recs, trace_paths(scene, *rays, 3, cfg_live))
    out["live_gradient"] = {
        "loss": float(loss_l), "ms": live_ms,
        "max_memory_allocated": peak_l,
        "launches": {k: v for k, v in live_launches.items() if v},
        "vs_replay_same_route": agree,
        "tolerance": "rel_norm_err <= 1e-4 a key",
        "vs_replay_default_route": versus(g_l, g_r),
        "records_differing_between_routes": {
            k: v for k, v in routes.items() if k.endswith(".tri")
            or k.endswith("_occ")}}

    # 5. one positions step, refit on the host, the refit scene traced
    # and captured anew
    pos = {"positions": scene.mesh.positions}
    _, g_p = dg.loss_and_grad_replay(pos, scene, *rays, 5, target, cfg)
    gp = g_p["positions"]
    if not (torch.isfinite(gp).all() and float(gp.abs().max()) > 0):
        raise AssertionError("positions gradient not finite and non-zero")
    moved = dg.apply_params(scene, {
        "positions": scene.mesh.positions - 1e-3 * torch.sign(gp)})
    t0 = time.perf_counter()
    refit = dg.refit_scene(moved)
    torch.cuda.synchronize()
    refit_ms = (time.perf_counter() - t0) * 1e3
    zero_counts(*tables)
    trace_paths(refit, *rays, 5, cfg)
    refit_launches = counts()
    if refit_launches != dict({k: 0 for k in refit_launches},
                              **trace_expected):
        raise AssertionError(f"refit scene's trace launched "
                             f"{refit_launches}")
    replayed = render_frame(refit, camera, cfg, 5, device=dev)
    eager = render_frame(refit, camera, cfg, 5, device=dev, eager=True)
    if not torch.equal(replayed, eager):
        raise AssertionError("the refit scene's captured frame is not its "
                             "eager frame")
    out["positions_step"] = {
        "grad_norm": float(torch.linalg.vector_norm(gp)),
        "refit_host_ms": refit_ms, "bvh_depth": refit.bvh_depth,
        "refit_trace_launches": {k: v for k, v in refit_launches.items()
                                 if v},
        "refit_replayed_equals_eager": True}

    # 6. three steps of the optimizer on materials and env texels: one
    # captured step replayed three times, its losses and parameters those
    # of the eager run; then three positions steps, each refit copied
    # into the program's scene while its layout holds
    from pnraytracing_tpu_torch.diff import program as sp

    adam = {}
    for label, keys_, spp_, eager in (
            ("captured", keys, spp, False), ("eager", keys, spp, True),
            ("positions", ("positions",), 1, False)):
        logs = []
        captures0 = sp.CAPTURES["steps"]
        t0 = time.perf_counter()
        res, losses = dg.adam_optimize(
            scene, camera, cfg, target.reshape(size, size, 3), keys=keys_,
            steps=3, spp_per_step=spp_, log_every=1, log_fn=logs.append,
            device=dev, eager=eager)
        adam_s = time.perf_counter() - t0
        if not all(map(lambda x: x == x and abs(x) < 1e30, losses)):
            raise AssertionError(f"adam {label} losses {losses}")
        adam[label] = {"losses": losses, "seconds": adam_s,
                       "captures": sp.CAPTURES["steps"] - captures0,
                       "step_ms": [json.loads(x)["step_s"] * 1e3
                                   for x in logs],
                       "rays_per_s": [json.loads(x)["rays_per_s"]
                                      for x in logs]}
        adam[label]["params"] = dg.param_leaves(dg.extract_params(res,
                                                                  keys_))
        if label == "positions":  # what the refits changed the shape of
            adam[label]["layout_changed"] = layout_changes(scene, res)
    same = (adam["captured"]["losses"] == adam["eager"]["losses"]
            and all(torch.equal(a, b) for a, b in zip(
                adam["captured"]["params"], adam["eager"]["params"])))
    if not (same and adam["captured"]["captures"] == 1
            and adam["eager"]["captures"] == 0
            and adam["positions"]["captures"] >= 1):
        raise AssertionError(f"adam_optimize: captured run equal to the "
                             f"eager run {same}, captures "
                             f"{[v['captures'] for v in adam.values()]}")
    for v in adam.values():
        del v["params"]
    out["adam"] = dict(adam["captured"], eager=adam["eager"],
                       positions=adam["positions"],
                       captured_equals_eager=True)
    out["card"] = smi
    emit(out)
    return {"trace": out["trace"]["launches"],
            "live_gradient": {k: v // spp for k, v in
                              out["live_gradient"]["launches"].items()},
            "captured_replay_step": out["captured_replay"][
                "launches_at_capture"],
            "captured_live_step": out["captured_live"][
                "launches_at_capture"]}


def grad_stream_phase(RenderConfig, scene, camera, dev, modules, tables,
                      counts, smi) -> None:
    """The trace of the streamed config5 at 128x128, depth 2, through the
    stream kernels (kernel 7 both modes and kernel 4, counted) against
    the plain stream walks, records bit for bit."""
    from pnraytracing_tpu_torch.core.camera import camera_rays
    from pnraytracing_tpu_torch.render.renderer import pixel_coords

    cfg = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                       max_depth=PARITY_DEPTH)
    px, py = pixel_coords(cfg, dev)
    o, d, _ = camera_rays(camera, PARITY_SIZE, PARITY_SIZE)
    res = trace_parity("grad/config5", scene, (o, d, px, py), 3, cfg,
                       modules, tables, counts,
                       dict(closest_hit_stream=1 + PARITY_DEPTH,
                            any_hit_stream=PARITY_DEPTH,
                            treelet_entry_key=cfg.sort_max_bounce))
    emit({"phase": "grad_stream", "width": PARITY_SIZE,
          "height": PARITY_SIZE, "depth": PARITY_DEPTH, **res, "card": smi})


def options_phase(render_frame, RenderConfig, scene, camera, dev, modules,
                  tables, counts, smi) -> None:
    """Phase 11: the ray-ordering and sampling options on the flagship.
    Each option's 128x128 frame (depth ``PARITY_DEPTH``, or ``DEPTH`` for
    ``FULL_DEPTH_OPTIONS``) through the kernels against the plain
    versions, and replayed from its captured program against the
    eager frame (bit for bit, two frame indices); its 512x512 frame's
    launches against the table (any ordering but the entry sort launches
    no key kernel, unfused shadows two any-hits a bounce); then ms/frame
    of the timed options over 5 eager frames after a warm-up in two
    rounds of opposite order, and over 10 replayed frames in four, and
    one profiled eager frame each: device busy ms and the port's
    kernels' sum (a replay runs the same kernels)."""
    import torch

    from pnraytracing_tpu_torch.render.renderer import (
        render_frame as replayed_frame,
    )

    parity, replay, launches = {}, {}, {}
    for name, kw in OPTIONS.items():
        cfgp = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                            max_depth=(DEPTH if name in FULL_DEPTH_OPTIONS
                                       else PARITY_DEPTH), **kw)
        if kw:  # the default's parity is phase 5
            parity[name] = frame_parity(render_frame, scene, camera, cfgp,
                                        dev, modules)
        replay[name] = replay_parity(scene, camera, cfgp, dev)
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH, **kw)
        img, got = frame_launches(render_frame, scene, camera, cfg, dev,
                                  tables, counts)
        keyed = (cfg.compact_rays and cfg.sort_rays
                 and cfg.sort_key == "entry")
        want = dict({k: 0 for k in got}, closest_hit_attr=1 + DEPTH,
                    any_hit=DEPTH * (1 if cfg.fuse_shadows else 2),
                    treelet_entry_key=cfg.sort_max_bounce if keyed else 0)
        if got != want:
            raise AssertionError(f"{name}: launches per frame {got}, "
                                 f"expected {want}")
        check_image(name, img, cfg)
        launches[name] = {k: v for k, v in got.items() if v}
    emit({"phase": "options_parity", "parity_128": parity,
          "replay_128": replay, "launches_per_frame": launches})

    cfgs = {n: RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH,
                            **OPTIONS[n]) for n in TIMED_OPTIONS}
    ms = {n: [] for n in TIMED_OPTIONS}
    ms_replayed = {n: [] for n in TIMED_OPTIONS}

    def timed(fn, n, frames):
        fn(scene, camera, cfgs[n], 2, device=dev)  # (a replay captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(frames):
            fn(scene, camera, cfgs[n], 3 + f, device=dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / frames

    for rnd in range(4):  # eager in the first two rounds only
        for n in (TIMED_OPTIONS if rnd % 2 == 0 else TIMED_OPTIONS[::-1]):
            if rnd < 2:
                ms[n].append(timed(render_frame, n, 5))
            ms_replayed[n].append(timed(replayed_frame, n, 10))
    prof = {}
    for n in TIMED_OPTIONS:
        p = profile_frame(lambda: render_frame(scene, camera, cfgs[n], 12,
                                               device=dev),
                          sum(ms[n]) / len(ms[n]))
        ours = p.get("port_kernels") or {}
        prof[n] = {"device_busy_ms": p["device_busy_ms"],
                   "device_idle_share": p["device_idle_share"],
                   "device_kernel_calls": p.get("device_kernel_calls"),
                   "port_kernels_ms": sum(v["device_ms"]
                                          for v in ours.values()),
                   "port_kernels": ours}
    emit({"phase": "options", "width": WIDTH, "height": HEIGHT,
          "depth": DEPTH, "ms_per_frame": ms,
          "ms_per_frame_replayed": ms_replayed, "profile": prof,
          "card": smi})


# the untextured catalog: (function of scene/scenes.py, its arguments)
CATALOG = {
    "cornell_box": ("cornell_box", {}),
    "cornell_box/sphere": ("cornell_box", dict(centerpiece="sphere")),
    "scene_flat": ("scene_flat", {}),
    "teapot_scene": ("teapot_scene", {}),
    "config2_teapot": ("config2_teapot", {}),
}


def scene_checks(render_frame, RenderConfig, name, scene, camera, kw, dev,
                 modules, tables, counts) -> dict:
    """One catalog scene on the card at ``PARITY_SIZE``, ``PARITY_DEPTH``
    with the ``RenderConfig`` fields ``kw``: its route, the launches of
    one frame (closest once a path segment, any-hit once a bounce for a
    scene with lights or an environment, none without, the key kernel
    for the sorted bounces), and that frame through the kernels against
    the plain versions."""
    from pnraytracing_tpu_torch.accel.route import traversal_route

    cfg = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                       max_depth=PARITY_DEPTH, **kw)
    route = traversal_route(scene.trav, cfg.kernel_interaction)
    img, got = frame_launches(render_frame, scene, camera, cfg, dev,
                              tables, counts)
    shadows = scene.lights.count > 0 or scene.env is not None
    want = dict({k: 0 for k in got},
                treelet_entry_key=min(cfg.sort_max_bounce, cfg.max_depth),
                any_hit=cfg.max_depth if shadows else 0)
    want["closest_hit_attr" if route == "attr" else "closest_hit"] = (
        1 + cfg.max_depth)
    if got != want:
        raise AssertionError(f"{name}: launches per frame {got}, "
                             f"expected {want}")
    check_image(name, img, cfg)
    return {"triangles": int(scene.trav.tri9.shape[0]), "route": route,
            "launches_per_frame": {k: v for k, v in got.items() if v},
            "parity_128": frame_parity(render_frame, scene, camera, cfg,
                                       dev, modules)}


def catalog_phase(render_frame, RenderConfig, dev, modules, tables,
                  counts) -> None:
    """Phase 12: each scene of the untextured catalog built on the card
    and checked by :func:`scene_checks`."""
    from pnraytracing_tpu_torch.scene import scenes

    out = {}
    for name, (fn, kw) in CATALOG.items():
        t0 = time.perf_counter()
        if fn == "config2_teapot":
            scene, cam_state = scenes.config2_teapot(device=dev, **kw)
        else:
            builder, cam_state = getattr(scenes, fn)(**kw)
            scene = builder.build(device=dev)
        build_s = time.perf_counter() - t0
        out[name] = dict(
            seconds=build_s, light_triangles=int(scene.lights.count),
            env=scene.env is not None,
            **scene_checks(render_frame, RenderConfig, name, scene,
                           cam_state.basis(device=dev), {}, dev, modules,
                           tables, counts))
    emit({"phase": "catalog", "scenes": out})


# the textured configurations: (function of scene/scenes.py, the extra
# RenderConfig fields of each frame checked)
TEXTURED = {
    "config1_triangle": ("config1_triangle", {}),
    "config4_marry": ("config4_marry", {}),
    "config4_marry/lod": ("config4_marry", dict(texture_lod_scale=0.0065)),
}


def textures_phase(render_frame, RenderConfig, dev, modules, tables,
                   counts) -> None:
    """Phase 13: config1_triangle and config4_marry (its stand-in
    branch: checkerboard textures), built on the card, checked by
    :func:`scene_checks` and replayed from the frame's captured program
    against the eager frame; config 4 also with ``texture_lod_scale``
    (trilinear over the mip strip)."""
    from pnraytracing_tpu_torch.scene import scenes

    out, built = {}, {}
    for name, (fn, kw) in TEXTURED.items():
        t0 = time.perf_counter()
        if fn not in built:
            scene, cam_state = getattr(scenes, fn)(device=dev)
            built[fn] = (scene, cam_state.basis(device=dev))
        scene, camera = built[fn]
        build_s = time.perf_counter() - t0
        cfg = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                           max_depth=PARITY_DEPTH, **kw)
        out[name] = dict(
            seconds=build_s, textures=scene.textures.count,
            textured_triangles=int((scene.mesh.texture_id >= 0).sum()),
            **scene_checks(render_frame, RenderConfig, name, scene, camera,
                           kw, dev, modules, tables, counts),
            replay_128=replay_parity(scene, camera, cfg, dev))
    emit({"phase": "textures", "scenes": out})


def stream_phases(render_frame, RenderConfig, dev, smi, modules, tables,
                  counts, cfgp, built) -> tuple:
    """Phases 14-16: config5_large through the brick-streaming kernels.
    Returns their rows of the kernels line, the times of the resident
    wide kernels on config5's rays, by wrapper name, and the scene and
    its camera."""
    import torch

    from pnraytracing_tpu_torch.accel.bricks import build_stream_data
    from pnraytracing_tpu_torch.accel.route import traversal_route
    from pnraytracing_tpu_torch.ops import shade
    from pnraytracing_tpu_torch.scene.scenes import config5_large

    _, trv, trs, compaction = modules

    # ---- 9. the scene ---------------------------------------------------
    t0 = time.perf_counter()
    scene, cam_state = config5_large(device=dev)
    camera = cam_state.basis(device=dev)
    build_s = time.perf_counter() - t0
    trav = scene.trav
    s = trav.stream
    route = traversal_route(trav, True)
    emit({"phase": "stream_scene", "seconds": build_s,
          "triangles": trav.tri9.shape[0], "bricks": s.n_bricks,
          "brick_kb": s.brick_words * 4 / 1024, "top_rows": s.n_top_rows,
          "brick_stack": s.brick_stack, "kernels": trs.kernel_info(trav),
          "bvh_depth": trav.bvh_depth, "treelets": trav.treelets.shape[0],
          "route": route})
    if route != "stream" or trav.tri9.shape[0] != 102404:
        raise AssertionError("config5_large must stream its 102,404 "
                             "triangles")

    # ---- 10. stream kernels vs plain, and vs the resident walk --------
    cfg1 = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=1)
    _, calls = record_frame(render_frame, scene, camera, cfg1, dev, *modules)
    primary, cont = calls["closest_hit_stream"][:2]
    shadow = calls["any_hit_stream"][0]
    r = primary[1].x.shape[0]
    res = {}
    for label, args in (("primary", primary), ("bounce0", cont)):
        o, d, tm, mask = rays_of(args)
        got, st = trs.closest_hit_stream(trav, o, d, tm, mask,
                                         with_stats=True)
        want, wst = trs.plain_closest_hit_stream(trav, o, d, tm, mask,
                                                 with_stats=True)
        bad, err = check_closest("closest_hit_stream/" + label, got, want, r)
        if bad or err or st.shape != (4, r) or not torch.equal(st, wst):
            raise AssertionError(
                f"closest_hit_stream/{label}: {bad} tri mismatches, max "
                f"|dt| {err}, stats equal {torch.equal(st, wst)}: the "
                "kernel must equal its plain version bit for bit")
        res_bad, res_err = check_closest(
            "closest_hit_resident_vs_stream/" + label,
            trv.closest_hit(trav, o, d, tm, mask), want, r)
        res[label] = {"tri_mismatch": bad, "err": err, "stats_equal": True,
                      "resident_tri_mismatch": res_bad,
                      "resident_err": res_err,
                      "pops_per_ray": float(st[0].sum()) / r,
                      "bricks_per_ray": float(st[3].sum()) / r}
    so, sd, stm, smask = rays_of(shadow)
    occ, st = trs.any_hit_stream(trav, so, sd, stm, smask, with_stats=True)
    wocc, wst = trs.plain_any_hit_stream(trav, so, sd, stm, smask,
                                         with_stats=True)
    occ_bad = check_occ("any_hit_stream", occ, wocc)
    if not torch.equal(st, wst):
        raise AssertionError("any_hit_stream: walk stats differ from the "
                             "plain version")
    res_occ_bad = check_occ("any_hit_resident_vs_stream", occ,
                            trv.any_hit(trav, so, sd, stm, smask))
    # the binary kernels on the same rays, over config5's 7.3 MB of
    # binary rows: hits, occlusion and stats equal their plain versions
    bin_res = binary_parity(trv, trav, cont, shadow, "config5")
    # the key kernel on config5's bounce-0 key rays (K = 388)
    ko, kd, tre, tree = calls["entry_key"][0]
    key_res = check_key("config5", compaction, ko, kd, tre, tree)
    key, kcounts = compaction.entry_key(ko, kd, tre, tree, with_stats=True)
    emit({"phase": "key_figures", "scene": "config5", "rays_of": "bounce0",
          **key_figures(kcounts, key, ko, kd, tree, tre.shape[0])})
    torch.cuda.synchronize()
    emit({"phase": "stream_parity", "rays": r,
          "shadow_rays": int(so.x.shape[0]), "closest": res,
          "entry_key": key_res, "any_hit_mismatch": occ_bad,
          "any_hit_resident_mismatch": res_occ_bad,
          "any_stats_equal": True, "binary": bin_res,
          "any_bricks_per_ray": float(st[3].sum()) / int(so.x.shape[0])})

    # ---- 11. the config5 frame -----------------------------------------
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    render_frame(scene, camera, cfg, 0, device=dev)  # warm-up
    torch.cuda.synchronize()
    zero_counts(*tables)
    img = render_frame(scene, camera, cfg, 1, device=dev)
    torch.cuda.synchronize()
    launches = counts()
    expected = dict({k: 0 for k in launches}, closest_hit_stream=1 + DEPTH,
                    any_hit_stream=DEPTH,
                    treelet_entry_key=cfg.sort_max_bounce)
    fill_launches = {"eager_frame": shade.LAUNCHES["interaction"]}
    if (launches != expected
            or fill_launches["eager_frame"] != fill_per_frame(scene, cfg)):
        raise AssertionError(f"config5 launches per frame {launches}, "
                             f"interaction {fill_launches}, expected "
                             f"{expected}, interaction "
                             f"{fill_per_frame(scene, cfg)}")
    if not (img.shape == (HEIGHT, WIDTH, 3) and torch.isfinite(img).all()
            and float(img.min()) >= 0.0 and float(img.max()) <= 1.0):
        raise AssertionError("config5 frame is not a finite [0,1] image")
    parity = frame_parity(render_frame, scene, camera, cfgp, dev, modules)
    torch.cuda.reset_peak_memory_stats()
    n_frames = 5
    enqueue_ms = []  # host time until render_frame returns, no sync
    t0 = time.perf_counter()
    for f in range(n_frames):
        t1 = time.perf_counter()
        render_frame(scene, camera, cfg, 2 + f, device=dev)
        enqueue_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t0) * 1e3 / n_frames
    peak = torch.cuda.max_memory_allocated()

    # bound: each input read once (rays, the top tree, the brick array).
    # What the walks touch (a 64 B row per internal pop, 36 B per triangle
    # test; re-reads come from the L2) is reported beside it, with the
    # time those bytes would take at the HBM rate.
    scene_bytes = 4 * (s.top16.numel() + s.bricks.numel())

    def touched(st):
        pops, leaf, tris, bricks = (int(x.sum()) for x in st)
        bytes_ = ROW_BYTES * (pops - leaf) + TRI_BYTES * tris
        return {"brick_visits": bricks, "pops": pops, "tri_tests": tris,
                "touched_bytes": bytes_,
                "touched_hbm_ms": bytes_ / HBM_BYTES_PER_S * 1e3}

    # the same tree cut into 96 KB bricks: the kernel's time should barely
    # depend on the brick size
    trav96 = dataclasses.replace(trav, stream=build_stream_data(
        scene.bvh, scene.mesh, 96 << 10, device=dev))
    rows = []
    o, d, tm, mask = rays_of(cont)
    _, st = trs.closest_hit_stream(trav, o, d, tm, mask, with_stats=True)
    got96 = trs.closest_hit_stream(trav96, o, d, tm, mask)
    check_closest("closest_hit_stream/96k", got96, trs.closest_hit_stream(
        trav, o, d, tm, mask), r)
    bnd = bound(r * (RAY_IN + 16) + scene_bytes, trav_ops(st))
    rows.append(dict(
        name="closest_hit_stream",
        source="pnraytracing_tpu_torch/csrc/traverse_stream.cu",
        replaces="pnraytracing_tpu/accel/traverse_stream.py:87",
        launches=launches["closest_hit_stream"],
        max_abs_err=max(v["err"] for v in res.values()),
        tri_mismatch=sum(v["tri_mismatch"] for v in res.values()),
        ms=time_ms(lambda: trs.closest_hit_stream(trav, o, d, tm, mask), 10),
        plain_ms=time_ms(lambda: trs.plain_closest_hit_stream(
            trav, o, d, tm, mask), 1),
        resident_ms=time_ms(lambda: trv.closest_hit(trav, o, d, tm, mask),
                            10),
        ms_96k=time_ms(lambda: trs.closest_hit_stream(trav96, o, d, tm,
                                                      mask), 10),
        resident_pops=int(trv.closest_hit(trav, o, d, tm, mask,
                                          with_stats=True)[1][0].sum()),
        bound_ms=bnd[0], bound_by=bnd[1], **touched(st)))
    rs = so.x.shape[0]
    _, st = trs.any_hit_stream(trav, so, sd, stm, smask, with_stats=True)
    check_occ("any_hit_stream/96k", trs.any_hit_stream(
        trav96, so, sd, stm, smask), occ)
    bnd = bound(rs * (RAY_IN + 1) + scene_bytes, trav_ops(st))
    rows.append(dict(
        name="any_hit_stream",
        source="pnraytracing_tpu_torch/csrc/traverse_stream.cu",
        replaces="pnraytracing_tpu/accel/traverse_stream.py:87",
        launches=launches["any_hit_stream"], max_abs_err=float(occ_bad),
        mismatches=occ_bad,
        ms=time_ms(lambda: trs.any_hit_stream(trav, so, sd, stm, smask), 10),
        plain_ms=time_ms(lambda: trs.plain_any_hit_stream(
            trav, so, sd, stm, smask), 1),
        resident_ms=time_ms(lambda: trv.any_hit(trav, so, sd, stm, smask),
                            10),
        ms_96k=time_ms(lambda: trs.any_hit_stream(trav96, so, sd, stm,
                                                  smask), 10),
        resident_pops=int(trv.any_hit(trav, so, sd, stm, smask,
                                      with_stats=True)[1][0].sum()),
        bound_ms=bnd[0], bound_by=bnd[1], **touched(st)))
    # kernels 1-3 on the same rays (the resident tables of the large
    # scene: 3.6 MB of rows, 4.9 MB of padded triangles, all in the L2)
    hit, _, st = trv.closest_hit_attr(trav, o, d, tm, mask, with_stats=True)
    figures = {"closest_hit_attr": walk_figures(
        st, fills=int(hit.valid.sum()))}
    figures["closest_hit"] = walk_figures(
        trv.closest_hit(trav, o, d, tm, mask, with_stats=True)[1])
    figures["any_hit"] = walk_figures(
        trv.any_hit(trav, so, sd, stm, smask, with_stats=True)[1])
    on_config5 = {
        "closest_hit_attr": time_ms(lambda: trv.closest_hit_attr(
            trav, o, d, tm, mask), 10),
        "closest_hit": rows[0]["resident_ms"],
        "any_hit": rows[1]["resident_ms"],
        "treelet_entry_key": time_ms(lambda: compaction.entry_key(
            ko, kd, tre, tree), 20),
        "closest_hit_binary": time_ms(lambda: trv.closest_hit(
            trav, o, d, tm, mask, variant="binary"), 20),
        "any_hit_binary": time_ms(lambda: trv.any_hit(
            trav, so, sd, stm, smask, variant="binary"), 20)}
    emit({"phase": "walk_figures", "scene": "config5", "ms": on_config5,
          "kernels": figures})
    emit({"phase": "stream_frame", "width": WIDTH, "height": HEIGHT,
          "depth": DEPTH, "frames": n_frames, "ms_per_frame": ms_frame,
          "rays_per_s": QUERIES_PER_FRAME / (ms_frame / 1e3),
          "queries_per_frame": QUERIES_PER_FRAME,
          "enqueue_ms": enqueue_ms,
          "launches_per_frame": launches, "parity_128": parity,
          "mean": float(img.mean()), "max_memory_allocated": peak,
          "bricks_96k": trav96.stream.n_bricks,
          "stream_ms": {row["name"]: {k: row[k] for k in (
              "ms", "ms_96k", "resident_ms")} for row in rows},
          "card": smi})
    emit(dict(phase="stream_profile", **profile_frame(
        lambda: render_frame(scene, camera, cfg, 12, device=dev), ms_frame)))
    rows.append(interaction_row(render_frame, scene, camera, dev,
                                modules[0], built, fill_launches))
    rows += compat_phase("config5", render_frame, RenderConfig, scene, camera,
                         dev, modules, tables, counts,
                         dict(closest_hit_stream_compat=1 + DEPTH,
                              any_hit_stream_compat=DEPTH,
                              treelet_entry_key=cfg.sort_max_bounce),
                         COMPAT_WALKS["stream"], smi)
    program_phase("config5", scene, camera, cfg, dev,
                  dict(closest_hit_stream=1 + DEPTH, any_hit_stream=DEPTH,
                       treelet_entry_key=cfg.sort_max_bounce),
                  tables, counts, smi)
    grad_stream_phase(RenderConfig, scene, camera, dev, modules, tables,
                      counts, smi)
    return rows, on_config5, scene, camera


# ---- bvh: scenes outside the packed layout ---------------------------------

BVH_SUBDIV = 8  # config5_large(subdiv=8): 1,638,404 triangles > 2^20
BVH_TRIANGLES = 1638404
BVH_PARITY_RAYS = 65536
NODE_BYTES = 4 * (6 + 4)  # node_min, node_max, axis, right, start, end


def _strided(v3_or_t, n):
    """``n`` lanes of a recorded batch, evenly strided over all of it
    (continuation rays: live ones first, then the masked tail; fused
    shadow rays: the light half, then the environment half)."""
    import torch

    from pnraytracing_tpu_torch.core.vec import V3

    if v3_or_t is None:
        return None
    t = v3_or_t.x if isinstance(v3_or_t, V3) else v3_or_t
    idx = torch.arange(0, t.shape[0], max(1, t.shape[0] // n),
                       device=t.device)[:n]
    pick = lambda a: a.index_select(0, idx).contiguous()
    return v3_or_t.map(pick) if isinstance(v3_or_t, V3) else pick(v3_or_t)


def _ulp_max(a, b) -> int:
    """The largest distance in float32 steps between ``a`` and ``b``."""
    import torch

    ia, ib = (x.contiguous().view(torch.int32).to(torch.int64)
              for x in (a, b))
    return int((ia - ib).abs().max()) if ia.numel() else 0


def bvh_kernel_rows(trb, scene, cont, shadow, launches, smi) -> list:
    """The walk over the plain BVH (csrc/traverse_bvh.cu), default and
    compat, against its plain version on ``BVH_PARITY_RAYS`` of the
    recorded bounce-0 continuation rays and fused shadow rays: tri
    mismatches <= 0.001% (exact-t ties), t and b equal bit for bit where
    tri is, occlusion and the [3, R] stats (pops, slab tests, triangle
    tests) exact.  Then each kernel's time at the path shapes (all the
    recorded rays), the plain version's time (the parity call), the
    bound from this run's stats, and registers.  Returns the kernels
    line's rows."""
    import torch

    bvh, mesh = scene.bvh, scene.mesh
    info = trb.kernel_info()
    tables = (NODE_BYTES * bvh.node_min.shape[0]
              + 4 * (mesh.indices.numel() + mesh.positions.numel()))
    rows, res = [], {}
    for closest, args in ((True, cont), (False, shadow)):
        o, d, tm, mask = args[2], args[3], args[4], args[5]
        po, pd, ptm, pmask = (_strided(x, BVH_PARITY_RAYS)
                              for x in (o, d, tm, mask))
        n = po.x.shape[0]
        name = "closest_hit_bvh" if closest else "any_hit_bvh"
        kern = trb.closest_hit if closest else trb.any_hit
        plain = trb.plain_closest_hit if closest else trb.plain_any_hit
        for compat in (False, True):
            cname = name + ("_compat" if compat else "")
            got, st = kern(bvh, mesh, po, pd, ptm, pmask, compat=compat,
                           with_stats=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, wst = plain(bvh, mesh, po, pd, ptm, pmask, compat=compat,
                              with_stats=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            check_stats(cname, st, wst)
            if closest:
                bad, err = check_closest(cname, got, want, n)
                same = got.tri == want.tri
                ulps = max(_ulp_max(getattr(got, k)[same],
                                    getattr(want, k)[same])
                           for k in ("t", "b1", "b2"))
                if ulps:
                    raise AssertionError(f"{cname}: t / b differ from the "
                                         f"plain version by {ulps} ulp")
            else:
                bad = check_occ(cname, got, want)
                err, ulps = float(bad), 0
            # the path shapes: every recorded ray
            r = o.x.shape[0]
            _, fst = kern(bvh, mesh, o, d, tm, mask, compat=compat,
                          with_stats=True)
            slabs, tests = (int(fst[k].sum()) for k in (1, 2))
            bnd = bound(r * (RAY_IN + (16 if closest else 1)) + tables,
                        OPS_AABB * slabs + OPS_TRIANGLE * tests)
            per_ray = lambda x: float(x.to(torch.int64).sum()) / max(r, 1)
            rows.append(dict(
                name=cname,
                source="pnraytracing_tpu_torch/csrc/traverse_bvh.cu",
                replaces="pnraytracing_tpu/accel/traverse.py:"
                         + ("106" if closest else "243")
                         + " (an XLA walk, not a TPU kernel)",
                launches=0 if compat else launches.get(cname, 0),
                max_abs_err=err, mismatches=bad, t_b_ulps=ulps,
                parity_rays=n,
                ms=time_ms(lambda: kern(bvh, mesh, o, d, tm, mask,
                                        compat=compat), 10),
                plain_ms=plain_ms, plain_rays=n, rays=r,
                bound_ms=bnd[0], bound_by=bnd[1],
                pops_per_ray=per_ray(fst[0]), slabs_per_ray=slabs / r,
                tri_tests_per_ray=tests / r, max_pops=int(fst[0].max()),
                **info[cname]))
            res[cname] = {"rays": n, "mismatches": bad, "t_b_ulps": ulps,
                          "stats_equal": True}
    emit({"phase": "bvh_kernels", "parity": res,
          "ms": {row["name"]: row["ms"] for row in rows},
          "plain_ms": {row["name"]: row["plain_ms"] for row in rows},
          "card": smi})
    return rows


def bvh_phase(render_frame, RenderConfig, dev, modules, tables, counts,
              c5, c5_cam, smi) -> tuple[list, dict]:
    """Phase bvh: scenes outside the packed layout.  (1) config5_large
    (subdiv 8, 1,638,404 triangles > 2^20) built by the native builder:
    no traversal layout, route ``bvh``, the tree within the kernel's
    stack.  (2) :func:`bvh_kernel_rows` on its 512x512 bounce-0 rays.
    (3) A 512x512 depth-4 frame: launches (5 closest + 4 any of the new
    walk, no key kernel: rays are only compacted), then phase program's
    capture, replay = eager, ms/frame and device busy.  (4) Its 128x128
    depth-2 frame through the kernels against the plain versions.  (5)
    ``config2_teapot(flat_bvh=True)`` with max_leaf_size = its triangle
    count: its 128x128 depth-2 frame against the packed-route frame of
    ``config2_teapot()`` (route 'wide', closest + make_interaction as on
    route 'bvh'; atol 2e-5, tests/test_render.py's tolerance, on all but
    0.02% of pixels), the default 'attr' route's distance beside it.  (6)
    Route ``binary``: config5 (subdiv 6) without its stream layout,
    through kernels 5 / 6: launches of a 512x512 depth-4 frame and the
    128x128 depth-2 frame against the plain versions.  Returns the
    kernels line's rows and the binary route's launches."""
    import torch

    from pnraytracing_tpu_torch.accel import traverse as trb
    from pnraytracing_tpu_torch.accel import walks
    from pnraytracing_tpu_torch.accel.route import traversal_route
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.scene.scenes import (
        config2_teapot,
        config5_large,
    )

    t0 = time.perf_counter()
    scene, cam_state = config5_large(subdiv=BVH_SUBDIV, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    camera = cam_state.basis(device=dev)
    n_tris = int(scene.mesh.indices.shape[0])
    route = traversal_route(scene.trav, True)
    leaf = scene.bvh.right_child < 0
    emit({"phase": "bvh_scene", "seconds": build_s, "triangles": n_tris,
          "nodes": int(scene.bvh.node_min.shape[0]),
          "bvh_depth": scene.bvh_depth, "route": route,
          "max_leaf": int((scene.bvh.end - scene.bvh.start)[leaf].max()),
          "kernels": trb.kernel_info()})
    if not (scene.trav is None and route == "bvh"
            and n_tris == BVH_TRIANGLES and scene.bvh_depth <= 64):
        raise AssertionError("config5_large(subdiv=8) must be outside the "
                             "packed layout, routed to 'bvh', within the "
                             "64-entry stack")

    cfg1 = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=1)
    cont = record_inputs(render_frame, scene, camera, cfg1, dev, walks,
                         "closest_hit_bvh")[1]
    shadow = record_inputs(render_frame, scene, camera, cfg1, dev,
                           walks, "any_hit_bvh")[0]

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    img, launches = frame_launches(render_frame, scene, camera, cfg, dev,
                                   tables, counts)
    expected = dict({k: 0 for k in launches}, closest_hit_bvh=1 + DEPTH,
                    any_hit_bvh=DEPTH)
    if launches != expected:
        raise AssertionError(f"bvh frame launches {launches}, expected "
                             f"{expected}")
    check_image("bvh", img, cfg)
    rows = bvh_kernel_rows(trb, scene, cont, shadow, launches, smi)
    del cont, shadow
    prog = program_phase("bvh", scene, camera, cfg, dev, expected, tables,
                         counts, smi)
    cfgp = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                        max_depth=PARITY_DEPTH)
    parity = frame_parity(render_frame, scene, camera, cfgp, dev, modules)
    program.clear_programs()
    del scene, img
    torch.cuda.empty_cache()

    flat, flat_cam = config2_teapot(flat_bvh=True, device=dev)
    packed, _ = config2_teapot(device=dev)
    flat_camera = flat_cam.basis(device=dev)
    size = dict(width=PARITY_SIZE, height=PARITY_SIZE,
                max_depth=PARITY_DEPTH)
    cfg_flat = RenderConfig(max_leaf_size=int(flat.mesh.indices.shape[0]),
                            **size)
    img_flat, flat_launches = frame_launches(render_frame, flat, flat_camera,
                                             cfg_flat, dev, tables, counts)
    want = dict({k: 0 for k in flat_launches},
                closest_hit_bvh=1 + PARITY_DEPTH, any_hit_bvh=PARITY_DEPTH)
    if flat.trav is not None or flat_launches != want:
        raise AssertionError(f"flat config2: trav {flat.trav is not None}, "
                             f"launches {flat_launches}, expected {want}")
    flat_out = {"launches_per_frame": {k: v for k, v in
                                       flat_launches.items() if v}}
    for label, kw in (("wide", dict(kernel_interaction=False)),
                      ("attr", {})):
        ref = render_frame(packed, flat_camera, RenderConfig(**size, **kw),
                           1, device=dev)
        px = (img_flat - ref).abs().amax(dim=-1)
        flat_out[label] = {"outside_atol_2e-5": int((px > 2e-5).sum()),
                           "max_abs_err": float(px.max())}
    limit = int(PARITY_SIZE * PARITY_SIZE * 2e-4)
    if flat_out["wide"]["outside_atol_2e-5"] > limit:
        raise AssertionError(f"flat config2 against the packed route: "
                             f"{flat_out}")
    check_image("flat config2", img_flat, cfg_flat)
    del flat, packed

    c5_binary = dataclasses.replace(c5, trav=dataclasses.replace(
        c5.trav, stream=None))
    if traversal_route(c5_binary.trav, True) != "binary":
        raise AssertionError("config5 without its stream layout must take "
                             "route 'binary'")
    img_b, bin_launches = frame_launches(render_frame, c5_binary, c5_cam,
                                         cfg, dev, tables, counts)
    want = dict({k: 0 for k in bin_launches}, closest_hit_binary=1 + DEPTH,
                any_hit_binary=DEPTH, treelet_entry_key=cfg.sort_max_bounce)
    if bin_launches != want:
        raise AssertionError(f"binary route launches {bin_launches}, "
                             f"expected {want}")
    check_image("binary route", img_b, cfg)
    bin_parity = frame_parity(render_frame, c5_binary, c5_cam, cfgp, dev,
                              modules)
    emit({"phase": "bvh", "triangles": n_tris, "build_s": build_s,
          "launches_per_frame": {k: v for k, v in launches.items() if v},
          "replayed_ms": prog["replayed_ms"], "eager_ms": prog["eager_ms"],
          "parity_128": parity, "flat_config2": flat_out,
          "binary_route": {"launches_per_frame": {
              k: v for k, v in bin_launches.items() if v},
              "parity_128": bin_parity},
          "card": smi})
    return rows, {k: v for k, v in bin_launches.items() if v}


# ---- 20. traversal: the walks of RenderConfig.traversal's XLA values -------

TRAVERSAL_VALUES = ("pallas", "packed", "pop", "packet", "wide", "wide4")
# the walk kernels each value's frame launches (closest, any) besides the
# key kernel; wide4 launches kernels 5 / 6 too, as its fallback
TRAVERSAL_KERNELS = {
    "pallas": ("closest_hit_attr", "any_hit"),
    "packed": ("closest_hit_packed", "any_hit_packed"),
    "pop": ("closest_hit_binary", "any_hit_binary"),
    "packet": ("closest_hit_binary", "any_hit_binary"),
    "wide": ("closest_hit", "any_hit"),
    "wide4": ("closest_hit_wide4", "any_hit_wide4"),
}
TRAVERSAL_PARITY_RAYS = 65536  # compat parity and the leaf-buffer sweep
LEAF_CAP_CUBES = 120  # the leaf-cap scene: 6-triangle leaves


def traversal_launches(value, depth, keys, key_launches, compat=False):
    """The launches of one frame of ``value`` at ``depth`` bounces."""
    c = "_compat" if compat else ""
    closest, anyh = TRAVERSAL_KERNELS[value]
    want = dict({k: 0 for k in keys}, **{closest + c: depth + 1,
                                         anyh + c: depth})
    if value == "wide4":
        want.update({"closest_hit_binary" + c: depth + 1,
                     "any_hit_binary" + c: depth})
    if key_launches:
        want["treelet_entry_key"] = key_launches
    return want


def leaf_cap_soup(n_cubes=LEAF_CAP_CUBES, seed=2):
    """``(positions [18 n, 3], indices [6 n, 3])``: groups of 6
    triangles, each group spanning all of one random cube (one centroid
    bound a group, so the builder keeps each as one leaf of 6 with
    ``max_leaf_size=8``): the geometry on which a cap of 4 leaves
    triangles 5 and 6 of a leaf untested."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(seed)
    corners = np.array(list(itertools.product((0, 1), repeat=3)),
                       np.float32)
    spans = [c for c in itertools.combinations(range(8), 3)
             if all(len(set(corners[list(c), k])) == 2 for k in range(3))]
    pick = corners[np.array([spans[j] for j in rng.choice(
        len(spans), 6, replace=False)])]
    base = rng.uniform(-3, 3, (n_cubes, 3)).astype(np.float32)
    base[:, 1] = rng.uniform(0, 3, n_cubes)
    size = rng.uniform(0.3, 0.8, (n_cubes, 1)).astype(np.float32)
    pos = (base[:, None, None] + size[:, None, None] * pick[None]).reshape(
        -1, 3).astype(np.float32)
    return pos, np.arange(len(pos), dtype=np.int32).reshape(-1, 3)


def leaf_cap_rays(pos, n: int, seed: int = 4):
    """``(o, d)`` [n, 3] float32: rays from around :func:`leaf_cap_soup`'s
    groups (origins in [-6, 6]^3), each aimed at a point inside the
    bounds of one random triangle's cube."""
    import numpy as np

    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    corners = pos.reshape(-1, 3, 3)[rng.integers(0, len(pos) // 3, n)]
    lo, hi = corners.min(axis=1), corners.max(axis=1)
    aim = lo + (hi - lo) * rng.uniform(0.1, 0.9, o.shape)
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def leaf_cap_scene(dev, n_cubes=LEAF_CAP_CUBES, seed=2):
    """The groups of :func:`leaf_cap_soup` over a floor, with its camera:
    the scene on which ``RenderConfig.max_leaf_size=4`` leaves
    triangles 5 and 6 of a leaf untested."""
    import numpy as np

    from pnraytracing_tpu_torch.core.camera import CameraState
    from pnraytracing_tpu_torch.scene import shapes
    from pnraytracing_tpu_torch.scene.build import SceneBuilder

    pos, idx = leaf_cap_soup(n_cubes, seed)
    b = SceneBuilder()
    b.add(dict(positions=pos, normals=np.zeros_like(pos),
               uvs=np.zeros((len(pos), 2), np.float32), indices=idx),
          dict(base_color=(0.7, 0.5, 0.3), roughness=0.4), name="cubes")
    b.add(shapes.quad(12.0), dict(base_color=(0.6, 0.6, 0.6)), name="floor")
    scene = b.build(max_leaf_size=8, env_constant=(0.6, 0.6, 0.7),
                    device=dev)
    cam = CameraState(eye=np.array([0.0, 4.0, 11.0]),
                      center=np.array([0.0, 1.5, 0.0]),
                      up=np.array([0.0, 1.0, 0.0]), fov_deg=45.0,
                      aspect=1.0)
    return scene, cam.basis(device=dev)


def _xla_parity(name, got, want, r, closest):
    """A walk kernel against its plain version: hits (tri mismatches <=
    0.001%, t / b equal where tri is) or occlusion exact; returns
    (mismatches, max |dt|)."""
    if closest:
        bad, err = check_closest(name, got, want, r)
        same = got.tri == want.tri
        ulps = max(_ulp_max(getattr(got, k)[same], getattr(want, k)[same])
                   for k in ("t", "b1", "b2"))
        if ulps:
            raise AssertionError(f"{name}: t / b differ from the plain "
                                 f"version by {ulps} ulp")
        return bad, err
    return check_occ(name, got, want), 0.0


def traversal_kernel_rows(trav, cont, shadow, launches, smi) -> list:
    """The packed walk (csrc/traverse_bvh.cu over nodes8 + tri12) and the
    4-wide walk (csrc/traverse_wide4.cu) against their plain versions on
    the flagship's bounce-0 continuation rays and fused shadow batch (the
    4-wide one at the frame's 32-slot buffer, and at 4 slots, where rays
    overflow): hits, occlusion, overflow flags and per-ray stats; the
    compat forms the same way on ``TRAVERSAL_PARITY_RAYS`` of them.  Then
    each kernel's time at the path shapes, its plain version's, its bound
    and what holds it back (pops, leaves, tests a ray, overflow share).
    Returns the kernels line's rows."""
    import torch

    from pnraytracing_tpu_torch.accel import traverse_packed as trp
    from pnraytracing_tpu_torch.accel import traverse_wide4 as tw4

    w4 = trav.w4
    w4_kw = dict(stack_depth=max(16, (w4.width - 1) * w4.depth4 + 4),
                 max_leaf_size=4)
    info = {**trp.kernel_info(), **tw4.kernel_info()}
    packed_bytes = 4 * (trav.nodes8.numel() + trav.tri12.numel())
    w4_bytes = 4 * (w4.nodes32.numel() + w4.leaf40.numel())
    codes = w4.nodes32[:, 6 * w4.width:7 * w4.width]
    slots_per_row = float((codes != 0).sum()) / codes.shape[0]
    rows, res = [], {}
    for closest, args in ((True, cont), (False, shadow)):
        o, d, tm, mask = rays_of(args)
        r = o.x.shape[0]
        q = "closest" if closest else "any"
        for compat in (False, True):
            c = "_compat" if compat else ""
            po, pd, ptm, pmask = ((o, d, tm, mask) if not compat else
                                  (_strided(x, TRAVERSAL_PARITY_RAYS)
                                   for x in (o, d, tm, mask)))
            n = po.x.shape[0]
            # the packed walk
            name = f"{q}_hit_packed{c}"
            kern = getattr(trp, f"{q}_hit_packed")
            plain = trp.plain(f"{q}_hit_packed")
            got, st = kern(trav, po, pd, ptm, pmask, compat=compat,
                           with_stats=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, wst = plain(trav, po, pd, ptm, pmask, compat=compat,
                              with_stats=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            check_stats(name, st, wst)
            bad, err = _xla_parity(name, got, want, n, closest)
            ref = got
            _, fst = kern(trav, o, d, tm, mask, compat=compat,
                          with_stats=True)
            slabs, tests = (int(fst[k].sum()) for k in (1, 2))
            bnd = bound(r * (RAY_IN + (16 if closest else 1)) + packed_bytes,
                        OPS_AABB * slabs + OPS_TRIANGLE * tests)
            rows.append(dict(
                name=name, source="pnraytracing_tpu_torch/csrc/"
                "traverse_bvh.cu",
                replaces="pnraytracing_tpu/accel/traverse_packed.py:"
                         + ("62" if closest else "130")
                         + " (an XLA walk, not a TPU kernel)",
                launches=launches.get(name, 0), max_abs_err=err,
                mismatches=bad, parity_rays=n, rays=r,
                ms=time_ms(lambda: kern(trav, o, d, tm, mask,
                                        compat=compat), 10),
                plain_ms=plain_ms, plain_rays=n,
                bound_ms=bnd[0], bound_by=bnd[1],
                pops_per_ray=float(fst[0].sum()) / r,
                slabs_per_ray=slabs / r, tri_tests_per_ray=tests / r,
                max_pops=int(fst[0].max()), **info[name]))
            res[name] = {"rays": n, "mismatches": bad, "stats_equal": True}
            # the 4-wide walk, at the frame's buffer and at 4 slots
            name = f"{q}_hit_wide4{c}"
            kern = getattr(tw4, f"{q}_hit_wide4")
            plain = getattr(tw4, f"plain_{q}_hit_wide4")
            sweep = {}
            for lb in (32, 4):
                kw = dict(w4_kw, leaf_buffer=lb, compat=compat,
                          with_stats=True)
                got, gov, st = kern(w4, po, pd, ptm, pmask, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want, wov, wst = plain(w4, po, pd, ptm, pmask, **kw)
                torch.cuda.synchronize()
                if lb == 32:
                    plain_ms = (time.perf_counter() - t0) * 1e3
                check_stats(f"{name}/buffer{lb}", st, wst)
                if not torch.equal(gov, wov):
                    raise AssertionError(f"{name}/buffer{lb}: overflow "
                                         "flags differ from the plain "
                                         "version")
                b_, e_ = _xla_parity(f"{name}/buffer{lb}", got, want, n,
                                     closest)
                # the walk as the frame runs it: overflowed rays walked
                # again by kernels 5 / 6, answers the packed walk's
                fb = kern(w4, po, pd, ptm, pmask, **dict(
                    kw, with_stats=False), fallback=lambda *a: getattr(
                        trp, f"{q}_hit_pop")(trav, *a, compat=compat))[0]
                # gated in the default form; the compat form is only
                # reported: its phase 1 prunes by the clipped slab test
                # (as JAX's), where the compat packed walk enters every
                # box the line crosses and so reaches the sheared test's
                # hits outside their leaf's box
                if compat:
                    vs_packed = int(((fb.tri != ref.tri) if closest
                                     else (fb != ref)).sum())
                elif closest:
                    vs_packed = check_closest(
                        f"{name}/buffer{lb}_vs_packed", fb, ref, n)[0]
                else:
                    vs_packed = check_occ(f"{name}/buffer{lb}_vs_packed",
                                          fb, ref)
                sweep[lb] = {"mismatches": b_, "overflow": int(gov.sum()),
                             "vs_packed_mismatches": vs_packed}
                if lb == 32:
                    bad, err = b_, e_
            kw = dict(w4_kw, leaf_buffer=32, compat=compat)
            _, fov, fst = kern(w4, o, d, tm, mask, **kw, with_stats=True)
            pops, leaves, tests = (int(fst[k].sum()) for k in range(3))
            bnd = bound(r * (RAY_IN + (16 if closest else 1) + 1) + w4_bytes,
                        OPS_AABB * pops * slots_per_row
                        + OPS_TRIANGLE * tests)
            fb_kw = dict(kw, fallback=lambda *a: getattr(
                trp, f"{q}_hit_pop")(trav, *a, compat=compat))
            rows.append(dict(
                name=name, source="pnraytracing_tpu_torch/csrc/"
                "traverse_wide4.cu",
                replaces="pnraytracing_tpu/accel/traverse_wide4.py:"
                         + ("164" if closest else "204")
                         + " (an XLA walk, not a TPU kernel)",
                launches=launches.get(name, 0), max_abs_err=err,
                mismatches=bad, parity_rays=n, rays=r,
                ms=time_ms(lambda: kern(w4, o, d, tm, mask, **kw), 10),
                with_fallback_ms=time_ms(lambda: kern(w4, o, d, tm, mask,
                                                      **fb_kw), 10),
                plain_ms=plain_ms, plain_rays=n,
                bound_ms=bnd[0], bound_by=bnd[1],
                pops_per_ray=pops / r, leaves_per_ray=leaves / r,
                tri_tests_per_ray=tests / r, max_pops=int(fst[0].max()),
                max_leaves=int(fst[1].max()),
                overflow_share=float(fov.sum()) / r,
                buffer_sweep=sweep, width=w4.width, depth4=w4.depth4,
                **info[name]))
            res[name] = {"rays": n, "mismatches": bad, "overflow_equal": True,
                         "stats_equal": True, "buffers": sweep}
    emit({"phase": "traversal_kernels", "parity": res,
          "ms": {row["name"]: row["ms"] for row in rows},
          "plain_ms": {row["name"]: row["plain_ms"] for row in rows},
          "card": smi})
    return rows


def traversal_phase(render_frame, RenderConfig, scene, camera, cont, shadow,
                    c5, c5_cam, dev, modules, tables, counts, smi):
    """Phase traversal: ``RenderConfig.traversal``'s six values on the
    card.  (1) The flagship at 512x512 depth 4 under each value: the
    launches of one eager frame (counters zeroed just before, read just
    after) against the value's kernels, ms/frame eager and replayed, the
    replay equal to the eager frame bit for bit, and the image within
    atol 3e-5 of the ``pallas`` frame with ``kernel_interaction=False``
    (the interaction route of every other value, ``make_interaction``)
    on all but 0.02% of pixels, the distance to the default ``pallas``
    frame (the attribute kernel's fill) beside it; compat frames under
    ``packed`` and ``wide4`` count the compat kernels.  (2)
    :func:`traversal_kernel_rows`.  (3) config5 under ``packed`` and
    ``wide4``: launches, ms/frame eager and replayed, replay = eager,
    the image against config5's ``pallas`` frame (stream route, also
    ``make_interaction``); ``collapse_binary`` and ``build_leaf40`` on
    config5's tree timed on the host and equal to its layout.  (4) The
    leaf-cap scene (:func:`leaf_cap_scene`) at 128x128 depth 2 under
    ``pop`` and ``wide`` (kernels 5 / 6 and 3 / 2 with the cap 4) and
    ``pallas``, each against its plain versions; the cap changes the
    image.  Returns the kernels line's new rows and each value's flagship
    launches."""
    import numpy as np
    import torch

    from pnraytracing_tpu_torch.accel import wide4
    from pnraytracing_tpu_torch.render import program
    from pnraytracing_tpu_torch.render.renderer import (
        render_frame as replayed_frame,
    )

    t_phase = time.perf_counter()
    keys = list(counts())
    limit = int(WIDTH * HEIGHT * 2e-4)
    base = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    ref = render_frame(scene, camera, dataclasses.replace(
        base, kernel_interaction=False), 1, device=dev)
    attr = render_frame(scene, camera, base, 1, device=dev)

    def run_value(label, scn, cam, cfg, want, refs, gate, frames=3):
        img, got = frame_launches(render_frame, scn, cam, cfg, dev, tables,
                                  counts)
        if got != want:
            raise AssertionError(f"traversal {label}: launches {got}, "
                                 f"expected {want}")
        check_image(f"traversal {label}", img, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(frames):
            render_frame(scn, cam, cfg, 2 + f, device=dev)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / frames
        rep = replayed_frame(scn, cam, cfg, 1, device=dev).clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(5):
            replayed_frame(scn, cam, cfg, 2 + f, device=dev)
        torch.cuda.synchronize()
        replayed_ms = (time.perf_counter() - t0) * 1e3 / 5
        program.clear_programs()
        out = {"launches": {k: v for k, v in got.items() if v},
               "eager_ms": eager_ms, "replayed_ms": replayed_ms,
               "replay_equals_eager": bool(torch.equal(rep, img))}
        for rname, r_img in refs.items():
            px = (img - r_img).abs().amax(dim=-1)
            out[rname] = {"outside_atol_3e-5": int((px > 3e-5).sum()),
                          "max_abs_err": float(px.max())}
        if not out["replay_equals_eager"]:
            raise AssertionError(f"traversal {label}: replay differs from "
                                 "the eager frame")
        if out[gate]["outside_atol_3e-5"] > limit:
            raise AssertionError(f"traversal {label}: {out[gate]}")
        return out, got

    flagship, launches = {}, {}
    for value in TRAVERSAL_VALUES:
        cfg = dataclasses.replace(base, traversal=value)
        # gated against the pallas frame of its interaction route: the
        # attribute fill for pallas itself, make_interaction for the rest
        flagship[value], got = run_value(
            value, scene, camera, cfg,
            traversal_launches(value, DEPTH, keys, cfg.sort_max_bounce),
            {"vs_pallas_kernel_interaction_off": ref, "vs_pallas": attr},
            "vs_pallas" if value == "pallas" else
            "vs_pallas_kernel_interaction_off")
        launches[value] = {k: v for k, v in got.items() if v}
    compat = {}
    for value in ("packed", "wide4"):
        cfg = dataclasses.replace(base, traversal=value, compat_pnrt=True)
        img, got = frame_launches(render_frame, scene, camera, cfg, dev,
                                  tables, counts)
        want = traversal_launches(value, DEPTH, keys, cfg.sort_max_bounce,
                                  compat=True)
        if got != want:
            raise AssertionError(f"traversal {value} compat: launches {got}"
                                 f", expected {want}")
        check_image(f"traversal {value} compat", img, cfg)
        compat[value] = {k: v for k, v in got.items() if v}
    emit({"phase": "traversal", "scene": "flagship", "width": WIDTH,
          "height": HEIGHT, "depth": DEPTH, "values": flagship,
          "compat_launches": compat, "limit": limit, "card": smi})

    frame_counts = {k: v for got in (*launches.values(), *compat.values())
                    for k, v in got.items()}
    rows = traversal_kernel_rows(scene.trav, cont, shadow, frame_counts,
                                 smi)

    # config5: the packed and 4-wide walks at 102,404 triangles
    t0 = time.perf_counter()
    host = lambda t: t.cpu().numpy()
    b5 = c5.bvh
    n32, ls, lc, depth4 = wide4.collapse_binary(
        host(b5.node_min), host(b5.node_max), host(b5.right_child),
        host(b5.start), host(b5.end), width=c5.trav.w4.width)
    collapse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    leaf40 = wide4.build_leaf40(host(c5.trav.tri9), ls, lc)
    leaf40_s = time.perf_counter() - t0
    if not (np.array_equal(n32, host(c5.trav.w4.nodes32))
            and np.array_equal(leaf40, host(c5.trav.w4.leaf40))
            and depth4 == c5.trav.w4.depth4):
        raise AssertionError("config5: collapse_binary / build_leaf40 "
                             "differ from the scene's 4-wide layout")
    c5_ref = render_frame(c5, c5_cam, base, 1, device=dev)
    on_c5 = {}
    for value in ("packed", "wide4"):
        cfg = dataclasses.replace(base, traversal=value)
        on_c5[value], _ = run_value(
            f"config5 {value}", c5, c5_cam, cfg,
            traversal_launches(value, DEPTH, keys, cfg.sort_max_bounce),
            {"vs_pallas": c5_ref}, "vs_pallas", frames=2)
    emit({"phase": "traversal_config5", "triangles": int(
        c5.mesh.indices.shape[0]), "wide_rows": int(n32.shape[0]),
        "leaves": int(leaf40.shape[0]), "depth4": depth4,
        "collapse_binary_s": collapse_s, "build_leaf40_s": leaf40_s,
        "values": on_c5, "card": smi})

    # the leaf cap: kernels 5 / 6 and 3 / 2 test 4 of a leaf's 6
    lc_scene, lc_cam = leaf_cap_scene(dev)
    leaf = lc_scene.bvh.right_child < 0
    max_leaf = int((lc_scene.bvh.end - lc_scene.bvh.start)[leaf].max())
    size = dict(width=PARITY_SIZE, height=PARITY_SIZE,
                max_depth=PARITY_DEPTH)
    cap = {"max_leaf": max_leaf, "w4": lc_scene.trav.w4 is not None}
    for value in ("pop", "wide", "pallas"):
        cfg = RenderConfig(traversal=value, **size)
        cap[value] = frame_parity(render_frame, lc_scene, lc_cam, cfg, dev,
                                  modules)
    img4 = render_frame(lc_scene, lc_cam, RenderConfig(traversal="wide",
                                                       **size), 1,
                        device=dev)
    img8 = render_frame(lc_scene, lc_cam, RenderConfig(
        traversal="wide", max_leaf_size=8, **size), 1, device=dev)
    cap["pixels_changed_by_the_cap"] = int(
        ((img4 - img8).abs().amax(dim=-1) > 1e-3).sum())
    if not (max_leaf == 6 and not cap["w4"]
            and cap["pixels_changed_by_the_cap"] > 0):
        raise AssertionError(f"leaf-cap scene: {cap}")
    emit({"phase": "traversal_leaf_cap", **cap, "card": smi,
          "phase_s": time.perf_counter() - t_phase})
    return rows, launches


# ---- 17. parallel: parallel/ on torch.distributed --------------------------

PRIM_SHARDS = (2, 8)  # shard counts built from config5's triangle list
PARALLEL_SIZE, PARALLEL_DEPTH = 128, 2  # config5's sharded frame
WORLD2 = 2
# world 2's dp gradient against world 1's, relative in norm.  A step is
# reproducible bit for bit (ops/gather.py) and world 1 sums in the
# single-process order, so both are gated at 0; world 2 adds its two
# ranks' partial sums, 4e-8..8e-8 apart on the card (PERF.md).  Each run
# also reads a lost rank's chunk (``dp_fault_lost_chunk``), which must
# read above the gate
DP_REL = 1e-6


def _build_shard(args):
    """One shard's BVH and rows on the host (a process-pool task)."""
    from pnraytracing_tpu_torch.parallel.primitive import build_shard

    return build_shard(*args)


def scene_shards(trav):
    """The one-shard placement of a scene: its own binary layout, global
    ids = its triangle ids."""
    import numpy as np

    from pnraytracing_tpu_torch.parallel.primitive import PrimShards

    host = lambda t: t.cpu().numpy()[None]
    return PrimShards(
        nodes8=host(trav.nodes8), tri9=host(trav.tri9),
        tri12=host(trav.tri12),
        tri_map=np.arange(trav.tri9.shape[0], dtype=np.int32)[None],
        n_shards=1, bvh_depth=trav.bvh_depth)


def primitive_rays(scene, camera, trav_walk):
    """The primitive queries' rays: config5's 512x512 primary rays
    (``t_max`` the largest float32) for the closest hit, and for the any hit a ray
    from each primary hit point (the eye on a miss) toward the lamp,
    ``t_max`` short of it.  ``trav_walk(o, d, t_max)`` is the unsharded
    closest walk."""
    import torch

    from pnraytracing_tpu_torch.core.camera import camera_rays

    o, d, _ = camera_rays(camera, WIDTH, HEIGHT)
    t_max = torch.full((o.shape[0],), 3.4028234663852886e38,
                       device=o.device)
    hit = trav_walk(o, d, t_max)
    p = torch.where(hit.valid[:, None], o + hit.t[:, None] * d, o)
    to = torch.tensor([0.0, 5.99, 0.0], device=o.device) - p
    dist = torch.linalg.vector_norm(to, dim=-1)
    sd = to / dist[:, None]
    return (o, d, t_max), ((p + 1e-3 * sd).contiguous(), sd.contiguous(),
                           (dist - 2e-3).contiguous())


def check_prim(name, hit, occ, ref_hit, ref_occ) -> dict:
    """A primitive-sharded answer against the unsharded walk: ``t`` and
    occlusion equal, ``tri`` equal but on exact-``t`` ties (<= 0.001% of
    rays), ``b1`` / ``b2`` equal where ``tri`` is."""
    import torch

    r = hit.t.shape[0]
    same = hit.tri == ref_hit.tri
    bad = int((~same).sum())
    ok = (torch.equal(hit.t, ref_hit.t) and torch.equal(occ, ref_occ)
          and bad <= max(1, int(r * 1e-5))
          and torch.equal(hit.b1[same], ref_hit.b1[same])
          and torch.equal(hit.b2[same], ref_hit.b2[same]))
    out = {"rays": r, "tri_mismatch": bad,
           "t_max_abs_err": float((hit.t - ref_hit.t).abs().max()),
           "occlusion_mismatch": int((occ != ref_occ).sum()),
           "hits": int(ref_hit.valid.sum()), "occluded": int(ref_occ.sum())}
    if not ok:
        raise AssertionError(f"{name}: primitive-sharded answer differs "
                             f"from the unsharded walk: {out}")
    return out


LEAF_CAP_SHARDS, LEAF_CAP_RAYS = 2, 65536


def leaf_cap_shards_check(pp, trv, dev) -> tuple[dict, dict]:
    """Kernels 5 / 6 at the default cap of 4 over shards whose leaves
    hold 6 triangles (:func:`leaf_cap_soup` built with
    ``max_leaf_size=8``): each shard's walk (``walk_closest`` /
    ``walk_any``) against the plain binary walks at the same cap, hits
    and occlusion equal (tri mismatches <= 0.001%); and the combine at
    cap 4 against cap 8, which must differ (the cap is applied).
    Returns (results, launches of the cap-4 combine)."""
    import torch

    from pnraytracing_tpu_torch.ops.intersect import Hit

    pos, idx = leaf_cap_soup(1000, 5)
    shards = pp.build_primitive_shards(pos, idx, LEAF_CAP_SHARDS,
                                       max_leaf_size=8)
    o, d = (torch.from_numpy(x).to(dev)
            for x in leaf_cap_rays(pos, LEAF_CAP_RAYS))
    t_max = torch.full((len(o),), 1e6, device=dev)
    placed = pp.place_all(shards, dev)
    ov, dv = pp.ray_components(o, d)
    out = {"rays": len(o), "shards": LEAF_CAP_SHARDS}
    for p in placed:
        kw = dict(stack_depth=p.stack_depth, max_leaf_size=4)
        got_c = pp.walk_closest(p, o, d, t_max)
        want = trv.plain_closest_hit_binary(p.trav, ov, dv, t_max, **kw)
        want_tri = torch.where(want.valid, p.tri_map[
            want.tri.clamp_min(0).long()], -1)
        got = Hit(tri=got_c[1], t=got_c[0], b1=got_c[2], b2=got_c[3])
        ref = Hit(tri=want_tri, t=want.t, b1=want.b1, b2=want.b2)
        bad, err = check_closest(f"closest_hit_binary/leaf_cap{p.shard}",
                                 got, ref, len(o))
        occ_bad = check_occ(f"any_hit_binary/leaf_cap{p.shard}",
                            pp.walk_any(p, o, d, t_max),
                            trv.plain_any_hit_binary(p.trav, ov, dv, t_max,
                                                     **kw))
        out[f"shard{p.shard}"] = {"tri_mismatch": bad, "err": err,
                                  "occlusion_mismatch": occ_bad}
    tables, counts = _launch_tables()
    torch.cuda.synchronize()
    zero_counts(*tables)
    cap4 = pp.shards_closest_hit(placed, o, d, t_max)
    occ4 = pp.shards_any_hit(placed, o, d, t_max)
    torch.cuda.synchronize()
    launches = counts()
    cap8 = pp.shards_closest_hit(placed, o, d, t_max, max_leaf_size=8)
    occ8 = pp.shards_any_hit(placed, o, d, t_max, max_leaf_size=8)
    out["t_changed_by_cap"] = int((cap4.t != cap8.t).sum())
    out["occlusion_changed_by_cap"] = int((occ4 != occ8).sum())
    out["hits_cap4"] = int(cap4.valid.sum())
    if out["t_changed_by_cap"] < len(o) // 20:
        raise AssertionError(f"leaf cap: caps 4 and 8 give nearly the same "
                             f"hits ({out}); the cap is not applied")
    return out, launches


def rel_err(a, b) -> float:
    """``||a - b|| / ||b||`` over one tensor or a list of them."""
    import torch

    a, b = ([a], [b]) if isinstance(a, torch.Tensor) else (a, b)
    num = sum(float(torch.sum((x.double() - y.double()) ** 2))
              for x, y in zip(a, b))
    den = sum(float(torch.sum(y.double() ** 2)) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def dp_parts(scene, rays, target, keys, cfg, m) -> dict:
    """This rank's parts of one replayed data-parallel gradient step,
    each timed on the host clock closed by a synchronize (median of 3):
    the trace of its chunk, the replay forward, the backward, and the
    ``all_reduce`` of the flat gradient alone."""
    import torch

    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.parallel import distributed
    from pnraytracing_tpu_torch.parallel.mesh import local_rows
    from pnraytracing_tpu_torch.render.integrator import (
        render_rays_replay,
        trace_paths,
    )

    params = dg.extract_params(scene, keys)
    o, d, px, py, t = local_rows(m, *rays, target)
    now = dg.apply_params(scene, dg.detached_params(params))
    trace_ms, recs = host_ms(lambda: trace_paths(now, o, d, px, py, 3, cfg))
    p, leaves = dg.leaf_copies(params)
    fwd = lambda: torch.sum((render_rays_replay(
        dg.apply_params(scene, p), o, d, px, py, 3, cfg, recs) - t) ** 2)
    fwd_ms, _ = host_ms(fwd)
    bwd, grads = [], None
    for _ in range(3):
        loss = fwd()
        ms, grads = host_ms(lambda: torch.autograd.grad(
            loss, leaves, allow_unused=True), reps=1)
        bwd.append(ms)
    flat = torch.cat([g.reshape(-1) for g in grads if g is not None])
    ar_ms, _ = host_ms(lambda: distributed.all_reduce(flat, "sum", m.group))
    return {"trace_ms": trace_ms, "forward_ms": fwd_ms,
            "backward_ms": sorted(bwd)[1], "all_reduce_ms": ar_ms,
            "all_reduce_bytes": 4 * flat.numel(), "rays": o.shape[0]}


def _launch_tables():
    from pnraytracing_tpu_torch.accel import walks
    from pnraytracing_tpu_torch.ops import compaction

    tables = walks.LAUNCH_TABLES + (compaction.LAUNCHES,)
    return tables, lambda: {k: v for t in tables for k, v in t.items()
                            if v}


def run_paths(pm, pp, flagship, flag_cam, c5, c5_cam, shards, prim, cfg,
              cfg5, keys, m) -> tuple[dict, dict, dict]:
    """The paths both worlds run, each with the launch counters zeroed
    just before it and read just after: the sharded flagship frame, the
    replayed and the live dp gradient, the primitive closest and any hit
    over ``shards``, config5's sharded frame.  Returns (results as
    tensors, launches by path, ms)."""
    import torch

    from pnraytracing_tpu_torch.core.camera import camera_rays
    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.parallel import distributed
    from pnraytracing_tpu_torch.render.renderer import pixel_coords

    tables, counts = _launch_tables()
    dev = flagship.mesh.positions.device
    res, launches, ms = {}, {}, {}

    def path(name, fn):
        torch.cuda.synchronize()
        zero_counts(*tables)
        out = fn()
        torch.cuda.synchronize()
        launches[name] = counts()
        return out

    res["frame"] = path("flagship_frame", lambda: pm.render_frame_sharded(
        flagship, flag_cam, cfg, 1, m))
    ms["flagship_frame"], _ = host_ms(lambda: pm.render_frame_sharded(
        flagship, flag_cam, cfg, 1, m))
    chunk = res["frame"].reshape(-1, 3)[m.chunk(cfg.num_pixels)]
    ms["flagship_frame_all_gather"], _ = host_ms(
        lambda: distributed.all_gather_rows(chunk, m.group))

    px, py = pixel_coords(cfg, dev)
    o, d, _ = camera_rays(flag_cam, cfg.width, cfg.height)
    rays = (o, d, px, py)
    target = torch.full((cfg.num_pixels, 3), 0.25, device=dev)
    params = dg.extract_params(flagship, keys)
    for tag, replay in (("dp_replay", True), ("dp_live", False)):
        res[tag] = path(tag, lambda: pm.dp_loss_and_grad(
            params, flagship, *rays, 3, target, cfg, m, use_replay=replay))
        ms[tag], _ = host_ms(lambda: pm.dp_loss_and_grad(
            params, flagship, *rays, 3, target, cfg, m, use_replay=replay))
    ms["dp_replay_parts"] = dp_parts(flagship, rays, target, keys, cfg, m)

    placed = pp.put_shards(shards, m)
    (o5, d5, tm5), (so, sd, stm) = prim
    for tag, compat in (("primitive", False), ("primitive_compat", True)):
        res[tag] = path(tag, lambda: (
            pp.primitive_sharded_closest_hit(placed, o5, d5, tm5, m,
                                             compat=compat),
            pp.primitive_sharded_any_hit(placed, so, sd, stm, m,
                                         compat=compat)))
    walked = pp.walk_closest(placed, o5, d5, tm5)
    reduce = pp.collective_reduce(m.group)
    ms["primitive"] = {
        "closest_ms": time_ms(lambda: pp.primitive_sharded_closest_hit(
            placed, o5, d5, tm5, m), 5),
        "any_ms": time_ms(lambda: pp.primitive_sharded_any_hit(
            placed, so, sd, stm, m), 5),
        "closest_walk_ms": time_ms(lambda: pp.walk_closest(
            placed, o5, d5, tm5), 5),
        "any_walk_ms": time_ms(lambda: pp.walk_any(placed, so, sd, stm), 5),
        "closest_combine_ms": host_ms(lambda: pp.combine_closest(
            *(x[None] for x in walked), [placed.shard], placed.n_shards, tm5,
            reduce))[0],
        "shards": shards.n_shards, "triangles_this_rank": int(
            (shards.tri_map[placed.shard] >= 0).sum())}

    res["config5_frame"] = path("config5_frame", lambda: (
        pm.render_frame_sharded(c5, c5_cam, cfg5, 1, m)))
    ms["config5_frame"], _ = host_ms(lambda: pm.render_frame_sharded(
        c5, c5_cam, cfg5, 1, m))
    return res, launches, ms


def _world2(rank, workdir):
    """One rank of the two-process world on the one card (gloo: NCCL
    refuses two ranks on one device): the paths of :func:`run_paths` on
    the inputs the parent wrote to ``workdir``; writes its results and
    its launches and times there."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from pnraytracing_tpu_torch.convert import (
        params_to_arrays,
        prim_shards_from_arrays,
        scene_from_arrays,
    )
    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.core.types import Camera
    from pnraytracing_tpu_torch.parallel import distributed
    from pnraytracing_tpu_torch.parallel import mesh as pm
    from pnraytracing_tpu_torch.parallel import primitive as pp

    torch.set_num_threads(2)
    distributed.initialize(
        init_method="file://" + os.path.join(workdir, "store"),
        world_size=WORLD2, rank=rank, backend="gloo")
    try:
        dev = distributed.rank_device()
        load = lambda n: dict(np.load(os.path.join(workdir, n + ".npz")))
        cam = lambda a, p: Camera(**{
            f: torch.from_numpy(a[f"{p}.{f}"]).to(dev)
            for f in ("eye", "lower_left", "horizontal", "vertical")})
        ins = load("inputs")
        flagship = scene_from_arrays(load("flagship"), device=dev)
        c5 = scene_from_arrays(load("config5"), device=dev)
        shards = prim_shards_from_arrays(load("shards2"))
        t = lambda k: torch.from_numpy(ins[k]).to(dev)
        prim = ((t("o5"), t("d5"), t("tm5")), (t("so"), t("sd"), t("stm")))
        cfg, cfg5 = (RenderConfig(width=int(w), height=int(h),
                                  max_depth=int(dp))
                     for w, h, dp in ins["sizes"])
        m = pm.make_device_mesh()
        res, launches, ms = run_paths(
            pm, pp, flagship, cam(ins, "flag"), c5, cam(ins, "c5"), shards,
            prim, cfg, cfg5, tuple(ins["keys"]), m)
        np.savez(os.path.join(workdir, f"world2_rank{rank}.npz"),
                 **flat_results(res, params_to_arrays))
        with open(os.path.join(workdir, f"world2_rank{rank}.json"),
                  "w") as f:
            json.dump({"launches": launches, "ms": ms}, f)
    finally:
        dist.destroy_process_group()


def flat_results(res, params_to_arrays) -> dict:
    """The results of :func:`run_paths` as numpy leaves."""
    out = {"frame": res["frame"], "config5_frame": res["config5_frame"]}
    for tag in ("dp_replay", "dp_live"):
        loss, grads = res[tag]
        out[f"{tag}.loss"] = loss
        out.update({f"{tag}.{k}": v
                    for k, v in params_to_arrays(grads).items()})
    for tag in ("primitive", "primitive_compat"):
        hit, occ = res[tag]
        out.update({f"{tag}.{f}": getattr(hit, f)
                    for f in ("tri", "t", "b1", "b2")})
        out[f"{tag}.occ"] = occ
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for k, v in out.items()}


def parallel_phase(render_frame, RenderConfig, flagship, flag_cam, c5,
                   c5_cam, dev, smi) -> dict:
    """Phase 17: ``parallel/`` on the card.  World 1 (NCCL, this process)
    runs the paths of :func:`run_paths`: the sharded flagship frame (bit
    for bit the eager frame), the dp gradient (replayed and live, bit
    for bit ``loss_and_grad_replay`` / ``loss_and_grad`` at spp 1, whose
    second run equals the first, while a lost rank's chunk reads above
    :data:`DP_REL`), the primitive-sharded closest and any hit over config5's
    triangles (one shard: the scene's own layout; kernels 5 / 6 and
    5* / 6*) against the unsharded walk, the same combine over 8 shards
    walked in this process (default and compat), config5's 128x128
    sharded frame (kernel 7), and kernels 5, 6, 5* and 6* against their
    plain versions at the primitive path's shapes.  World 2 (two
    processes, gloo, the one card) runs the same paths with 2 shards;
    each result equals world 1's (frames bit for bit, gradients within
    :data:`DP_REL` in norm) and the primitive answers the unsharded
    walk's.  Returns the launches by path for the kernels line."""
    import multiprocessing
    import os
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    import torch.distributed as dist

    from pnraytracing_tpu_torch.accel import traverse_cuda as trv
    from pnraytracing_tpu_torch.convert import (
        params_to_arrays,
        prim_shards_to_arrays,
        scene_to_arrays,
    )
    from pnraytracing_tpu_torch.cuda_build import BUILD_DIR
    from pnraytracing_tpu_torch.diff import grad as dg
    from pnraytracing_tpu_torch.ops.intersect import Hit
    from pnraytracing_tpu_torch.parallel import distributed
    from pnraytracing_tpu_torch.parallel import mesh as pm
    from pnraytracing_tpu_torch.parallel import primitive as pp

    t_phase = time.perf_counter()
    keys = ("materials", "env_image")
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    cfg5 = RenderConfig(width=PARALLEL_SIZE, height=PARALLEL_SIZE,
                        max_depth=PARALLEL_DEPTH)
    positions = c5.mesh.positions.cpu().numpy()
    indices = c5.mesh.indices.cpu().numpy()
    out = {"phase": "parallel", "card": smi}
    workdir = os.path.join(os.path.dirname(BUILD_DIR), "parallel_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    with ProcessPoolExecutor(
            max_workers=os.cpu_count() or 4,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = {}
        for n in PRIM_SHARDS:
            b = pp.shard_bounds(len(indices), n)
            futs[n] = [pool.submit(_build_shard, (positions, indices,
                                                  int(b[s]), int(b[s + 1])))
                       for s in range(n)]
        t0 = time.perf_counter()
        distributed.initialize(f"tcp://localhost:{distributed.free_port()}",
                               world_size=1, rank=0)
        try:
            m = pm.make_device_mesh()
            out["world1_init_s"] = time.perf_counter() - t0
            binary = lambda tr, o, d, t, any_=False, compat=False: (
                trv.any_hit if any_ else trv.closest_hit)(
                tr, *pp.ray_components(o, d), t, variant="binary",
                compat=compat)
            prim = primitive_rays(c5, c5_cam, lambda o, d, t: binary(
                c5.trav, o, d, t))
            (o5, d5, tm5), (so, sd, stm) = prim
            ref = {c: (binary(c5.trav, o5, d5, tm5, compat=c),
                       binary(c5.trav, so, sd, stm, True, compat=c))
                   for c in (False, True)}
            unsharded_ms = {
                "closest_ms": time_ms(lambda: binary(c5.trav, o5, d5, tm5),
                                      5),
                "any_ms": time_ms(lambda: binary(c5.trav, so, sd, stm, True),
                                  5)}
            res1, launches, ms1 = run_paths(
                pm, pp, flagship, flag_cam, c5, c5_cam, scene_shards(c5.trav),
                prim, cfg, cfg5, keys, m)

            # world 1 against the single-process paths
            eager = render_frame(flagship, flag_cam, cfg, 1, device=dev)
            eager5 = render_frame(c5, c5_cam, cfg5, 1, device=dev)
            checks = {
                "frame_equal": torch.equal(res1["frame"], eager),
                "config5_frame_equal": torch.equal(res1["config5_frame"],
                                                   eager5)}
            from pnraytracing_tpu_torch.core.camera import camera_rays
            from pnraytracing_tpu_torch.render.renderer import pixel_coords

            px, py = pixel_coords(cfg, dev)
            o, d, _ = camera_rays(flag_cam, WIDTH, HEIGHT)
            target = torch.full((cfg.num_pixels, 3), 0.25, device=dev)
            params = dg.extract_params(flagship, keys)
            # the single-process steps eager, as the dp step runs (their
            # captured programs equal them bit for bit: phase grad)
            single = {
                "dp_replay": dg.loss_and_grad_replay(
                    params, flagship, o, d, px, py, 3, target, cfg, spp=1,
                    dual=False, eager=True),
                "dp_live": dg.loss_and_grad(
                    params, flagship, o, d, px, py, 3, target, cfg, spp=1,
                    dual=False, eager=True)}
            # the same single-process steps again: the distance between two
            # runs of one step (0: the gathers' backward sums in a fixed
            # order, ops/gather.py)
            again = {
                "dp_replay": dg.loss_and_grad_replay(
                    params, flagship, o, d, px, py, 3, target, cfg, spp=1,
                    dual=False, eager=True),
                "dp_live": dg.loss_and_grad(
                    params, flagship, o, d, px, py, 3, target, cfg, spp=1,
                    dual=False, eager=True)}
            grad_rel = lambda a, b: {
                "loss": rel_err(a[0], b[0]),
                **{k: rel_err(dg.param_leaves({k: a[1][k]}),
                              dg.param_leaves({k: b[1][k]})) for k in keys}}
            for tag in single:
                checks[tag] = grad_rel(res1[tag], single[tag])
                checks[tag + "_single_again"] = grad_rel(again[tag],
                                                         single[tag])
            # a fault the gate must catch: the step of a world of two
            # whose rank 1 lost its chunk (rank 0's chunk of a two-rank
            # mesh, summed over this world of one)
            lost = pm.Mesh(group=None, size=2, index=0)
            checks["dp_fault_lost_chunk"] = grad_rel(pm.dp_loss_and_grad(
                params, flagship, o, d, px, py, 3, target, cfg, lost,
                use_replay=True), single["dp_replay"])
            if max(checks["dp_fault_lost_chunk"].values()) <= DP_REL:
                raise AssertionError(f"the dp gate misses a lost chunk: "
                                     f"{checks['dp_fault_lost_chunk']}")
            for c, tag in ((False, "primitive"), (True, "primitive_compat")):
                checks[tag] = check_prim(tag, *res1[tag], *ref[c])
            # world 1 sums in the single-process order: bit for bit, and a
            # second single-process step equals the first
            if not (checks["frame_equal"] and checks["config5_frame_equal"]
                    and all(v == 0.0 for tag in single for t in (
                        tag, tag + "_single_again")
                            for v in checks[t].values())):
                raise AssertionError(f"world 1 differs from the "
                                     f"single-process paths: {checks}")

            # the same combine over 8 shards walked in this process
            t0 = time.perf_counter()
            shards = {n: pp.stack_shards([f.result() for f in futs[n]])
                      for n in PRIM_SHARDS}
            out["shard_build_wait_s"] = time.perf_counter() - t0
            placed8 = pp.place_all(shards[8], dev)
            tables, counts = _launch_tables()
            for c, tag in ((False, "primitive_one_process_8"),
                           (True, "primitive_one_process_8_compat")):
                zero_counts(*tables)
                hit8 = pp.shards_closest_hit(placed8, o5, d5, tm5, compat=c)
                occ8 = pp.shards_any_hit(placed8, so, sd, stm, compat=c)
                torch.cuda.synchronize()
                launches[tag] = counts()
                checks[tag] = check_prim(tag, hit8, occ8, *ref[c])
            ms1["primitive_one_process_8"] = {
                "closest_ms": time_ms(lambda: pp.shards_closest_hit(
                    placed8, o5, d5, tm5), 5),
                "any_ms": time_ms(lambda: pp.shards_any_hit(
                    placed8, so, sd, stm), 5)}

            # kernels 5, 6, 5* and 6* against their plain versions at the
            # shapes of the primitive path (one shard: all of config5, all
            # rays); the references above are these kernels' answers
            one = pp.place_shard(scene_shards(c5.trav), 0, dev)
            ov, dv = pp.ray_components(o5, d5)
            sov, sdv = pp.ray_components(so, sd)
            checks["kernels_vs_plain"] = {}
            for c in (False, True):
                kw = dict(stack_depth=one.stack_depth, compat=c)
                t0 = time.perf_counter()
                want_c = trv.plain_closest_hit_binary(one.trav, ov, dv, tm5,
                                                      **kw)
                torch.cuda.synchronize()
                plain_c = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                want_a = trv.plain_any_hit_binary(one.trav, sov, sdv, stm,
                                                  **kw)
                torch.cuda.synchronize()
                plain_a = (time.perf_counter() - t0) * 1e3
                got_c = trv.closest_hit(one.trav, ov, dv, tm5,
                                        variant="binary", **kw)
                got_a = trv.any_hit(one.trav, sov, sdv, stm,
                                    variant="binary", **kw)
                name_c = trv.launch_name("closest_hit_binary", c)
                name_a = trv.launch_name("any_hit_binary", c)
                bad, err = check_closest(name_c + "/primitive", got_c,
                                         want_c, got_c.t.shape[0])
                checks["kernels_vs_plain"][name_c] = {
                    "tri_mismatch": bad, "err": err, "plain_ms": plain_c}
                checks["kernels_vs_plain"][name_a] = {
                    "mismatches": check_occ(name_a + "/primitive", got_a,
                                            want_a), "plain_ms": plain_a}

            # kernels 5 / 6 at the default leaf cap over shards of
            # 6-triangle leaves (fault 5)
            checks["leaf_cap"], launches["primitive_leaf_cap"] = (
                leaf_cap_shards_check(pp, trv, dev))

            # world 2: two processes on the one card
            host = lambda t: t.detach().cpu().numpy()
            np.savez(os.path.join(workdir, "flagship.npz"),
                     **scene_to_arrays(flagship))
            np.savez(os.path.join(workdir, "config5.npz"),
                     **scene_to_arrays(c5))
            np.savez(os.path.join(workdir, "shards2.npz"),
                     **prim_shards_to_arrays(shards[2]))
            np.savez(os.path.join(workdir, "inputs.npz"), keys=np.array(keys),
                     sizes=np.array([(c.width, c.height, c.max_depth)
                                     for c in (cfg, cfg5)]),
                     o5=host(o5), d5=host(d5), tm5=host(tm5), so=host(so),
                     sd=host(sd), stm=host(stm),
                     **{f"{p}.{f}": host(getattr(c, f)) for p, c in (
                         ("flag", flag_cam), ("c5", c5_cam))
                        for f in ("eye", "lower_left", "horizontal",
                                  "vertical")})
            t0 = time.perf_counter()
            torch.multiprocessing.spawn(_world2, args=(workdir,),
                                        nprocs=WORLD2, join=True)
            out["world2_s"] = time.perf_counter() - t0
            w1 = flat_results(res1, params_to_arrays)
            ref_host = {c: (Hit(**{f: getattr(ref[c][0], f).cpu()
                                   for f in ("tri", "t", "b1", "b2")}),
                            ref[c][1].cpu()) for c in (False, True)}
            world2 = []
            for rank in range(WORLD2):
                got = dict(np.load(os.path.join(
                    workdir, f"world2_rank{rank}.npz")))
                with open(os.path.join(workdir,
                                       f"world2_rank{rank}.json")) as f:
                    world2.append(json.load(f))
                w2 = {"frame_equal": bool(np.array_equal(
                          got["frame"], w1["frame"])),
                      "config5_frame_equal": bool(np.array_equal(
                          got["config5_frame"], w1["config5_frame"]))}
                for tag in ("dp_replay", "dp_live"):
                    group = lambda d_, k: [torch.from_numpy(v) for n, v in
                                           sorted(d_.items())
                                           if n.startswith(f"{tag}.{k}")]
                    w2[tag] = {k: rel_err(group(got, k), group(w1, k))
                               for k in ("loss", *keys)}
                for tag, c in (("primitive", False),
                               ("primitive_compat", True)):
                    hit = Hit(**{f: torch.from_numpy(got[f"{tag}.{f}"])
                                 for f in ("tri", "t", "b1", "b2")})
                    w2[tag] = check_prim(
                        f"world2_rank{rank}/{tag}", hit,
                        torch.from_numpy(got[f"{tag}.occ"]), *ref_host[c])
                ok = (w2["frame_equal"] and w2["config5_frame_equal"]
                      and all(v <= DP_REL for tag in ("dp_replay", "dp_live")
                              for v in w2[tag].values()))
                if not ok:
                    raise AssertionError(f"world 2 rank {rank} differs from "
                                         f"world 1: {w2}")
                checks[f"world2_rank{rank}"] = w2
        finally:
            dist.destroy_process_group()
    shutil.rmtree(workdir, ignore_errors=True)

    expected = {
        "flagship_frame": dict(closest_hit_attr=1 + DEPTH, any_hit=DEPTH,
                               treelet_entry_key=cfg.sort_max_bounce),
        "dp_replay": dict(closest_hit_attr=1 + DEPTH, any_hit=DEPTH,
                          treelet_entry_key=cfg.sort_max_bounce),
        "dp_live": dict(closest_hit=1 + DEPTH, any_hit=DEPTH,
                        treelet_entry_key=cfg.sort_max_bounce),
        "primitive": dict(closest_hit_binary=1, any_hit_binary=1),
        "primitive_compat": dict(closest_hit_binary_compat=1,
                                 any_hit_binary_compat=1),
        "primitive_one_process_8": dict(closest_hit_binary=8,
                                        any_hit_binary=8),
        "primitive_one_process_8_compat": dict(
            closest_hit_binary_compat=8, any_hit_binary_compat=8),
        "primitive_leaf_cap": dict(closest_hit_binary=LEAF_CAP_SHARDS,
                                   any_hit_binary=LEAF_CAP_SHARDS)}
    by_world = {"world1": launches, **{f"world2_rank{k}": w["launches"]
                                       for k, w in enumerate(world2)}}
    for world, got in by_world.items():
        for path, want in expected.items():
            if path in got and got[path] != want:
                raise AssertionError(f"{world}/{path} launched {got[path]}, "
                                     f"expected {want}")
        c5l = got["config5_frame"]
        if not all(c5l.get(k, 0) > 0 for k in (
                "closest_hit_stream", "any_hit_stream", "treelet_entry_key")):
            raise AssertionError(f"{world}: config5's sharded frame "
                                 f"launched {c5l}")
    out.update(checks=checks, launches=by_world, world1_ms=ms1,
               unsharded_walk_ms=unsharded_ms,
               world2_ms=[w["ms"] for w in world2],
               seconds=time.perf_counter() - t_phase)
    emit(out)
    return by_world


# ---- phase 21: the repo's entry points -----------------------------------

BENCH_RUNS = {"fwd": [], "bwd": ["--bwd", "--frames", "2"],
              "bwd_no_replay": ["--bwd", "--no-replay", "--frames", "2"]}
BENCH_KEYS = ["metric", "unit", "value", "vs_baseline"]
DRYRUN_RANKS = 2


def bench_run(name, flags, smi) -> dict:
    """``python -m pnraytracing_tpu_torch.bench`` with ``flags`` in a
    process of its own: its last stdout line must be the bench's one JSON
    line, and its last stderr line the card's ``nvidia-smi`` line."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pnraytracing_tpu_torch.bench", *flags],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"bench {name} exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    line = json.loads(lines[-1])
    mode = "fwd+bwd" if "--bwd" in flags else "fwd"
    metric = (f"rays/s/chip {mode} ({WIDTH}x{HEIGHT}, 1spp, {DEPTH} "
              "bounces, teapot_night)")
    err = out.stderr.splitlines()
    if not (len(lines) == 1 and sorted(line) == BENCH_KEYS
            and line["metric"] == metric and line["value"] > 0
            and line["unit"] == "rays/s/chip" and err[-1] == smi):
        raise AssertionError(f"bench {name}: stdout {out.stdout!r}, last "
                             f"stderr line {err[-1]!r}")
    counts = re.search(r"launches: warm-up (\{.*\}); timed (\{.*\})",
                       out.stderr)
    return {"flags": flags, "line": line, "wall_s": wall,
            "phases": [x for x in err if x.startswith("[bench")],
            "launches": {"warmup": json.loads(counts.group(1)),
                         "timed": json.loads(counts.group(2))},
            "card": err[-1]}


def bench_phase(camera, smi) -> dict:
    """Phase 21: the repo's two entry points as the port has them.  The
    bench (``python -m pnraytracing_tpu_torch.bench``) forward, ``--bwd``
    and ``--bwd --no-replay``, each in a process of its own, one after
    another; ``entry()``'s step twice (bit for bit the same) against the
    replayed flagship frame (``render_average`` of frame 0: the frame
    the bench times), with its launches counted (kernels 1, 2, 4); and
    ``dryrun_multichip(2, backend="gloo")``, two processes on the one
    card, with each rank's launches (kernels 5, 6 of the packet walk,
    and 4).  Fails if a kernel of 1, 2, 4, 5, 6 was launched no time.
    Returns the launches by path for the kernels line."""
    import torch

    from pnraytracing_tpu_torch.entry import dryrun_multichip, entry
    from pnraytracing_tpu_torch.render.renderer import render_average

    t_phase = time.perf_counter()
    out = {"phase": "bench", "card": smi,
           "bench": {k: bench_run(k, f, smi) for k, f in BENCH_RUNS.items()}}
    launches = {f"bench_{k}_{w}": v["launches"][w]
                for k, v in out["bench"].items() for w in ("warmup", "timed")}

    tables, counts = _launch_tables()
    t0 = time.perf_counter()
    fn, args = entry()
    out["entry_build_s"] = time.perf_counter() - t0
    cfg = fn.keywords["cfg"]
    torch.cuda.synchronize()
    zero_counts(*tables)
    first = fn(*args)
    torch.cuda.synchronize()
    launches["entry"] = counts()
    second = fn(*args)
    replayed = render_average(args[0], camera, cfg, 0, 1).reshape(-1, 3)
    ok = (first.shape == (WIDTH * HEIGHT, 3) and bool(
        torch.isfinite(first).all()) and torch.equal(first, second)
        and torch.equal(first, replayed))
    out["entry"] = {"equal_second_call": torch.equal(first, second),
                    "equal_replayed_frame": torch.equal(first, replayed),
                    "max_abs_diff_replayed": float(
                        (first - replayed).abs().max()),
                    "ms": host_ms(lambda: fn(*args))[0],
                    "traversal": cfg.traversal}
    if not ok:
        raise AssertionError(f"entry(): {out['entry']}")

    t0 = time.perf_counter()
    ranks = dryrun_multichip(DRYRUN_RANKS, backend="gloo")
    out["dryrun"] = {"seconds": time.perf_counter() - t0,
                     "losses": [r["losses"] for r in ranks],
                     "params_digest": ranks[0]["digest"]}
    for k, r in enumerate(ranks):
        launches[f"dryrun_rank{k}"] = r["launches"]
    # the forward bench's capture and each gradient step run kernels 1,
    # 2, 4 (the live gradient 3, 2, 4); the dryrun's packet walk 5, 6
    # (counted at the capture in the first warm-up call: the timed calls
    # replay the captured frame or step and count none)
    resident = ("closest_hit_attr", "any_hit", "treelet_entry_key")
    need = {"entry": resident, "bench_fwd_warmup": resident,
            "bench_bwd_warmup": resident,
            "bench_bwd_no_replay_warmup": ("closest_hit", "any_hit",
                                           "treelet_entry_key"),
            **{f"dryrun_rank{k}": ("closest_hit_binary", "any_hit_binary")
               for k in range(DRYRUN_RANKS)}}
    for path, names in need.items():
        if not all(launches[path].get(n, 0) > 0 for n in names):
            raise AssertionError(f"{path} launched {launches[path]}: "
                                 f"each of {names} must run")
    replayed = [k for k in BENCH_RUNS if launches[f"bench_{k}_timed"]]
    if replayed:
        raise AssertionError(f"the timed calls of bench {replayed} launched "
                             f"kernels: they must replay a captured program")
    out.update(launches=launches, seconds=time.perf_counter() - t_phase)
    emit(out)
    return launches


# ---- phase 18: the asset loaders -------------------------------------------

# the two materials of the config-4 asset's MTL (marry's body material,
# the name the JAX package's MTL-only branch looks for, and a second one)
MARRY_MTL = """newmtl MC003_Kozakura_Mari
Kd 0.8 0.7 0.65
Ns 20
map_Kd MC003_Kozakura_Mari.png
newmtl Sphere
Kd 0.9 0.9 0.9
Ns 200
"""


def first_use_order(indices, *arrays):
    """``(*arrays renumbered, indices)``: the vertices in order of first
    use by ``indices`` (the order in which the OBJ loader creates them),
    unused ones dropped: what an OBJ round trip returns unchanged."""
    import numpy as np

    flat = np.asarray(indices).reshape(-1)
    _, first = np.unique(flat, return_index=True)
    used = flat[np.sort(first)]
    new = np.empty(max(len(a) for a in arrays), np.int64)
    new[used] = np.arange(len(used))
    return (*(a[used] for a in arrays),
            new[np.asarray(indices)].astype(np.int32))


def write_obj(path, groups, mtllib=None) -> None:
    """``groups``: (usemtl name or None, positions [V, 3], normals [V, 3],
    uvs [V, 2] or None, indices [T, 3]) a group, its vertices in
    first-use order; floats as ``%.9g`` (float32 round-trips), faces
    ``v//vn`` or ``v/vt/vn``.  The loaders flip v (aiProcess_FlipUVs), so
    ``1 - v`` is written."""
    import numpy as np

    lines = [f"mtllib {mtllib}"] if mtllib else []
    base = 0
    for name, pos, nrm, uvs, idx in groups:
        lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in pos.tolist()]
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in nrm.tolist()]
        if uvs is not None:
            lines += [f"vt {u:.9g} {1.0 - v:.9g}" for u, v in uvs.tolist()]
        if name:
            lines.append(f"usemtl {name}")
        f = (np.asarray(idx, np.int64) + base + 1).tolist()
        c = "{0}/{0}/{0}" if uvs is not None else "{0}//{0}"
        lines += [" ".join(["f"] + [c.format(k) for k in t]) for t in f]
        base += len(pos)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_ply_binary(path, positions, normals, indices) -> None:
    """Binary little-endian PLY: float x y z nx ny nz, uchar-int faces."""
    import numpy as np

    head = ["ply", "format binary_little_endian 1.0",
            f"element vertex {len(positions)}"]
    head += [f"property float {p}" for p in ("x", "y", "z", "nx", "ny",
                                             "nz")]
    head += [f"element face {len(indices)}",
             "property list uchar int vertex_indices", "end_header"]
    verts = np.concatenate([positions, normals], 1).astype("<f4")
    faces = np.zeros(len(indices), [("n", "u1"), ("i", "<i4", 3)])
    faces["n"], faces["i"] = 3, indices
    with open(path, "wb") as fh:
        fh.write(("\n".join(head) + "\n").encode())
        fh.write(verts.tobytes())
        fh.write(faces.tobytes())


def write_glb(path, positions, normals, indices) -> None:
    """A .glb: one node, one triangle primitive (f32 POSITION / NORMAL,
    u32 indices) in the BIN chunk."""
    import numpy as np

    parts = [np.ascontiguousarray(positions, "<f4").tobytes(),
             np.ascontiguousarray(normals, "<f4").tobytes(),
             np.ascontiguousarray(indices, "<u4").tobytes()]
    views, off = [], 0
    for p in parts:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(p)})
        off += len(p)
    v = len(positions)
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
           "meshes": [{"name": "asset", "primitives": [{
               "attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2}]}],
           "buffers": [{"byteLength": off}], "bufferViews": views,
           "accessors": [
               {"bufferView": 0, "componentType": 5126, "count": v,
                "type": "VEC3"},
               {"bufferView": 1, "componentType": 5126, "count": v,
                "type": "VEC3"},
               {"bufferView": 2, "componentType": 5125,
                "count": 3 * len(indices), "type": "SCALAR"}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    binp = b"".join(parts)
    binp += b"\0" * (-len(binp) % 4)
    import struct

    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(binp)))
        fh.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        fh.write(struct.pack("<II", len(binp), 0x004E4942) + binp)


def _fbx_node(name, props, children, off, long_offsets) -> bytes:
    """One binary FBX node record at absolute offset ``off``."""
    import struct

    head = 25 if long_offsets else 13
    plist = b"".join(props)
    body, at = b"", off + head + len(name) + len(plist)
    for c in children:
        b = c(at)
        body += b
        at += len(b)
    if children:
        body += b"\0" * head  # the NULL record ending a child list
    end = off + head + len(name) + len(plist) + len(body)
    fmt = "<QQQ" if long_offsets else "<III"
    return (struct.pack(fmt, end, len(props), len(plist))
            + struct.pack("<B", len(name)) + name.encode() + plist + body)


def write_fbx_binary(path, positions, normals, indices,
                     version: int = 7500) -> None:
    """A binary FBX (7500: 64-bit record offsets; 7400: 32-bit) holding
    one geometry (``Vertices`` and ``Normals`` as zlib-deflated double
    arrays, ``PolygonVertexIndex`` deflated int32, each triangle's last
    corner XOR'd) under one model."""
    import struct
    import zlib

    import numpy as np

    long_offsets = version >= 7500
    s = lambda t: b"S" + struct.pack("<I", len(t)) + t.encode()
    q = lambda v: b"L" + struct.pack("<q", v)

    def arr(code, a):
        raw = np.ascontiguousarray(a).tobytes()
        comp = zlib.compress(raw)
        return code + struct.pack("<III", a.size, 1, len(comp)) + comp

    pvi = np.asarray(indices, np.int32).copy()
    pvi[:, 2] = ~pvi[:, 2]
    corner_n = np.asarray(normals, np.float64)[np.asarray(indices)]
    node = lambda name, props, kids=(): (
        lambda off: _fbx_node(name, props, list(kids), off, long_offsets))
    layer = node("LayerElementNormal", [q(0)], [
        node("MappingInformationType", [s("ByPolygonVertex")]),
        node("ReferenceInformationType", [s("Direct")]),
        node("Normals", [arr(b"d", corner_n.reshape(-1))])])
    geom = node("Geometry", [q(1001), s("asset\x00\x01Geometry"), s("Mesh")],
                [node("Vertices", [arr(b"d", np.asarray(
                    positions, np.float64).reshape(-1))]),
                 node("PolygonVertexIndex", [arr(b"i", pvi.reshape(-1))]),
                 layer])
    model = node("Model", [q(2002), s("asset\x00\x01Model"), s("Mesh")])
    objects = node("Objects", [], [geom, model])
    conns = node("Connections", [], [
        node("C", [s("OO"), q(1001), q(2002)]),
        node("C", [s("OO"), q(2002), q(0)])])
    header = (b"Kaydara FBX Binary  \x00\x1a\x00"
              + struct.pack("<I", version))
    off = len(header)
    body = b""
    for top in (objects, conns):
        b = top(off)
        body += b
        off += len(b)
    with open(path, "wb") as fh:
        fh.write(header + body + b"\0" * (25 if long_offsets else 13))


def check_bvh(name, built, positions, indices, max_leaf_size=4) -> dict:
    """A flat BVH of the layout ``accel/bvh.py`` documents, checked from
    its arrays: ``order`` a permutation of the triangles, every leaf over
    1..``max_leaf_size`` of them and the leaves tiling [0, T) in
    depth-first order, every box holding its children's boxes and its
    triangles' corners exactly; with its SAH cost (traversal 1,
    intersection 1, areas relative to the root's)."""
    import numpy as np

    t = len(indices)
    order = np.asarray(built.order)
    ok = np.array_equal(np.sort(order), np.arange(t))
    corners = positions[np.asarray(indices)[order]]  # [T, 3, 3] leaf order
    lo, hi = corners.min(1), corners.max(1)
    right = np.asarray(built.right_child)
    start, end = np.asarray(built.start), np.asarray(built.end)
    nmin, nmax = np.asarray(built.node_min), np.asarray(built.node_max)
    n = len(right)
    area = lambda a, b: 2 * ((b - a)[..., 0] * (b - a)[..., 1]
                             + (b - a)[..., 1] * (b - a)[..., 2]
                             + (b - a)[..., 2] * (b - a)[..., 0])
    leaf = right == -1
    lv = np.nonzero(leaf)[0]  # depth-first ids: the leaves in order
    s0, e0 = start[lv], end[lv]
    ok &= bool(len(lv) and s0[0] == 0 and e0[-1] == t
               and (s0[1:] == e0[:-1]).all()
               and ((e0 - s0 > 0) & (e0 - s0 <= max_leaf_size)).all())
    if ok:
        ok &= bool((nmin[lv] <= np.minimum.reduceat(lo, s0)).all()
                   and (nmax[lv] >= np.maximum.reduceat(hi, s0)).all())
    inner = np.nonzero(~leaf)[0]
    for c in (inner + 1, right[inner]):
        ok &= bool((c < n).all() and (nmin[inner] <= nmin[c]).all()
                   and (nmax[inner] >= nmax[c]).all())
    a = area(nmin, nmax) / max(float(area(nmin[0], nmax[0])), 1e-30)
    sah = float(a[inner].sum() + (a[leaf] * (end - start)[leaf]).sum())
    if not ok:
        raise AssertionError(f"{name}: not a valid BVH over the triangles")
    return {"nodes": n, "leaves": int(leaf.sum()),
            "depth": int(built.max_depth), "sah_cost": sah}


def world_mesh(mesh, transform):
    """A shape's positions and normals under ``transform`` (4x4), as
    ``SceneBuilder.build`` places them, in float32."""
    import numpy as np

    m = np.asarray(transform, np.float64)
    pos = np.asarray(mesh["positions"], np.float64) @ m[:3, :3].T + m[:3, 3]
    nrm = np.asarray(mesh["normals"], np.float64) @ np.linalg.inv(
        m[:3, :3])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    return pos.astype(np.float32), nrm.astype(np.float32)


def write_marry(tmp) -> dict:
    """config4_marry's assets in ``tmp``: ``marry.obj`` (the stand-in's
    figure, the teapot with its uvs, under the MTL's body material, and
    its sphere under the second material; the floor and the lamp are
    the scene's own in every branch), ``Marry.mtl`` and the body's
    ``map_Kd`` PNG (a checkerboard, written by ``utils/image.py``)."""
    import os

    from pnraytracing_tpu_torch.scene import shapes
    from pnraytracing_tpu_torch.scene.scenes import checkerboard
    from pnraytracing_tpu_torch.scene.transform import (
        compose,
        scale,
        translate,
    )
    from pnraytracing_tpu_torch.utils.image import save_png

    groups = []
    for mtl, shape, tf, uvs in (
            ("MC003_Kozakura_Mari", shapes.teapot(),
             compose(translate(0.1, 0, -0.5), scale(0.35)), True),
            ("Sphere", shapes.icosphere(4),
             compose(translate(-1.4, 0.5, 0.3), scale(0.5)), False)):
        pos, nrm = world_mesh(shape, tf)
        arrays = (pos, nrm, shape["uvs"]) if uvs else (pos, nrm)
        *arrays, idx = first_use_order(shape["indices"], *arrays)
        groups.append((mtl, arrays[0], arrays[1],
                       arrays[2] if uvs else None, idx))
    write_obj(os.path.join(tmp, "marry.obj"), groups, mtllib="Marry.mtl")
    with open(os.path.join(tmp, "Marry.mtl"), "w") as fh:
        fh.write(MARRY_MTL)
    save_png(os.path.join(tmp, "MC003_Kozakura_Mari.png"),
             checkerboard(128, 16, (0.85, 0.6, 0.55), (0.4, 0.2, 0.2)),
             gamma=1.0)
    return {"triangles": sum(len(g[4]) for g in groups)}


def config5_asset(c5):
    """config5's geometry from its built scene: one group a material
    (world-space positions and normals, triangles in leaf order,
    vertices in first-use order) and the MTL of its materials."""
    import numpy as np

    pos = c5.mesh.positions.cpu().numpy()
    nrm = c5.mesh.normals.cpu().numpy()
    idx = c5.mesh.indices.cpu().numpy()
    mid = c5.mesh.material_id.cpu().numpy()
    mats = c5.materials
    groups, mtl = [], []
    for m in range(int(mats.roughness.shape[0])):
        sel = idx[mid == m]
        if not len(sel):
            continue
        p, n, i = first_use_order(sel, pos, nrm)
        groups.append((f"m{m}", p, n, None, i))
        kd = mats.base_color[m].tolist()
        ke = mats.emissive[m].tolist()
        r = float(mats.roughness[m])
        mtl += [f"newmtl m{m}", "Kd {:.9g} {:.9g} {:.9g}".format(*kd),
                f"Ns {2.0 / r ** 2 - 2.0:.9g}"]
        if any(ke):
            mtl.append("Ke {:.9g} {:.9g} {:.9g}".format(*ke))
    return groups, "\n".join(mtl) + "\n"


def merged(groups):
    """(positions, normals, indices) of all the groups in one mesh."""
    import numpy as np

    base, idx = 0, []
    for g in groups:
        idx.append(g[4] + base)
        base += len(g[1])
    return (np.concatenate([g[1] for g in groups]),
            np.concatenate([g[2] for g in groups]),
            np.concatenate(idx).astype(np.int32))


def equal_arrays(name, got: dict, want: dict) -> None:
    import numpy as np

    for k, w in want.items():
        if not np.array_equal(np.asarray(got[k]), w):
            raise AssertionError(f"{name}: {k} differs from the written "
                                 "arrays")


def asset_frames(label, render_frame, RenderConfig, scene, camera, dev,
                 modules, tables, counts, expected) -> dict:
    """A loaded scene on the card: its route, the launches of one eager
    512x512 depth-4 frame against ``expected``, eager and replayed
    ms/frame (three frames each, after a warm-up), and the 128x128
    depth-2 frame through the kernels against the plain versions."""
    import torch

    from pnraytracing_tpu_torch.accel.route import traversal_route
    from pnraytracing_tpu_torch.render import program, renderer

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    img, got = frame_launches(render_frame, scene, camera, cfg, dev,
                              tables, counts)
    want = dict({k: 0 for k in got}, **expected)
    if got != want:
        raise AssertionError(f"{label}: launches per frame {got}, "
                             f"expected {want}")
    check_image(label, img, cfg)
    out = {"route": traversal_route(scene.trav, cfg.kernel_interaction),
           "triangles": int(scene.trav.tri9.shape[0]),
           "launches_per_frame": {k: v for k, v in got.items() if v}}
    for mode, fn in (("eager", render_frame),
                     ("replayed", renderer.render_frame)):
        fn(scene, camera, cfg, 2, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(3):
            fn(scene, camera, cfg, 3 + f, device=dev)
        torch.cuda.synchronize()
        out[f"{mode}_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / 3
    cfgp = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                        max_depth=PARITY_DEPTH)
    out["parity_128"] = frame_parity(render_frame, scene, camera, cfgp,
                                     dev, modules)
    program.clear_programs()  # the captured frames hold the scene
    return out


def timed(fn):
    t0 = time.perf_counter()
    res = fn()
    return res, time.perf_counter() - t0


def _timed_numpy_bvh(pos, idx):
    """The numpy builder's tree of ``(pos, idx)`` and its seconds (a
    process-pool task: it runs beside the phase's frames)."""
    from pnraytracing_tpu_torch.accel.bvh import build_bvh

    return timed(lambda: build_bvh(pos, idx))


def assets_phase(render_frame, RenderConfig, c5, c5_cam, dev, modules,
                 tables, counts, smi) -> dict:
    """Phase 18: the asset loaders.  Everything loaded is first written
    into a temporary directory.  (1) config4_marry through its OBJ
    branch, then its MTL-only branch (the OBJ removed): route ``wide``,
    kernels 3, 2, 4 (5 + 4 + 2 launches a 512x512 depth-4 frame), eager
    and replayed ms/frame, 128x128 depth-2 parity.  (2) config5's
    102,404 triangles written as .obj (one group a material, with its
    MTL), binary .ply, .glb and binary .fbx (64-bit offsets) and loaded
    by ``io.load_model``: the arrays equal the written ones; the native
    and the pure-Python OBJ loaders timed side by side; the native and
    numpy BVH builders on that geometry (seconds, the numpy one in a
    worker process while the frames run; both trees valid and equal);
    the scene built from the OBJ renders through route ``stream``
    (kernels 7c, 7a, 4).  (3) the native library is built and every
    dispatcher of ``io`` runs it, timed beside its pure-Python path on
    the same data with equal results.  Returns the launches of each
    path for the kernels line."""
    import multiprocessing
    import os
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from pnraytracing_tpu_torch import io as pio
    from pnraytracing_tpu_torch.accel.native import build_bvh_native
    from pnraytracing_tpu_torch.io import hdr as py_hdr
    from pnraytracing_tpu_torch.io import native as nio
    from pnraytracing_tpu_torch.io import obj as py_obj
    from pnraytracing_tpu_torch.io.hdr import procedural_sky
    from pnraytracing_tpu_torch.io.png import read_png_rgb
    from pnraytracing_tpu_torch.scene.build import SceneBuilder
    from pnraytracing_tpu_torch.scene.scenes import config4_marry
    from pnraytracing_tpu_torch.utils import image as py_image
    from pnraytracing_tpu_torch.utils import nativelib

    out = {"phase": "assets"}
    lib, lib_s = timed(nativelib.get_lib)
    if lib is None or pio._native() is not nio:
        raise AssertionError("the native library was not built or the io "
                             "dispatchers do not take it: g++ must exist "
                             "where nvcc does")
    out["native_library"] = {
        "path": os.path.relpath(lib._name), "get_lib_s": lib_s}
    tmp = tempfile.mkdtemp(prefix="pnrt_assets_")
    launches = {}
    # the numpy BVH of config5's geometry (~15 s) runs in a worker
    # process beside the frames below
    groups, mtl = config5_asset(c5)
    pos, nrm, idx = merged(groups)
    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    numpy_bvh = pool.submit(_timed_numpy_bvh, pos, idx)
    try:
        # (1) config 4's asset branches
        out["marry_asset"] = write_marry(tmp)
        wide = dict(closest_hit=1 + DEPTH, any_hit=DEPTH,
                    treelet_entry_key=2)
        for branch in ("obj", "mtl"):
            if branch == "mtl":
                os.remove(os.path.join(tmp, "marry.obj"))
            (scene, cam_state), build_s = timed(
                lambda: config4_marry(device=dev, marry_dir=tmp))
            res = asset_frames(f"config4_marry/{branch}", render_frame,
                               RenderConfig, scene,
                               cam_state.basis(device=dev), dev, modules,
                               tables, counts, wide)
            if res["route"] != "wide":
                raise AssertionError(f"config4_marry/{branch}: route "
                                     f"{res['route']}")
            launches[f"config4_{branch}"] = res["launches_per_frame"]
            out[f"config4_{branch}"] = dict(
                build_s=build_s, textures=scene.textures.count,
                textured_triangles=int((scene.mesh.texture_id >= 0).sum()),
                **res)

        # (2) the config5-class asset in four formats
        paths = {e: os.path.join(tmp, f"asset.{e}")
                 for e in ("obj", "ply", "glb", "fbx")}
        with open(os.path.join(tmp, "asset.mtl"), "w") as fh:
            fh.write(mtl)
        _, write_s = timed(lambda: (
            write_obj(paths["obj"], groups, mtllib="asset.mtl"),
            write_ply_binary(paths["ply"], pos, nrm, idx),
            write_glb(paths["glb"], pos, nrm, idx),
            write_fbx_binary(paths["fbx"], pos, nrm, idx)))
        loads = {"triangles": len(idx), "write_s": write_s,
                 "bytes": {e: os.path.getsize(p) for e, p in paths.items()}}
        for tag, fn in (("obj_native", lambda: pio.load_model(paths["obj"])),
                        ("obj_python", lambda: py_obj.load_obj(
                            paths["obj"]))):
            got, loads[f"{tag}_s"] = timed(fn)
            if len(got) != len(groups):
                raise AssertionError(f"{tag}: {len(got)} groups")
            for (mesh, _, _, _), g in zip(got, groups):
                equal_arrays(tag, mesh, dict(positions=g[1], normals=g[2],
                                             indices=g[4]))
        obj_groups = got
        for e in ("ply", "glb", "fbx"):
            got, loads[f"{e}_s"] = timed(lambda: pio.load_model(paths[e]))
            mesh = got if e == "ply" else got[0][0]
            want = (dict(positions=pos[idx].reshape(-1, 3),
                         normals=nrm[idx].reshape(-1, 3),
                         indices=np.arange(3 * len(idx), dtype=np.int32)
                         .reshape(-1, 3)) if e == "fbx" else
                    dict(positions=pos, normals=nrm, indices=idx))
            equal_arrays(e, mesh, want)
        loads["arrays_equal_written"] = True
        # the BVH of the geometry: native against numpy (whose tree the
        # worker built meanwhile)
        built = {"native": timed(lambda: build_bvh_native(pos, idx))}
        # the scene built from the OBJ, through the stream kernels
        sb = SceneBuilder()
        for mesh, mat, tex, name in obj_groups:
            sb.add(mesh, mat, name=name, texture=tex)
        scene, build_s = timed(lambda: sb.build(
            env_image=procedural_sky(256, 512), device=dev))
        res = asset_frames("config5_asset", render_frame, RenderConfig,
                           scene, c5_cam, dev, modules, tables, counts,
                           dict(closest_hit_stream=1 + DEPTH,
                                any_hit_stream=DEPTH,
                                treelet_entry_key=2))
        if res["route"] != "stream":
            raise AssertionError(f"config5_asset: route {res['route']}")
        launches["config5_asset"] = res["launches_per_frame"]
        del scene
        built["numpy"] = numpy_bvh.result()
        bvh = {tag: dict(seconds=sec, **check_bvh(tag, tree, pos, idx))
               for tag, (tree, sec) in built.items()}
        a, b = (built[t][0] for t in ("native", "numpy"))
        # equal on this geometry (its triangles in leaf order); on
        # icospheres in shape order the two split SAH ties otherwise
        bvh["trees_equal"] = all(np.array_equal(getattr(a, f), getattr(b, f))
                                 for f in ("node_min", "node_max", "axis",
                                           "right_child", "start", "end",
                                           "order"))
        if not bvh["trees_equal"]:
            raise AssertionError("config5_asset: the native and numpy BVH "
                                 "builders give other trees")
        out["config5_asset"] = dict(loads, bvh=bvh, build_s=build_s, **res)

        # (3) every dispatcher: native against the pure-Python path
        sky = procedural_sky(256, 512)
        disp = {}
        hdr_n, hdr_p = (os.path.join(tmp, f"sky_{t}.hdr")
                        for t in ("native", "python"))
        _, n_s = timed(lambda: pio.write_hdr(hdr_n, sky))
        _, p_s = timed(lambda: py_hdr.write_hdr(hdr_p, sky))
        disp["write_hdr"] = {"native_s": n_s, "python_s": p_s}
        a, n_s = timed(lambda: pio.read_hdr(hdr_p))
        b, p_s = timed(lambda: py_hdr.read_hdr(hdr_p))
        if not (np.array_equal(a, b) and np.array_equal(
                nio.read_hdr_native(hdr_n), py_hdr.read_hdr(hdr_n))):
            raise AssertionError("read_hdr: native and python differ")
        disp["read_hdr"] = {"native_s": n_s, "python_s": p_s, "equal": True}
        img = np.clip(sky / sky.max(), 0, 1)
        png_n, png_p = (os.path.join(tmp, f"sky_{t}.png")
                        for t in ("native", "python"))
        _, n_s = timed(lambda: pio.save_png(png_n, img))
        _, p_s = timed(lambda: py_image.save_png(png_p, img))
        if not np.array_equal(read_png_rgb(png_n), read_png_rgb(png_p)):
            raise AssertionError("save_png: native and python differ")
        disp["save_png"] = {"native_s": n_s, "python_s": p_s,
                            "equal": True}
        disp["load_obj"] = {"native_s": loads["obj_native_s"],
                            "python_s": loads["obj_python_s"],
                            "equal": True}
        out["dispatchers"] = disp
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    out["card"] = smi
    emit(out)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    from pnraytracing_tpu_torch import cuda_build
    from pnraytracing_tpu_torch.accel import traverse_cuda as trv
    from pnraytracing_tpu_torch.accel import traverse_stream_cuda as trs
    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.ops import compaction, shade
    from pnraytracing_tpu_torch.render import integrator, renderer
    from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

    # the eager frame (op by op): the phases that count launches per
    # frame, record kernel inputs or time the eager path; the phases
    # ``program``, ``session``, ``options`` and ``textures`` replay the
    # captured frame (render/program.py) too
    render_frame = functools.partial(renderer.render_frame, eager=True)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": built})

    t0 = time.perf_counter()
    scene, cam_state = config3_teapot_night(env_height=256, device=dev)
    camera = cam_state.basis(device=dev)
    trav = scene.trav
    # the tables the resident wide kernels read: rows and padded triangles
    scene_bytes = 4 * (trav.nodes16c.numel() + trav.tri12.numel())
    info = trv.kernel_info()
    emit({"phase": "scene", "seconds": time.perf_counter() - t0,
          "triangles": trav.tri9.shape[0],
          "wide_rows": trav.nodes16c.shape[0],
          "treelets": trav.treelets.shape[0], "bvh_depth": trav.bvh_depth,
          "scene_bytes": scene_bytes,
          "attr_bytes": 4 * trav.tri_attr16.numel(),
          "wide_kernels": info})

    # ---- 4. kernel parity on the rays of one plain-path frame ----------
    modules = (integrator, trv, trs, compaction)
    cfg1 = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=1)
    _, calls = record_frame(render_frame, scene, camera, cfg1, dev, *modules)
    primary = calls["closest_hit_attr"][0]
    cont = calls["closest_hit_attr"][1]
    shadow = calls["any_hit"][0]
    key_in = calls["entry_key"][0]
    r = primary[1].x.shape[0]

    results = {}
    for label, args in (("primary", primary), ("bounce0", cont)):
        o, d, tm = args[1], args[2], args[3]
        mask = args[4] if len(args) > 4 else None
        want, wattr, wst = trv.plain_closest_hit_attr(trav, o, d, tm, mask,
                                                      with_stats=True)
        got, gattr, st = trv.closest_hit_attr(trav, o, d, tm, mask,
                                              with_stats=True)
        bad_a, err_a = check_closest("closest_hit_attr/" + label, got, want,
                                     r, (gattr, wattr))
        check_stats("closest_hit_attr/" + label, st, wst)
        # the fill depends on the winning hit alone: every value equal
        attr_err = max(float((g.float() - w.float()).abs().max())
                       for g, w in zip(gattr, wattr))
        got3, st = trv.closest_hit(trav, o, d, tm, mask, with_stats=True)
        want3, wst = trv.plain_closest_hit(trav, o, d, tm, mask,
                                           with_stats=True)
        bad_c, err_c = check_closest("closest_hit/" + label, got3, want3, r)
        check_stats("closest_hit/" + label, st, wst)
        results[label] = {"attr_tri_mismatch": bad_a, "attr_err": err_a,
                          "attr_fill_max_abs_err": attr_err,
                          "tri_mismatch": bad_c, "err": err_c,
                          "stats_equal": True}
        if bad_a or bad_c or err_a or err_c or attr_err:
            raise AssertionError(f"closest hit/{label}: {results[label]}: "
                                 "the kernels must equal their plain "
                                 "versions bit for bit")
    o, d, tm, mask = shadow[1], shadow[2], shadow[3], shadow[4]
    occ_k, st = trv.any_hit(trav, o, d, tm, mask, with_stats=True)
    occ_p, wst = trv.plain_any_hit(trav, o, d, tm, mask, with_stats=True)
    occ_bad = int((occ_k != occ_p).sum())
    if occ_bad:
        raise AssertionError(f"any_hit: {occ_bad} occlusion mismatches")
    check_stats("any_hit", st, wst)
    # the key kernel on the bounce-0 and bounce-1 key rays and on rays no
    # frame sends, against both of its plain versions
    ko, kd, tre, tree = key_in
    cfg2 = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=2)
    key_sets = {"bounce0": (ko, kd), "bounce1": record_inputs(
        render_frame, scene, camera, cfg2, dev, integrator)[1][:2],
        "synthetic": synthetic_key_rays(tre, dev)}
    key_res = {label: check_key(label, compaction, *od, tre, tree)
               for label, od in key_sets.items()}
    key_bad = sum(v["mismatch_all_k"] + v["mismatch_walk"]
                  for v in key_res.values())
    torch.cuda.synchronize()
    emit({"phase": "kernel_parity", "rays": r,
          "shadow_rays": int(o.x.shape[0]), "closest": results,
          "any_hit_mismatch": occ_bad, "any_stats_equal": True,
          "entry_key_mismatch": key_bad, "entry_key": key_res})
    for label in ("bounce0", "bounce1"):
        ko_, kd_ = key_sets[label]
        key, kcounts = compaction.entry_key(ko_, kd_, tre, tree,
                                            with_stats=True)
        emit({"phase": "key_figures", "scene": "flagship", "rays_of": label,
              **key_figures(kcounts, key, ko_, kd_, tree, tre.shape[0])})

    # ---- 5. frame parity: kernels vs plain versions on the card --------
    cfgp = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                        max_depth=DEPTH)
    emit(dict(phase="frame_parity", **frame_parity(
        render_frame, scene, camera, cfgp, dev, modules)))

    # ---- 6. the flagship frame ------------------------------------------
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    render_frame(scene, camera, cfg, 0, device=dev)  # warm-up 1
    torch.cuda.synchronize()
    walk_tables = _launch_tables()[0]
    # the shade kernel's table is zeroed with the walks' and read apart:
    # ``counts`` (the walks and the key) is what each route is held to,
    # as render/program.py::launch_counts() leaves the shade kernel out
    tables = walk_tables + (shade.LAUNCHES,)
    counts = lambda: {k: v for t in walk_tables for k, v in t.items()}
    zero_counts(*tables)
    img = render_frame(scene, camera, cfg, 1, device=dev)  # warm-up 2
    torch.cuda.synchronize()
    launches = counts()
    expected = dict({k: 0 for k in launches}, closest_hit_attr=1 + DEPTH,
                    any_hit=DEPTH, treelet_entry_key=cfg.sort_max_bounce)
    shade_launches = {"eager_frame": shade.LAUNCHES["shade"]}
    tail_launches = {"eager_frame": shade.LAUNCHES["accumulate"]}
    if (launches != expected or shade_launches["eager_frame"] != DEPTH
            or tail_launches["eager_frame"] != DEPTH):
        raise AssertionError(f"launches per frame {launches}, shade "
                             f"{shade_launches}, accumulate "
                             f"{tail_launches}, expected {expected}, "
                             f"shade and accumulate {DEPTH}")
    if not (img.shape == (HEIGHT, WIDTH, 3) and torch.isfinite(img).all()
            and float(img.min()) >= 0.0 and float(img.max()) <= 1.0):
        raise AssertionError("flagship frame is not a finite [0,1] image")
    # kernel 3's own path: the same frame with kernel_interaction off
    cfg_off = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH,
                           kernel_interaction=False)
    zero_counts(*tables)
    img_off = render_frame(scene, camera, cfg_off, 1, device=dev)
    torch.cuda.synchronize()
    launches_off = counts()
    shade_launches["kernel_interaction_off"] = shade.LAUNCHES["shade"]
    tail_launches["kernel_interaction_off"] = shade.LAUNCHES["accumulate"]
    if launches_off != dict(expected, closest_hit_attr=0,
                            closest_hit=1 + DEPTH) or shade.LAUNCHES[
                                "shade"] != DEPTH or shade.LAUNCHES[
                                    "accumulate"] != DEPTH:
        raise AssertionError(f"kernel_interaction=False frame launched "
                             f"{launches_off}, shade {shade.LAUNCHES}")
    off_px = int(((img_off - img).abs().amax(dim=-1) > 1e-3).sum())
    # the same frame through closest_hit + make_interaction, timed: the
    # interaction route every streamed frame takes
    t0 = time.perf_counter()
    for f in range(3):
        render_frame(scene, camera, cfg_off, 2 + f, device=dev)
    torch.cuda.synchronize()
    ms_off = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.reset_peak_memory_stats()
    n_frames = 10
    t0 = time.perf_counter()
    for f in range(n_frames):
        img = render_frame(scene, camera, cfg, 2 + f, device=dev)
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t0) * 1e3 / n_frames
    peak = torch.cuda.max_memory_allocated()

    # per-kernel device times at the path's shapes, with bounds from the
    # work these inputs need (per-ray stats of one extra launch)
    attr_bytes = 4 * trav.tri_attr16.numel()
    rows = []
    o, d, tm = cont[1], cont[2], cont[3]
    mask = cont[4]
    figures = {}
    hit, _, st = trv.closest_hit_attr(trav, o, d, tm, mask, with_stats=True)
    bnd, by = bound(r * (RAY_IN + 40) + scene_bytes + attr_bytes,
                    trav_ops(st))
    figures["closest_hit_attr"] = walk_figures(st, fills=int(hit.valid.sum()))
    rows.append(dict(
        name="closest_hit_attr", source="pnraytracing_tpu_torch/csrc/"
        "traverse.cu", replaces="pnraytracing_tpu/accel/traverse_pallas.py"
        ":488", launches=launches["closest_hit_attr"],
        max_abs_err=max(v["attr_err"] for v in results.values()),
        tri_mismatch=sum(v["attr_tri_mismatch"] for v in results.values()),
        ms=time_ms(lambda: trv.closest_hit_attr(trav, o, d, tm, mask), 20),
        plain_ms=time_ms(lambda: trv.plain_closest_hit_attr(
            trav, o, d, tm, mask), 2), bound_ms=bnd, bound_by=by))
    _, st = trv.closest_hit(trav, o, d, tm, mask, with_stats=True)
    bnd, by = bound(r * (RAY_IN + 16) + scene_bytes, trav_ops(st))
    figures["closest_hit"] = walk_figures(st)
    rows.append(dict(
        name="closest_hit", source="pnraytracing_tpu_torch/csrc/traverse.cu",
        replaces="pnraytracing_tpu/accel/traverse_pallas.py:340",
        launches=launches["closest_hit"],
        max_abs_err=max(v["err"] for v in results.values()),
        tri_mismatch=sum(v["tri_mismatch"] for v in results.values()),
        ms=time_ms(lambda: trv.closest_hit(trav, o, d, tm, mask), 20),
        plain_ms=time_ms(lambda: trv.plain_closest_hit(trav, o, d, tm, mask),
                         2), bound_ms=bnd, bound_by=by))
    so, sd, stm, smask = shadow[1], shadow[2], shadow[3], shadow[4]
    _, st = trv.any_hit(trav, so, sd, stm, smask, with_stats=True)
    rs = so.x.shape[0]
    bnd, by = bound(rs * (RAY_IN + 1) + scene_bytes, trav_ops(st))
    figures["any_hit"] = walk_figures(st)
    rows.append(dict(
        name="any_hit", source="pnraytracing_tpu_torch/csrc/traverse.cu",
        replaces="pnraytracing_tpu/accel/traverse_pallas.py:668",
        launches=launches["any_hit"], max_abs_err=float(occ_bad),
        mismatches=occ_bad,
        ms=time_ms(lambda: trv.any_hit(trav, so, sd, stm, smask), 20),
        plain_ms=time_ms(lambda: trv.plain_any_hit(trav, so, sd, stm, smask),
                         2), bound_ms=bnd, bound_by=by))
    for row in rows:  # kernels 1-3: how the walk runs on these rays
        f = figures[row["name"]]
        row.update(info[row["name"]], touched_bytes=f["touched_bytes"],
                   touched_hbm_ms=f["touched_hbm_ms"],
                   simt_efficiency=f["simt_efficiency"]["pops"])
    emit({"phase": "walk_figures", "scene": "flagship", "kernels": figures})
    # the key kernel: each input once (rays, the tree) and the slab tests
    # this run's rays need; the bound of all K tests a ray beside it
    k_total = tre.shape[0]
    _, kcounts = compaction.entry_key(ko, kd, tre, tree, with_stats=True)
    tests = int(kcounts.sum())
    bnd, by = bound(r * (24 + 4) + 4 * tree.numel(), OPS_ENTRY_BOX * tests)
    rows.append(dict(
        name="treelet_entry_key", source="pnraytracing_tpu_torch/csrc/"
        "entry_key.cu", replaces="pnraytracing_tpu/ops/compaction.py:177",
        launches=launches["treelet_entry_key"],
        max_abs_err=float(key_bad), mismatches=key_bad,
        ms=time_ms(lambda: compaction.entry_key(ko, kd, tre, tree), 20),
        plain_ms=time_ms(lambda: compaction.entry_key_walk(
            ko, kd, tree, k_total), 2),
        all_k_plain_ms=time_ms(lambda: compaction.treelet_entry_key(
            ko, kd, tre), 2),
        bound_ms=bnd, bound_by=by, tests_per_ray=tests / r,
        all_k_bound_ms=bound(r * (24 + 4) + 24 * k_total,
                             OPS_ENTRY_BOX * k_total * r)[0],
        **compaction.kernel_info(k_total)))
    rows.append(shade_row(render_frame, scene, camera, dev, integrator,
                          built, shade_launches))
    rows.append(accumulate_row(render_frame, scene, camera, dev, integrator,
                               built, tail_launches))
    emit({"phase": "flagship", "width": WIDTH, "height": HEIGHT,
          "depth": DEPTH, "frames": n_frames, "ms_per_frame": ms_frame,
          "rays_per_s": QUERIES_PER_FRAME / (ms_frame / 1e3),
          "queries_per_frame": QUERIES_PER_FRAME,
          "launches_per_frame": dict(
              launches, shade=shade_launches["eager_frame"],
              accumulate=tail_launches["eager_frame"]),
          "launches_kernel_interaction_off": dict(
              launches_off, shade=shade_launches["kernel_interaction_off"],
              accumulate=tail_launches["kernel_interaction_off"]),
          "pixels_off_1e-3_kernel_interaction_off": off_px,
          "ms_per_frame_kernel_interaction_off": ms_off,
          "max_memory_allocated": peak,
          "card": smi})
    emit(dict(phase="profile", **profile_frame(
        lambda: render_frame(scene, camera, cfg, 12, device=dev), ms_frame)))
    flagship_program = program_phase("flagship", scene, camera, cfg, dev,
                                     expected, tables, counts, smi)
    shade_launches.update(flagship_program["shade_launches"])
    tail_launches.update(flagship_program["tail_launches"])
    session_phase(RenderConfig, scene, cam_state, dev, smi)
    app_launches = app_phase(RenderConfig, dev, expected, smi)
    grad_launches = grad_phase(RenderConfig, scene, camera, dev, modules,
                               tables, counts, smi)

    rows += binary_phase(trv, trav, cont, shadow, primary, launches)
    rows += compat_phase("flagship", render_frame, RenderConfig, scene,
                         camera, dev, modules, tables, counts,
                         dict(closest_hit_attr_compat=1 + DEPTH,
                              any_hit_compat=DEPTH,
                              treelet_entry_key=cfg.sort_max_bounce),
                         COMPAT_WALKS["resident"], smi)
    options_phase(render_frame, RenderConfig, scene, camera, dev, modules,
                  tables, counts, smi)
    catalog_phase(render_frame, RenderConfig, dev, modules, tables, counts)
    textures_phase(render_frame, RenderConfig, dev, modules, tables, counts)
    stream_rows, on_config5, c5, c5_cam = stream_phases(
        render_frame, RenderConfig, dev, smi, modules, tables, counts, cfgp,
        built)
    asset_launches = assets_phase(render_frame, RenderConfig, c5, c5_cam,
                                  dev, modules, tables, counts, smi)
    bvh_rows, binary_route = bvh_phase(render_frame, RenderConfig, dev,
                                       modules, tables, counts, c5, c5_cam,
                                       smi)
    trav_rows, trav_launches = traversal_phase(
        render_frame, RenderConfig, scene, camera, cont, shadow, c5, c5_cam,
        dev, modules, tables, counts, smi)
    par_launches = parallel_phase(render_frame, RenderConfig, scene, camera,
                                  c5, c5_cam, dev, smi)
    bench_launches = bench_phase(camera, smi)
    for row in rows:  # kernels 1-3 on config5's rays
        if row["name"] in on_config5:
            row["config5_ms"] = on_config5[row["name"]]
    for row in rows:  # kernels 5 / 6 on route 'binary' (phase bvh)
        if row["name"] in binary_route:
            row["binary_route_launches"] = binary_route[row["name"]]
    rows += stream_rows + bvh_rows + trav_rows
    for row in rows:
        row.update(route="cuda", library_ms=None)
        if row["name"] in ("shade", "accumulate", "interaction"):
            # the paths below count the walks' tables (the workers and
            # ranks report render/program.py::launch_counts()), which the
            # shade kernel stays out of: its row keeps what shade.LAUNCHES
            # read (shade_row's ``path_launches``)
            continue
        # launches of one flagship frame under each traversal value
        row["traversal_launches"] = {v: n.get(row["name"], 0)
                                     for v, n in trav_launches.items()}
        if row["name"].startswith(("closest_hit_bvh", "any_hit_bvh")):
            # one compat probe_pixel call a scene (phase compat)
            row["probe_pixel_launches"] = {
                k: v.get(row["name"], 0) for k, v in PROBE_LAUNCHES.items()}
        if row["name"] in ("closest_hit_attr", "any_hit", "closest_hit",
                           "treelet_entry_key"):
            # launches a sample on the gradient path (phase grad)
            row["grad_launches"] = {k: v.get(row["name"], 0)
                                    for k, v in grad_launches.items()}
        # launches on the paths of phase parallel, by world and path
        on = {w: {p: n.get(row["name"], 0) for p, n in paths.items()}
              for w, paths in par_launches.items()}
        row["primitive_launches"] = {
            w: {p: n for p, n in v.items() if p.startswith("primitive")}
            for w, v in on.items()}
        row["parallel_launches"] = {
            w: {p: n for p, n in v.items() if not p.startswith("primitive")}
            for w, v in on.items()}
        # launches a captured 512x512 depth-4 flagship frame in the
        # resilient loop's worker and in the render CLI's (phase app)
        row["app_launches"] = {k: v.get(row["name"], 0)
                               for k, v in app_launches.items()}
        # launches a 512x512 depth-4 frame on the loaded scenes (phase
        # assets)
        row["assets_launches"] = {k: v.get(row["name"], 0)
                                  for k, v in asset_launches.items()}
        # launches of entry()'s step and of each dryrun rank (phase bench)
        row["bench_launches"] = {k: v.get(row["name"], 0)
                                 for k, v in bench_launches.items()}
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
