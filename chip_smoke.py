#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Drives the port's main path — the flagship teapot_night forward frame
(512x512, 1 spp, 4 bounces) through ``render_frame`` — and holds every
CUDA kernel of that path against its plain PyTorch version.  Each phase
prints one JSON line; any failure raises and the script exits non-zero
without printing a result.  Phases:

1. device: the card's name and ``nvidia-smi`` name/power limit;
2. build: every ``csrc/*.cu`` compiled by ``nvcc`` in parallel, with the
   registers and spills ``-Xptxas -v`` reports;
3. scene: the flagship scene built by the port on the card;
4. kernel parity: each kernel against its plain version on the rays one
   plain-path frame hands it (primary rays, the bounce-0 sort-key rays,
   the bounce-0 fused shadow batch and continuation rays);
5. frame parity: a 128x128 depth-4 frame through the kernels and through
   the plain versions;
6. flagship: launch counts of one frame (counters zeroed just before),
   ms/frame and rays/s over 10 frames after 2 warm-up frames, each
   kernel's time by CUDA events at its path shapes beside its plain
   version's time and its bound, and peak device memory;
7. profile: one flagship frame under torch.profiler — device busy time,
   the top device kernels, and the idle share: busy time over the
   unprofiled ms/frame of phase 6 (the profiler slows the host).

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
``{"ok": true, "device": ...}`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

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
# test 9+6+3+2+2 add/sub, 6+3+6+3+1 mul, 1 div, ~8 compares.
OPS_AABB = 25
OPS_TRIANGLE = 50
OPS_ENTRY_BOX = 25

WIDTH = HEIGHT = 512
DEPTH = 4
QUERIES_PER_FRAME = WIDTH * HEIGHT * (1 + 3 * DEPTH)  # as bench.py counts
PARITY_SIZE = 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Swaps the integrator's kernel wrappers for recording versions that
    clone their inputs and compute with the plain versions, so one frame
    yields the path's real kernel inputs without launching a kernel."""

    def __init__(self, integrator, traverse, compaction):
        self.mod = integrator
        self.names = ("closest_hit_attr", "closest_hit", "any_hit",
                      "entry_key")
        self.saved = {n: getattr(integrator, n) for n in self.names}
        self.calls: list[tuple[str, tuple]] = []
        plain = {
            "closest_hit_attr": traverse.plain_closest_hit_attr,
            "closest_hit": traverse.plain_closest_hit,
            "any_hit": traverse.plain_any_hit,
            "entry_key": compaction.treelet_entry_key,
        }
        for n in self.names:
            setattr(integrator, n, self._recording(n, plain[n]))

    def _recording(self, name, fn):
        def call(*args, **kw):
            self.calls.append((name, _clone(args)))
            return fn(*args, **kw)
        return call

    def restore(self):
        for n, f in self.saved.items():
            setattr(self.mod, n, f)


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


def profile_frame(fn, frame_ms: float, top: int = 8) -> dict:
    """Where one frame's time goes: torch.profiler over one call of
    ``fn`` — device busy time (sum of the CUDA kernels' self times), the
    number of device kernels, the profiled wall time and the top kernels
    by device time.  The device's idle share is taken against
    ``frame_ms``, the unprofiled time of the same frame, since the
    profiler's own host overhead stretches the profiled wall time.
    Device fields are None when the profiler records no device activity
    on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0)
    # device-side kernel records only (the CPU-side aten ops that launch
    # them carry the same time and would count it twice)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if not kernels:
        return {"profiled_wall_ms": profiled_wall_ms, "frame_ms": frame_ms,
                "device_busy_ms": None,
                "device_idle_share": None, "top_kernels": None}
    kernels.sort(key=dev_us, reverse=True)
    ours = {}
    for e in kernels:
        # demangled ("closest_hit_kernel<true>") or mangled ("...ILb1E")
        m = re.search(r"(closest_hit|any_hit|entry_key)_kernel"
                      r"(?:<(true|false)>|ILb([01])E)?", e.key)
        if m:
            attr = m.group(2) or m.group(3)
            name = ("closest_hit_attr" if attr in ("true", "1") else
                    "closest_hit" if attr in ("false", "0") else m.group(1))
            name = "treelet_entry_key" if name == "entry_key" else name
            ours[name] = {"calls": e.count, "device_ms": dev_us(e) / 1e3}
    return {
        "profiled_wall_ms": profiled_wall_ms, "frame_ms": frame_ms,
        "device_busy_ms": busy_ms,
        # negative if the busy time exceeds the frame: reported, not hidden
        "device_idle_share": 1.0 - busy_ms / frame_ms,
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    from pnraytracing_tpu_torch import cuda_build
    from pnraytracing_tpu_torch.accel import traverse_cuda as trv
    from pnraytracing_tpu_torch.core.config import RenderConfig
    from pnraytracing_tpu_torch.ops import compaction
    from pnraytracing_tpu_torch.render import integrator
    from pnraytracing_tpu_torch.render.renderer import render_frame
    from pnraytracing_tpu_torch.scene.scenes import config3_teapot_night

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
    scene_bytes = 4 * (trav.nodes16c.numel() + trav.tri9.numel())
    emit({"phase": "scene", "seconds": time.perf_counter() - t0,
          "triangles": trav.tri9.shape[0],
          "wide_rows": trav.nodes16c.shape[0],
          "treelets": trav.treelets.shape[0], "bvh_depth": trav.bvh_depth,
          "scene_bytes": scene_bytes,
          "attr_bytes": 4 * trav.tri_attr16.numel()})

    # ---- 4. kernel parity on the rays of one plain-path frame ----------
    cfg1 = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=1)
    rec = Recorder(integrator, trv, compaction)
    try:
        render_frame(scene, camera, cfg1, 0, device=dev)
    finally:
        rec.restore()
    calls = {}
    for name, args in rec.calls:
        calls.setdefault(name, []).append(args)
    primary = calls["closest_hit_attr"][0]
    cont = calls["closest_hit_attr"][1]
    shadow = calls["any_hit"][0]
    key_in = calls["entry_key"][0]
    r = primary[1].x.shape[0]

    results = {}
    for label, args in (("primary", primary), ("bounce0", cont)):
        o, d, tm = args[1], args[2], args[3]
        mask = args[4] if len(args) > 4 else None
        want, wattr = trv.plain_closest_hit_attr(trav, o, d, tm, mask)
        got, gattr = trv.closest_hit_attr(trav, o, d, tm, mask)
        bad_a, err_a = check_closest("closest_hit_attr/" + label, got, want,
                                     r, (gattr, wattr))
        got3 = trv.closest_hit(trav, o, d, tm, mask)
        bad_c, err_c = check_closest("closest_hit/" + label, got3,
                                     trv.plain_closest_hit(trav, o, d, tm,
                                                           mask), r)
        results[label] = {"attr_tri_mismatch": bad_a, "attr_err": err_a,
                          "tri_mismatch": bad_c, "err": err_c}
    o, d, tm, mask = shadow[1], shadow[2], shadow[3], shadow[4]
    occ_k = trv.any_hit(trav, o, d, tm, mask)
    occ_p = trv.plain_any_hit(trav, o, d, tm, mask)
    occ_bad = int((occ_k != occ_p).sum())
    if occ_bad:
        raise AssertionError(f"any_hit: {occ_bad} occlusion mismatches")
    ko, kd, tre = key_in
    key_k = compaction.entry_key(ko, kd, tre)
    key_p = compaction.treelet_entry_key(ko, kd, tre)
    key_bad = int((key_k != key_p).sum())
    if key_bad:
        raise AssertionError(f"entry_key: {key_bad} key mismatches")
    torch.cuda.synchronize()
    emit({"phase": "kernel_parity", "rays": r,
          "shadow_rays": int(o.x.shape[0]), "closest": results,
          "any_hit_mismatch": occ_bad, "entry_key_mismatch": key_bad})

    # ---- 5. frame parity: kernels vs plain versions on the card --------
    cfgp = RenderConfig(width=PARITY_SIZE, height=PARITY_SIZE,
                        max_depth=DEPTH)
    img_k = render_frame(scene, camera, cfgp, 0, device=dev)
    rec = Recorder(integrator, trv, compaction)
    try:
        img_p = render_frame(scene, camera, cfgp, 0, device=dev)
    finally:
        rec.restore()
    px_err = (img_k - img_p).abs().amax(dim=-1)
    n_out = int((px_err > 3e-5).sum())
    limit = int(PARITY_SIZE * PARITY_SIZE * 2e-4)
    finite = bool(torch.isfinite(img_k).all())
    emit({"phase": "frame_parity", "pixels": PARITY_SIZE * PARITY_SIZE,
          "outside_atol_3e-5": n_out, "limit": limit,
          "max_abs_err": float(px_err.max()), "finite": finite,
          "mean": float(img_k.mean())})
    if n_out > limit or not finite:
        raise AssertionError("frame parity failed")

    # ---- 6. the flagship frame ------------------------------------------
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    render_frame(scene, camera, cfg, 0, device=dev)  # warm-up 1
    torch.cuda.synchronize()
    for counts in (trv.LAUNCHES, compaction.LAUNCHES):
        for k in counts:
            counts[k] = 0
    img = render_frame(scene, camera, cfg, 1, device=dev)  # warm-up 2
    torch.cuda.synchronize()
    launches = dict(trv.LAUNCHES, **compaction.LAUNCHES)
    expected = {"closest_hit_attr": 1 + DEPTH, "any_hit": DEPTH,
                "treelet_entry_key": cfg.sort_max_bounce, "closest_hit": 0}
    if launches != expected:
        raise AssertionError(f"launches per frame {launches}, expected "
                             f"{expected}")
    if not (img.shape == (HEIGHT, WIDTH, 3) and torch.isfinite(img).all()
            and float(img.min()) >= 0.0 and float(img.max()) <= 1.0):
        raise AssertionError("flagship frame is not a finite [0,1] image")
    # kernel 3's own path: the same frame with kernel_interaction off
    cfg_off = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=DEPTH,
                           kernel_interaction=False)
    for counts in (trv.LAUNCHES, compaction.LAUNCHES):
        for k in counts:
            counts[k] = 0
    img_off = render_frame(scene, camera, cfg_off, 1, device=dev)
    torch.cuda.synchronize()
    launches_off = dict(trv.LAUNCHES, **compaction.LAUNCHES)
    if launches_off != dict(expected, closest_hit_attr=0,
                            closest_hit=1 + DEPTH):
        raise AssertionError(f"kernel_interaction=False frame launched "
                             f"{launches_off}")
    off_px = int(((img_off - img).abs().amax(dim=-1) > 1e-3).sum())
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
    def bound(bytes_, ops):
        b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")

    def trav_ops(stats):
        pops, leaf, tris = (int(s.sum()) for s in stats)
        return OPS_AABB * 2 * (pops - leaf) + OPS_TRIANGLE * tris

    ray_in = 4 * 7 + 1  # ox..dz, t_max (f32) + mask (bool)
    attr_bytes = 4 * trav.tri_attr16.numel()
    rows = []
    o, d, tm = cont[1], cont[2], cont[3]
    mask = cont[4]
    _, _, st = trv.closest_hit_attr(trav, o, d, tm, mask, with_stats=True)
    bnd, by = bound(r * (ray_in + 40) + scene_bytes + attr_bytes,
                    trav_ops(st))
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
    bnd, by = bound(r * (ray_in + 16) + scene_bytes, trav_ops(st))
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
    bnd, by = bound(rs * (ray_in + 1) + scene_bytes, trav_ops(st))
    rows.append(dict(
        name="any_hit", source="pnraytracing_tpu_torch/csrc/traverse.cu",
        replaces="pnraytracing_tpu/accel/traverse_pallas.py:668",
        launches=launches["any_hit"], max_abs_err=float(occ_bad),
        mismatches=occ_bad,
        ms=time_ms(lambda: trv.any_hit(trav, so, sd, stm, smask), 20),
        plain_ms=time_ms(lambda: trv.plain_any_hit(trav, so, sd, stm, smask),
                         2), bound_ms=bnd, bound_by=by))
    k_total = tre.shape[0]
    bnd, by = bound(r * (24 + 4) + 24 * k_total, OPS_ENTRY_BOX * k_total * r)
    rows.append(dict(
        name="treelet_entry_key", source="pnraytracing_tpu_torch/csrc/"
        "entry_key.cu", replaces="pnraytracing_tpu/ops/compaction.py:177",
        launches=launches["treelet_entry_key"],
        max_abs_err=float((key_k - key_p).abs().max()), mismatches=key_bad,
        ms=time_ms(lambda: compaction.entry_key(ko, kd, tre), 20),
        plain_ms=time_ms(lambda: compaction.treelet_entry_key(ko, kd, tre),
                         2), bound_ms=bnd, bound_by=by))
    for row in rows:
        row.update(route="cuda", library_ms=None)
    emit({"phase": "flagship", "width": WIDTH, "height": HEIGHT,
          "depth": DEPTH, "frames": n_frames, "ms_per_frame": ms_frame,
          "rays_per_s": QUERIES_PER_FRAME / (ms_frame / 1e3),
          "queries_per_frame": QUERIES_PER_FRAME,
          "launches_per_frame": launches,
          "launches_kernel_interaction_off": launches_off,
          "pixels_off_1e-3_kernel_interaction_off": off_px,
          "max_memory_allocated": peak,
          "card": smi})
    emit(dict(phase="profile", **profile_frame(
        lambda: render_frame(scene, camera, cfg, 12, device=dev), ms_frame)))
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
