"""Loop kind ``progressive``: one user converging images, closed loop.

Each call is ``render/renderer.py::render_average`` of ``spp_per_call``
frames (the replayed frame program), its image fetched to the host as a
viewer or the render command line would.  Call k renders frames
``start + k * spp_per_call`` onwards, ``start`` = seed x 2^20.

- ``frame_ms``: the window's wall time over the frames its calls
  completed; the clock closes on the last image's fetch.  Standard
  error also gets the fastest, median and slowest call's ms a frame:
  an H100 runs the replayed frame at one of two paces (PERF.md, section
  2), and these show which.
- The profiled stretch: whole calls (at most ``spp_per_call`` frames
  each) until about ``trace_device_s`` of frames at the window's rate.
- The check (``limits/<cell>.json``): ``answers`` calls drawn from the
  seed, the last one always among them, each at ``pixels`` pixels drawn
  from the seed, against the reference's mean of the same frames.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np

from pnrt_bench import check, port
from pnrt_bench.tracing import span
from pnrt_bench.scenes import make_recipe


class Loop:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.limits = check.load_limits(run.name)
        self.recipe = make_recipe(run.config)

    def setup(self):
        import torch

        from pnraytracing_tpu_torch.render.renderer import render_average

        run, dev = self.run, self.run.device
        self.scene = port.build_scene(self.recipe, dev, run)
        self.cfg = port.render_config(run.config)
        self.basis = port.camera_state(self.recipe.camera).basis(device=dev)
        self.start = port.frames_start(run.seed)
        self.spp = int(self.t["spp_per_call"])
        w, h = self.cfg.width, self.cfg.height
        self.pix = check.sample_pixels(run.seed, w, h, self.limits["pixels"])
        t0 = time.perf_counter()
        if dev.type == "cuda":
            from pnraytracing_tpu_torch.render.program import frame_program

            prog = frame_program(self.scene, self.cfg, dev)
            prog.capture(self.basis, self.start)
            torch.cuda.synchronize(dev)
            port.check_route(prog.launches, run.config)
        run.setup["capture_s"] = time.perf_counter() - t0
        self.render = render_average
        # one call through the window's path (the graph, the fetch)
        self._call(self.start, 1)
        self.answers = []

    def _call(self, start, spp=None):
        spp = self.spp if spp is None else spp
        run = self.run
        with span("replay"):
            img = self.render(self.scene, self.basis, self.cfg, start, spp,
                              device=run.device)
            if run.fault == "half":  # half of the frames, their mean
                img = self.render(self.scene, self.basis, self.cfg, start,
                                  spp // 2, device=run.device)
            elif run.fault == "stale" and hasattr(self, "last"):
                img = self.last
            elif run.fault == "altered":
                img = img * 1.01
        with span("fetch"):
            host = img.cpu()
        self.last = img
        return host

    def window(self, seconds: float) -> dict:
        calls, ms = 0, []
        t0 = t = time.perf_counter()
        while True:
            start = (self.start + (calls + 1) * self.spp) & 0xFFFFFFFF
            host = self._call(start)
            flat = host.reshape(-1, 3).numpy()
            self.answers.append((start, flat[self.pix].copy()))
            calls += 1
            ms.append((time.perf_counter() - t) * 1e3 / self.spp)
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        print(f"window: {calls} calls, ms a frame by call: min "
              f"{min(ms):.3f} median {statistics.median(ms):.3f} max "
              f"{max(ms):.3f}", file=sys.stderr)
        self.frames = calls * self.spp
        self.frame_s = wall / self.frames
        self.next_start = (self.start + (calls + 1) * self.spp) & 0xFFFFFFFF
        return {"frame_ms": wall * 1e3 / self.frames}

    def stretch(self) -> int:
        """Whole calls until ~``trace_device_s`` of frames: the frames
        done."""
        want = max(1, math.ceil(float(self.t["trace_device_s"])
                                / self.frame_s))
        done, start = 0, self.next_start
        while done < want:
            n = min(self.spp, want - done)
            self._call(start, n)
            start = (start + n) & 0xFFFFFFFF
            done += n
        return done

    def release(self):
        import torch

        from pnraytracing_tpu_torch.render import program

        program.clear_programs()
        self.scene = self.last = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """(checks, attempted, failed): the worst mismatch share over the
        checked calls."""
        import torch

        from pnrt_bench.reference import scene as rscene
        from pnrt_bench.reference import tracer

        run = self.run
        rng = np.random.default_rng([run.seed, 11])
        n = len(self.answers)
        k = min(int(self.limits["answers"]), n)
        others = rng.choice(n - 1, size=min(k - 1, n - 1), replace=False)
        picked = sorted({n - 1} | set(others.tolist()))
        ref_scene = rscene.build(self.recipe, run.device)
        cfg = dict(width=self.cfg.width, height=self.cfg.height,
                   max_depth=self.cfg.max_depth)
        px, py = tracer.pixel_rows(torch.as_tensor(self.pix,
                                                   device=run.device),
                                   self.cfg.width, self.cfg.height)
        checks = check.Checks(self.limits["limits"])
        worst, failed = 0.0, 0
        for i in picked:
            start, got = self.answers[i]
            frames = [(start + j) & 0xFFFFFFFF for j in range(self.spp)]
            with torch.no_grad():
                want = tracer.render_pixels(ref_scene, self.recipe.camera, cfg,
                                            px, py, frames)
            share = check.mismatch_share(got, want.float().cpu().numpy(),
                                         self.limits["pixel_tol"])
            failed += share > self.limits["limits"]["mismatch_share"]
            worst = max(worst, share)
        checks.add("mismatch_share", worst)
        return checks, n, failed


def control(config: dict, traffic: dict, limits: dict, seed: int, device):
    """The check's numbers with the reference computed in bfloat16 put in
    the program's place: ``answers`` calls of the seed's traffic."""
    import torch

    from pnrt_bench.reference import scene as rscene
    from pnrt_bench.reference import tracer

    recipe = make_recipe(config)
    r = config["render"]
    low = rscene.build(recipe, device, torch.bfloat16)
    ref = rscene.build(recipe, device)
    pix = check.sample_pixels(seed, r["width"], r["height"], limits["pixels"])
    px, py = tracer.pixel_rows(torch.as_tensor(pix, device=device),
                               r["width"], r["height"])
    spp, start = int(traffic["spp_per_call"]), port.frames_start(seed)
    worst = 0.0
    for k in range(int(limits["answers"])):
        frames = [(start + (k + 1) * spp + j) & 0xFFFFFFFF
                  for j in range(spp)]
        with torch.no_grad():
            got, want = (tracer.render_pixels(x, recipe.camera, r, px, py,
                                              frames) for x in (low, ref))
        worst = max(worst, check.mismatch_share(
            got.float().cpu().numpy(), want.float().cpu().numpy(),
            limits["pixel_tol"]))
    return {"mismatch_share": worst}
