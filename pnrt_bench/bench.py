"""The benchmark of the port: one run of one cell.

Everything is found by name.  ``BENCHMARK.json`` names the cell, its
configuration (``configs/<config>.json``: the scene recipe, the render
settings, the expected route), its traffic mix (``traffic/<traffic>.json``:
the parameters of one of the loop kinds in ``loops/``, named by its
``kind``) and its metrics; each per-layer metric is read by
``metrics/<metric>.py``; the limits of a cell's check are in
``limits/<cell>.json``.  A later cell, mix or metric is a new file and a
new entry, never an edit.

A run: make the scene from the recipe, hand it to the program, set up the
cell's programs and warm them up (``setup_s``), run the timed window for
``seconds``, optionally profile one bounded stretch after it (``--trace
1``), read the peak memory, free the program's state, then hold the
window's answers against the plain reference (``reference/``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "pnraytracing_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(root, "BENCHMARK.json")


def find_cell(bench: dict, workload: str, root: str):
    """(cell entry, configuration, traffic mix) of ``workload``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"choose from {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root, entry["file"])
    traffic = load_json(root, "pnrt_bench", "traffic",
                        f"{cell['traffic']}.json")
    return cell, config, traffic


def loop_module(kind: str):
    return importlib.import_module(f"pnrt_bench.loops.{kind}")


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py`` (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "pnrt_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Run:
    """What one run knows: its cell, its configuration and traffic mix,
    the seed, the device, its set-up times, the loop's counters, and
    (traced) the profiled stretch."""

    name: str
    config: dict
    traffic: dict
    seed: int
    device: object
    setup: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    fault: str | None = None


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             root: str, t_process: float, device=None,
             overrides: dict | None = None, fault: str | None = None):
    """One run: ``(result dict, check lines)``.  ``overrides`` replaces
    top-level keys of the configuration (the CPU tests shrink the
    frame); ``fault`` breaks the timed path underneath (tests only)."""
    import torch

    from pnrt_bench.tracing import breakdown, profile

    bench = benchmark(root)
    cell, config, traffic = find_cell(bench, workload, root)
    config = {**config, **(overrides or {})}
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    run = Run(name=workload, config=config, traffic=traffic, seed=int(seed),
              device=dev, fault=fault)
    loop = loop_module(traffic["kind"]).Loop(run)
    loop.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_process
    t_window = time.perf_counter()
    e2e = loop.window(float(seconds))
    t_trace = time.perf_counter()
    metrics = {}
    if trace:
        run.trace = profile(loop.stretch, dev)
        for m in metrics_of(bench, "per_layer", workload):
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in metrics_of(bench, "end_to_end", workload):
            # ``frame_ms.large`` is the loop's ``frame_ms`` in the cells
            # that report it: a suffix splits a quantity by its cells
            value = e2e[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
    }
    if trace:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    loop.release()
    t_check = time.perf_counter()
    checks, attempted, failed = loop.check()
    t_end = time.perf_counter()
    result = {"correct": bool(checks.ok and failed == 0),
              "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace and run.trace.ops:
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks.table()
    lines = [f"phases: set-up {setup_s:.2f} s, window "
             f"{t_trace - t_window:.2f} s, trace {t_check - t_trace:.2f} s, "
             f"check {t_end - t_check:.2f} s"]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in result["checks"].items()]
    return result, lines
