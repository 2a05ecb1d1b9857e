"""The benchmark's core, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
harness finds everything by those names and by the metrics' names:

- ``configs[].file``: the configuration's sizes (JSON);
- ``perfbench/traffic/<traffic>.json``: the mix's parameters, among them
  ``driver``, the kind of call;
- ``perfbench/drivers/<driver>.py``: ``setup``, ``call``, ``traced``,
  ``release`` and ``check`` for that kind of call;
- ``perfbench/metrics/<metric>.py``: ``read(run)``, one metric from what the
  run recorded, or None where it finds nothing to read.

One run: set-up (``setup_s`` runs from the process's start to the first
timed call), the measured window (calls back to back, each after the last
returns, until ``--seconds`` have passed), with ``--trace 1`` one more call
under ``torch.profiler``, then the program's state is freed and the plain
reference judges what the window produced.  The last line of standard
output is the result (perfbench/README.md); the numbers compared, each
beside its limit, are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import platform
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "vican_tpu")
# the program's build caches, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": os.path.join(ROOT, ".perfbench_cache", "torch_extensions"),
              "TRITON_CACHE_DIR": os.path.join(ROOT, ".perfbench_cache", "triton")}


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"perfbench: no {kind} file {path}")
    mod_name = "perfbench_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """``(cell, configuration, traffic)`` of a cell: its entry, its
    configuration file's contents and its traffic file's."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A metric without ``workloads``
    belongs to every cell that reports the end-to-end metric it moves."""
    def e2e_here(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if e2e_here(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def layer_here(m):
        return workload in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in spec["per_layer"] if layer_here(m)]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def window(driver, state, seconds: float) -> list[tuple[float, float, float]]:
    """Calls back to back until ``seconds`` have passed since the first
    started: ``[(start, end, units done)]`` by the host's clock."""
    calls = []
    deadline = time.perf_counter() + seconds
    while True:
        t0 = time.perf_counter()
        units = driver.call(state)
        t1 = time.perf_counter()
        calls.append((t0, t1, float(units)))
        if t1 >= deadline:
            return calls


def device_info(device: str, chips: int) -> dict:
    if device == "cuda":
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}
    return {"platform": "cpu", "kind": platform.processor() or platform.machine(),
            "count": 1, "memory_peak_bytes": 0}


def _parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, start: float | None = None, device: str | None = None,
         overrides: dict | None = None) -> int:
    """Run one cell; returns the exit code.  ``device`` and ``overrides``
    (``{"config": {...}, "traffic": {...}}``, merged into the files'
    contents) serve the tests on the CPU: the command passes neither."""
    start = time.perf_counter() if start is None else start
    args = _parse(argv)
    spec = load_spec()
    cell, config, traffic = cell_parts(spec, args.workload)
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(part)
    for var, path in CACHE_DIRS.items():
        os.environ.setdefault(var, path)
    if device is None:
        import torch

        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell["chips"]:
            print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s), "
                  f"found {found}", file=sys.stderr)
            return 3
        device = "cuda"
        # the configuration's host cores (a cut listed in its ``reduced``);
        # every thread the program starts inherits them
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, cores[:config.get("host_cores", len(cores))])
    trace = bool(args.trace)
    driver = load_module("drivers", traffic["driver"])
    readers = {m["name"]: load_module("metrics", m["name"])
               for m in cell_metrics(spec, args.workload, trace)}

    state = driver.setup(config, traffic, args.seed, device, trace)
    run = {"setup_s": time.perf_counter() - start}
    run["calls"] = window(driver, state, args.seconds)
    info = device_info(device, cell["chips"])
    if trace:
        run.update(driver.traced(state))
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    run.update(driver.release(state))
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    checks, failed = driver.check(state)
    run.setdefault("notes", []).extend(getattr(state, "notes", []))

    metrics = {}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    if trace:
        info["busy_s"] = run["trace"]["busy_s"]
        info["window_s"] = run["trace"]["window_s"]
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 4
    correct = bool(checks) and failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": len(run["calls"]), "failed": failed,
              "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = run["trace"]["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for line in run.get("notes", []):
        print(line, file=sys.stderr)
    for c in checks:
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {c['name']} {c['value']!r} <= {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
