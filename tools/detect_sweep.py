"""Time versions of the detect kernels' source against each other on the
card, in one process, on P's first batch (``tests/torch_bars.py``).

    python3 tools/detect_sweep.py NAME=path/to/detect.cu ... [--reps N]

Each NAME=path is a version of ``vican_torch/csrc/detect.cu`` with the same
C entry (``detect_candidates_f64``): this checkout's, an older checkout's,
or an edit of it.  The script builds them all with the flags
``vican_torch/_kernels.py`` gives ``detect.cu`` (one ``nvcc`` each, all
started together, into ``vican_torch/_build/sweep/``), renders P's first 32
frames and captures their detect batch (``torch_bars.p_first_batch``),
then, with each version's library in place of the wrapper's: checks it
against ``detect_candidates_plain`` at each refine kind
(``tests/torch_bars.detect_ok``'s bars), and times it by
``kernel_times.device_ms`` at each kind and on the one-valid-slot batches
of ``kernel_times.one_slot_batches``, ``--reps`` rounds (3 by default) in
turns (forward, then backward), with each kernel's device time
(``kernel_times.kernel_split``) and its ptxas registers, stack and
spills.  A version that defines
``detect_clock_read(void*)`` and ``detect_clock_reset()`` (a ``__device__``
``long long [8192 * 16]`` of ``clock64()`` stamps, slot by slot, stamp 0 at
the slot's start, 1 after refine, 2 after the homography, 3-7 after the first
attempt's sampling, histogram, Otsu, cells and dictionary, 8-12 the second's,
13 at the end) also gets each phase's cycles: median, 90th percentile and
most over the valid slots of the batch and of the one-slot batches.  One
JSON object a line.  Needs a CUDA card.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

import kernel_times as kt

PHASES = {"refine": (0, 1), "lu": (1, 2), "a1_sample": (2, 3), "a1_hist": (3, 4),
          "a1_otsu": (4, 5), "a1_cells": (5, 6), "a1_dictionary": (6, 7),
          "a2_sample": (7, 8), "a2_hist": (8, 9), "a2_otsu": (9, 10), "a2_cells": (10, 11),
          "a2_dictionary": (11, 12), "total": (0, 13)}
KINDS = ("apriltag", "subpix", "none")


def build(versions: dict) -> tuple[dict, dict]:
    """Each version's library (argtypes set) and its kernels' ptxas report."""
    from vican_torch import _kernels

    out_dir = os.path.join(_kernels.BUILD, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in versions.items():
        out = os.path.join(out_dir, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *_kernels.SOURCE_FLAGS["detect"], "-o", out,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs, ptxas = {}, {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"version": name, "build_failed": log[-3000:]}), flush=True)
            continue
        lib = ctypes.CDLL(out)
        for fn, argtypes in _kernels.SOURCES["detect"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.detect_error_string.argtypes = [ctypes.c_int]
        lib.detect_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        ptxas[name] = {("slots" if "slots" in k else "dedup"): {
            x: v.get(x) for x in ("registers", "stack_frame", "spill_stores", "spill_loads")}
            for k, v in kt.ptxas_kernels(log).items()}
    return libs, ptxas


def clock_phases(lib, run, valid) -> dict:
    """Each phase's cycles over the valid slots of one call of ``run``."""
    import numpy as np
    import torch

    lib.detect_clock_reset()
    run()
    torch.cuda.synchronize()
    clk = np.zeros((8192, 16), np.int64)
    lib.detect_clock_read(ctypes.c_void_p(clk.ctypes.data))
    mask = valid.reshape(-1).cpu().numpy()
    rows = clk[:len(mask)][mask]
    res = {}
    for phase, (a, b) in PHASES.items():
        sel = (rows[:, a] > 0) & (rows[:, b] > 0)
        d = rows[sel, b] - rows[sel, a]
        res[phase] = ([int(np.median(d)), int(np.percentile(d, 90)), int(d.max()), int(sel.sum())]
                      if sel.any() else None)
    return res


def main() -> None:
    import numpy as np
    import torch

    from torch_bars import detect_gaps, detect_ok, p_first_batch
    from vican_torch import _kernels
    from vican_torch.ops import detect as TD

    versions = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 3
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    _kernels.build(["threshold", "pnp", "detect"])
    libs, ptxas = build(versions)
    gray, quads, valid, areas, codes, n_bits, params = p_first_batch(dev)[1]
    quads, valid, areas = (torch.as_tensor(x, device=dev) for x in (quads, valid, areas))
    ones = kt.one_slot_batches(gray, quads, valid, codes, n_bits, params)
    print(json.dumps({"built_s": time.perf_counter() - t0, "valid_slots": int(valid.sum()),
                      "ptxas": ptxas}), flush=True)

    def run(p, v=valid):
        return TD.detect_candidates(gray, quads, v, areas, codes, n_bits, p)

    kinds = {k: params._replace(corner_refine=k) for k in KINDS}
    refs = {k: TD.detect_candidates_plain(gray, quads, valid, areas, codes, n_bits, p)
            for k, p in kinds.items()}
    for name, lib in libs.items():
        _kernels._libs["detect"] = lib
        gaps = {}
        for k, p in kinds.items():
            g = detect_gaps(run(p), refs[k])
            gaps[k] = dict(ok=detect_ok(g), corners=g["corners"], corners_all=g["corners_all"])
        print(json.dumps({"version": name, "gaps": gaps}), flush=True)
    times = {n: {} for n in libs}
    order = list(libs)
    for r in range(reps):
        for name in order if r % 2 == 0 else order[::-1]:
            _kernels._libs["detect"] = libs[name]
            for k, p in kinds.items():
                times[name].setdefault(k, []).append(kt.device_ms(lambda p=p: run(p)))
            for case, one in ones.items():
                times[name].setdefault("one_" + case, []).append(
                    kt.device_ms(lambda one=one: run(params, one)))
    for name in order:
        _kernels._libs["detect"] = libs[name]
        print(json.dumps({"version": name,
                          "median_ms": {k: float(np.median(v)) for k, v in times[name].items()},
                          "ms": times[name], "ptxas": ptxas[name],
                          "split": {k: kt.kernel_split(lambda p=p: run(p))
                                    for k, p in kinds.items()}}), flush=True)
        if hasattr(libs[name], "detect_clock_read"):
            cases = [("batch", k, valid) for k in KINDS] + [
                ("one_" + c, k, o) for c, o in ones.items() for k in ("apriltag", "subpix")]
            for tag, k, v in cases:
                print(json.dumps({"version": name, "clock": tag, "kind": k,
                                  "cycles_median_p90_max_n": clock_phases(
                                      libs[name], lambda k=k, v=v: run(kinds[k], v), v)}),
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"sweep_s": time.perf_counter() - t0, "nvidia_smi": smi.strip()}),
          flush=True)


if __name__ == "__main__":
    main()
