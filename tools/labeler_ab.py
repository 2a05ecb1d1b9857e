"""Time two builds of the host labeler and gates (``vican_torch/_native/
fastccl.c``) in one process, in turns, on P's first batch
(``tests/torch_bars.p_first_batch``: 32 frames of 1280x720, two cameras
distorted, thresholded on the card: 224 packed masks), and check that they
give the same bytes.  The labeler's speed hangs on where its code lands, so
two versions compare only within one process.  Needs a CUDA card.

    python3 tools/labeler_ab.py OTHER_DIR [--threads 1,4] [--rounds 40] [--cores 4]

``OTHER_DIR`` holds the other ``fastccl.c`` and its headers (an older
checkout's ``vican_torch/_native``); it is built there with this checkout's
flags.  The process keeps the first ``--cores`` of its cores (the
benchmark's ``host_cores``).  Prints the card's name and power limit, then
one JSON line a build and thread count: the call's wall ``ms`` and the
labeler's and gates' thread-ms (medians and minima over the rounds), the
runs labeled where the build counts them, and whether the two builds'
quads, valid flags, areas and re-fit counters are the same bytes.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]


def gated_call(ccl, packed, H, W, params, threads):
    """One ``quad_candidates_gated_batch`` call: ``(bytes of the outputs,
    wall seconds, labeler seconds, gates seconds, runs or None)``."""
    from vican_torch import perception as TP

    B, Wn, _, Wb = packed.shape
    Ks = params.max_candidates + params.max_candidates_4conn
    quads = np.empty((B, Wn * Ks, 4, 2), np.float32)
    areas = np.empty((B, Wn * Ks), np.float32)
    valid = np.empty((B, Wn * Ks), bool)
    stats = np.empty(len(TP.GATE_COUNTS), np.int64)
    times = np.full(5, -1.0)  # a build that counts no runs leaves the last entry
    t0 = time.perf_counter()
    ccl.quad_candidates_gated_batch(
        packed, B, Wn, H, W, Wb, params.max_candidates, params.max_candidates_4conn,
        params.min_area, params.max_area_rate * H * W, params.border_margin,
        TP._min_hollow_side(params), quads, areas, valid, stats, threads, times)
    seconds = time.perf_counter() - t0
    per_tick = seconds / max(times[3], 1.0)
    out = quads.tobytes() + valid.tobytes() + areas.tobytes() + stats.tobytes()
    runs = int(times[4]) if times[4] >= 0 else None
    return out, seconds, times[0] * per_tick, times[1] * per_tick, runs


def ms(seconds) -> list:
    """``[median, minimum]`` of ``seconds``, in milliseconds."""
    return [1e3 * float(np.median(seconds)), 1e3 * float(np.min(seconds))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="directory of the other fastccl.c and its headers")
    ap.add_argument("--threads", default="1,4", help="thread counts, comma-separated")
    ap.add_argument("--rounds", type=int, default=40, help="calls of each build a count")
    ap.add_argument("--cores", type=int, default=4, help="cores the process keeps")
    args = ap.parse_args(argv)
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:args.cores])

    import torch

    from torch_bars import p_first_batch
    from vican_torch import _native
    from vican_torch.ops.detect import DetectorParams
    from vican_torch.ops.threshold import multi_threshold

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    frames = p_first_batch(torch.device("cuda"))[0]
    params = DetectorParams()
    H, W = frames.shape[1:]
    packed = multi_threshold(frames.cuda(), params.win_sizes, params.thresh_const)
    packed = np.ascontiguousarray(packed.cpu().numpy()[:, :, :H])
    so = _native._build("fastccl", os.path.abspath(args.other))
    if so is None:
        raise SystemExit(f"the other fastccl.c did not build: {_native.build_errors}")
    spec = importlib.util.spec_from_file_location("other.fastccl", so)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    builds = {"this": _native.get_fastccl(), "other": other}

    for threads in (int(t) for t in args.threads.split(",")):
        seen = {name: gated_call(ccl, packed, H, W, params, threads)[0]
                for name, ccl in builds.items()}  # each warmed once
        same = seen["this"] == seen["other"]
        rows = {name: [] for name in builds}
        for r in range(args.rounds):
            for name in (("this", "other") if r % 2 == 0 else ("other", "this")):
                rows[name].append(gated_call(builds[name], packed, H, W, params, threads)[1:])
        for name, got in rows.items():
            wall, labeler, gates, runs = zip(*got)
            print(json.dumps({
                "build": name, "threads": threads, "masks": int(np.prod(packed.shape[:2])),
                "ms": ms(wall), "labeler_ms": ms(labeler), "gates_ms": ms(gates),
                "runs": runs[0], "same_bytes": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
