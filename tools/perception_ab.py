"""Warm perception timings of one checkout on the card, for comparing two
checkouts in one chip call (the in-order parent against the pipelined
port, say).

    python3 tools/perception_ab.py CHECKOUT TAG

imports ``chip_smoke.py`` from ``CHECKOUT`` (copy the current one into an
older checkout first), builds the threshold, PnP and detect kernels (those
the checkout has) and the C modules,
renders the smoke's 384-frame perception scene on the card, runs
``estimate_pose_gray`` once to warm up and three more times (each through
``chip_smoke._perception_run``: the wall, each phase's seconds, the feed's
and the drain's), then ``chip_smoke.pipeline_trace`` (the detect
program's launches a batch and its split into refine, decode and dedup,
or into the detect kernels), then writes the frames as JPEGs and runs
``cam.estimate_pose_mp`` on the files twice.  Where the checkout's C
labeler spreads a batch over threads, it also records the thread count
perception hands it (``host_threads``), times the labeler alone on the
first batch's masks at 1 to 8 threads (``labeler_threads``), and runs P
twice with one core left to the drain (``runs_one_core_left``).  It
prints one line, ``AB``
and a JSON object: the warm-up's and the runs' rows, the file runs'
seconds and their detections.  Run the checkouts as separate processes in
turns (parent, change, change, parent, ...): both packages are named
``vican_torch``.  Needs a CUDA card and cv2.

    python3 tools/perception_ab.py CHECKOUT TAG SAVE.npz

also writes the last warm run's edges (keys, corners, poses) to
``SAVE.npz``;

    python3 tools/perception_ab.py --compare A.npz B.npz

prints how far two saved edge sets are apart (no card needed).
"""
import json
import os
import sys
import tempfile
import time


def save_edges(path: str, edges: dict) -> None:
    """The edges' keys (as text), corners and 4x4 poses, in dict order."""
    import numpy as np

    np.savez(path, keys=np.array([repr(k) for k in edges]),
             corners=np.stack([np.asarray(e["corners"], np.float64) for e in edges.values()]),
             poses=np.stack([np.asarray(e["pose"].pose(), np.float64) for e in edges.values()]))


def compare(a: str, b: str) -> dict:
    """Same keys in the same order, and the largest corner and pose-entry
    gaps of two saved edge sets."""
    import numpy as np

    x, y = np.load(a), np.load(b)
    same = x["keys"].shape == y["keys"].shape and bool((x["keys"] == y["keys"]).all())
    gaps = {k: float(np.abs(x[k] - y[k]).max()) if same else None for k in ("corners", "poses")}
    return dict(detections=[len(x["keys"]), len(y["keys"])], same_keys=same,
                max_corner_diff_px=gaps["corners"], max_pose_entry_diff=gaps["poses"])


def labeler_sweep(frames) -> dict:
    """The C labeler and gates alone (``quads_from_packed_masks``) on one
    batch's threshold masks at 1 to 8 threads: the median of 5 calls each,
    in seconds."""
    import numpy as np
    import torch

    from vican_torch import perception
    from vican_torch.ops.detect import DetectorParams
    from vican_torch.ops.threshold import multi_threshold

    p = DetectorParams()
    H, W = frames.shape[1:]
    packed = multi_threshold(torch.as_tensor(frames).cuda(), p.win_sizes,
                             p.thresh_const).cpu().numpy()
    threads, times = perception._host_threads, {}
    try:
        for t in range(1, 9):
            perception._host_threads = lambda m, t=t: t
            runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                perception.quads_from_packed_masks(packed, H, W, p)
                runs.append(time.perf_counter() - t0)
            times[t] = float(np.median(runs))
    finally:
        perception._host_threads = threads
    return times


def main() -> None:
    if sys.argv[1] == "--compare":
        print(json.dumps(compare(sys.argv[2], sys.argv[3])))
        return
    checkout, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, checkout)
    import cv2
    import torch

    import chip_smoke as cs
    from vican_torch import _kernels, perception
    from vican_torch.cam import estimate_pose_mp

    # the checkout's perception kernels (an older one has no pnp.cu or detect.cu)
    _kernels.build([k for k in ("threshold", "pnp", "detect") if k in _kernels.SOURCES])
    cs._build_native()
    scene = cs.perception_scene(torch.device("cuda"))
    host, names, frame_cams = scene[3].cpu().numpy(), scene[4], scene[5]
    del scene
    torch.cuda.empty_cache()
    out = {"tag": tag}
    _, out["warmup"] = cs._perception_run(host, names, frame_cams)
    out["runs"] = []
    for _ in range(3):
        edges, row = cs._perception_run(host, names, frame_cams)
        out["runs"].append(row)
    if len(sys.argv) > 3:
        save_edges(sys.argv[3], edges)
    out["trace"] = cs.pipeline_trace(host, names, frame_cams)
    threads = getattr(perception, "_host_threads", None)
    B = cs.PERCEPTION_KW["batch_size"]
    out["host_threads"] = 1 if threads is None else threads(B * 7)
    if threads is not None:
        out["labeler_threads"] = labeler_sweep(host[:B])
        perception._host_threads = lambda m: max(1, min(threads(m) - 1, m))
        try:
            out["runs_one_core_left"] = [cs._perception_run(host, names, frame_cams)[1]
                                         for _ in range(2)]
        finally:
            perception._host_threads = threads
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for img, name in zip(host, names):
            path = os.path.join(tmp, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            cv2.imwrite(path, img)
            files.append(path)
        out["files_s"] = []
        for _ in range(2):
            t0 = time.perf_counter()
            edges = estimate_pose_mp(files, frame_cams, brightness=0, contrast=0,
                                     marker_ids=None, **cs.PERCEPTION_KW)
            torch.cuda.synchronize()
            out["files_s"].append(time.perf_counter() - t0)
    out["files_detections"] = len(edges)
    print("AB " + json.dumps(out))


if __name__ == "__main__":
    main()
