"""Warm perception timings of one checkout on the card, for comparing two
checkouts in one chip call (the in-order parent against the pipelined
port, say).

    python3 tools/perception_ab.py CHECKOUT TAG

imports ``chip_smoke.py`` from ``CHECKOUT`` (copy the current one into an
older checkout first), builds the threshold and PnP kernels (those the
checkout has) and the C modules,
renders the smoke's 384-frame perception scene on the card, runs
``estimate_pose_gray`` once to warm up and three more times (each through
``chip_smoke._perception_run``), then writes the frames as JPEGs and runs
``cam.estimate_pose_mp`` on the files twice.  It prints one line, ``AB``
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


def main() -> None:
    if sys.argv[1] == "--compare":
        print(json.dumps(compare(sys.argv[2], sys.argv[3])))
        return
    checkout, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, checkout)
    import cv2
    import torch

    import chip_smoke as cs
    from vican_torch import _kernels
    from vican_torch.cam import estimate_pose_mp

    # the checkout's perception kernels (an older one has no pnp.cu)
    _kernels.build([k for k in ("threshold", "pnp") if k in _kernels.SOURCES])
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
