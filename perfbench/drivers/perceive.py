"""Perception cells: one capture of a room a call, frames in, edge dict out.

The capture is rendered on the card in set-up from the seed
(:mod:`perfbench.gen.scene`): the configuration's cameras around its
tumbling cube, ``timesteps`` x ``cameras`` frames.  The traffic's
``source`` says how the program is handed it:

- ``frames``: the uint8 frames in host memory, through
  ``vican_torch.perception.estimate_pose_gray``;
- ``jpeg``: the frames written once in set-up as three-channel JPEG files
  (``jpeg_quality``) under a fresh directory in ``TMPDIR``, through the
  file entry ``vican_torch.perception.estimate_pose_batched`` (the body of
  ``cam.estimate_pose_mp``), with the traffic's ``brightness`` and
  ``contrast``.

Each call passes a ``PhaseTimer`` and keeps the edges of ``sample_frames``
frames drawn from the seed; once the window has closed the plain reference
(:mod:`perfbench.reference.perception`) detects those frames again, from
the frames or by decoding the files itself, and every kept capture's edges
are held to it: the keys, the corners, the poses and the reprojection
errors, each against the configuration's ``limits``.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import roofline
from perfbench import trace as tr
from perfbench.gen import scene
from perfbench.reference import candidates as ref_candidates
from perfbench.reference import perception as ref_perception

PHASES = ("upload", "threshold kernel", "masks to host", "host threshold", "host candidates",
          "device candidates", "detect program", "PnP", "dict")
# each kernel wrapper's launch counter, and the kernels a launch runs
COUNTERS = {"multi_threshold": ("vican_torch.ops.threshold", "multi_threshold"),
            "detect_candidates": ("vican_torch.ops.detect", "detect_candidates"),
            "pnp_block": ("vican_torch.ops.pnp", "pnp_block")}
KERNELS = {"multi_threshold": ("threshold_band_kernel",),
           "detect_candidates": ("detect_slots_kernel", "dedup_kernel"),
           "pnp_block": ("pnp_block_kernel",)}
# a sample in which the reference finds fewer markers a frame judges little
MIN_MARKERS_PER_FRAME = 3


class State:
    pass


def _counter(name):
    import importlib

    module, attr = COUNTERS[name]
    return getattr(importlib.import_module(module), attr)


def _sample(seed: int, n: int, k: int) -> np.ndarray:
    rng = np.random.default_rng([seed % (1 << 63), 1])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def setup(config, traffic, seed, device, trace):
    from vican_torch.cam import Camera
    from vican_torch.geometry import SE3

    s = State()
    s.config, s.traffic, s.device = config, traffic, device
    frames, names, cam_of, cams = scene.render(config, seed % (1 << 63), device)
    s.frames = frames.cpu().numpy()
    del frames
    s.names, s.cams = names, [cams[i] for i in cam_of]
    program_cams = [Camera(id=c["id"], intrinsics=c["K"], distortion=c["dist"].copy(),
                           extrinsics=SE3(R=c["extrinsics"][:3, :3], t=c["extrinsics"][:3, 3]),
                           resolution_x=c["W"], resolution_y=c["H"]) for c in cams]
    s.frame_cams = [program_cams[i] for i in cam_of]
    s.tmp = None
    if traffic["source"] == "jpeg":
        import cv2

        s.tmp = tempfile.mkdtemp(prefix="perfbench-jpeg-")
        atexit.register(shutil.rmtree, s.tmp, True)
        s.files = []
        for img, name in zip(s.frames, names):
            path = os.path.join(s.tmp, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            bgr = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
            if not cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, traffic["jpeg_quality"]]):
                raise OSError(f"perfbench: could not write {path}")
            s.files.append(path)
    elif traffic["source"] != "frames":
        raise ValueError(f"perfbench: unknown perception source {traffic['source']!r}")
    s.sample = _sample(seed, len(names), traffic["sample_frames"])
    s.sample_names = {(s.files if s.tmp else names)[i] for i in s.sample}
    s.kept, s.phases = [], []
    s.kw = dict(aruco=config["aruco"], marker_size=config["marker_size"],
                corner_refine=config["corner_refine"], flags=config["flags"],
                batch_size=config["batch_size"], lm_iters=config["lm_iters"],
                pipeline_mode=traffic["pipeline_mode"], verbose=False, device=device)
    # warm-up: one batch, the one shape the captures run, builds or loads
    # every kernel and C module the cell uses
    call(s, frames=config["batch_size"])
    s.kept, s.phases = [], []
    return s


def _capture(s, timer, n):
    from vican_torch import perception

    if s.tmp is None:
        return perception.estimate_pose_gray(s.frames[:n], s.names[:n], s.frame_cams[:n],
                                             timer=timer, **s.kw)
    return perception.estimate_pose_batched(
        s.files[:n], s.frame_cams[:n], brightness=s.traffic["brightness"],
        contrast=s.traffic["contrast"], timer=timer, **s.kw)


def call(s, trace: bool = False, frames: int | None = None) -> int:
    """One capture (its first ``frames`` frames only: the warm-up)."""
    from vican_torch.utils import PhaseTimer

    timer = PhaseTimer(verbose=False, trace=trace, device=torch.device(s.device))
    out = _capture(s, timer, frames or len(s.names))
    s.phases.extend(timer.events)
    s.kept.append({k: (np.array(v["pose"].R(), np.float64), np.array(v["pose"].t(), np.float64),
                       np.array(v["corners"], np.float64), float(v["reprojected_err"]))
                   for k, v in out.items() if v["im_filename"] in s.sample_names})
    return len(s.names)


def traced(s) -> dict:
    before = {n: _counter(n).launches for n in COUNTERS}
    phases = len(s.phases)
    summary = tr.capture(lambda: call(s, trace=True), PHASES, cuda=s.device == "cuda")
    del s.phases[phases:]  # the window's phases only
    launches = {n: _counter(n).launches - before[n] for n in COUNTERS}
    W, H = s.config["resolution"]
    wins = ref_perception.detector_params(s.config).win_sizes
    notes = [f"trace: {n} launches {launches[n]}, traced "
             + ", ".join(f"{k} {sum(v[0] for name, v in summary['kernels'].items() if k in name)}"
                         for k in KERNELS[n])
             for n in COUNTERS]
    notes.append(f"trace: window {summary['window_s']:.6f} s, busy {summary['busy_s']:.6f} s, "
                 f"read in {summary['read_s']:.3f} s")
    return {"trace": summary, "launches": launches, "notes": notes,
            "work": {"threshold": roofline.threshold_work(s.kw["batch_size"], H, W, wins)}}


def release(s) -> dict:
    s.frame_cams = None
    return {"phases": s.phases}


def _reference_gray(s) -> np.ndarray:
    """The sampled frames as the reference sees them: the frames, or the
    files decoded and preprocessed by the reference's own code."""
    if s.tmp is None:
        return s.frames[s.sample]
    import cv2

    images = np.stack([cv2.imread(s.files[i], cv2.IMREAD_COLOR) for i in s.sample])
    return ref_candidates.host_preprocess(images, float(s.traffic["brightness"]),
                                          float(s.traffic["contrast"]))


def compare(kept: list, ref: dict) -> dict:
    """The widest gaps between every kept capture's edges and the
    reference's: keys found by one side only, corners (px), rotation
    entries, translations (m) and reprojection errors (px)."""
    worst = dict(unmatched_keys=0.0, corner_gap_px=0.0, rotation_gap=0.0,
                 translation_gap_m=0.0, error_gap_px=0.0)
    failed_captures = []
    for got in kept:
        gaps = dict(unmatched_keys=float(len(set(got) ^ set(ref))), corner_gap_px=0.0,
                    rotation_gap=0.0, translation_gap_m=0.0, error_gap_px=0.0)
        for k in set(got) & set(ref):
            R, t, c, e = got[k]
            Rr, tr_, cr, er = ref[k]
            gaps["corner_gap_px"] = max(gaps["corner_gap_px"], float(np.abs(c - cr).max()))
            gaps["rotation_gap"] = max(gaps["rotation_gap"], float(np.abs(R - Rr).max()))
            gaps["translation_gap_m"] = max(gaps["translation_gap_m"],
                                            float(np.abs(t - tr_).max()))
            gaps["error_gap_px"] = max(gaps["error_gap_px"], abs(e - er))
        failed_captures.append(gaps)
        for name, v in gaps.items():
            worst[name] = max(worst[name], v)
    return worst, failed_captures


def check(s):
    start = time.perf_counter()
    try:
        gray = _reference_gray(s)
        names = [(s.files if s.tmp else s.names)[i] for i in s.sample]
        ref = ref_perception.edges(gray, names, [s.cams[i] for i in s.sample], s.config,
                                   s.device)
    finally:
        if s.tmp is not None:
            shutil.rmtree(s.tmp, ignore_errors=True)
    limits = s.config["limits"]
    worst, per_capture = compare(s.kept, ref)
    s.readings = worst
    checks = [{"name": n, "value": v, "limit": limits[n]} for n, v in worst.items()]
    short = MIN_MARKERS_PER_FRAME * len(s.sample) - len(ref)
    checks.append({"name": "reference_short", "value": float(max(0, short)), "limit": 0.0})
    failed = sum(1 for g in per_capture if any(v > limits[n] for n, v in g.items()))
    s.notes = [f"check: the reference over {len(s.sample)} frames, {len(ref)} markers, "
               f"{len(s.kept)} captures compared, {time.perf_counter() - start:.1f} s"]
    return checks, failed


def control(s):
    """The control: the reference in float32, the precision below the
    configuration's float64, in the program's place on the same sampled
    frames, judged as a capture of the program is.  Not run by the
    benchmark; ``perfbench/tests/readings.py`` reads it on the card."""
    gray = _reference_gray(s)
    names = [(s.files if s.tmp else s.names)[i] for i in s.sample]
    cams = [s.cams[i] for i in s.sample]
    ref = ref_perception.edges(gray, names, cams, s.config, s.device)
    low = ref_perception.edges(gray, names, cams, s.config, s.device, dtype=torch.float32)
    return compare([low], ref)[0]
