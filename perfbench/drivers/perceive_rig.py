"""Perception of a rig of several camera models: one capture of a dome a
call, decoded frames of every size in, edge dict out.

The capture is rendered on the card in set-up from the seed
(:mod:`perfbench.gen.dome`) and held as a list of 2-D uint8 frames in
capture order: timesteps outer, the cameras of a timestep in the dome's
fixed order, frame sizes interleaved.  Each call hands the whole list to
``vican_torch.perception.estimate_pose_gray``, which groups it by size and
runs every group's batches through one pipeline, with a ``PhaseTimer``
whose events are tagged with the call's index (``capture``).

``sample_frames`` frames drawn from the seed, as many of each size, are
kept from every capture; once the window has closed the plain reference
(:mod:`perfbench.reference.perception`) detects them again, once a size,
and every kept capture's edges are held to it as in the room cells
(:mod:`perfbench.drivers.perceive`), against the configuration's
``limits``.  The readings (:func:`check`'s and :func:`control`'s) are
given a size at a time, ``<number>.<W>x<H>``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import roofline
from perfbench import trace as tr
from perfbench.drivers import perceive
from perfbench.gen import dome
from perfbench.reference import perception as ref_perception

PHASES = ("stack",) + perceive.PHASES


class State:
    pass


def _sample(seed: int, sizes: list, k: int) -> np.ndarray:
    """``k`` frames drawn from the seed, as many of each size."""
    rng = np.random.default_rng([seed % (1 << 63), 2])
    groups = [np.flatnonzero([s == size for s in sizes]) for size in dict.fromkeys(sizes)]
    per = k // len(groups)
    return np.sort(np.concatenate([rng.choice(g, size=min(per, len(g)), replace=False)
                                   for g in groups]))


def setup(config, traffic, seed, device, trace):
    from vican_torch.cam import Camera
    from vican_torch.geometry import SE3

    s = State()
    s.config, s.traffic, s.device = config, traffic, device
    s.frames, s.names, cam_of, cams = dome.render(config, seed % (1 << 63), device)
    s.cams = [cams[i] for i in cam_of]
    program_cams = [Camera(id=c["id"], intrinsics=c["K"], distortion=c["dist"].copy(),
                           extrinsics=SE3(R=c["extrinsics"][:3, :3], t=c["extrinsics"][:3, 3]),
                           resolution_x=c["W"], resolution_y=c["H"]) for c in cams]
    s.frame_cams = [program_cams[i] for i in cam_of]
    s.sizes = [(c["W"], c["H"]) for c in s.cams]
    s.size_of = {c["id"]: (c["W"], c["H"]) for c in cams}
    s.sample = _sample(seed, s.sizes, traffic["sample_frames"])
    s.sample_names = {s.names[i] for i in s.sample}
    s.kept, s.phases, s.captures = [], [], 0
    s.kw = dict(aruco=config["aruco"], marker_size=config["marker_size"],
                corner_refine=config["corner_refine"], flags=config["flags"],
                batch_size=config["batch_size"], lm_iters=config["lm_iters"],
                pipeline_mode=traffic["pipeline_mode"], verbose=False, device=device)
    # warm-up: one batch of each size, in one call, builds or loads every
    # kernel and C module the cell uses
    B = config["batch_size"]
    call(s, frames=[i for size in dict.fromkeys(s.sizes)
                    for i in np.flatnonzero([z == size for z in s.sizes])[:B]])
    s.kept, s.phases, s.captures = [], [], 0
    return s


def call(s, trace: bool = False, frames: list | None = None) -> int:
    """One capture (only the ``frames`` given: the warm-up)."""
    from vican_torch import perception
    from vican_torch.utils import PhaseTimer

    timer = PhaseTimer(verbose=False, trace=trace, device=torch.device(s.device))
    if frames is None:
        out = perception.estimate_pose_gray(s.frames, s.names, s.frame_cams, timer=timer,
                                            **s.kw)
    else:
        out = perception.estimate_pose_gray([s.frames[i] for i in frames],
                                            [s.names[i] for i in frames],
                                            [s.frame_cams[i] for i in frames], timer=timer,
                                            **s.kw)
    for e in timer.events:
        e["capture"] = s.captures
    s.captures += 1
    s.phases.extend(timer.events)
    s.kept.append({k: (np.array(v["pose"].R(), np.float64), np.array(v["pose"].t(), np.float64),
                       np.array(v["corners"], np.float64), float(v["reprojected_err"]))
                   for k, v in out.items() if v["im_filename"] in s.sample_names})
    return len(s.names)


def traced(s) -> dict:
    before = {n: perceive._counter(n).launches for n in perceive.COUNTERS}
    phases = len(s.phases)
    summary = tr.capture(lambda: call(s, trace=True), PHASES, cuda=s.device == "cuda")
    del s.phases[phases:]  # the window's phases only
    launches = {n: perceive._counter(n).launches - before[n] for n in perceive.COUNTERS}
    notes = [f"trace: {n} launches {launches[n]}, traced "
             + ", ".join(f"{k} {sum(v[0] for name, v in summary['kernels'].items() if k in name)}"
                         for k in perceive.KERNELS[n])
             for n in perceive.COUNTERS]
    notes.append(f"trace: window {summary['window_s']:.6f} s, busy {summary['busy_s']:.6f} s, "
                 f"read in {summary['read_s']:.3f} s")
    return {"trace": summary, "launches": launches, "notes": notes,
            "work": {"threshold": _threshold_work(s)}}


def _threshold_work(s) -> dict:
    """The threshold's work a launch, weighted by launches: one a batch,
    each at its size's shape (a tail batch is padded to the full batch)."""
    B = s.config["batch_size"]
    wins = ref_perception.detector_params(s.config).win_sizes
    total, launches = {"ops": 0, "bytes": 0}, 0
    for (W, H), n in zip(*np.unique(np.array(s.sizes), axis=0, return_counts=True)):
        batches = -(-int(n) // B)
        work = roofline.threshold_work(B, int(H), int(W), wins)
        launches += batches
        for key in total:
            total[key] += batches * work[key]
    return {key: v / launches for key, v in total.items()}


def release(s) -> dict:
    s.frame_cams = None
    return {"phases": s.phases}


def _by_size(edges: dict, size_of: dict, size) -> dict:
    return {k: v for k, v in edges.items() if size_of[k[0]] == size}


def _reference(s, dtype=torch.float64) -> dict:
    """The reference's edges of the sampled frames, a size at a time."""
    ref = {}
    for size in dict.fromkeys(s.sizes):
        idx = [i for i in s.sample if s.sizes[i] == size]
        ref.update(ref_perception.edges(np.stack([s.frames[i] for i in idx]),
                                        [s.names[i] for i in idx], [s.cams[i] for i in idx],
                                        s.config, s.device, dtype=dtype))
    return ref


def _readings(s, kept: list, ref: dict) -> dict:
    """The compared numbers a size at a time: ``<number>.<W>x<H>``."""
    out = {}
    for size in dict.fromkeys(s.sizes):
        worst, _ = perceive.compare([_by_size(k, s.size_of, size) for k in kept],
                                    _by_size(ref, s.size_of, size))
        out.update({f"{n}.{size[0]}x{size[1]}": v for n, v in worst.items()})
    return out


def check(s):
    start = time.perf_counter()
    ref = _reference(s)
    limits = s.config["limits"]
    worst, per_capture = perceive.compare(s.kept, ref)
    s.readings = _readings(s, s.kept, ref)
    checks = [{"name": n, "value": v, "limit": limits[n]} for n, v in worst.items()]
    short = perceive.MIN_MARKERS_PER_FRAME * len(s.sample) - len(ref)
    checks.append({"name": "reference_short", "value": float(max(0, short)), "limit": 0.0})
    failed = sum(1 for g in per_capture if any(v > limits[n] for n, v in g.items()))
    counts = ", ".join(f"{W}x{H} {len(_by_size(ref, s.size_of, (W, H)))}"
                       for W, H in dict.fromkeys(s.sizes))
    s.notes = [f"check: the reference over {len(s.sample)} frames, {len(ref)} markers "
               f"({counts}), {len(s.kept)} captures compared, "
               f"{time.perf_counter() - start:.1f} s"]
    return checks, failed


def control(s):
    """The control: the reference in float32, the precision below the
    configuration's float64, in the program's place on the same sampled
    frames, read a size at a time.  Not run by the benchmark;
    ``perfbench/tests/readings.py`` reads it on the card."""
    return _readings(s, [_reference(s, torch.float32)], _reference(s))
