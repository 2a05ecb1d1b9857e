"""Solve cells: one calibration of a camera network a call, the edge dict in,
world poses out.

The problem is made in set-up from the seed (:mod:`perfbench.gen.shop`)
and handed to the program as the upstream schema's edge dict,
``{(camera id, "<t>_<marker>"): {"pose", "corners", "reprojected_err",
"im_filename"}}``, with the markers' ground-truth poses as constraints and
the noise models and filter as a user writes them (``lambda e: 1.0``,
``lambda e: e["reprojected_err"] < 0.05``).  Each call runs
``vican_torch.bipgo.bipartite_se3sync`` at the configuration's dtype,
``maxiter`` and translation solver and keeps every pose it returns; with
``--trace 1`` each call also logs its phases (``verbose=True``), which the
solver's per-layer metrics read.  Once the window has closed the plain
reference (:mod:`perfbench.reference.solve`) solves the problem's arrays in
float64, and every solve of the window is held to it (:func:`compare`).
"""
from __future__ import annotations

import contextlib
import io
import os
import re
import time

import numpy as np

from perfbench import trace as tr
from perfbench.gen import shop
from perfbench.reference import solve as ref_solve

# the noise models and the filter as the upstream notebook writes them; the
# configuration states the same constants (checked in setup)
NOISE = lambda e: 1.0  # noqa: E731
FILTER = lambda e: e["reprojected_err"] < 0.05  # noqa: E731
PHASES = ("Applying constraints", "Optimizing + solving (device)")
_PHASE_LINE = re.compile(r"^(.*) \(([0-9.]+)s\)\.$")


class State:
    pass


def edge_dict(a: dict) -> dict:
    """The upstream schema's edge dict of a problem's arrays, every pose a
    view of one (E, 4, 4) float64 array."""
    from vican_torch.geometry import SE3

    E = len(a["ci"])
    poses = np.zeros((E, 4, 4))
    poses[:, :3, :3] = a["R"]
    poses[:, :3, 3] = a["t"]
    poses[:, 3, 3] = 1.0
    view = SE3._from_pose_view
    ci, ti, mi = a["ci"].tolist(), a["ti"].tolist(), a["mi"].tolist()
    errs = a["errs"].tolist()
    return {(str(c), f"{t}_{m}"): {"pose": view(poses[e]), "corners": a["corners"][e],
                                   "reprojected_err": errs[e], "im_filename": f"{t}/{c}.jpg"}
            for e, (c, t, m) in enumerate(zip(ci, ti, mi))}


def dict_arrays(a: dict) -> dict:
    """The arrays of the edges the edge dict holds: of observations with
    the same (camera, timestep, marker), the later replaces the earlier, as
    a dict's key does."""
    key = (a["ci"] * (int(a["ti"].max()) + 1) + a["ti"]) * (int(a["mi"].max()) + 1) + a["mi"]
    _, first_of_reversed = np.unique(key[::-1], return_index=True)
    keep = np.sort(len(key) - 1 - first_of_reversed)
    out = dict(a)
    for name in ("ci", "ti", "mi", "R", "t", "corners", "errs"):
        out[name] = a[name][keep]
    return out


def setup(config, traffic, seed, device, trace):
    from vican_torch.geometry import SE3

    if (config["noise_model_r"], config["noise_model_t"], config["max_reprojected_err"]) != (
            NOISE(None), NOISE(None), 0.05):
        raise ValueError("perfbench: the solve driver's noise models and filter are fixed")
    s = State()
    s.config, s.device, s.trace = config, device, trace
    s.arrays = shop.make(config, seed % (1 << 63), device)
    s.edges = edge_dict(s.arrays)
    constraints = {str(m): SE3(R=s.arrays["Rm"][m], t=s.arrays["tm"][m])
                   for m in range(config["n_markers"])}
    s.kw = dict(constraints=constraints, noise_model_r=NOISE, noise_model_t=NOISE,
                edge_filter=FILTER, maxiter=config["maxiter"],
                lsqr_solver=config["lsqr_solver"], dtype=np.dtype(config["dtype"]),
                device=device)
    s.kept, s.solver_phases = [], []
    call(s)  # warm-up: builds or loads the kernels and C modules, sizes the caches
    s.kept, s.solver_phases = [], []
    return s


def _poses(config: dict, est: dict) -> tuple[np.ndarray, np.ndarray]:
    """Every returned pose as ``(R (C+T, 3, 3), t (C+T, 3))``, cameras by
    number, then timesteps; NaN where a node is missing."""
    keys = [str(c) for c in range(config["n_cams"])] + [f"{t}_0" for t in range(config["n_times"])]
    R = np.full((len(keys), 3, 3), np.nan, np.float32)
    t = np.full((len(keys), 3), np.nan, np.float32)
    for i, k in enumerate(keys):
        p = est.get(k)
        if p is not None:
            R[i], t[i] = p.R(), p.t()
    return R, t


def call(s, verbose: bool | None = None) -> int:
    from vican_torch import bipgo

    verbose = s.trace if verbose is None else verbose
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        est = bipgo.bipartite_se3sync(s.edges, verbose=verbose, **s.kw)
    if verbose:
        phases = {}
        for line in buf.getvalue().splitlines():
            m = _PHASE_LINE.match(line.strip())
            if m:
                phases[m.group(1)] = phases.get(m.group(1), 0.0) + float(m.group(2))
        s.solver_phases.append(phases)
    s.kept.append(_poses(s.config, est))
    return 1


def traced(s) -> dict:
    saved = os.environ.get("VICAN_TPU_TRACE")
    os.environ["VICAN_TPU_TRACE"] = "1"  # the solver's phases as profiler ranges
    try:
        summary = tr.capture(lambda: call(s, verbose=False), PHASES, cuda=s.device == "cuda")
    finally:
        if saved is None:
            os.environ.pop("VICAN_TPU_TRACE", None)
        else:
            os.environ["VICAN_TPU_TRACE"] = saved
    notes = [f"trace: window {summary['window_s']:.6f} s, busy {summary['busy_s']:.6f} s, "
             f"read in {summary['read_s']:.3f} s"]
    return {"trace": summary, "notes": notes}


def release(s) -> dict:
    s.edges = s.kw = None
    return {"solver_phases": s.solver_phases}


def _rotation_gap_deg(R: np.ndarray, Rr: np.ndarray) -> np.ndarray:
    """Geodesic angles (degrees) between rotations, from the Frobenius
    distance (exact at small angles): ``|R - Rr|_F = 2 sqrt(2) sin(a / 2)``."""
    d = np.linalg.norm((R.astype(np.float64) - Rr).reshape(len(R), 9), axis=1)
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def compare(kept: list, ref: dict, prob) -> tuple[dict, list]:
    """Readings of every kept solve, and the widest of each: nodes missing
    or not finite; the gaps to the reference's poses (rotations in degrees,
    translations in m; the widest and the median); the timesteps' rotations
    against the closest to ``B^T r_C`` of the solve's own camera rotations
    (``prob``, float64, the last step of the rotation stage); the relative
    residual of the solve's translations in the float64 normal equations
    of its own rotations (the translation stage)."""
    C = prob.C
    Rr = np.concatenate([ref["r_cam"], ref["r_time"]])
    tr_ = np.concatenate([ref["t_cam"], ref["t_time"]])
    worst: dict = {}
    per_solve = []
    for R, t in kept:
        ok = np.isfinite(R).all(axis=(1, 2)) & np.isfinite(t).all(axis=1)
        rot = _rotation_gap_deg(R[ok], Rr[ok])
        tra = np.linalg.norm(t[ok] - tr_[ok], axis=1)
        gaps = dict(missing_nodes=float((~ok).sum()),
                    rotation_gap_deg=float(rot.max(initial=0.0)),
                    rotation_gap_median_deg=float(np.median(rot)) if rot.size else 0.0,
                    translation_gap_m=float(tra.max(initial=0.0)),
                    translation_gap_median_m=float(np.median(tra)) if tra.size else 0.0,
                    time_rotation_gap_deg=float("inf"), translation_residual=float("inf"))
        if ok.all():
            R64, t64 = R.astype(np.float64), t.astype(np.float64)
            r_time = prob.time_rotations(R64[:C]).double().cpu().numpy()
            gaps["time_rotation_gap_deg"] = float(_rotation_gap_deg(R[C:], r_time).max())
            gaps["translation_residual"] = prob.residual(R64[:C], R64[C:], t64)
        per_solve.append(gaps)
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst, per_solve


def _reference(s):
    arrays = dict_arrays(s.arrays)
    prob = ref_solve.Problem(arrays, s.config, s.device)
    return arrays, prob, ref_solve.solve(arrays, s.config, s.device)


def check(s):
    start = time.perf_counter()
    _, prob, ref = _reference(s)
    limits = s.config["limits"]
    worst, per_solve = compare(s.kept, ref, prob)
    s.readings = worst
    checks = [{"name": n, "value": worst[n], "limit": limit} for n, limit in limits.items()]
    failed = sum(1 for g in per_solve if any(g[n] > limit for n, limit in limits.items()))
    s.notes = [f"check: {s.arrays['seen']} observations seen, {s.arrays['unseen']} "
               f"timesteps unseen; the reference in {ref['iterations']} iterations, "
               f"{len(s.kept)} solves compared, {time.perf_counter() - start:.1f} s"]
    return checks, failed


def control(s):
    """The control: the reference in float32 with TF32 products, the
    precision below the configuration's float32 with TF32 off, in the
    program's place, judged as a solve of the program is.  Not run by the benchmark;
    ``perfbench/tests/readings.py`` reads it on the card."""
    arrays, prob, ref = _reference(s)
    low = ref_solve.solve(arrays, s.config, s.device, control=True)
    R = np.concatenate([low["r_cam"], low["r_time"]]).astype(np.float32)
    t = np.concatenate([low["t_cam"], low["t_time"]]).astype(np.float32)
    return compare([(R, t)], ref, prob)[0]
