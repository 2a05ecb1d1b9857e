"""Synthetic calibration problems at benchmark scale (host NumPy).

The port's own copy of ``vican_tpu.synthetic.make_problem_arrays``: the same
seed gives the same ground truth and the same edge dict in both packages,
so a problem built here can be checked against numbers the JAX package
produced.  Edges follow the reference schema
``{(cam_id, "<t>_<marker>"): {"pose": SE3, "corners", "reprojected_err",
"im_filename"}}`` (vican/cam.py:120-124); noise is Langevin-like rotation
noise plus Gaussian translation noise (vican/geometry.py:13-30).
"""
from __future__ import annotations

import numpy as np

from .geometry import SE3

__all__ = ["SyntheticProblem", "make_problem_arrays"]


class SyntheticProblem:
    """Ground truth + measurements for a synthetic camera-network problem."""

    def __init__(self, cams_gt, obj_gt, markers_gt, edges):
        self.cams_gt = cams_gt  # {cam_id: SE3} camera->world
        self.obj_gt = obj_gt  # {t: SE3} object->world per timestep
        self.markers_gt = markers_gt  # {marker_id: SE3} marker->object
        self.edges = edges  # reference-schema edge dict

    def constraints(self) -> dict:
        """Marker constraints in the form bipartite_se3sync expects."""
        return dict(self.markers_gt)


def _random_rotations(rng: np.random.Generator, n: int, max_angle=np.pi) -> np.ndarray:
    """Uniform-axis random rotations, angles U(0, max_angle)."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v *= rng.uniform(0.0, max_angle, size=(n, 1))
    return _rodrigues_batch(v)


def _rodrigues_batch(v: np.ndarray) -> np.ndarray:
    """Batched Rodrigues formula, (n, 3) axis-angle -> (n, 3, 3)."""
    theta = np.linalg.norm(v, axis=-1)
    theta = np.maximum(theta, 1e-12)
    k = v / theta[:, None]
    K = np.zeros((len(v), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return (
        eye
        + np.sin(theta)[:, None, None] * K
        + (1.0 - np.cos(theta))[:, None, None] * (K @ K)
    )


def make_problem_arrays(
    seed: int = 0,
    n_cams: int = 100,
    n_times: int = 10_000,
    n_markers: int = 24,
    n_edges: int = 120_000,
    kappa_r: float = 1e4,
    sigma_t: float = 1e-3,
    scene_radius: float = 5.0,
    marker_radius: float = 0.3,
) -> SyntheticProblem:
    """Benchmark-scale problem (large_shop: hundreds of cameras, 10k
    timesteps, 1e5-1e6 edges): ``n_edges`` unique (camera, time, marker)
    observations, measurements built with one einsum chain."""
    rng = np.random.default_rng(seed)

    Rc = _random_rotations(rng, n_cams)
    tc = rng.uniform(-scene_radius, scene_radius, size=(n_cams, 3))
    Rm = _random_rotations(rng, n_markers)
    tm = rng.uniform(-marker_radius, marker_radius, size=(n_markers, 3))
    Ro = _random_rotations(rng, n_times)
    to = rng.uniform(-scene_radius, scene_radius, size=(n_times, 3))

    # unique observation triples (oversample, unique, trim)
    key = rng.integers(0, n_cams * n_times * n_markers, size=int(n_edges * 1.3))
    key = np.unique(key)[:n_edges]
    rng.shuffle(key)
    ci = (key // (n_times * n_markers)).astype(np.int64)
    ti = ((key // n_markers) % n_times).astype(np.int64)
    mi = (key % n_markers).astype(np.int64)
    # every camera and timestep appears at least once
    ci[: n_cams] = np.arange(n_cams)
    ti[n_cams : n_cams + n_times] = np.arange(n_times)
    E = len(key)

    # GT edge pose: cam^-1 . obj_t . marker_m
    R_gt = np.einsum("eji,ejk,ekl->eil", Rc[ci], Ro[ti], Rm[mi])
    t_gt = np.einsum("eji,ej->ei", Rc[ci], np.einsum("eij,ej->ei", Ro[ti], tm[mi]) + to[ti] - tc[ci])

    noise_v = rng.normal(0.0, 1.0 / np.sqrt(kappa_r), size=(E, 3))
    R_meas = _rodrigues_batch(noise_v) @ R_gt
    t_meas = t_gt + rng.normal(0.0, sigma_t, size=(E, 3))
    corners = rng.uniform(0, 1280, size=(E, 4, 2)).astype(np.float32)
    errs = rng.uniform(0.0, 0.04, size=E)

    edges = {}
    for e in range(E):
        edges[(str(ci[e]), f"{ti[e]}_{mi[e]}")] = {
            "pose": SE3(R=R_meas[e], t=t_meas[e]),
            "corners": corners[e],
            "reprojected_err": float(errs[e]),
            "im_filename": f"{ti[e]}/{ci[e]}.jpg",
        }

    cams_gt = {str(c): SE3(R=Rc[c], t=tc[c]) for c in range(n_cams)}
    markers_gt = {str(m): SE3(R=Rm[m], t=tm[m]) for m in range(n_markers)}
    obj_gt = {str(t): SE3(R=Ro[t], t=to[t]) for t in range(n_times)}
    return SyntheticProblem(cams_gt, obj_gt, markers_gt, edges)
