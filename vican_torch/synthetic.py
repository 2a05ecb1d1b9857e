"""Synthetic calibration problems and synthetic captures (host NumPy).

The port's own copy of ``vican_tpu.synthetic``: :func:`make_problem` and
:func:`make_problem_arrays` draw from the seed as the JAX package does, so
the same seed gives the same ground truth and the same edge dict in both
packages and a problem built here can be checked against numbers the JAX
package produced; :func:`calibration_sweep` and :func:`render_cube_scene`
are the tutorial's synthetic captures.  Edges follow the reference schema
``{(cam_id, "<t>_<marker>"): {"pose": SE3, "corners", "reprojected_err",
"im_filename"}}`` (vican/cam.py:120-124); noise is Langevin-like rotation
noise plus Gaussian translation noise (vican/geometry.py:13-30).
"""
from __future__ import annotations

import numpy as np

from .geometry import SE3, rodrigues

__all__ = ["SyntheticProblem", "make_problem", "make_problem_arrays",
           "render_cube_scene", "calibration_sweep"]


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


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    v = rng.normal(size=3)
    v = v / np.linalg.norm(v) * rng.uniform(0.0, np.pi)
    return rodrigues(v)


def _langevin_noise(rng: np.random.Generator, kappa: float) -> np.ndarray:
    """Small random rotation with Langevin-like concentration ``kappa``:
    a normal magnitude of deviation 1/sqrt(kappa), the large-kappa limit of
    the von Mises magnitude."""
    v = rng.normal(size=3)
    mag = rng.normal(0.0, 1.0 / np.sqrt(max(kappa, 1e-9)))
    return rodrigues(v / np.linalg.norm(v) * mag)


def make_problem(
    seed: int = 0,
    n_cams: int = 10,
    n_times: int = 100,
    n_markers: int = 8,
    p_obs: float = 0.35,
    kappa_r: float = 1e4,
    sigma_t: float = 1e-3,
    scene_radius: float = 5.0,
    marker_radius: float = 0.3,
) -> SyntheticProblem:
    """A random camera network observing a moving marker object.

    Every (camera, time, marker) triple is observed independently with
    probability ``p_obs``; each camera and timestep is guaranteed at least one
    observation so the graph is connected with high probability.
    """
    rng = np.random.default_rng(seed)

    def pose(radius):
        return SE3(R=_random_rotation(rng), t=rng.uniform(-radius, radius, size=3))

    cams_gt = {str(c): pose(scene_radius) for c in range(n_cams)}
    markers_gt = {str(m): pose(marker_radius) for m in range(n_markers)}
    obj_gt = {str(t): pose(scene_radius) for t in range(n_times)}

    obs = rng.random((n_cams, n_times, n_markers)) < p_obs
    # connectivity: every camera and every timestep sees something
    for ci in range(n_cams):
        if not obs[ci].any():
            obs[ci, rng.integers(n_times), rng.integers(n_markers)] = True
    for ti in range(n_times):
        if not obs[:, ti].any():
            obs[rng.integers(n_cams), ti, rng.integers(n_markers)] = True

    edges = {}
    for ci, c in enumerate(cams_gt):
        cam_inv = cams_gt[c].inv()
        for ti, t in enumerate(obj_gt):
            marker_world_base = cam_inv @ obj_gt[t]
            for m in range(n_markers):
                if not obs[ci, ti, m]:
                    continue
                gt_pose = marker_world_base @ markers_gt[str(m)]
                R = _langevin_noise(rng, kappa_r) @ gt_pose.R()
                tvec = gt_pose.t() + rng.normal(0.0, sigma_t, size=3)
                corners = rng.uniform(0, 1280, size=(4, 2))
                edges[(c, f"{t}_{m}")] = {
                    "pose": SE3(R=R, t=tvec),
                    "corners": corners,
                    "reprojected_err": float(rng.uniform(0.0, 0.04)),
                    "im_filename": f"{t}/{c}.jpg",
                }

    return SyntheticProblem(cams_gt, obj_gt, markers_gt, edges)


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


def _rot_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector ``a`` onto unit vector ``b``."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # antiparallel: rotate pi about any axis perpendicular to a
        p = np.array([1.0, 0.0, 0.0]) if abs(a[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        axis = np.cross(a, p)
        return rodrigues(axis / np.linalg.norm(axis) * np.pi)
    axis = v / np.linalg.norm(v)
    return rodrigues(axis * np.arccos(np.clip(c, -1.0, 1.0)))


def calibration_sweep(n_frames: int, cam_pos, target=(0.0, 0.0, 1.0)) -> dict:
    """Deterministic cube-calibration trajectory: ``{t: SE3}``.

    Interleaves two view families so that the marker graph is both well
    covered and connected: 6 face views (each face turned square toward the
    camera, spun through varying in-plane angles: frontal detections that
    pass the tutorial's reprojection filter) and 12 edge-bridge views (an
    edge midpoint normal toward the camera, both adjacent faces at ~45
    degrees, which links the faces' markers into one component).  The
    reference's cube_calib capture reaches the same coverage with 2000
    random tumbles (reference render.py:393-432).
    """
    d = np.asarray(cam_pos, float) - np.asarray(target, float)
    d = d / np.linalg.norm(d)
    normals = [np.array(n, float) for n in
               [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]]
    # base rotations taking a cube direction onto the view axis
    views = [_rot_between(n, d) for n in normals]
    for i, ni in enumerate(normals):
        for nj in normals[i + 1:]:
            if abs(float(np.dot(ni, nj))) > 0.5:  # opposite faces share no edge
                continue
            e = ni + nj
            views.append(_rot_between(e / np.linalg.norm(e), d))
    out = {}
    for t in range(n_frames):
        # the in-plane spin varies across repeats of a view, so that face
        # views cover all four marker orientations
        phi = 2.0 * np.pi * (t * 0.37 + 0.15)
        out[str(t)] = SE3(R=rodrigues(d * phi) @ views[t % len(views)],
                          t=np.asarray(target, float))
    return out


def _cube_scene(cam_positions, n_frames: int, seed: int, *, res=(1280, 720),
                wander: bool = False, target=(0.0, 0.0, 1.0), traj: dict | None = None):
    """The cameras and the trajectory of :func:`render_cube_scene`, without
    rendering: ``({cam_id: Camera}, {t: SE3 object->world})``."""
    from .cam import Camera
    from .render import cube_trajectory, look_at

    W, H = res
    f = 0.55 * (W + H)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    cams = {
        str(i): Camera(id=str(i), intrinsics=K, distortion=np.zeros(12),
                       extrinsics=look_at(p, target), resolution_x=W, resolution_y=H)
        for i, p in enumerate(cam_positions)
    }
    if traj is None:
        traj = cube_trajectory(n_frames, seed, target=target, wander=wander)
    return cams, traj


def render_cube_scene(
    root,
    cam_positions,
    n_frames: int,
    seed: int,
    *,
    res=(1280, 720),
    marker_size: float = 0.48 * 0.575,
    wander: bool = False,
    aruco: str = "DICT_4X4_1000",
    target=(0.0, 0.0, 1.0),
    traj: dict | None = None,
    device=None,
):
    """Render a synthetic marker-cube capture to ``root``.

    The scene recipe of the tutorial and the perception benchmark: cameras
    at ``cam_positions`` looking at ``target`` with f = 0.55 (W + H), the
    24-marker cube tumbling at the target (``wander=True`` adds the
    tutorial's positional jitter), or moving along ``traj``.  Frames are
    rendered on ``device`` (``None``: the CUDA card) and written by
    :func:`vican_torch.render.render_dataset`.  Skips rendering when
    ``root`` already exists.  Returns ``(cams, traj)``.
    """
    import os

    from .render import make_cube_markers, render_dataset

    cams, traj = _cube_scene(cam_positions, n_frames, seed, res=res, wander=wander,
                             target=target, traj=traj)
    if not os.path.isdir(root):
        render_dataset(root, cams, traj, make_cube_markers(aruco), aruco=aruco,
                       marker_size=marker_size, device=device)
    return cams, traj
