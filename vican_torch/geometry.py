"""Host-side SO(3)/SE(3) geometry: the pose types that cross the API.

Plain NumPy (and scipy for :func:`langevin`), API-compatible with the
reference (vican/geometry.py) and with ``vican_tpu.geometry``, of which
this module is the port's own copy: edge dicts built with either package
feed the other, since both packers read a pose through ``.R()``/``.t()``.
Batched device math lives in :mod:`vican_torch.ops.lie`.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

__all__ = [
    "langevin",
    "rotx",
    "roty",
    "rotz",
    "rodrigues",
    "rad2deg",
    "deg2rad",
    "angle",
    "distance_SO3",
    "project_SO3",
    "SE3",
    "optimize_gauge_SO3",
    "optimize_gauge_SE3",
]


def rodrigues(vec: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> 3x3 rotation matrix, in closed form (the
    reference calls ``cv.Rodrigues``, geometry.py:29)."""
    vec = np.asarray(vec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(vec)
    if theta < 1e-12:
        return np.eye(3)
    k = vec / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def langevin(k: float, rng: np.random.Generator | None = None) -> np.ndarray:
    """Sample from the isotropic Langevin distribution on SO(3)
    (geometry.py:13-30): a random axis (isotropic Gaussian, normalized)
    scaled by a von Mises magnitude with concentration ``k``, through
    Rodrigues.  ``rng``: the source of randomness (the global NumPy RNG by
    default, as in the reference); a generator draws the same samples as
    ``vican_tpu.geometry.langevin`` with the same generator."""
    from scipy.stats import vonmises

    if rng is None:
        vec = np.random.normal(0.0, 1.0, size=(3,))
        mag = vonmises.rvs(k)
    else:
        vec = rng.normal(0.0, 1.0, size=(3,))
        mag = vonmises.rvs(k, random_state=rng)
    return rodrigues(mag * vec / np.linalg.norm(vec))


def rotx(theta: float) -> np.ndarray:
    """SO(3) rotation around the x-axis (radians)."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def roty(theta: float) -> np.ndarray:
    """SO(3) rotation around the y-axis (radians)."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def rotz(theta: float) -> np.ndarray:
    """SO(3) rotation around the z-axis (radians)."""
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


def rad2deg(rad: float) -> float:
    """Radians to degrees."""
    return rad * 180.0 / np.pi


def deg2rad(deg: float) -> float:
    """Degrees to radians."""
    return deg * np.pi / 180.0


def angle(r: np.ndarray) -> float:
    """Rotation angle in degrees of a 3x3 SO(3) matrix (geometry.py:135-151)."""
    rad = np.arccos(np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0))
    return rad2deg(rad)


def distance_SO3(r1: np.ndarray, r2: np.ndarray) -> float:
    """Geodesic angle in degrees between two rotations (geometry.py:154-172)."""
    assert r1.shape == (3, 3) and r2.shape == (3, 3)
    return angle(r1.T @ r2)


def project_SO3(x: np.ndarray) -> np.ndarray:
    """Orthogonal projection of a 3x3 matrix onto SO(3) (geometry.py:175-191):
    SVD projection with the determinant fixed to +1."""
    u, _, vh = np.linalg.svd(x)
    return u @ np.diag([1.0, 1.0, np.linalg.det(u @ vh)]) @ vh


class SE3:
    """3D rigid transformation (host type).

    Construct from either ``pose=`` (4x4 matrix; cast to float32 like the
    reference, geometry.py:208-211) or ``R=`` and ``t=`` (kept at their input
    dtype, geometry.py:212-218).
    """

    __slots__ = ("_pose", "_R", "_t")

    def __init__(self, **kwargs):
        if "pose" in kwargs:
            self._pose = np.asarray(kwargs["pose"]).astype(np.float32)
            self._R = self._pose[:3, :3]
            self._t = self._pose[:3, -1]
        else:
            self._R = np.asarray(kwargs["R"])
            self._t = np.asarray(kwargs["t"]).flatten()
            pose = np.zeros((4, 4), dtype=np.result_type(self._R.dtype, np.float32))
            pose[:3, :3] = self._R
            pose[:3, -1] = self._t
            pose[-1, -1] = 1.0
            self._pose = pose

    @classmethod
    def _from_pose_view(cls, pose: np.ndarray) -> "SE3":
        """Zero-copy construction from an existing 4x4 array (solver output
        path: no dtype cast, no per-instance allocation)."""
        obj = object.__new__(cls)
        object.__setattr__(obj, "_pose", pose)
        object.__setattr__(obj, "_R", pose[:3, :3])
        object.__setattr__(obj, "_t", pose[:3, 3])
        return obj

    def R(self) -> np.ndarray:
        """3x3 rotation block."""
        return self._R

    def t(self) -> np.ndarray:
        """Translation vector."""
        return self._t

    def pose(self) -> np.ndarray:
        """Full 4x4 matrix."""
        return self._pose

    def inv(self) -> "SE3":
        """Inverse transformation."""
        inverted = np.zeros_like(self._pose)
        inverted[-1, -1] = 1.0
        inverted[:3, :3] = self._R.T
        inverted[:3, -1] = -self._R.T @ self._t
        return SE3(pose=inverted)

    def apply(self, x: np.ndarray) -> np.ndarray:
        """Apply the transformation to 3 x n points."""
        assert x.ndim == 2 and x.shape[0] == 3
        return self._R @ x + self._t.reshape([-1, 1])

    def __repr__(self) -> str:
        return str(np.round(self._pose, 4))

    def __matmul__(self, x: "SE3") -> "SE3":
        return SE3(pose=self._pose @ x._pose)

    def __getstate__(self):
        return {"_pose": self._pose, "_R": self._R, "_t": self._t}

    def __setstate__(self, state):
        object.__setattr__(self, "_pose", state["_pose"])
        object.__setattr__(self, "_R", state["_R"])
        object.__setattr__(self, "_t", state["_t"])


def optimize_gauge_SO3(
    poses_a: Iterable[np.ndarray], poses_b: Iterable[np.ndarray]
) -> np.ndarray:
    """Procrustes gauge: rotation aligning ``poses_a ~ poses_b @ gauge_r``
    (geometry.py:264-291): SVD of ``(sum_i a_i^T b_i)^T`` with determinant
    fix."""
    poses_a, poses_b = list(poses_a), list(poses_b)
    assert len(poses_a) == len(poses_b)
    acc = np.zeros((3, 3), dtype=np.float64)
    for a, b in zip(poses_a, poses_b):
        acc += a.T @ b
    u, _, vh = np.linalg.svd(acc.T)
    return u @ np.diag([1.0, 1.0, np.linalg.det(u @ vh)]) @ vh


def optimize_gauge_SE3(poses_a: Iterable[SE3], poses_b: Iterable[SE3]) -> SE3:
    """SE(3) gauge aligning ``poses_a ~ poses_b @ gauge`` (geometry.py:294-325):
    rotation via Procrustes, translation the mean offset in the b-frame."""
    poses_a, poses_b = list(poses_a), list(poses_b)
    assert len(poses_a) == len(poses_b)
    acc = np.zeros((3, 3), dtype=np.float64)
    gauge_t = np.zeros((3, 1), dtype=np.float64)
    for a, b in zip(poses_a, poses_b):
        acc += a.R().T @ b.R()
        gauge_t += b.R().T @ (a.t() - b.t()).reshape((-1, 1))
    u, _, vh = np.linalg.svd(acc.T)
    gauge_r = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vh)]) @ vh
    return SE3(R=gauge_r, t=gauge_t / len(poses_a))
