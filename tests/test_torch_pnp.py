"""The port's batched PnP (``vican_torch.ops.pnp``) against the JAX
package's ``vmap``-ed one, on seeded float64 corner sets."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vican_tpu.ops import pnp as J
from vican_torch.geometry import rodrigues
from vican_torch.ops import pnp as P

MARKER = 0.138
DIST = np.array([-0.25, 0.08, 1.5e-3, -1.2e-3, -0.012, -0.02, 0.004, -0.001,
                 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])  # tests/test_perception.py:132


def _corner_sets(n=48, seed=5, distorted=False):
    """Markers 0.6-3 m in front of a 640x360 camera, tilted up to 60 deg,
    their corners projected (float64) and jittered by 0.2 px."""
    rng = np.random.default_rng(seed)
    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    dist = DIST if distorted else np.zeros(14)
    R = np.empty((n, 3, 3))
    t = np.empty((n, 3))
    for i in range(n):
        axis = rng.normal(size=3)
        tilt = rodrigues(axis / np.linalg.norm(axis) * rng.uniform(0.0, np.pi / 3))
        R[i] = tilt @ np.diag([1.0, -1.0, -1.0])  # marker +z toward the camera
        z = rng.uniform(0.6, 3.0)
        t[i] = [rng.uniform(-0.25, 0.25) * z, rng.uniform(-0.15, 0.15) * z, z]
    obj = np.asarray(J.marker_object_points(MARKER, jnp.float64))
    Ks = np.repeat(K[None], n, 0)
    dists = np.repeat(dist[None], n, 0)
    px = np.asarray(jax.vmap(J.project_points, (None, 0, 0, 0, 0))(obj, R, t, Ks, dists))
    return px + rng.normal(scale=0.2, size=px.shape), Ks, dists, R, t


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _angle_deg(Ra, Rb):
    c = np.clip((np.einsum("nij,nij->n", Ra, Rb) - 1.0) * 0.5, -1.0, 1.0)
    return np.degrees(np.arccos(c))


@pytest.mark.parametrize("distorted", [False, True])
def test_project_and_undistort(distorted):
    corners, Ks, dists, R, t = _corner_sets(distorted=distorted)
    obj = np.asarray(J.marker_object_points(MARKER, jnp.float64))
    ref = np.asarray(jax.vmap(J.project_points, (None, 0, 0, 0, 0))(obj, R, t, Ks, dists))
    out = P.project_points(_t(obj), _t(R), _t(t), _t(Ks), _t(dists)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    ref = np.asarray(jax.vmap(J.undistort_points)(corners, Ks, dists))
    out = P.undistort_points(_t(corners), _t(Ks), _t(dists)).numpy()
    # normalized coordinates: 1e-5 px at f = 420
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 / 420.0)


@pytest.mark.parametrize("method", ["ippe_square", "iterative"])
@pytest.mark.parametrize("distorted", [False, True])
def test_solve_marker_pose_matches_jax(method, distorted):
    corners, Ks, dists, R_gt, _ = _corner_sets(distorted=distorted)
    R_ref, t_ref, e_ref = jax.vmap(
        lambda c, K, d: J.solve_marker_pose(c, K, d, MARKER, lm_iters=20, method=method)
    )(corners, Ks, dists)
    R, t, e = P.solve_marker_pose(_t(corners), _t(Ks), _t(dists), MARKER, lm_iters=20,
                                  method=method)
    R_ref, t_ref, e_ref = (np.asarray(a, np.float64) for a in (R_ref, t_ref, e_ref))
    # well posed: the poses are near the truth (the jitter is 0.2 px)
    assert np.median(_angle_deg(R.numpy(), R_gt)) < 2.0
    assert _angle_deg(R.numpy(), R_ref).max() < 0.01
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=0, atol=1e-3)


def test_degenerate_quads_do_not_raise():
    """All-zero quads (empty detection slots) give a non-finite pose or
    error, never an exception (JAX returns inf/nan there)."""
    corners, Ks, dists, _, _ = _corner_sets(n=4)
    corners[1:3] = 0.0
    R, t, e = P.solve_marker_pose(_t(corners), _t(Ks), _t(dists), MARKER)
    assert np.isfinite(e[[0, 3]].numpy()).all()
    bad = ~(torch.isfinite(e) & torch.isfinite(R).all(dim=(1, 2)) & torch.isfinite(t).all(dim=1))
    assert bad[1:3].all() or (e[1:3] > 1.0).all()
