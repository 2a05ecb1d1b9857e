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


def _detections(B=4, D=6, seed=9, distorted=False):
    """A ``(B, D)`` detection batch as the drain hands it to PnP: the
    corner sets above, one camera per frame, about a third of the slots
    not valid, and all-zero quads in some slots, valid or not."""
    rng = np.random.default_rng(seed)
    corners, Ks, dists, _, _ = _corner_sets(n=B * D, seed=seed, distorted=distorted)
    valid = rng.random(B * D) > 1 / 3
    zero = np.zeros(B * D, bool)
    zero[[1, 5, 8]] = True  # slot 1 stays valid
    valid[[1, 2, 3]] = [True, False, True]
    valid[[5, 8]] = False
    corners[zero] = 0.0
    ids = rng.integers(0, 1000, B * D)
    return corners, ids, valid, Ks[::D].copy(), dists[::D].copy()


@pytest.mark.parametrize("method", ["ippe_square", "iterative"])
@pytest.mark.parametrize("distorted", [False, True])
def test_pnp_block_matches_jax_pnp_block(method, distorted):
    """``pnp_block`` on CPU tensors (its plain version) against the JAX
    package's ``_pnp_block`` (vican_tpu/perception.py:883) on the same
    detections: corners, ids and ``ok`` identical; the poses and errors of
    the slots that are ok within the PnP bars above."""
    from types import SimpleNamespace

    from vican_tpu.perception import _pnp_block

    B, D = 4, 6
    corners, ids, valid, Ks, dists = _detections(B, D, distorted=distorted)
    run = _pnp_block(B, SimpleNamespace(max_detections=D), 20, MARKER, method)
    ref = np.asarray(run(corners.reshape(B, D, 4, 2), ids.reshape(B, D), valid.reshape(B, D),
                         Ks, dists), np.float64).T
    out = P.pnp_block(_t(corners), torch.tensor(ids), torch.tensor(valid), _t(Ks), _t(dists),
                      MARKER, 20, method).numpy()
    assert out.shape == (B * D, 23)
    np.testing.assert_array_equal(out[:, :9], ref[:, :9])
    np.testing.assert_array_equal(out[:, 9], ref[:, 9])
    ok = ref[:, 9] > 0.5
    assert 0 < ok.sum() < valid.sum()  # the valid all-zero slot is not ok
    assert not ok[1] and (out[~valid, 9:] == 0).all()
    assert _angle_deg(out[ok, 10:19].reshape(-1, 3, 3), ref[ok, 10:19].reshape(-1, 3, 3)).max() < 0.01
    np.testing.assert_allclose(out[ok, 19:22], ref[ok, 19:22], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[ok, 22], ref[ok, 22], rtol=0, atol=1e-3)


def test_perception_pnp_block_keeps_the_packed_layout():
    """``perception._pnp_block`` through the wrapper: the ``(B*D, 23)``
    buffer that ``_unpack_pnp_result`` reads, each valid slot's pose that
    of ``solve_marker_pose`` on it alone."""
    from vican_torch import perception
    from vican_torch.ops.detect import Detections

    B, D = 3, 5
    corners, ids, valid, Ks, dists = _detections(B, D, seed=4)
    det = Detections(_t(corners.reshape(B, D, 4, 2)), torch.tensor(ids.reshape(B, D)),
                     torch.tensor(valid.reshape(B, D)), torch.zeros(B, D))
    out = perception._pnp_block(det, _t(Ks), _t(dists), MARKER, 20, "ippe_square")
    assert out.dtype == torch.float64 and out.shape == (B * D, 23)
    c, i, ok, R, t, err = perception._unpack_pnp_result(out.numpy())
    np.testing.assert_array_equal(c, corners)
    np.testing.assert_array_equal(i, ids)
    assert not ok[~valid].any() and (out.numpy()[~valid, 9:] == 0).all()
    for s in np.nonzero(valid)[0]:
        b = s // D
        R1, t1, e1 = P.solve_marker_pose(_t(corners[s:s + 1]), _t(Ks[b:b + 1]),
                                         _t(dists[b:b + 1]), MARKER)
        finite = bool(torch.isfinite(e1).all() and torch.isfinite(R1).all()
                      and torch.isfinite(t1).all())
        assert ok[s] == finite
        if finite:
            np.testing.assert_allclose(R[s], R1[0].numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(t[s], t1[0].numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(err[s], e1[0].numpy(), rtol=0, atol=1e-6)
    assert ok.sum() >= 5


def test_pnp_kernel_takes_marker_size_as_a_double():
    """The kernel's argtypes name a C double for ``marker_size``, in the
    place where ``pnp_block`` passes it, and ctypes hands 0.138 through
    them exactly; through a C float it would move by ~1e-9 relative, past
    the kernel's float64 bars."""
    import ctypes

    from vican_torch import _kernels

    argtypes = _kernels.SOURCES["pnp"]["pnp_block_f64"]
    assert argtypes == [*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 4, ctypes.c_double,
                        ctypes.c_void_p]
    seen = []
    as_c = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(lambda *a: seen.append(a) or 0)
    as_c(*[None] * 6, 768, 24, 20, P.PNP_METHODS["iterative"], MARKER, None)
    assert seen[0][6:11] == (768, 24, 20, 1, MARKER)
    as_float = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_float)(lambda a: seen.append(a) or 0)
    as_float(MARKER)
    assert abs(seen[1] - MARKER) / MARKER > 1e-9


def test_pnp_block_refuses_an_unknown_method():
    corners, ids, valid, Ks, dists = _detections(2, 5)
    with pytest.raises(ValueError, match="unknown PnP method"):
        P.pnp_block(_t(corners), torch.tensor(ids), torch.tensor(valid), _t(Ks), _t(dists),
                    MARKER, 20, "epnp")
