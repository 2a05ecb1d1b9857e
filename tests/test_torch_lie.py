"""vican_torch.ops.lie against vican_tpu.ops.lie on the same numpy inputs.

Both sides run on the CPU.  The Jacobi SVD is a faithful op-by-op port, so
the bars are rounding bars: 1e-5 in float32 and 1e-12 in float64, on
random, clustered, rank-deficient and zero blocks.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vican_tpu.ops import lie as jlie
from vican_torch.ops import lie as tlie

BARS = {np.float32: 1e-5, np.float64: 1e-12}


def _blocks(kind: str, rng: np.random.Generator) -> np.ndarray:
    n = 64
    if kind == "random":
        return rng.standard_normal((n, 3, 3))
    if kind == "clustered":
        # scaled near-rotations: the dual blocks the solver feeds, with
        # singular values clustered within 1e-3
        q = rng.standard_normal((n, 4))
        R = jlie.quat_to_mat(jnp.asarray(q))
        s = 1.0 + 1e-3 * rng.standard_normal((n, 3))
        return np.asarray(R) * s[:, None, :]
    if kind == "rank_deficient":
        a = rng.standard_normal((n, 3, 1))
        b = rng.standard_normal((n, 1, 3))
        c = rng.standard_normal((n, 3, 1)) * rng.standard_normal((n, 1, 3))
        out = a @ b  # rank 1
        out[n // 2:] += c[n // 2:]  # rank 2
        return out
    return np.zeros((n, 3, 3))


def _close(a, b, bar):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1.0)
    assert err < bar, err


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["random", "clustered", "rank_deficient", "zero"])
def test_svd3_so3_matches_jax(kind, dtype):
    x = _blocks(kind, np.random.default_rng(3)).astype(dtype)
    jr, ju, js, jvt = (np.asarray(a) for a in jlie.svd3_so3(jnp.asarray(x)))
    tr, tu, ts, tvt = (a.numpy() for a in tlie.svd3_so3(torch.from_numpy(x)))
    bar = BARS[dtype]
    _close(ts, js, bar)
    _close(tu, ju, bar)
    # both factorizations reproduce the same matrix
    _close((tu * ts[:, None, :]) @ tvt, (ju * js[:, None, :]) @ jvt, bar)
    # A rank-1 block (the first half of "rank_deficient") leaves V's two
    # null-space columns free, and so its closest rotation: in float32 the
    # two packages' last-bit rounding picks different, equally valid
    # bases there.  Every other block has unique r and V.
    unique = slice(len(x) // 2 if kind == "rank_deficient" else 0, None)
    _close(tr[unique], jr[unique], bar)
    _close(tvt[unique], jvt[unique], bar)
    _close(
        tlie.project_so3(torch.from_numpy(x)).numpy()[unique],
        np.asarray(jlie.project_so3(jnp.asarray(x)))[unique], bar,
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quat_to_mat_and_angles_match_jax(dtype):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((128, 4)).astype(dtype)
    Rj = np.asarray(jlie.quat_to_mat(jnp.asarray(q)))
    Rt = tlie.quat_to_mat(torch.from_numpy(q)).numpy()
    _close(Rt, Rj, BARS[dtype])
    # angles compared away from 0 and pi, where arccos amplifies rounding
    d_j = np.asarray(jlie.distance_so3(jnp.asarray(Rj[:64]), jnp.asarray(Rj[64:])))
    d_t = tlie.distance_so3(torch.from_numpy(Rt[:64]), torch.from_numpy(Rt[64:])).numpy()
    keep = (d_j > 1.0) & (d_j < 179.0)
    _close(d_t[keep], d_j[keep], 1e-3 if dtype == np.float32 else 1e-9)
    g_j = np.asarray(jlie.gauge_procrustes_so3(jnp.asarray(Rj[:64]), jnp.asarray(Rj[64:])))
    g_t = tlie.gauge_procrustes_so3(torch.from_numpy(Rt[:64]), torch.from_numpy(Rt[64:])).numpy()
    _close(g_t, g_j, BARS[dtype])


def _rigid(rng, n, dtype):
    R = np.asarray(jlie.quat_to_mat(jnp.asarray(rng.standard_normal((n, 4))))).astype(dtype)
    return R, rng.standard_normal((n, 3)).astype(dtype)


SE3_BARS = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_se3_algebra_matches_jax(dtype):
    rng = np.random.default_rng(8)
    (Ra, ta), (Rb, tb) = _rigid(rng, 64, dtype), _rigid(rng, 64, dtype)
    x = rng.standard_normal((64, 3)).astype(dtype)
    J, T = (lambda *a: [jnp.asarray(v) for v in a]), (lambda *a: [torch.from_numpy(v) for v in a])
    bar = SE3_BARS[dtype]
    for jo, to in zip(jlie.se3_compose(*J(Ra, ta, Rb, tb)), tlie.se3_compose(*T(Ra, ta, Rb, tb))):
        _close(to.numpy(), jo, bar)
    for jo, to in zip(jlie.se3_inverse(*J(Ra, ta)), tlie.se3_inverse(*T(Ra, ta))):
        _close(to.numpy(), jo, bar)
    _close(tlie.se3_apply(*T(Ra, ta, x)).numpy(), jlie.se3_apply(*J(Ra, ta, x)), bar)
    # a stack related by one gauge: (Ra, ta) = (Rb, tb) @ g plus noise
    g_R, g_t = Rb[0], tb[0]
    Rn, tn = _rigid(np.random.default_rng(9), 64, np.float64)
    Ra2 = (Rb @ g_R).astype(dtype)
    ta2 = (np.einsum("nij,j->ni", Rb, g_t) + tb + 1e-2 * tn).astype(dtype)
    for jo, to in zip(jlie.gauge_procrustes_se3(*J(Ra2, ta2, Rb, tb)),
                      tlie.gauge_procrustes_se3(*T(Ra2, ta2, Rb, tb))):
        _close(to.numpy(), jo, bar)


def _angles(R) -> np.ndarray:
    """Rotation angles from the antisymmetric part and the trace in
    float64: exact down to the small angles of large kappa."""
    R = np.asarray(R, np.float64)
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    return np.arctan2(np.linalg.norm(w, axis=-1) / 2, (np.trace(R, axis1=-2, axis2=-1) - 1) / 2)


@pytest.mark.parametrize("k", [10.0, 1e3, 1e5])
def test_random_langevin_angles_match_jax_in_distribution(k):
    """The two packages' PRNG streams differ, so the samplers are held by
    the distribution of the rotation angle: a two-sample KS statistic
    < 0.03 at n = 20 000 (JAX draws in float64 under the suite's x64)."""
    from scipy.stats import ks_2samp

    import jax

    n = 20_000
    ref = jlie.random_langevin(jax.random.PRNGKey(0), k, (n,))
    out = tlie.random_langevin(torch.Generator().manual_seed(0), k, (n,), device="cpu")
    assert out.shape == (n, 3, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.double() @ out.double().transpose(1, 2),
                               np.broadcast_to(np.eye(3), (n, 3, 3)), atol=1e-6)
    stat = ks_2samp(_angles(ref), _angles(out)).statistic
    assert stat < 0.03, stat


def test_random_langevin_same_seed_same_samples():
    a = tlie.random_langevin(torch.Generator().manual_seed(4), 500.0, (7, 3), device="cpu")
    b = tlie.random_langevin(torch.Generator().manual_seed(4), 500.0, (7, 3), device="cpu")
    assert a.shape == (7, 3, 3, 3)
    assert torch.equal(a, b)
    c = tlie.random_langevin(torch.Generator().manual_seed(5), 500.0, (7, 3), device="cpu")
    assert not torch.equal(a, c)
