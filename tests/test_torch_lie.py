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
