"""The port's dense route against the JAX package and the stored reference.

All on the CPU.  The golden fixture holds the reference solver's own
output; the parity tests start both packages' solvers from identical
packed arrays (``packed_from_arrays``), so solver parity is tested apart
from packing, and packing is tested field for field on its own.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vican_tpu._native as jnative
from vican_tpu.solver import core as jcore
from vican_tpu.solver.packing import pack_problem as jpack
from vican_tpu.synthetic import make_problem_arrays
from vican_torch import bipgo as tbipgo
from vican_torch.geometry import SE3, distance_SO3
from vican_torch.solver import core as tcore
from vican_torch.solver.packing import pack_problem as tpack, packed_from_arrays

_spec = importlib.util.spec_from_file_location(
    "gen_golden_se3sync",
    os.path.join(os.path.dirname(__file__), "fixtures", "gen_golden_se3sync.py"),
)
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_se3sync.npz")

FIELDS = ("cam_ids", "time_ids", "marker_ids", "edata", "eidx", "R_con", "t_con",
          "root_idx", "k_r_scale", "has_quats", "R_e_raw")


@pytest.mark.parametrize("dtype,tag", [(np.float64, "64"), (np.float32, "32")])
def test_dense_route_matches_stored_reference_golden(dtype, tag):
    data = np.load(FIXTURE)
    edges = _gen.edges_from_arrays(
        data["ci"], data["ti"], data["mi"], data["R"], data["t"], data["err"], SE3)
    constraints = {str(m): SE3(R=data["R_con"][m], t=data["t_con"][m])
                   for m in range(int(data["n_markers"]))}
    C, T = int(data["n_cams"]), int(data["n_times"])
    node_keys = [str(c) for c in range(C)] + [f"{t}_0" for t in range(T)]
    est = tbipgo.bipartite_se3sync(
        edges, constraints=constraints, noise_model_r=_gen.NOISE_R,
        noise_model_t=_gen.NOISE_T, edge_filter=_gen.FILT,
        maxiter=int(data["maxiter"]), lsqr_solver="conjugate_gradient",
        dtype=dtype, verbose=False, device="cpu",
    )
    assert set(est) == set(node_keys)
    R_gold, t_gold = data["R_gold" + tag], data["t_gold" + tag]
    r_errs = np.array([distance_SO3(np.asarray(est[k].R(), np.float64), R_gold[i])
                       for i, k in enumerate(node_keys)])
    t_errs = np.array([np.linalg.norm(np.asarray(est[k].t(), np.float64) - t_gold[i])
                       for i, k in enumerate(node_keys)])
    # the bars of tests/test_golden.py:78-81
    rot_budget = 0.057 if tag == "64" else 0.15
    assert r_errs.max() < rot_budget, (r_errs.max(), r_errs.mean())
    assert r_errs.mean() < rot_budget / 3.0, r_errs.mean()
    assert t_errs.max() < 1e-3, t_errs.max()


@pytest.fixture(scope="module")
def prob():
    return make_problem_arrays(seed=11, n_cams=30, n_times=300, n_markers=6,
                               n_edges=4000, kappa_r=1e5, sigma_t=1e-4)


def _packed_pair(prob, dtype):
    jp = jpack(prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0,
               lambda e: True, dtype=dtype)
    return jp, packed_from_arrays({k: getattr(jp, k) for k in FIELDS})


# Rotation entries, eigenvalues (relative to the largest of the five) and
# translations.  f64: the same iteration in the same precision, LAPACK
# eigh on both sides; measured 5e-15 / 1e-13 / 2e-12 m.  f32: the two eigh
# and scatter orders round differently; measured 1.2e-6 / 6e-5 / 1.7e-5 m.
@pytest.mark.parametrize("dtype,rot_bar,ev_bar,t_bar", [
    (np.float64, 1e-12, 1e-10, 1e-9), (np.float32, 1e-4, 1e-3, 1e-4)])
def test_so3_sync_and_cg_match_jax(prob, dtype, rot_bar, ev_bar, t_bar):
    jp, tp = _packed_pair(prob, dtype)
    C, T, root = jp.num_cams, jp.num_times, jp.root_idx
    cert = 1e-6 / jp.k_r_scale

    jarr = {k: jnp.asarray(getattr(jp, k)) for k in
            ("R_e", "k_r", "k_t", "t_e", "marker_idx", "cam_idx", "time_idx", "R_con", "t_con")}
    jKR = jcore.fold_constraints(jarr["R_e"], jarr["k_r"], jarr["marker_idx"], jarr["R_con"], root)
    jres = jcore.so3_sync(jKR, jarr["k_r"], jarr["cam_idx"], jarr["time_idx"], C=C, T=T,
                          maxiter=jnp.asarray(4, jnp.int32), cert_tol=cert)
    jtt = jcore.translation_rhs(jres.r_cam, jres.r_time, jarr["t_e"], jarr["k_t"],
                                jarr["cam_idx"], jarr["time_idx"], jarr["marker_idx"],
                                jarr["R_con"], jarr["t_con"], root)
    jt, jr = jcore.solve_translations_cg(jtt, jarr["k_t"], jarr["cam_idx"], jarr["time_idx"],
                                         C=C, T=T)

    tarr = {k: torch.from_numpy(np.ascontiguousarray(getattr(tp, k))) for k in
            ("R_e", "k_r", "k_t", "t_e", "R_con", "t_con")}
    for k in ("marker_idx", "cam_idx", "time_idx"):
        tarr[k] = torch.from_numpy(np.ascontiguousarray(getattr(tp, k))).long()
    tKR = tcore.fold_constraints(tarr["R_e"], tarr["k_r"], tarr["marker_idx"], tarr["R_con"], root)
    tres = tcore.so3_sync(tKR, tarr["k_r"], tarr["cam_idx"], tarr["time_idx"], C=C, T=T,
                          maxiter=4, cert_tol=cert)
    ttt = tcore.translation_rhs(tres.r_cam, tres.r_time, tarr["t_e"], tarr["k_t"],
                                tarr["cam_idx"], tarr["time_idx"], tarr["marker_idx"],
                                tarr["R_con"], tarr["t_con"], root)
    tt, tr = tcore.solve_translations_cg(ttt, tarr["k_t"], tarr["cam_idx"], tarr["time_idx"],
                                         C=C, T=T)

    assert tres.num_iters == int(jres.num_iters)
    for a, b in ((tres.r_cam, jres.r_cam), (tres.r_time, jres.r_time)):
        d = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64)).max()
        assert d < rot_bar, d
    ev_t, ev_j = tres.evals.numpy(), np.asarray(jres.evals)
    assert np.abs(ev_t - ev_j).max() <= ev_bar * np.abs(ev_j).max()
    assert np.abs(tt.numpy() - np.asarray(jt)).max() < t_bar
    assert float(tr) < 1e-4 and float(jr) < 1e-4


def test_lsqr_matches_jax(prob):
    """The "direct" translation solver (LSQR) against JAX's on the same
    right-hand side, in float64: measured 1e-13 m."""
    jp, tp = _packed_pair(prob, np.float64)
    arrs = tbipgo._device_arrays(tp, torch.float64, torch.device("cpu"))
    KR = tcore.fold_constraints(arrs["R_e"], arrs["k_r"], arrs["marker_idx"], arrs["R_con"],
                                tp.root_idx)
    res = tcore.so3_sync(KR, arrs["k_r"], arrs["cam_idx"], arrs["time_idx"],
                         C=tp.num_cams, T=tp.num_times, maxiter=4)
    x_t, r_t = tbipgo._solve_translations(res, arrs, tp, "direct",
                                          tp.num_cams, tp.num_times)
    t_tilde = tcore.translation_rhs(
        res.r_cam, res.r_time, arrs["t_e"], arrs["k_t"], arrs["cam_idx"], arrs["time_idx"],
        arrs["marker_idx"], arrs["R_con"], arrs["t_con"], tp.root_idx).numpy()
    x_j, r_j = jcore.solve_translations_lsqr(
        jnp.asarray(t_tilde), jnp.asarray(jp.k_t), jnp.asarray(jp.cam_idx),
        jnp.asarray(jp.time_idx), C=jp.num_cams, T=jp.num_times)
    assert float(r_t) < 1e-4 and float(r_j) < 1e-4
    assert np.abs(x_t.numpy() - np.asarray(x_j)).max() < 1e-9


def test_cg_scatter_matvec_matches_dense_adjacency(prob, monkeypatch):
    """Past the dense-adjacency budget CG multiplies by scatter-adds instead
    of the materialized (C, T) adjacency: same system, same solution."""
    _, tp = _packed_pair(prob, np.float64)
    arrs = tbipgo._device_arrays(tp, torch.float64, torch.device("cpu"))
    KR = tcore.fold_constraints(arrs["R_e"], arrs["k_r"], arrs["marker_idx"], arrs["R_con"],
                                tp.root_idx)
    res = tcore.so3_sync(KR, arrs["k_r"], arrs["cam_idx"], arrs["time_idx"],
                         C=tp.num_cams, T=tp.num_times, maxiter=4)
    args = (res, arrs, tp, "conjugate_gradient", tp.num_cams, tp.num_times)
    x_dense, _ = tbipgo._solve_translations(*args)
    monkeypatch.setattr(tcore, "_DENSE_ADJ_BUDGET_BYTES", 0)
    x_scatter, r = tbipgo._solve_translations(*args)
    assert float(r) < 1e-4
    assert np.abs(x_dense.numpy() - x_scatter.numpy()).max() < 1e-9


def test_pack_problem_matches_jax_field_for_field(prob, monkeypatch):
    """The port's packer is a copy of the JAX pure-Python packer: identical
    output on one dict (the JAX C packer is turned off for the comparison)."""
    filt = lambda e: e["reprojected_err"] < 0.03
    nm_r = lambda e: 1.0 + e["corners"][0, 0] * 1e-3
    nm_t = lambda e: 2.0 - e["corners"][0, 1] * 1e-4
    monkeypatch.setenv("VICAN_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(jnative, "_cache", {})
    for dtype in (np.float32, np.float64):
        jp = jpack(prob.edges, prob.constraints(), nm_r, nm_t, filt, dtype=dtype)
        tp = tpack(prob.edges, prob.constraints(), nm_r, nm_t, filt, dtype=dtype)
        for k in FIELDS:
            a, b = getattr(tp, k), getattr(jp, k)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                assert a == b, k


def test_entry_points_default_to_the_card(prob):
    """No device given and no card present: the entry point raises rather
    than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbipgo.bipartite_se3sync(
            prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0,
            lambda e: True, maxiter=4, verbose=False,
        )


def test_object_bipartite_se3sync_matches_jax():
    """The single-camera object wrapper against JAX's, float64: rotations
    to rounding, translations to the CG stopping noise (measured 3e-8 m)."""
    from vican_tpu.bipgo import object_bipartite_se3sync as jobject

    p = make_problem_arrays(seed=3, n_cams=1, n_times=60, n_markers=5, n_edges=240,
                            kappa_r=1e6, sigma_t=1e-5)
    args = (p.edges, lambda e: 1.0, lambda e: 1.0, lambda e: True)
    out = tbipgo.object_bipartite_se3sync(*args, maxiter=4, dtype=np.float64,
                                          verbose=False, device="cpu")
    ref = jobject(*args, maxiter=4, dtype=np.float64, verbose=False)
    assert set(out) == set(ref) == {str(m) for m in range(5)}
    for m in ref:
        a, b = out[m].pose(), np.asarray(ref[m].pose(), np.float64)
        assert np.abs(a[:3, :3] - b[:3, :3]).max() < 1e-12
        assert np.abs(a[:3, 3] - b[:3, 3]).max() < 1e-6
