"""The port's large-graph route against the JAX package and against the
port's own dense route, on the CPU (the filter kernel's plain version)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vican_tpu.ops.lie import distance_so3 as jdist
from vican_tpu.solver import core as jcore
from vican_tpu.solver.packing import pack_problem as jpack
from vican_tpu.solver.scale import so3_sync_large as jlarge
from vican_tpu.solver.scale import sort_edges_by_time as jsort
from vican_tpu.synthetic import make_problem_arrays
from vican_torch import bipgo as tbipgo
from vican_torch.geometry import distance_SO3
from vican_torch.solver.mv import thin_mv
from vican_torch.solver.pwr import pwr_apply
from vican_torch.solver.scale import so3_sync_large as tlarge
from vican_torch.solver.scale import sort_edges_by_time as tsort
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)


def _chunked(dtype, chunk_t):
    """The fixture of tests/test_pallas_pwr.py:96-114, chunked by the JAX
    package; both solvers take the same arrays."""
    prob = make_problem_arrays(seed=7, n_cams=24, n_times=96, n_markers=6, n_edges=2500,
                               kappa_r=1e5, sigma_t=1e-4)
    p = jpack(prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0,
              lambda e: True, dtype=dtype)
    KR = jcore.fold_constraints(jnp.asarray(p.R_e), jnp.asarray(p.k_r),
                                jnp.asarray(p.marker_idx), jnp.asarray(p.R_con), p.root_idx)
    chunked = jsort(np.asarray(KR), p.k_r, p.cam_idx, p.time_idx, p.num_times, chunk_t)
    return p, chunked


# Degrees and rotation entries.  f32: bf16 filter on both sides, float32
# sums in other orders, amplified through QR on this noisy fixture (the bar
# of tests/test_pallas_pwr.py:133; 0.15 deg is 2.6e-3 in entries, measured
# 1e-4).  f64: full-precision filter on both sides, LAPACK QR/eigh;
# measured 2e-15 in entries (the angle bar sits above arccos's 1e-6 deg
# floor).
@pytest.mark.parametrize("dtype,bar,entry_bar", [(np.float32, 0.15, 2.6e-3),
                                                 (np.float64, 1e-5, 1e-10)])
def test_so3_sync_large_matches_jax(dtype, bar, entry_bar):
    p, chunked = _chunked(dtype, 32)
    C, T = p.num_cams, p.num_times
    ref = jlarge(*[jnp.asarray(x) for x in chunked], C=C, T=T, chunk_t=32,
                 maxiter=jnp.asarray(4, jnp.int32))
    before = pwr_apply.launches
    out = tlarge(*chunked, C=C, T=T, chunk_t=32, maxiter=4, device="cpu")
    assert pwr_apply.launches == before  # CPU tensors: the plain version
    assert out.num_iters == int(ref.num_iters)
    for a, b in ((out.r_cam, ref.r_cam), (out.r_time, ref.r_time)):
        d = np.asarray(jdist(jnp.asarray(a.numpy(), jnp.float64), jnp.asarray(b, jnp.float64)))
        assert d.max() < bar, d.max()
        e = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64)).max()
        assert e < entry_bar, e


# The streaming regime (past the operator budget; ``materialize_budget=1``
# forces it) on both sides, with the bars above.  f32: the bf16 copy of the
# dense scaled Laplacian on both sides, float32 sums in other orders;
# measured 0.049 deg / 1.2e-3 in entries.  f64: full precision; measured
# 2.4e-6 deg (arccos's floor) / 1.4e-15 in entries.
@pytest.mark.parametrize("dtype,bar,entry_bar", [(np.float32, 0.15, 2.6e-3),
                                                 (np.float64, 1e-5, 1e-10)])
def test_streaming_regime_matches_jax(dtype, bar, entry_bar):
    p, chunked = _chunked(dtype, 32)
    C, T = p.num_cams, p.num_times
    ref = jlarge(*[jnp.asarray(x) for x in chunked], C=C, T=T, chunk_t=32,
                 maxiter=jnp.asarray(4, jnp.int32), materialize_budget=1)
    before, pwr_before = thin_mv.launches, pwr_apply.launches
    out = tlarge(*chunked, C=C, T=T, chunk_t=32, maxiter=4, materialize_budget=1,
                 device="cpu")
    # CPU tensors: the plain versions, and the materialized kernel unused
    assert (thin_mv.launches, pwr_apply.launches) == (before, pwr_before)
    assert out.num_iters == int(ref.num_iters)
    for a, b in ((out.r_cam, ref.r_cam), (out.r_time, ref.r_time)):
        d = np.asarray(jdist(jnp.asarray(a.numpy(), jnp.float64), jnp.asarray(b, jnp.float64)))
        assert d.max() < bar, d.max()
        e = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64)).max()
        assert e < entry_bar, e


def test_streaming_regime_matches_materialized():
    """The port's two regimes on one problem, float32: the same iteration
    through different products (the bar of tests/test_scale.py:99-123;
    measured 0.029 deg)."""
    p, chunked = _chunked(np.float32, 32)
    kw = dict(C=p.num_cams, T=p.num_times, chunk_t=32, maxiter=4, device="cpu")
    stream = tlarge(*chunked, materialize_budget=1, **kw)
    mat = tlarge(*chunked, **kw)
    d = np.asarray(jdist(jnp.asarray(stream.r_cam.numpy(), jnp.float64),
                         jnp.asarray(mat.r_cam.numpy(), jnp.float64)))
    assert d.max() < 0.25, d.max()
    assert torch.isfinite(stream.evals).all()


def test_matches_tpu_chunking():
    """The port's chunk packer is the JAX one: identical arrays."""
    rng = np.random.default_rng(0)
    E, T = 500, 70
    KR = rng.standard_normal((E, 3, 3)).astype(np.float32)
    k = rng.random(E).astype(np.float32)
    cam = rng.integers(0, 9, E).astype(np.int32)
    tim = rng.integers(0, T, E).astype(np.int32)
    for a, b in zip(tsort(KR, k, cam, tim, T, 16), jsort(KR, k, cam, tim, T, 16)):
        np.testing.assert_array_equal(a, b)


def test_dict_api_large_route_matches_dense_route(monkeypatch, capsys):
    """bipartite_se3sync forced onto the large-graph route against the
    port's dense route (the bars of tests/test_scale.py:205-206)."""
    prob = make_problem_arrays(seed=13, n_cams=40, n_times=256, n_markers=8, n_edges=6000,
                               kappa_r=1e5, sigma_t=1e-4)
    kwargs = dict(
        constraints=prob.constraints(),
        noise_model_r=lambda e: 1.0, noise_model_t=lambda e: 1.0,
        edge_filter=lambda e: True, maxiter=4, dtype=np.float32, device="cpu",
    )
    dense = tbipgo.bipartite_se3sync(prob.edges, verbose=False, **kwargs)
    monkeypatch.setenv("VICAN_TPU_BLOCK_BUDGET_BYTES", "1")
    monkeypatch.setenv("VICAN_TPU_SCALE_CHUNK_T", "64")
    routed = tbipgo.bipartite_se3sync(prob.edges, verbose=True, **kwargs)
    assert "Large-graph path" in capsys.readouterr().out
    assert set(routed) == set(dense)
    d_rot = max(distance_SO3(np.asarray(dense[n].R(), np.float64),
                             np.asarray(routed[n].R(), np.float64)) for n in dense)
    d_tr = max(np.linalg.norm(dense[n].t() - routed[n].t()) for n in dense)
    assert d_rot < 0.2, d_rot  # degrees
    assert d_tr < 0.05, d_tr
