"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one).  The file imports neither JAX nor the JAX package, so it runs
on a machine with the card and PyTorch alone:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX for the rest of the
suite).  Whether a card is present is decided inside the fixture, so every
pytest worker collects the same tests.
"""
import numpy as np
import pytest
import torch

from vican_torch import bipgo
from vican_torch.geometry import distance_SO3
from vican_torch.solver.pwr import filter_operator, pwr_apply, pwr_apply_plain
from vican_torch.synthetic import make_problem_arrays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,T,w", [
    (48, 70, 5), (64, 64, 1), (48, 33, 10), (128, 32, 7), (21, 10, 16),
    (3000, 1000, 10), (3000, 1000, 1),
])
def test_cuda_kernel_matches_plain(cuda, n, T, w):
    rng = np.random.default_rng(3)
    B = torch.from_numpy(rng.standard_normal((n, 3 * T)).astype(np.float32)).to(cuda)
    lbd = torch.from_numpy(rng.standard_normal((T, 3, 3)).astype(np.float32)).to(cuda)
    X = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32)).to(cuda)
    Bt = filter_operator(B)
    before = pwr_apply.launches
    out = pwr_apply(Bt, lbd, X)
    torch.cuda.synchronize()
    assert pwr_apply.launches == before + 1
    ref = pwr_apply_plain(Bt, lbd, X)
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    # a float32 sum order other than cuBLAS's may flip the bf16 rounding of
    # single W entries (chip_smoke.py:kernel_phase); a fault shows at O(1)
    assert err < 1e-3, err


@pytest.mark.gpu
def test_large_route_on_the_card_matches_cpu(cuda, monkeypatch):
    """bipartite_se3sync on the large-graph route: the card (kernel) and
    the CPU (plain version) agree, and the kernel was launched."""
    prob = make_problem_arrays(seed=13, n_cams=40, n_times=256, n_markers=8,
                               n_edges=6000, kappa_r=1e5, sigma_t=1e-4)
    monkeypatch.setenv("VICAN_TPU_SCALE_MIN_CAMS", "16")
    args = (prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0, lambda e: True)
    before = pwr_apply.launches
    gpu = bipgo.bipartite_se3sync(*args, maxiter=4, verbose=False)
    assert pwr_apply.launches > before
    cpu = bipgo.bipartite_se3sync(*args, maxiter=4, verbose=False, device="cpu")
    d_rot = max(distance_SO3(np.asarray(gpu[k].R(), np.float64),
                             np.asarray(cpu[k].R(), np.float64)) for k in cpu)
    d_tr = max(np.linalg.norm(gpu[k].t() - cpu[k].t()) for k in cpu)
    # the bars of tests/test_scale.py:205-206 (f32 variants on a noisy fixture)
    assert d_rot < 0.2, d_rot
    assert d_tr < 0.05, d_tr
