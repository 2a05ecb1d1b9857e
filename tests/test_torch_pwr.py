"""The CheFSI filter product: the port's plain version against the Pallas
kernel (interpret mode on the CPU), the transposed layout and the CUDA
kernels' launch plans.  The CUDA kernels themselves are tested in
tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vican_tpu.solver.pallas_pwr import PANEL, lam_panels, panels_from_flat
from vican_tpu.solver.pallas_pwr import pwr_apply as jax_pwr_apply
from vican_torch.solver.pwr import LD_ALIGN, filter_operator, pwr_apply, pwr_apply_plain, pwr_plan
from vican_torch.solver.tiles import (CLUSTER_SIZES, SINGLE_MAX_N, SINGLE_MT, SINGLE_P, SMEM_LIMIT,
                                      XT_ALIGN, n_tiles, single_plan, single_smem, stage_depth)

SHAPES = [
    (48, 70, 5),    # T not a panel multiple
    (64, 64, 1),    # w=1: the lambda_max probes
    (48, 33, 10),   # production block width
    (128, PANEL, 7),  # exactly one TPU panel
]


def _inputs(n, T, w, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, 3 * T)).astype(np.float32)
    lbd = rng.standard_normal((T, 3, 3)).astype(np.float32)
    X = rng.standard_normal((n, w)).astype(np.float32)
    return B, lbd, X


@pytest.mark.parametrize("n,T,w", SHAPES)
def test_plain_matches_pallas_kernel(n, T, w):
    B, lbd, X = _inputs(n, T, w)
    bpan = panels_from_flat(jnp.asarray(B), T)
    lamp = lam_panels(jnp.asarray(lbd), bpan.shape[0])
    ref = np.asarray(jax_pwr_apply(
        lamp, jnp.transpose(jnp.asarray(X)).astype(jnp.bfloat16), bpan, interpret=True)).T
    out = pwr_apply_plain(filter_operator(torch.from_numpy(B)), torch.from_numpy(lbd),
                          torch.from_numpy(X)).numpy()
    assert out.shape == (n, w) and out.dtype == np.float32
    # same bf16 operands and bf16 W on both sides; float32 sums in another
    # order (the bar of tests/test_pallas_pwr.py)
    err = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-30)
    assert err < 1e-5, err


def test_filter_operator_layout():
    """Bt[3t+a, i] == bf16(B[i, 3t+a]); the camera axis padded with zeros
    to a multiple of 8 (16-byte rows for the kernel's vector loads)."""
    B, _, _ = _inputs(21, 10, 1, seed=1)
    Bt = filter_operator(torch.from_numpy(B))
    assert Bt.dtype == torch.bfloat16 and Bt.is_contiguous()
    assert Bt.shape == (30, 24) and Bt.shape[1] % LD_ALIGN == 0
    Bb = torch.from_numpy(B).to(torch.bfloat16)
    assert torch.equal(Bt[:, :21], Bb.T)
    assert not Bt[:, 21:].any()


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor goes through the plain version and is not counted as a
    kernel launch."""
    B, lbd, X = _inputs(48, 33, 10, seed=2)
    Bt = filter_operator(torch.from_numpy(B))
    before = pwr_apply.launches
    out = pwr_apply(Bt, torch.from_numpy(lbd), torch.from_numpy(X))
    assert pwr_apply.launches == before
    assert torch.equal(out, pwr_apply_plain(Bt, torch.from_numpy(lbd), torch.from_numpy(X)))
    with pytest.raises(ValueError):
        pwr_apply(Bt, torch.from_numpy(lbd), torch.zeros(48, 17))


# both sides of every switch of the single read's plan (clusters of 1, 2,
# 4, 8, 16 CTAs at 1920 columns a CTA; the two reads past 30720), ragged n
_PLAN_N = sorted({*range(3, 400, 13), 1919, 1920, 1921, 3839, 3840, 3841, 7680, 7681,
                  15360, 15361, 17000, 30000, 30719, 30720, 30721, 36000})


@pytest.mark.parametrize("w", [1, 2, 8, 9, 10, 16])
def test_launch_plan_covers_the_camera_axis(w):
    """For n from 3 to 36000: the single read's CTA column slices cover n
    within the shared memory a block may use, in the smallest cluster that
    holds them; the two reads run only past 16 x 1920 columns, with
    phases whose splits cover their reduction axes."""
    for n in _PLAN_N:
        for T in (1, 7, 10_000):
            plan = pwr_plan(n, T, w)
            single = single_plan(n, T)
            assert (plan.design == "single") == (n <= SINGLE_MAX_N) == (single is not None)
            if single is not None:
                assert plan.single == single
                cs, cc = single.cs, single.cc
                assert cs in CLUSTER_SIZES and cc % 128 == 0 and cc <= 1920
                assert cs * cc >= n  # slices [r cc, (r + 1) cc) cover [0, n)
                assert cs == 1 or -(-n // (cs // 2 * 128)) > SINGLE_MT  # no smaller cluster holds n
                assert single.smem == single_smem(cc) <= SMEM_LIMIT
                assert 1 <= single.clusters <= min(132 // cs, -(-T // SINGLE_P))
            else:
                for phase, M, K, trans in ((plan.phase1, 3 * T, n, False),
                                           (plan.phase2, n, 3 * T, True)):
                    nt = n_tiles(w)
                    assert phase.nt == nt and phase.xt_rows == 8 * nt and phase.passes == 1
                    assert phase.ldx % XT_ALIGN == 0 and phase.ldx >= K
                    depth = stage_depth(nt, trans)
                    assert phase.splits * phase.tps * depth >= K > (phase.splits - 1) * phase.tps * depth


def test_design_is_checked_and_cpu_takes_plain():
    B, lbd, X = _inputs(48, 33, 10, seed=4)
    Bt = filter_operator(torch.from_numpy(B))
    args = (Bt, torch.from_numpy(lbd), torch.from_numpy(X))
    ref = pwr_apply_plain(*args)
    for design in ("single", "two"):
        assert torch.equal(pwr_apply(*args, design=design), ref)
    with pytest.raises(ValueError):
        pwr_apply(*args, design="three")
    with pytest.raises(ValueError):
        pwr_plan(40_000, 10, 10, design="single")
