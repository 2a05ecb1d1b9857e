"""The CheFSI filter product: the port's plain version against the Pallas
kernel (interpret mode on the CPU) and the transposed layout.  The CUDA
kernel itself is tested in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vican_tpu.solver.pallas_pwr import PANEL, lam_panels, panels_from_flat
from vican_tpu.solver.pallas_pwr import pwr_apply as jax_pwr_apply
from vican_torch.solver.pwr import LD_ALIGN, filter_operator, pwr_apply, pwr_apply_plain

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
