"""The thin matvec: the port's plain version against the JAX package's
Pallas probe kernel (interpret mode on the CPU) and against XLA's bf16 x
bf16 -> f32 matmul, and the kernel's launch plan.  The CUDA kernel itself
is tested in tests/test_torch_gpu.py."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vican_torch.solver.mv import aligned_bf16, thin_mv, thin_mv_plain
from vican_torch.solver.tiles import XT_ALIGN, mma_plan, stage_depth

_PROBE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmarks", "mv_kernel_probe.py")


@pytest.fixture(scope="module")
def probe():
    """benchmarks/mv_kernel_probe.py, loaded as it stands (its import-time
    compile-cache call is the one tests/conftest.py makes)."""
    spec = importlib.util.spec_from_file_location("mv_kernel_probe", _PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_interpret(probe, B, X, bm, bk):
    """The probe's ``_kernel`` with ``pallas_mv``'s BlockSpecs and VMEM
    accumulator (mv_kernel_probe.py:52-69), in interpret mode."""
    M, K = B.shape
    w = X.shape[1]
    grid = (M // bm, K // bk)
    return pl.pallas_call(
        functools.partial(probe._kernel, k_blocks=grid[1]),
        grid=grid,
        in_specs=[pl.BlockSpec((bm, bk), lambda i, j: (i, j)),
                  pl.BlockSpec((bk, w), lambda i, j: (j, 0))],
        out_specs=pl.BlockSpec((bm, w), lambda i, j: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, w), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bm, w), jnp.float32)],
        interpret=True,
    )(B, X)


def _operands(M, K, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, w)).astype(np.float32))


def _rel(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


# the same bf16 products (exact in f32) summed in other f32 orders:
# measured 2.0e-7 and 2.1e-7 of max |Y|; the probe's own bar is 1e-5
# (mv_kernel_probe.py:107)
@pytest.mark.parametrize("M,K,w,bm,bk", [(256, 512, 16, 128, 256), (128, 1024, 128, 64, 512)])
def test_plain_matches_probe_kernel(probe, M, K, w, bm, bk):
    B, X = _operands(M, K, w)
    ref = np.asarray(_probe_interpret(probe, jnp.asarray(B, jnp.bfloat16),
                                      jnp.asarray(X, jnp.bfloat16), bm, bk))
    Bb = torch.from_numpy(B).to(torch.bfloat16)
    out = thin_mv_plain(Bb, torch.from_numpy(X)).numpy()
    assert out.shape == (M, w) and out.dtype == np.float32
    assert _rel(out, ref) < 1e-5, _rel(out, ref)
    before = thin_mv.launches
    assert np.array_equal(thin_mv(Bb, torch.from_numpy(X)).numpy(), out)
    assert thin_mv.launches == before  # CPU tensors: the plain version


# ragged M and K (neither a multiple of 8), the streaming route's widths;
# B stored plain and with 16-byte aligned rows
@pytest.mark.parametrize("M,K,w", [(37, 101, 1), (61, 203, 10), (1003, 999, 10)])
@pytest.mark.parametrize("aligned", [False, True])
def test_plain_matches_xla_bf16_matmul(M, K, w, aligned):
    B, X = _operands(M, K, w, seed=M + K + w)
    ref = np.asarray(jnp.matmul(jnp.asarray(B, jnp.bfloat16), jnp.asarray(X).astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32))
    Bt = torch.from_numpy(B)
    Bb = aligned_bf16(Bt) if aligned else Bt.to(torch.bfloat16)
    before = thin_mv.launches
    out = thin_mv(Bb, torch.from_numpy(X)).numpy()
    assert thin_mv.launches == before
    assert _rel(out, ref) < 1e-5, _rel(out, ref)


def test_aligned_bf16_layout():
    """A (M, K) view of a zeroed (M, ld) bfloat16 buffer, ld the next
    multiple of 8: rows start on 16-byte boundaries."""
    A = torch.from_numpy(_operands(5, 13, 1)[0])
    B = aligned_bf16(A)
    assert B.shape == (5, 13) and B.dtype == torch.bfloat16
    assert B.stride() == (16, 1) and B.data_ptr() % 16 == 0
    assert torch.equal(B, A.to(torch.bfloat16))
    assert not B.as_strided((5, 16), (16, 1))[:, 13:].any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    B = torch.zeros(8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        thin_mv(B.float(), torch.zeros(16, 2))  # not bfloat16
    with pytest.raises(ValueError):
        thin_mv(B.T, torch.zeros(8, 2))  # column stride
    with pytest.raises(ValueError):
        thin_mv(B, torch.zeros(15, 2))  # K mismatch


@pytest.mark.parametrize("w", [1, 8, 9, 16, 17, 32, 33, 64, 65, 127, 128, 129, 200, 256, 300])
def test_launch_plan_passes_and_splits(w):
    """The thin-matvec grid: one launch, ceil(w / 128) column slices of at
    most 16 n8 tiles, a transposed X wide enough for every stage, and K
    splits that cover K, none empty, at most 16, fewer where the partials
    would cost over 1% of the operator's bytes."""
    for M, K in ((37, 101), (1003, 999), (30000, 30000), (30208, 31744)):
        plan = mma_plan(M, K, w)
        assert plan.passes == -(-w // 128)
        assert plan.nt in (1, 2, 4, 8, 16) and 8 * plan.nt >= min(w, 128)
        assert plan.nt == 16 or plan.passes == 1
        assert plan.xt_rows == (128 * plan.passes if plan.passes > 1 else 8 * plan.nt)
        assert plan.ldx % XT_ALIGN == 0 and plan.ldx >= K
        depth = stage_depth(plan.nt, False)
        assert plan.splits * plan.tps * depth >= K > (plan.splits - 1) * plan.tps * depth
        assert 1 <= plan.splits <= 16
        assert plan.splits == 1 or plan.splits <= K // (400 * w)
