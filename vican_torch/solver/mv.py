"""The thin matvec ``Y (M, w) = B (M, K) . X (K, w)``: bfloat16 operands,
float32 accumulation, float32 out.

The function of the JAX package's tiled matvec probe
(``benchmarks/mv_kernel_probe.py:pallas_mv``) and of the large-graph
route's streaming filter product (``vican_tpu/solver/scale.py:484-487``,
``jnp.matmul(Lb, X.astype(bfloat16), preferred_element_type=float32)``).
In the port the streaming regime of :mod:`.scale` calls it on the bfloat16
copy of the dense (3C, 3C) scaled Laplacian, about 230 times per float32
solve at ``w`` 10 (the filtered subspace) and 1 (the lambda_max probes).

This module holds the CUDA kernel's wrapper (``thin_mv``), its plain
PyTorch version (``thin_mv_plain``) and the helper that stores an operator
with 16-byte aligned rows (``aligned_bf16``).
"""
from __future__ import annotations

import torch

from .pwr import LD_ALIGN
from .tiles import mma_plan, n_tiles

__all__ = ["aligned_bf16", "thin_mv", "thin_mv_plain"]


def aligned_bf16(A: torch.Tensor) -> torch.Tensor:
    """A bfloat16 copy of ``A (M, K)`` whose rows start on 16-byte
    boundaries: a ``(M, K)`` view of a zeroed ``(M, ld)`` buffer, ``ld`` the
    next multiple of 8, written in one pass.  The kernel reads such rows as
    16-byte vectors."""
    M, K = A.shape
    ld = -(-K // LD_ALIGN) * LD_ALIGN
    buf = torch.zeros((M, ld), dtype=torch.bfloat16, device=A.device)
    buf[:, :K].copy_(A)
    return buf[:, :K]


def thin_mv_plain(B: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the float32 product of the
    bfloat16 operands.  Products of two bfloat16 values are exact in
    float32, so with TF32 off (``vican_torch.utils.no_tf32``) this carries
    exactly the kernel's terms, summed in another order."""
    return B.float() @ X.to(torch.bfloat16).float()


def _check(B, X):
    if B.dim() != 2 or X.dim() != 2:
        raise ValueError("thin_mv: B and X must be 2-D")
    if B.dtype != torch.bfloat16 or B.stride(1) != 1:
        raise ValueError("thin_mv: B must be bfloat16 with unit column stride")
    M, K = B.shape
    if X.shape[0] != K or M == 0 or K == 0 or X.shape[1] == 0:
        raise ValueError(f"thin_mv: shapes {tuple(B.shape)} x {tuple(X.shape)}")
    if X.device != B.device:
        raise ValueError("thin_mv: operands on different devices")


def thin_mv(B: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``Y (M, w) = B X`` in float32 from ``B (M, K)`` bfloat16 (any row
    stride, unit column stride) and ``X (K, w)``, which is rounded to
    bfloat16 first.

    CPU tensors take :func:`thin_mv_plain`.  CUDA tensors launch the kernel
    of ``vican_torch/csrc/mv.cu``, or raise; each launch adds one to
    ``thin_mv.launches``.  Rows of ``B`` on 16-byte boundaries (see
    :func:`aligned_bf16`) are copied as vectors, others entry by entry.
    One launch takes every column of ``X`` (in 128-column grid slices past
    128, :func:`vican_torch.solver.tiles.mma_plan`).
    """
    _check(B, X)
    if B.device.type != "cuda":
        return thin_mv_plain(B, X)
    from .. import _kernels

    M, K = B.shape
    w = X.shape[1]
    plan = mma_plan(M, K, w, _slots(B.device, n_tiles(w)))
    X = X.to(torch.float32).contiguous()  # the kernel rounds it to bf16
    Xt = torch.empty((plan.xt_rows, plan.ldx), dtype=torch.bfloat16, device=B.device)
    Y = torch.empty((M, w), dtype=torch.float32, device=B.device)
    Ypart = (torch.empty((plan.splits, M, w), dtype=torch.float32, device=B.device)
             if plan.splits > 1 else Y)
    ldb = B.stride(0)
    vec = int(ldb % LD_ALIGN == 0 and B.data_ptr() % 16 == 0)
    _kernels.launch("mv", "thin_mv_bf16", B, X, Xt, Ypart, Y, M, K, ldb, plan.ldx, w, plan.nt,
                    plan.splits, plan.tps, vec)
    thin_mv.launches += 1
    return Y


thin_mv.launches = 0

_blocks_per_sm: dict = {}


def _slots(dev, nt: int) -> int:
    """Blocks of the ``nt`` instance the card holds at once: SMs x blocks
    per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), asked once."""
    from .. import _kernels

    key = (nt, torch.device(dev).index)
    if key not in _blocks_per_sm:
        with torch.cuda.device(dev):
            blocks = _kernels.call("mv", "thin_mv_occupancy", nt)
        if blocks <= 0:
            raise RuntimeError(f"thin_mv_occupancy({nt}): {blocks}")
        _blocks_per_sm[key] = blocks
    return _kernels.sm_count(dev) * _blocks_per_sm[key]
