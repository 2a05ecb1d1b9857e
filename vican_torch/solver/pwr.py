"""The CheFSI filter's power-graph product ``Y = B Lambda_T B^T X``.

The dominant cost of :func:`vican_torch.solver.scale.so3_sync_large`: about
230 applications per float32 solve at ``maxiter=4`` of

    Y (n, w) = B (n, 3T) . blockdiag(Lambda_T) . B^T (3T, n) . X (n, w)

with ``n = 3C`` (30000 at 10k cameras), ``w`` 1 (the lambda_max probes) or
10 (the filtered subspace), and ``B`` a bfloat16 copy of the folded-edge
operator.  This module holds the CUDA kernel's wrapper (``pwr_apply``), its
plain PyTorch version (``pwr_apply_plain``) and the layout helper
(``filter_operator``).

Numerics (the contract of ``vican_tpu/solver/pallas_pwr.py:50-52`` and of
the XLA path it replaced, scale.py:389-416): bfloat16 operands, float32
accumulation, ``Lambda_T`` applied blockwise in float32, the intermediate
``W = Lambda_T B^T X`` rounded to bfloat16 before the second product.

Layout: the operator is stored once per solve TRANSPOSED, ``Bt (3T, ld)``
bfloat16 row-major with ``Bt[3t+a, i] = B[i, 3t+a]`` and the camera axis
zero-padded to ``ld``, a multiple of 8, so every row starts on a 16-byte
boundary.  The rows of one timestep are contiguous, so ``Lambda_T`` closes
over three neighbouring rows.
"""
from __future__ import annotations

import torch

__all__ = ["filter_operator", "pwr_apply", "pwr_apply_plain", "LD_ALIGN"]

LD_ALIGN = 8  # bf16 elements per 16-byte vector


def filter_operator(B: torch.Tensor) -> torch.Tensor:
    """``Bt (3T, ld)`` bfloat16 from the flat operator ``B (n, 3T)``.

    Written in one pass into a zeroed buffer: no float32 copy of the
    transpose is ever made.
    """
    n, q = B.shape
    ld = -(-n // LD_ALIGN) * LD_ALIGN
    Bt = torch.zeros((q, ld), dtype=torch.bfloat16, device=B.device)
    Bt[:, :n].copy_(B.T)
    return Bt


def pwr_apply_plain(Bt: torch.Tensor, lbd_t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The same function as the kernel in plain PyTorch: float32 products
    of the bfloat16-rounded operands (TF32 off), so ``W`` and ``Y`` carry
    float32 sums of exactly the kernel's terms.  Returns ``Y (n, w)``
    float32."""
    n, w = X.shape
    Bf = Bt[:, :n].float()
    Z = Bf @ X.to(torch.bfloat16).float()  # (3T, w)
    Z = torch.einsum("tab,tbw->taw", lbd_t.float(), Z.view(-1, 3, w)).reshape(-1, w)
    return Bf.T @ Z.to(torch.bfloat16).float()


_K2_TILE = 1024  # camera columns per phase-2 block (pwr.cu:K2_TILE)


def _slices(q: int, ld: int, dev) -> int:
    """Row slices of the kernel's second phase: enough blocks for ~4 per SM
    (each slice adds one (w, ld) float32 partial, summed in a fixed order),
    and no slice under 128 rows."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    col_tiles = -(-ld // _K2_TILE)
    return max(1, min(-(-4 * sms // col_tiles), -(-q // 128)))


def _check(Bt, lbd_t, X):
    q, ld = Bt.shape
    n, w = X.shape
    if Bt.dtype != torch.bfloat16 or not Bt.is_contiguous():
        raise ValueError("pwr_apply: Bt must be a contiguous bfloat16 (3T, ld) tensor")
    if q % 3 or lbd_t.shape != (q // 3, 3, 3):
        raise ValueError(f"pwr_apply: lbd_t {tuple(lbd_t.shape)} does not match Bt {tuple(Bt.shape)}")
    if n > ld or ld % LD_ALIGN:
        raise ValueError(f"pwr_apply: X has {n} rows, Bt's padded width is {ld}")
    if not 1 <= w <= 16:
        raise ValueError(f"pwr_apply: thin width {w} outside 1..16")
    if not (X.device == Bt.device == lbd_t.device):
        raise ValueError("pwr_apply: operands on different devices")


def pwr_apply(Bt: torch.Tensor, lbd_t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``Y (n, w) = B Lambda_T B^T X`` in float32 from ``Bt (3T, ld)``
    bfloat16, ``lbd_t (T, 3, 3)`` and ``X (n, w)``, ``1 <= w <= 16``.

    CPU tensors take :func:`pwr_apply_plain`.  CUDA tensors launch the
    kernel of ``vican_torch/csrc/pwr.cu``, or raise; each launch adds one
    to ``pwr_apply.launches``.
    """
    _check(Bt, lbd_t, X)
    if Bt.device.type != "cuda":
        return pwr_apply_plain(Bt, lbd_t, X)
    from .. import _kernels

    q, ld = Bt.shape
    n, w = X.shape
    dev = Bt.device
    Xt = torch.zeros((w, ld), dtype=torch.bfloat16, device=dev)
    Xt[:, :n].copy_(X.T)
    lam = lbd_t.to(torch.float32).contiguous()
    Wbuf = torch.empty((q, w), dtype=torch.bfloat16, device=dev)
    Yt = torch.empty((w, ld), dtype=torch.float32, device=dev)
    slices = _slices(q, ld, dev)
    Ypart = (torch.empty((slices, w, ld), dtype=torch.float32, device=dev)
             if slices > 1 else Yt)
    _kernels.launch(
        "pwr", "pwr_apply_bf16",
        Bt, lam, Xt, Wbuf, Ypart, Yt, q // 3, ld, w, slices,
    )
    pwr_apply.launches += 1
    return Yt[:, :n].T


pwr_apply.launches = 0
