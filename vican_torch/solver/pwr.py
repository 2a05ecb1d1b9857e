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

import functools
from dataclasses import dataclass

import torch

from .tiles import MmaPlan, SinglePlan, mma_plan, single_plan

__all__ = ["filter_operator", "pwr_apply", "pwr_apply_plain", "pwr_plan", "PwrPlan",
           "LD_ALIGN"]

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


@dataclass(frozen=True)
class PwrPlan:
    """How one ``pwr_apply`` launch runs: ``design`` "single" (one read of
    ``Bt``, :class:`~.tiles.SinglePlan` in ``single``) or "two" (two reads
    on the tile engine: ``phase1`` Z = Bt X over (3T, n), ``phase2`` Y =
    Bt^T W over (n, 3T), each a :class:`~.tiles.MmaPlan`)."""

    design: str
    single: SinglePlan | None = None
    phase1: MmaPlan | None = None
    phase2: MmaPlan | None = None


@functools.lru_cache(maxsize=256)
def pwr_plan(n: int, T: int, w: int, sms: int = 132, design: str | None = None,
             occupancy: tuple[int, int] = (2, 3)) -> PwrPlan:
    """The launch plan for ``n`` camera rows, ``T`` timesteps and width
    ``w`` on ``sms`` SMs: the single read wherever
    :func:`~.tiles.single_plan` fits ``n`` (``n <= 30720``), else the two
    reads, whose phases hold ``occupancy`` blocks per SM; ``design``
    forces one of them (the card tests hold both to the plain version at
    one shape)."""
    if design not in (None, "single", "two"):
        raise ValueError(f"pwr_plan: design {design!r}")
    single = single_plan(n, T, sms) if design != "two" else None
    if single is not None:
        return PwrPlan("single", single=single)
    if design == "single":
        raise ValueError(f"pwr_plan: the single read does not fit n = {n}")
    return PwrPlan("two", phase1=mma_plan(3 * T, n, w, sms * occupancy[0]),
                   phase2=mma_plan(n, 3 * T, w, sms * occupancy[1], trans=True))


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


def pwr_apply(Bt: torch.Tensor, lbd_t: torch.Tensor, X: torch.Tensor,
              design: str | None = None) -> torch.Tensor:
    """``Y (n, w) = B Lambda_T B^T X`` in float32 from ``Bt (3T, ld)``
    bfloat16, ``lbd_t (T, 3, 3)`` and ``X (n, w)``, ``1 <= w <= 16``.

    CPU tensors take :func:`pwr_apply_plain`.  CUDA tensors launch the
    kernels of ``vican_torch/csrc/pwr.cu`` in the design :func:`pwr_plan`
    picks by shape (``design`` forces one), or raise; each call adds one to
    ``pwr_apply.launches``.
    """
    _check(Bt, lbd_t, X)
    if design not in (None, "single", "two"):
        raise ValueError(f"pwr_apply: design {design!r}")
    if Bt.device.type != "cuda":
        return pwr_apply_plain(Bt, lbd_t, X)
    from .. import _kernels

    q, ld = Bt.shape
    T = q // 3
    n, w = X.shape
    dev = Bt.device
    plan = pwr_plan(n, T, w, _kernels.sm_count(dev), design, phase_occupancy(dev, w))
    lam = _aligned(lbd_t.to(torch.float32).contiguous())
    X = _aligned(X.to(torch.float32).contiguous())  # the kernels round it to bf16
    Y = torch.empty((n, w), dtype=torch.float32, device=dev)
    if plan.design == "single":
        sp = plan.single
        clusters = min(sp.clusters, single_capacity(sp.cs, w, sp.mt, dev))
        Ypart = torch.empty((clusters, n, w), dtype=torch.float32, device=dev)
        _kernels.launch("pwr", "pwr_single_bf16", Bt, lam, X, Ypart, Y,
                        T, n, ld, w, sp.cs, sp.mt, clusters)
    else:
        p1, p2 = plan.phase1, plan.phase2
        Xt = torch.empty((p1.xt_rows, p1.ldx), dtype=torch.bfloat16, device=dev)
        Zpart = torch.empty((p1.splits, q, w), dtype=torch.float32, device=dev)
        Wt = torch.empty((p2.xt_rows, p2.ldx), dtype=torch.bfloat16, device=dev)
        Ypart = (torch.empty((p2.splits, n, w), dtype=torch.float32, device=dev)
                 if p2.splits > 1 else Y)
        _kernels.launch("pwr", "pwr_apply_bf16", Bt, lam, X, Xt, Zpart, Wt, Ypart, Y,
                        T, n, ld, p1.ldx, p2.ldx, w, p1.splits, p1.tps, p2.splits, p2.tps)
    pwr_apply.launches += 1
    return Y


pwr_apply.launches = 0

_card: dict = {}  # what the card reports for a kernel and shape, asked once


def phase_occupancy(dev, w: int) -> tuple[int, int]:
    """Blocks per SM of the two-read kernel's phases at width ``w``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), asked once."""
    from .. import _kernels

    key = ("phases", w <= 8, torch.device(dev).index)
    if key not in _card:
        with torch.cuda.device(dev):
            blocks = tuple(_kernels.call("pwr", "pwr_mma_occupancy", w, t) for t in (0, 1))
        if min(blocks) <= 0:
            raise RuntimeError(f"pwr_mma_occupancy({w}): {blocks}")
        _card[key] = blocks
    return _card[key]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it starts on a 16-byte boundary, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def single_capacity(cs: int, w: int, mt: int, dev) -> int:
    """Clusters of ``cs`` CTAs the card holds at once for the single-read
    kernel (``cudaOccupancyMaxActiveClusters``), asked once per shape."""
    from .. import _kernels

    key = ("clusters", cs, w <= 8, mt, torch.device(dev).index)
    if key not in _card:
        with torch.cuda.device(dev):
            count = _kernels.call("pwr", "pwr_single_clusters", cs, w, mt)
        if count <= 0:
            raise RuntimeError(f"pwr_single_clusters({cs}, {w}, {mt}): {count}")
        _card[key] = count
    return _card[key]
