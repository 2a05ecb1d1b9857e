"""Launch plans of the tensor-core tile engine (``csrc/thin_mma.cuh``) and
of the single-read filter kernel (``csrc/pwr.cu:pwr_single``).

Pure arithmetic on shapes, so the CPU tests check it: how many 64-entry
tiles of the reduction axis each K split takes, how many 128-column slices
a wide ``X`` needs, and how the single-read kernel cuts the camera axis
over a thread-block cluster within an SM's shared memory.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

__all__ = ["BM", "XT_ALIGN", "PASS", "SMEM_LIMIT", "SINGLE_P", "SINGLE_MT", "SINGLE_WARPS",
           "SINGLE_MAX_N", "CLUSTER_SIZES", "MmaPlan", "SinglePlan", "mma_plan", "n_tiles",
           "single_plan", "single_smem", "stage_depth", "round_up"]

BM = 128            # rows of the product per block (thin_mma.cuh:BM)
XT_ALIGN = 256      # the transposed X's row stride (thin_mma.cuh:XT_ALIGN)
PASS = 128          # columns of X per grid-z slice (thin_mma.cuh:PASS)
SMEM_LIMIT = 232_448  # shared memory one block may use on an H100
SINGLE_P = 8        # timesteps per panel (pwr.cu:SR_P)
SINGLE_MT = 15      # most m16 column tiles per warp (pwr.cu:SR_MT)
SINGLE_WARPS = 8    # warps per CTA (pwr.cu:SR_WARPS)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is past the portable 8 (non-portable cluster)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def n_tiles(width: int) -> int:
    """n8 tiles of X's padded width in one slice: 1, 2, 4, 8 or 16."""
    need = -(-min(width, PASS) // 8)
    return 1 << (need - 1).bit_length()


def stage_depth(nt: int, trans: bool) -> int:
    """Reduction entries per pipeline stage (thin_mma.cuh:stage_depth): 64
    for the transposed operator; for the row-read one 256 at 1-2 n8 tiles,
    128 at 4, 64 beyond."""
    return 64 if trans else 256 if nt <= 2 else 128 if nt <= 4 else 64


@dataclass(frozen=True)
class MmaPlan:
    nt: int           # n8 tiles per slice
    passes: int       # 128-column slices of X (grid z)
    splits: int       # K splits (grid y), partials summed in order
    tps: int          # stage-depth tiles of K per split
    ldx: int          # row stride of the transposed X: a multiple of XT_ALIGN, >= K
    xt_rows: int      # rows of the transposed X


@functools.lru_cache(maxsize=256)
def mma_plan(M: int, K: int, w: int, slots: int = 264, trans: bool = False) -> MmaPlan:
    """The engine's grid for ``C (M, w) = A (M, K) X (K, w)`` (``trans``:
    A read from its stored transpose) on a card that holds ``slots``
    blocks at once (SMs x blocks per SM): K is split until about three
    waves of blocks fill those slots, with no split under 4 stages, at most
    16, and no more than keeps the splits' (M, w) float32 partials, written
    and read again, under 1% of A's bytes (``K // (400 w)``)."""
    nt = n_tiles(w)
    passes = -(-w // PASS)
    k_tiles = -(-K // stage_depth(nt, trans))
    blocks = -(-M // BM) * passes
    splits = max(1, min(-(-3 * slots // blocks), k_tiles // 4, 16, K // (400 * w)))
    tps = -(-k_tiles // splits)
    splits = -(-k_tiles // tps)  # no empty split
    return MmaPlan(nt=nt, passes=passes, splits=splits, tps=tps, ldx=round_up(K, XT_ALIGN),
                   xt_rows=passes * PASS if passes > 1 else nt * 8)


def single_smem(cc: int) -> int:
    """Shared-memory bytes of the single-read kernel at ``cc`` columns per
    CTA (pwr.cu:single_smem): two panels of 3P rows padded by 8 entries;
    Z^T (16 x 3P float32) per warp and twice for the CTA; Lambda for two
    panels; W^T (16 x 32 bf16); and the panels' two mbarriers."""
    q = 3 * SINGLE_P
    return (2 * q * (cc + 8) * 2 + (SINGLE_WARPS + 2) * 16 * q * 4
            + 2 * SINGLE_P * 9 * 4 + 16 * 32 * 2 + 16)


@dataclass(frozen=True)
class SinglePlan:
    cs: int           # CTAs per cluster
    mt: int           # m16 column tiles per warp
    cc: int           # camera columns per CTA
    clusters: int     # clusters wanted (capped by the card's occupancy at launch)
    smem: int         # dynamic shared memory per CTA


@functools.lru_cache(maxsize=256)
def single_plan(n: int, T: int, sms: int = 132) -> SinglePlan | None:
    """The single-read kernel's cut of the camera axis: the smallest
    cluster whose CTAs hold ``n`` columns at most 15 m16 tiles per warp
    (1920 columns a CTA) in shared memory; ``None`` past ``16 x 1920 =
    30720`` cameras' rows, where the two-read kernel runs.  One cluster per
    ``cs`` SMs, and no more clusters than panels of 8 timesteps."""
    per_warp = 16 * SINGLE_WARPS
    for cs in CLUSTER_SIZES:
        mt = -(-n // (cs * per_warp))
        if mt > SINGLE_MT:
            continue
        cc = mt * per_warp
        smem = single_smem(cc)
        if smem > SMEM_LIMIT:
            continue
        clusters = max(1, min(sms // cs, -(-T // SINGLE_P)))
        return SinglePlan(cs=cs, mt=mt, cc=cc, clusters=clusters, smem=smem)
    return None


# the largest n the single read takes: 16 CTAs x 1920 columns
SINGLE_MAX_N = CLUSTER_SIZES[-1] * SINGLE_MT * 16 * SINGLE_WARPS
