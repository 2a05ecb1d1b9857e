"""The multi-window adaptive threshold with bit-packed masks.

Perception's device mode thresholds every frame at 7 window sizes
(reference cam.py:132-135) and ships the masks to the host bit-packed.
The JAX package does this as the Pallas kernel
``vican_tpu/ops/pallas/threshold.py:multi_threshold`` (per image, f32 in,
(7, H, W) f32 masks out) followed by a pack along W in XLA
(``vican_tpu/perception.py:_build_threshold``).  Here both are one CUDA
kernel per frame batch (``vican_torch/csrc/threshold.cu``): uint8 gray
``(B, H, W)`` in, packed masks ``(B, n_win, H, ceil(W/8))`` uint8 out,
little-endian within a byte (``np.unpackbits(..., bitorder="little")``),
bits of columns >= W zero.

:func:`multi_threshold_plain` is the same function in plain PyTorch,
written literally after ``vican_tpu.ops.detect._box_mean`` /
``adaptive_threshold`` (int32 integral images over a replicate-padded
image, the float32 mean and compare), then the pack.  The kernel's integer
test is exact against it (see threshold.cu).  :func:`threshold_plan` is the
kernel's launch plan (column band, rows per CTA, grid, shared memory, the
aligned or byte-load path), plain arithmetic on shapes that the CPU tests
check.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["WIN_SIZES", "ThresholdPlan", "adaptive_threshold", "multi_threshold",
           "multi_threshold_plain", "pack_bits", "threshold_plan"]

WIN_SIZES = (3, 9, 13, 19, 23, 29, 33)
_MAX_WIN = 33  # threshold.cu: a 16-pixel halo
_MAX_N_WIN = 8

# threshold.cu's launch constants (threshold_constant reads them back)
BAND = 256          # output columns per CTA (BW)
STEP_ROWS = 32      # rows per step, one per lane (RS)
THREADS = 256
HALO = _MAX_WIN // 2
SMEM = 72 * (BAND + 2 * HALO + 4) * 4 + 3 * STEP_ROWS * (BAND + 2 * HALO + 16)
SMEM_LIMIT = 232_448  # shared memory one block may use on an H100
CTAS_PER_SM = 2       # two blocks of SMEM fit an SM's 228 KB
# output rows per CTA: the fastest of nine cuts at 32 x 720 x 1280 on an
# H100, within 1.3% of 256 (timed through the wrapper's ``rows`` override)
SEGMENT_ROWS = 3 * STEP_ROWS

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_bits(fg: torch.Tensor) -> torch.Tensor:
    """Pack a bool ``(..., W)`` mask along its last axis into
    ``(..., ceil(W/8))`` uint8, little-endian within a byte."""
    W = fg.shape[-1]
    Wp = -(-W // 8) * 8
    if Wp != W:
        fg = F.pad(fg, (0, Wp - W))
    bits = fg.reshape(*fg.shape[:-1], Wp // 8, 8).to(torch.int32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=fg.device)
    return (bits * weights).sum(-1).to(torch.uint8)


def _box_mean(im: torch.Tensor, win: int) -> torch.Tensor:
    """Mean filter with replicate borders from an integer integral image
    (``vican_tpu.ops.detect._box_mean``): exact box sums, then the float32
    division.  ``im``: float32 (B, H, W) of integer values."""
    r = win // 2
    padded = F.pad(im[:, None], (r, r, r, r), mode="replicate")[:, 0]
    ii = torch.cumsum(torch.cumsum(padded.to(torch.int32), dim=-2), dim=-1)
    ii = F.pad(ii, (1, 0, 1, 0))
    s = ii[..., win:, win:] - ii[..., :-win, win:] - ii[..., win:, :-win] + ii[..., :-win, :-win]
    # the divisor as a tensor on the image's device: PyTorch's CUDA division
    # by a Python scalar multiplies by its rounded reciprocal, which is not
    # the IEEE quotient (at win = 5, 7, 11, 15 it flips masks)
    return s.to(im.dtype) / torch.tensor(win * win, dtype=im.dtype, device=im.device)


def adaptive_threshold(gray: torch.Tensor, win: int, C: float) -> torch.Tensor:
    """ADAPTIVE_THRESH_MEAN_C + THRESH_BINARY_INV on float32 ``(B, H, W)``:
    foreground (dark) where ``gray <= boxmean - C``
    (``vican_tpu.ops.detect.adaptive_threshold``)."""
    return gray <= _box_mean(gray, win) - C


def multi_threshold_plain(gray: torch.Tensor, win_sizes=WIN_SIZES,
                          thresh_const: float = 10.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: uint8 ``(B, H, W)`` ->
    packed ``(B, n_win, H, ceil(W/8))`` uint8, :func:`adaptive_threshold`
    at every window."""
    g = gray.to(torch.float32)
    return pack_bits(torch.stack([adaptive_threshold(g, w, thresh_const) for w in win_sizes],
                                 dim=1))


@dataclass(frozen=True)
class ThresholdPlan:
    band: int          # output columns per CTA
    rows: int          # output rows per CTA, a multiple of STEP_ROWS
    grid: tuple        # (column bands, row segments, frames)
    threads: int
    smem: int          # dynamic shared memory bytes per CTA
    aligned: bool      # 16-byte cp.async loads; else byte loads
    max_prefix: int    # largest running column sum a CTA carries (< 2^23)
    max_box: int       # largest box sum (exact in float32)


@functools.lru_cache(maxsize=256)
def threshold_plan(B: int, H: int, W: int, n_win: int, ptr_alignment: int,
                   sms: int = 132, rows: int | None = None) -> ThresholdPlan:
    """The launch of ``csrc/threshold.cu`` for a uint8 ``(B, H, W)`` batch
    at ``n_win`` windows whose base address is a multiple of
    ``ptr_alignment`` bytes, on a card of ``sms`` SMs.

    Bands of :data:`BAND` columns; each frame's rows are cut into the
    longest segments of at most :data:`SEGMENT_ROWS` rows (a multiple of
    :data:`STEP_ROWS`) that give every SM a CTA, else :data:`STEP_ROWS`
    rows; ``rows`` (a multiple of :data:`STEP_ROWS`) overrides the cut.
    The aligned path needs 16-byte rows and base."""
    if min(B, H, W) < 1 or not 1 <= n_win <= _MAX_N_WIN:
        raise ValueError(f"threshold_plan: bad shape {(B, H, W)} or {n_win} windows")
    bands = -(-W // BAND)
    if rows is None:
        rows = next((r for r in range(SEGMENT_ROWS, STEP_ROWS, -STEP_ROWS)
                     if bands * B * -(-H // r) >= sms), STEP_ROWS)
    elif rows < 1 or rows % STEP_ROWS or (rows + 2 * HALO + 1) * 255 >= 1 << 23:
        raise ValueError(f"threshold_plan: rows {rows} is not a multiple of {STEP_ROWS} "
                         f"that keeps column sums below 2^23")
    rows = min(rows, -(-H // STEP_ROWS) * STEP_ROWS)
    segs = -(-H // rows)
    return ThresholdPlan(
        band=BAND, rows=rows, grid=(bands, segs, B), threads=THREADS, smem=SMEM,
        aligned=W % 16 == 0 and ptr_alignment % 16 == 0,
        max_prefix=(rows + 2 * HALO + 1) * 255, max_box=_MAX_WIN ** 2 * 255)


def _alignment(ptr: int) -> int:
    """The largest power of two up to 16 that divides ``ptr``."""
    return min(16, ptr & -ptr) if ptr else 16


def _check(gray: torch.Tensor, win_sizes) -> None:
    if gray.dtype != torch.uint8 or gray.dim() != 3 or not gray.is_contiguous():
        raise ValueError("multi_threshold: gray must be a contiguous uint8 (B, H, W) tensor")
    if min(gray.shape) < 1:
        raise ValueError(f"multi_threshold: empty batch {tuple(gray.shape)}")
    if not 1 <= len(win_sizes) <= _MAX_N_WIN or any(
            w % 2 == 0 or not 1 <= w <= _MAX_WIN for w in win_sizes):
        raise ValueError(f"multi_threshold: windows must be 1..{_MAX_N_WIN} odd sizes "
                         f"<= {_MAX_WIN}, got {win_sizes}")


def multi_threshold(gray: torch.Tensor, win_sizes=WIN_SIZES,
                    thresh_const: float = 10.0, rows: int | None = None) -> torch.Tensor:
    """Bit-packed adaptive-threshold masks of a uint8 frame batch
    ``(B, H, W)`` -> ``(B, n_win, H, ceil(W/8))`` uint8.

    CPU tensors take :func:`multi_threshold_plain`.  CUDA tensors launch
    the kernel of ``vican_torch/csrc/threshold.cu``, or raise; each launch
    adds one to ``multi_threshold.launches``.  ``rows`` overrides the plan's
    rows per CTA (for the tests and the smoke's sweep; the result is the
    same).
    """
    win_sizes = tuple(int(w) for w in win_sizes)
    _check(gray, win_sizes)
    if gray.device.type != "cuda":
        return multi_threshold_plain(gray, win_sizes, thresh_const)
    from .. import _kernels

    B, H, W = gray.shape
    n = len(win_sizes)
    out = torch.empty((B, n, H, -(-W // 8)), dtype=torch.uint8, device=gray.device)
    c = float(thresh_const)
    c_is_int = c.is_integer() and abs(c) <= 1 << 13  # C win^2 stays exact in float32
    wins = list(win_sizes) + [1] * (_MAX_N_WIN - n)
    plan = threshold_plan(B, H, W, n, _alignment(gray.data_ptr()),
                          _kernels.sm_count(gray.device), rows)
    _kernels.launch("threshold", "threshold_pack_u8", gray, out, B, H, W, n, *wins,
                    int(c_is_int), int(c) if c_is_int else 0, c, plan.rows, plan.grid[1],
                    int(plan.aligned))
    multi_threshold.launches += 1
    return out


multi_threshold.launches = 0
