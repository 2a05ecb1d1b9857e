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
test is exact against it (see threshold.cu).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["WIN_SIZES", "adaptive_threshold", "multi_threshold", "multi_threshold_plain",
           "pack_bits"]

WIN_SIZES = (3, 9, 13, 19, 23, 29, 33)
_MAX_WIN = 33  # threshold.cu: a 16-pixel halo
_MAX_N_WIN = 8

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
    return s.to(im.dtype) / (win * win)


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
                    thresh_const: float = 10.0) -> torch.Tensor:
    """Bit-packed adaptive-threshold masks of a uint8 frame batch
    ``(B, H, W)`` -> ``(B, n_win, H, ceil(W/8))`` uint8.

    CPU tensors take :func:`multi_threshold_plain`.  CUDA tensors launch
    the kernel of ``vican_torch/csrc/threshold.cu``, or raise; each launch
    adds one to ``multi_threshold.launches``.
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
    c_is_int = c.is_integer() and abs(c) <= 1 << 20  # (g + C) win^2 stays in int32
    wins = list(win_sizes) + [1] * (_MAX_N_WIN - n)
    _kernels.launch("threshold", "threshold_pack_u8", gray, out, B, H, W, n, *wins,
                    int(c_is_int), int(c) if c_is_int else 0, c)
    multi_threshold.launches += 1
    return out


multi_threshold.launches = 0
