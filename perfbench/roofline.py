"""The yardstick of the kernels' roofline shares: the card's peaks and the
work each kernel's call needs, counted from the shapes.

Peaks of one H100 SXM at its 700 W limit: device-memory bandwidth from
NVIDIA's data sheet; the int32 rate derived from the Hopper architecture
white paper (64 INT32 lanes per SM x 132 SMs x the 1.98 GHz boost clock),
not a data-sheet figure.  A share is the least time these peaks allow
(the larger of operations over the rate and bytes over the bandwidth)
over the kernel's traced device time a launch, in percent.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS = 64 * 132 * 1.98e9


def threshold_work(B: int, H: int, W: int, wins) -> dict:
    """The multi-window mean-C threshold of ``B`` uint8 frames into
    bit-packed masks: int32 operations and bytes the function needs (not a
    design's): one integral image of each replicate-padded frame (2 an
    entry), g + C once a pixel, and per window and pixel a 3-term box sum,
    the scale and the compare; the frames read once, the masks written
    once."""
    R = max(wins) // 2
    ops = B * (H + 2 * R) * (W + 2 * R) * 2 + B * H * W * (1 + 5 * len(wins))
    nbytes = B * H * W + B * len(wins) * H * (-(-W // 8))
    return {"ops": ops, "bytes": nbytes}


def bound_s(work: dict) -> float:
    return max(work["ops"] / PEAK_INT32_OPS, work["bytes"] / PEAK_BYTES_S)
