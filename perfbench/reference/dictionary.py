"""The ArUco dictionary ``DICT_4X4_1000``: OpenCV's public bit table.

``dict_4x4_1000.txt`` holds one marker a line, its 16 cells as 4 hex
digits, row-major from the top-left cell, 1 = white.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dict_4x4_1000.txt")


@functools.lru_cache(maxsize=None)
def marker_bits() -> np.ndarray:
    """``(1000, 4, 4)`` uint8, the canonical pattern of each id."""
    with open(_TABLE) as f:
        rows = [bytes.fromhex(line.strip()) for line in f if line.strip()]
    packed = np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), 2)
    return np.unpackbits(packed, axis=1)[:, :16].reshape(-1, 4, 4)


def rotation_table() -> np.ndarray:
    """``(1000, 4, 16)``: rotation r is the pattern seen when the quad's
    first corner sits r quarter-turns clockwise from the canonical
    top-left."""
    bits = marker_bits()
    return np.ascontiguousarray(np.stack(
        [np.rot90(bits, -r, axes=(1, 2)).reshape(-1, 16) for r in range(4)], axis=1))


def correction_bits(rate: float) -> int:
    """The Hamming budget ``floor(rate * ((tau - 1) // 2))``, tau the least
    distance between two (id, rotation) words, a word against itself
    excluded."""
    table = rotation_table()
    A = table[:, 0, :]
    D = (A[:, None, None, :] != table[None, :, :, :]).sum(-1)
    D[np.arange(len(A)), np.arange(len(A)), 0] = 1 << 30
    tau = int(D.min())
    return int(rate * ((tau - 1) // 2))
