"""ArUco dictionary tables (the port's copy of ``vican_tpu.ops.dictionary``).

The predefined OpenCV dictionaries are fixed public bit tables, shipped as
packed bits in ``vican_torch/data/aruco_dicts.npz`` (a byte-for-byte copy
of the JAX package's file: canonical orientation, 1 cell per bit), so
detection needs no OpenCV.  ``DICT_nXn_50/100/250`` are prefixes of the
corresponding ``_1000`` table.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from ..utils.registry import ARUCO_DICTS, resolve

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "aruco_dicts.npz")

__all__ = [
    "get_dictionary",
    "marker_bits_table",
    "min_hamming_distance",
    "max_correction_bits",
]


@lru_cache(maxsize=None)
def _load_raw(n: int) -> np.ndarray:
    with np.load(_DATA) as z:
        packed = z[f"dict_{n}x{n}"]
    bits = np.unpackbits(packed, axis=1)[:, : n * n]
    return bits.reshape(-1, n, n).astype(np.uint8)


@lru_cache(maxsize=None)
def get_dictionary(name: str):
    """Resolve a dictionary name -> (bits (size, n, n) uint8, n).

    ``bits[id]`` is the canonical marker pattern, 1 = white cell.
    """
    n, size = resolve(ARUCO_DICTS, name, "aruco dictionary")
    return _load_raw(n)[:size], n


@lru_cache(maxsize=None)
def marker_bits_table(name: str) -> np.ndarray:
    """All four rotations, flattened: (size, 4, n*n) uint8.

    Rotation ``r`` is the marker as seen when the observed quad's first corner
    sits ``r`` quarter-turns clockwise from the canonical top-left corner
    (``np.rot90(bits, -r)`` of the canonical pattern).
    """
    bits, n = get_dictionary(name)
    rots = np.stack(
        [np.rot90(bits, -r, axes=(1, 2)).reshape(-1, n * n) for r in range(4)], axis=1
    )
    return np.ascontiguousarray(rots)


@lru_cache(maxsize=None)
def min_hamming_distance(name: str) -> int:
    """Minimum Hamming distance ``tau`` over all ordered pairs of (marker id,
    rotation) words, a word against itself excluded: both the inter-marker
    distance and each marker's self-rotation distance count (a detection
    resolves the id AND the orientation)."""
    table = marker_bits_table(name)  # (size, 4, L) uint8
    A = table[:, 0, :]
    size = A.shape[0]
    tau = 1 << 30
    step = max(1, (1 << 24) // max(table.size, 1))  # ~16M bool temporaries
    for i0 in range(0, size, step):
        D = (A[i0 : i0 + step, None, None, :] != table[None, :, :, :]).sum(-1)
        ii = np.arange(i0, min(i0 + step, size))
        D[np.arange(len(ii)), ii, 0] = 1 << 30  # a word vs itself
        tau = min(tau, int(D.min()))
    return tau


def max_correction_bits(name: str) -> int:
    """Unique-decoding radius ``(tau - 1) // 2``: correcting up to this many
    bit errors never turns one dictionary word into (a rotation of)
    another."""
    return (min_hamming_distance(name) - 1) // 2
