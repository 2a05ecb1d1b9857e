"""Polygon area (shoelace formula), the port's copy of
``vican_tpu.ops.shoelace``.

The tutorial's noise models use ``shapely.geometry.Polygon(...).area`` over
the 4 detected corners; this is the exact shoelace formula instead.  Works
on NumPy arrays and on torch tensors, with any leading batch dimensions.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["polygon_area"]


def polygon_area(corners):
    """Area of a polygon given (..., N, 2) vertices in order; matches
    ``shapely.Polygon(zip(x, y)).area`` on the 4-corner marker quads."""
    if isinstance(corners, torch.Tensor):
        x, y = corners[..., 0], corners[..., 1]
        return 0.5 * torch.abs(torch.sum(x * torch.roll(y, -1, -1)
                                         - torch.roll(x, -1, -1) * y, dim=-1))
    c = np.asarray(corners)
    if c.shape == (4, 2):
        # scalar path for the per-edge noise-model call pattern (the
        # reference's shapely .area sits in the same per-edge Python loop)
        (x0, y0), (x1, y1), (x2, y2), (x3, y3) = c.tolist()
        return 0.5 * abs(x0 * y1 - x1 * y0 + x1 * y2 - x2 * y1
                         + x2 * y3 - x3 * y2 + x3 * y0 - x0 * y3)
    x, y = c[..., 0], c[..., 1]
    return 0.5 * np.abs(np.sum(x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y, axis=-1))
