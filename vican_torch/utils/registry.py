"""String-option registries (the port's copy of ``vican_tpu.utils.registry``).

The reference resolves OpenCV options from strings via ``eval('cv.'+name)``
(vican/cam.py:126,130,165).  The string API stays — ``aruco='DICT_4X4_1000'``,
``corner_refine='CORNER_REFINE_APRILTAG'``, ``flags='SOLVEPNP_IPPE_SQUARE'``
— resolved through explicit registries (never ``eval``).
"""
from __future__ import annotations

__all__ = ["ARUCO_DICTS", "CORNER_REFINE", "PNP_FLAGS", "resolve"]

# Supported predefined ArUco dictionaries: (marker_bits, dict_size).
ARUCO_DICTS = {
    "DICT_4X4_50": (4, 50),
    "DICT_4X4_100": (4, 100),
    "DICT_4X4_250": (4, 250),
    "DICT_4X4_1000": (4, 1000),
    "DICT_5X5_50": (5, 50),
    "DICT_5X5_100": (5, 100),
    "DICT_5X5_250": (5, 250),
    "DICT_5X5_1000": (5, 1000),
    "DICT_6X6_50": (6, 50),
    "DICT_6X6_100": (6, 100),
    "DICT_6X6_250": (6, 250),
    "DICT_6X6_1000": (6, 1000),
    "DICT_7X7_50": (7, 50),
    "DICT_7X7_100": (7, 100),
    "DICT_7X7_250": (7, 250),
    "DICT_7X7_1000": (7, 1000),
}

# Corner-refinement methods for the detector.  SUBPIX maps to the
# cornerSubPix-style refiner (ops.detect.refine_corners_subpix); CONTOUR has
# no tensor analogue (it walks OpenCV's contour point lists) and is served by
# the edge-line-fit method, the closest in spirit.
CORNER_REFINE = {
    None: "none",
    "CORNER_REFINE_NONE": "none",
    "CORNER_REFINE_SUBPIX": "subpix",
    "CORNER_REFINE_CONTOUR": "apriltag",
    "CORNER_REFINE_APRILTAG": "apriltag",
}

# PnP solve methods.
PNP_FLAGS = {
    "SOLVEPNP_IPPE_SQUARE": "ippe_square",
    "SOLVEPNP_IPPE": "ippe_square",
    "SOLVEPNP_ITERATIVE": "iterative",
}


def resolve(registry: dict, name, what: str):
    """Look up ``name`` in ``registry`` with a helpful error."""
    try:
        return registry[name]
    except KeyError:
        raise ValueError(
            f"unknown {what}: {name!r}; supported: {sorted(k for k in registry if k)}"
        ) from None
