"""Visualization helpers, API-compatible with the reference (vican/plot.py).

The port of ``vican_tpu.plot``:

- :func:`draw_marker` / :func:`detect_and_draw` -- marker overlays; the
  detection behind ``detect_and_draw`` is the port's default perception
  mode (the threshold kernel on the card, the C labeler, refine, decode
  and dedup), not OpenCV's;
- :func:`plot_cams_3D` -- 3D camera poses: plotly if installed (the
  reference's behavior), otherwise a matplotlib 3D figure;
- :func:`plot2D` -- 2D scatter of pose translations with gauge transforms
  (plot.py:145-221).

OpenCV, plotly and matplotlib are imported only by the functions that use
them.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from .cam import Camera
from .geometry import SE3

__all__ = ["draw_marker", "detect_and_draw", "plot_cams_3D", "plot2D"]


def draw_marker(im: np.ndarray, marker_corners: np.ndarray, marker_id: str) -> np.ndarray:
    """Draw a detected marker's corner quad and id label (plot.py:16-48)."""
    import cv2 as cv

    marker_corners = np.asarray(marker_corners).reshape((4, 2))
    top_l, top_r, bottom_r, bottom_l = marker_corners.astype(np.int32)
    for a, b in [(top_l, top_r), (top_r, bottom_r), (bottom_r, bottom_l), (bottom_l, top_l)]:
        cv.line(im, tuple(a), tuple(b), (0, 255, 0), 1)
    if marker_id is not None:
        cv.putText(
            im, str(marker_id), (int(top_l[0]), int(top_l[1]) - 5),
            cv.FONT_HERSHEY_SIMPLEX, 2, (0, 0, 255), 4,
        )
    return im


def detect_and_draw(
    im_filename: str,
    aruco: str,
    brightness: int = 0,
    contrast: int = 0,
    corner_refine: str = "CORNER_REFINE_APRILTAG",
    device=None,
) -> np.ndarray:
    """Detect markers in one image and overlay them (plot.py:51-105).

    As in the JAX package, the preprocessed frame goes through
    :func:`vican_torch.ops.detect.detect_markers`, the ``pure`` detection,
    on ``device`` (``None``: the CUDA card, where the threshold kernel
    runs; raises without one), with the default detector parameters and
    the requested corner refinement.  Prints the sorted ids found and
    returns the preprocessed gray image as 3 channels with the overlays.
    """
    import cv2 as cv
    import torch

    from .ops import detect as D_
    from .ops.dictionary import get_dictionary, marker_bits_table
    from .utils import no_tf32, resolve_device
    from .utils.registry import CORNER_REFINE, resolve

    im = cv.imread(im_filename)
    if im is None:
        raise FileNotFoundError(im_filename)
    dev = resolve_device(device)
    no_tf32()
    _, n_bits = get_dictionary(aruco)
    params = D_.DetectorParams()._replace(
        corner_refine=resolve(CORNER_REFINE, corner_refine, "corner_refine"))
    params = D_.resolve_error_correction(params, aruco)
    gray = D_.preprocess(torch.from_numpy(im).to(dev), brightness, contrast)
    det = D_.detect_markers(gray, marker_bits_table(aruco), n_bits, params, device=dev)
    gray = gray.to(torch.uint8).cpu().numpy()[None]

    vis = np.stack((gray[0],) * 3, axis=2)
    valid = det.valid.cpu().numpy()
    ids = det.ids.cpu().numpy()
    corners = det.corners.cpu().numpy()
    found = []
    for i in np.flatnonzero(valid):
        vis = draw_marker(vis, corners[i], str(int(ids[i])))
        found.append(int(ids[i]))
    print(sorted(found))
    return vis


def plot_cams_3D(cams: Iterable[Camera], scale: float = 0.4, renderer: str = "browser"):
    """3D scatter of camera centers and RGB axis triads (plot.py:108-142):
    plotly when it is installed (the reference's behavior), otherwise
    matplotlib 3D."""
    cams = list(cams)
    pos = np.stack([np.asarray(c.extrinsics.t(), float) for c in cams])
    axs = np.zeros((len(cams), 3, 3, 2))
    for i, cam in enumerate(cams):
        t = np.asarray(cam.extrinsics.t(), float).reshape(-1, 1)
        axs[i, :, :, 0] = t
        axs[i, :, :, 1] = t + scale * np.asarray(cam.extrinsics.R(), float)

    try:
        import plotly.express as px
    except ImportError:
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c="gray", s=8)
        for i in range(len(cams)):
            for j, c in enumerate(["r", "g", "b"]):
                ax.plot(axs[i, 0, j, :], axs[i, 1, j, :], axs[i, 2, j, :], c=c)
        ax.set_box_aspect((1, 1, 1))
        return fig

    fig = px.scatter_3d(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2])
    fig.update_traces(marker_size=2, marker_color="gray")
    colors = ["red", "green", "blue"]
    for i in range(len(cams)):
        for j in range(3):
            fig.add_traces(
                px.line_3d(x=axs[i, 0, j, :], y=axs[i, 1, j, :], z=axs[i, 2, j, :])
                .update_traces(line_color=colors[j]).data
            )
    fig.update_scenes(aspectmode="data")
    fig.show(renderer=renderer)
    return fig


def plot2D(
    ax,
    data: dict,
    view: str,
    marker: str,
    s: float,
    c,
    invert: bool = False,
    idx: Iterable | None = None,
    left_gauge: SE3 | None = None,
    right_gauge: SE3 | None = None,
) -> None:
    """2D scatter of pose translations (plot.py:145-221).

    ``data[n]`` may be a :class:`Camera` or an :class:`SE3`; poses are
    transformed ``left_gauge @ pose @ right_gauge`` (then optionally
    inverted) and the chosen pair of axes (``"xy" | "xz" | "yz"``) plotted.
    """
    GL = left_gauge if left_gauge is not None else SE3(pose=np.eye(4))
    GR = right_gauge if right_gauge is not None else SE3(pose=np.eye(4))
    if idx is None:
        idx = data.keys()

    pts = []
    for n in idx:
        item = data[n]
        if isinstance(item, Camera):
            pose = GL @ item.extrinsics @ GR
        elif isinstance(item, SE3):
            pose = GL @ item @ GR
        else:
            raise TypeError(f"data[{n!r}] is neither Camera nor SE3")
        xyz = pose.inv().t() if invert else pose.t()
        if view == "xy":
            pts.append(xyz[:2])
        elif view == "xz":
            pts.append(xyz[0::2])
        elif view == "yz":
            pts.append(xyz[1:])
        else:
            raise ValueError(f"unknown view: {view!r}")
    pts = np.stack(pts, axis=0)
    ax.scatter(pts[:, 0], pts[:, 1], s, marker=marker, c=c)
