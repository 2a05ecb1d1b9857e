"""Cameras and the perception front-end API (reference: vican/cam.py).

The port of ``vican_tpu.cam``.  :class:`Camera` and :func:`gen_marker_uid`
are host types; detection, PnP and LM refinement run batched on the card
(:mod:`vican_torch.perception`), driven by :func:`estimate_pose_mp`: in the
``device`` mode with the candidates extracted on the host, or the whole
detection on the card in the ``pure`` mode; with ``mesh=``, over the cards
of a ``torch.distributed`` mesh (:mod:`vican_torch.parallel`).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from .geometry import SE3

__all__ = ["Camera", "gen_marker_uid", "estimate_pose_mp", "estimate_pose_worker"]


class Camera:
    """Perspective camera record (vican/cam.py:14-56).

    Parameters
    ----------
    id : str
        Unique camera identifier.
    intrinsics : np.ndarray
        3x3 pinhole matrix.
    distortion : np.ndarray
        OpenCV distortion vector (the datasets use the full 12-coefficient
        rational + thin-prism + tilt model — vican/cam.py:31-32, render.py:293;
        shorter vectors are zero-padded on use).
    extrinsics : SE3
        Camera pose in the world frame.
    resolution_x, resolution_y : int
    """

    def __init__(
        self,
        id: str,
        intrinsics: np.ndarray,
        distortion: np.ndarray,
        extrinsics: SE3,
        resolution_x: int,
        resolution_y: int,
    ):
        self.id = id
        self.intrinsics = np.asarray(intrinsics).squeeze()
        self.distortion = np.asarray(distortion).squeeze()
        self.extrinsics = extrinsics
        self.resolution_x = resolution_x
        self.resolution_y = resolution_y

    def __repr__(self) -> str:
        out = f"Camera {self.resolution_y}x{self.resolution_x} id={self.id}\n"
        out += "Intrinsics:\n" + str(self.intrinsics)
        out += "\nDistortion:\n" + str(self.distortion)
        out += "\nExtrinsics:\n" + str(self.extrinsics)
        return out


def gen_marker_uid(im_filename: str, marker_id: str) -> str:
    """Unique id ``"<timestep>_<marker>"`` for a detection in an image.

    The timestep is the parent directory name of the image path
    (vican/cam.py:59-80).
    """
    timestamp = im_filename.replace("\\", "/").split("/")[-2]
    return timestamp + "_" + str(marker_id)


def estimate_pose_worker(
    im_filename: str,
    cam: Camera,
    aruco: str,
    marker_size: float,
    corner_refine: str,
    flags: str,
    brightness: int,
    contrast: int,
    device=None,
) -> dict | None:
    """Single-image detection + pose estimation (vican/cam.py:83-186 parity).

    Provided for API compatibility; internally batches of one image go through
    the same device pipeline as :func:`estimate_pose_mp`.  Returns ``None``
    when nothing was detected (reference semantics).
    """
    out = estimate_pose_mp(
        im_filenames=[im_filename],
        cams=[cam],
        aruco=aruco,
        marker_size=marker_size,
        corner_refine=corner_refine,
        brightness=brightness,
        contrast=contrast,
        flags=flags,
        marker_ids=None,
        batch_size=1,
        verbose=False,
        device=device,
    )
    return out if out else None


def estimate_pose_mp(
    im_filenames: Iterable[str],
    cams: Iterable[Camera],
    aruco: str,
    marker_size: float,
    corner_refine: str,
    brightness: int,
    contrast: int,
    flags: str,
    marker_ids: Iterable[str] | None,
    batch_size: int = 32,
    mesh=None,
    pipeline_mode: str = "auto",
    detector_params=None,
    verbose: bool = True,
    device=None,
) -> dict:
    """Batched marker detection + PnP over all images (vican/cam.py:190-265).

    The reference fans out one OpenCV pipeline per image over a
    multiprocessing pool; here images stream through a host decode stage into
    batches on the card (thresholding, corner refinement, decoding, IPPE PnP
    and LM refinement -- see :mod:`vican_torch.perception`).
    ``pipeline_mode``: ``"auto"`` (= ``"device"``: the threshold kernel on
    the card), ``"device"``, ``"host"`` or ``"roi"`` (the threshold on the
    host), which give the same detections, or ``"pure"`` (the components
    and candidates on the card too).  ``mesh``: a ``DeviceMesh`` of
    :mod:`vican_torch.parallel`; call on every rank, each runs its share of
    every batch and all return the whole dict.  ``device=None`` is the
    CUDA card (raises without one); ``device="cpu"`` runs the plain versions
    of the kernels.

    Returns the reference edge dict: keys ``(cam_id, "<t>_<marker>")``, values
    with ``pose`` / ``corners`` / ``reprojected_err`` / ``im_filename``.
    """
    from .perception import estimate_pose_batched

    im_filenames = list(im_filenames)
    cams = list(cams)
    assert len(im_filenames) == len(cams)
    if verbose:
        print("\nMarker detection")
        print("Received {} images.".format(len(im_filenames)))

    out = estimate_pose_batched(
        im_filenames,
        cams,
        aruco=aruco,
        marker_size=marker_size,
        corner_refine=corner_refine,
        brightness=brightness,
        contrast=contrast,
        flags=flags,
        batch_size=batch_size,
        mesh=mesh,
        pipeline_mode=pipeline_mode,
        detector_params=detector_params,
        verbose=verbose,
        device=device,
    )

    if marker_ids is not None:
        marker_ids = set(map(str, marker_ids))
        out = {k: v for k, v in out.items() if k[-1].split("_")[-1] in marker_ids}
    if verbose:
        print("Finished: {} markers detected.".format(len(out)))
    return out
