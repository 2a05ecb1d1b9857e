"""Frames -> camera-marker edges, plain: the reference of the room cells.

For uint8 frames: the host candidates (:mod:`.candidates`), refine, decode
and dedup (:mod:`.detect`) and the markers' poses (:mod:`.pnp`), in blocks
of frames so that it fits beside anything.  The geometry computes in the
``dtype`` given: float64, as the configuration states, or float32, the
control.
"""
from __future__ import annotations

import numpy as np
import torch

from . import candidates as C_
from . import detect as D_
from . import pnp as P_
from .dictionary import correction_bits, rotation_table

REFINE = {"CORNER_REFINE_APRILTAG": "apriltag", "CORNER_REFINE_SUBPIX": "subpix",
          "CORNER_REFINE_NONE": "none"}


def detector_params(config: dict) -> D_.DetectorParams:
    """The detector's parameters for a room configuration: the upstream
    project's tuned values, its refinement, the dictionary's budget."""
    if config["aruco"] != "DICT_4X4_1000":
        raise ValueError(f"the reference holds DICT_4X4_1000 only, not {config['aruco']}")
    if config["flags"] != "SOLVEPNP_IPPE_SQUARE":
        raise ValueError(f"the reference solves SOLVEPNP_IPPE_SQUARE only, not {config['flags']}")
    params = D_.DetectorParams(corner_refine=REFINE[config["corner_refine"]])
    return params._replace(error_correction_bits=correction_bits(params.error_correction_rate))


def timestep_of(name: str) -> str:
    """The timestep a frame's name carries: its parent directory."""
    return name.replace("\\", "/").split("/")[-2]


def edges(gray: np.ndarray, names, cams: list, config: dict, device,
          dtype=torch.float64, block: int = 32) -> dict:
    """``gray (N, H, W)`` uint8 with a file name and a camera (``id``,
    ``K``, ``dist``) a frame -> ``{(cam id, "<t>_<marker>"): (R (3, 3), t
    (3,), corners (4, 2), reprojection error)}``, float64 numpy, for every
    marker whose pose is finite."""
    params = detector_params(config)
    codes = D_.dictionary_codes(rotation_table(), device)
    out = {}
    for s in range(0, len(names), block):
        g = np.ascontiguousarray(gray[s:s + block])
        quads, valid, areas = C_.candidates(g, params)
        det = D_.detect(torch.as_tensor(g).to(device), quads, valid, areas, codes, 4, params,
                        dtype)
        B, Dn = det.ids.shape
        sel = det.valid.reshape(-1).nonzero()[:, 0]
        if not sel.numel():
            continue
        im = sel // Dn
        K = torch.as_tensor(np.stack([np.asarray(cams[i]["K"], np.float64)
                                      for i in range(s, s + B)]), device=device).to(dtype)
        dist = P_.pad_distortion(torch.as_tensor(np.stack(
            [np.asarray(cams[i]["dist"], np.float64) for i in range(s, s + B)]),
            device=device)).to(dtype)
        corners = det.corners.reshape(B * Dn, 4, 2)[sel]
        R, t, err = P_.marker_poses(corners, K[im], dist[im], config["marker_size"],
                                    config["lm_iters"])
        finite = (torch.isfinite(err) & torch.isfinite(R).all(dim=(1, 2))
                  & torch.isfinite(t).all(dim=1))
        ids = det.ids.reshape(-1)[sel]
        for j, (e, f) in enumerate(zip(im.tolist(), finite.tolist())):
            if not f:
                continue
            i = s + e
            key = (cams[i]["id"], f"{timestep_of(names[i])}_{int(ids[j])}")
            out[key] = (R[j].double().cpu().numpy(), t[j].double().cpu().numpy(),
                        corners[j].double().cpu().numpy(), float(err[j]))
    return out
