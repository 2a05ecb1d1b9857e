"""Calibration evaluation: the tutorial's cell-9 protocol as a library.

The port's copy of ``vican_tpu.evaluation`` (host NumPy).  The reference
computes its acceptance metrics inline in the notebook (main.ipynb cell 9):
gauge-align the estimated camera poses to ground truth, then report the
per-camera SO(3) error (degrees) and translation error (cm, overall and
per axis) as min/avg/std/median/max.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .geometry import SE3, distance_SO3, optimize_gauge_SE3

__all__ = ["CalibrationReport", "evaluate_calibration", "stats"]


def stats(x) -> dict:
    """min/avg/std/median/max summary (cell 9's print format)."""
    x = np.asarray(x, dtype=np.float64)
    return {
        "min": float(np.min(x)),
        "avg": float(np.mean(x)),
        "std": float(np.std(x)),
        "median": float(np.median(x)),
        "max": float(np.max(x)),
    }


@dataclass
class CalibrationReport:
    """Gauge-aligned per-camera error statistics."""

    missing_cam_ids: list
    valid_cam_ids: list
    gauge: SE3
    r_err_deg: np.ndarray
    t_err_cm: np.ndarray
    xyz_err_cm: np.ndarray  # (N, 3)

    def summary(self) -> dict:
        return {
            "missing": self.missing_cam_ids,
            "SO3_deg": stats(self.r_err_deg),
            "E3_cm": stats(self.t_err_cm),
            "X_cm": stats(self.xyz_err_cm[:, 0]),
            "Y_cm": stats(self.xyz_err_cm[:, 1]),
            "Z_cm": stats(self.xyz_err_cm[:, 2]),
        }

    def __str__(self) -> str:
        fmt = (
            "{name}\t min: {min:.3f}{u} | avg: {avg:.3f}{u} | std: {std:.3f}{u} | "
            "median: {median:.3f}{u} |  max: {max:.3f}{u}"
        )
        lines = [
            "Missing cameras: {}".format(self.missing_cam_ids if self.missing_cam_ids else "None")
        ]
        s = self.summary()
        lines.append(fmt.format(name="SO(3)", u="deg", **s["SO3_deg"]))
        lines.append(fmt.format(name="E(3) ", u="cm ", **s["E3_cm"]))
        for axis in ("X", "Y", "Z"):
            lines.append(fmt.format(name=axis + "    ", u="cm ", **s[f"{axis}_cm"]))
        return "\n".join(lines)


def evaluate_calibration(cams_gt: dict, pose_est: dict) -> CalibrationReport:
    """Compare estimated world-frame camera poses against ground truth.

    ``cams_gt``: ``{cam_id: Camera}`` (uses ``.extrinsics``) or
    ``{cam_id: SE3}``; ``pose_est``: solver output ``{node: SE3}``.
    Replicates main.ipynb cell 9: the SE(3) gauge is fit on the *inverted*
    poses, then errors measured in the world frame.
    """
    def gt_pose(v):
        return v.extrinsics if hasattr(v, "extrinsics") else v

    missing = [c for c in cams_gt if c not in pose_est]
    valid = [c for c in cams_gt if c in pose_est]
    if not valid:
        raise ValueError("no estimated cameras overlap ground truth")

    G = optimize_gauge_SE3(
        [gt_pose(cams_gt[c]).inv() for c in valid], [pose_est[c].inv() for c in valid]
    )

    r_err, t_err, xyz = [], [], []
    for c in valid:
        gt = gt_pose(cams_gt[c])
        est = G.inv() @ pose_est[c]
        r_err.append(
            distance_SO3(np.asarray(gt.R(), np.float64), np.asarray(est.R(), np.float64))
        )
        diff = (np.asarray(gt.t(), np.float64) - np.asarray(est.t(), np.float64)) * 100.0
        t_err.append(np.linalg.norm(diff))
        xyz.append(np.abs(diff))

    return CalibrationReport(
        missing_cam_ids=missing,
        valid_cam_ids=valid,
        gauge=G,
        r_err_deg=np.asarray(r_err),
        t_err_cm=np.asarray(t_err),
        xyz_err_cm=np.stack(xyz),
    )
