"""The tutorial flow (examples/tutorial.py, the reference's main.ipynb) on
the port, on the CPU, through the file path at the example's ``--quick``
size (examples/tutorial.py:110-113: 16 room timesteps over 4 cameras, 24
cube frames, 960x540): render both captures to JPEGs, calibrate the cube
from its capture, detect the markers of the room capture, solve the camera
network, evaluate against ground truth (cell 9) and plot (cell 11).  The
bars are tests/test_tutorial.py's: all 24 marker poses, camera errors
under 1 degree and 10 cm on average."""
import os

import numpy as np
import pytest

pytest.importorskip("cv2")

from vican_torch.bipgo import bipartite_se3sync, object_bipartite_se3sync
from vican_torch.cam import estimate_pose_mp
from vican_torch.dataset import Dataset
from vican_torch.evaluation import evaluate_calibration
from vican_torch.ops.shoelace import polygon_area
from vican_torch.plot import plot2D
from vican_torch.synthetic import calibration_sweep, render_cube_scene

# examples/tutorial.py's hyperparameters (its synthetic mode)
MARKER_SIZE = 0.138
MARKER_IDS = [str(i) for i in range(24)]
ROOM_RIG = [(3, 0, 1.2), (0, 3, 1.5), (-3, 0, 1.0), (0, -3, 1.3)]
CUBE_POS = (1.1, 0.2, 1.1)
RES = (960, 540)
DETECT = dict(aruco="DICT_4X4_1000", marker_size=MARKER_SIZE,
              corner_refine="CORNER_REFINE_APRILTAG", marker_ids=MARKER_IDS,
              flags="SOLVEPNP_IPPE_SQUARE", brightness=-150, contrast=120, verbose=False,
              device="cpu")


class RecordingAx:
    def __init__(self):
        self.calls = []

    def scatter(self, x, y, s, marker=None, c=None):
        self.calls.append((np.asarray(x), np.asarray(y)))


def test_tutorial_flow_on_the_port(tmp_path):
    room, cube = str(tmp_path / "small_room_synth"), str(tmp_path / "cube_calib_synth")
    render_cube_scene(room, ROOM_RIG, 16, seed=1, res=RES, marker_size=MARKER_SIZE,
                      wander=True, device="cpu")
    render_cube_scene(cube, [CUBE_POS], 24, seed=2, res=RES, marker_size=MARKER_SIZE,
                      traj=calibration_sweep(24, CUBE_POS), device="cpu")
    dataset, obj_dataset = Dataset(root=room), Dataset(root=cube)
    assert len(dataset.im_data["filename"]) == 64 and len(obj_dataset.im_data["filename"]) == 24

    # 1. the cube from its own capture (cell 3; the synthetic obj_t_power 2)
    aux = estimate_pose_mp(cams=obj_dataset.im_data["cam"],
                           im_filenames=obj_dataset.im_data["filename"], **DETECT)
    obj_pose_est = object_bipartite_se3sync(
        aux,
        noise_model_r=lambda e: 0.01 * polygon_area(e["corners"]) ** 2,
        noise_model_t=lambda e: 0.001 * polygon_area(e["corners"]) ** 2.0,
        edge_filter=lambda e: e["reprojected_err"] < 0.1,
        maxiter=4, lsqr_solver="conjugate_gradient", dtype=np.float64, verbose=False,
        device="cpu")
    assert sorted(obj_pose_est, key=int) == MARKER_IDS

    # 2. the room capture (cell 5), 3. the camera network (cell 7)
    cam_marker_edges = estimate_pose_mp(cams=dataset.im_data["cam"],
                                        im_filenames=dataset.im_data["filename"], **DETECT)
    edges = {k: v for k, v in cam_marker_edges.items() if int(k[1].split("_")[0]) < 2000}
    pose_est = bipartite_se3sync(
        edges, constraints=obj_pose_est,
        noise_model_r=lambda e: 0.001 * polygon_area(e["corners"]) ** 1.0,
        noise_model_t=lambda e: 0.001 * polygon_area(e["corners"]) ** 2.0,
        edge_filter=lambda e: e["reprojected_err"] < 0.05,
        maxiter=4, lsqr_solver="conjugate_gradient", dtype=np.float32, verbose=False,
        device="cpu")

    # 4. ground truth (cell 9)
    report = evaluate_calibration(dataset.cams, pose_est)
    assert report.missing_cam_ids == []
    s = report.summary()
    assert s["SO3_deg"]["avg"] < 1.0, str(report)
    assert s["E3_cm"]["avg"] < 10.0, str(report)
    assert str(report).splitlines()[1].startswith("SO(3)")

    # 5. the 2D plot (cell 11): estimates land on the ground truth
    ax = RecordingAx()
    plot2D(ax, pose_est, idx=report.valid_cam_ids, left_gauge=report.gauge.inv(), view="xy",
           marker="x", s=30, c="blue")
    plot2D(ax, dataset.cams, view="xy", marker="x", s=30, c="red")
    plot2D(ax, dataset.object, view="xy", marker=".", s=15, c=[[0, 0.6, 0, 0.4]])
    (ex, ey), (gx, gy), (ox, _) = ax.calls
    assert len(ox) == 16
    np.testing.assert_allclose(np.stack([ex, ey]), np.stack([gx, gy]), atol=0.1)
    assert os.path.isfile(os.path.join(room, "object_pose_0.json"))
