"""Dataset loaders, API-compatible with the reference (vican/dataset.py).

The port's copy of ``vican_tpu.dataset``, on the port's
:class:`~vican_torch.cam.Camera` and :class:`~vican_torch.geometry.SE3`.
Two directory layouts are supported:

- :class:`Dataset`: the Blender-rendered layout,
  ``root/<timestep>/<camera_id>.jpg`` + ``root/cameras.json`` +
  optional ``root/object_pose_<n>.json`` (vican/dataset.py:14-99).
- :class:`DojoDataset`: a real-world capture layout with separate
  intrinsics/extrinsics JSONs and an ``aruco_images_samples/`` image tree
  (vican/dataset.py:102-181).

Both expose ``.cams`` (dict of cameras), ``.im_data`` (parallel lists
``filename/timestamp/cam/cam_id``, which feed
:func:`vican_torch.cam.estimate_pose_mp`) and object-pose dicts.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .cam import Camera
from .geometry import SE3

__all__ = ["Dataset", "DojoDataset"]


def _scan_images(root: str, cams: dict) -> dict:
    """Scan ``root/<timestep>/<cam_id>.jpg`` into the ``im_data`` contract.

    One ``os.scandir`` pass per directory, in sorted order so that
    ``im_data`` is the same on every filesystem.  Returns parallel lists
    keyed ``filename/timestamp/cam/cam_id`` (vican/dataset.py:79-98).
    """
    im_data = {"filename": [], "timestamp": [], "cam": [], "cam_id": []}
    with os.scandir(root) as it:
        tdirs = sorted((e.name, e.path) for e in it if e.name.isnumeric() and e.is_dir())
    for t, tpath in tdirs:
        with os.scandir(tpath) as it:
            files = sorted(e.name for e in it if e.name.endswith(".jpg"))
        for filename in files:
            cam_id = filename.rsplit(".", 1)[0]
            im_data["cam_id"].append(cam_id)
            im_data["filename"].append(os.path.join(tpath, filename))
            im_data["timestamp"].append(t)
            im_data["cam"].append(cams[cam_id])
    return im_data


class Dataset:
    """Blender-rendered dataset: images, cameras, optional GT object poses.

    Parameters
    ----------
    root : str
        Directory with ``<timestep>/<camera_id>.jpg`` images, a
        ``cameras.json`` (``fx, fy, cx, cy, distortion, R, t, resolution_*``
        per camera) and optional ``object_pose_<n>.json`` ground-truth
        files.
    """

    def __init__(self, root: str):
        self.root = root
        self.cam_path = os.path.join(root, "cameras.json")
        if not os.path.isfile(self.cam_path):
            raise FileNotFoundError(f"missing {self.cam_path}")
        self.read_cameras()
        self.read_im_data()
        self.read_object()

    def read_cameras(self):
        """Load the camera dictionary from ``cameras.json``."""
        with open(self.cam_path) as f:
            data = json.load(f)
        self.cams = {}
        for k, v in data.items():
            K = np.array([[v["fx"], 0.0, v["cx"]], [0.0, v["fy"], v["cy"]], [0.0, 0.0, 1.0]])
            self.cams[k] = Camera(
                id=k,
                intrinsics=K,
                distortion=np.array(v["distortion"]),
                extrinsics=SE3(R=np.array(v["R"]), t=np.array(v["t"])),
                resolution_x=v["resolution_x"],
                resolution_y=v["resolution_y"],
            )

    def read_object(self):
        """Load GT object poses from every ``object_pose_*.json`` shard,
        merged by timestep key (a render farm writes one shard per worker)."""
        self.object = {}
        with os.scandir(self.root) as it:
            shards = sorted(e.path for e in it if e.name.startswith("object_"))
        for path in shards:
            with open(path) as f:
                object_data = json.load(f)
            for t, pose_dict in object_data.items():
                self.object[t] = SE3(R=np.array(pose_dict["R"]), t=np.array(pose_dict["t"]))

    def read_im_data(self):
        """Scan numeric subdirectories for ``<cam_id>.jpg`` images."""
        self.im_data = _scan_images(self.root, self.cams)


class DojoDataset:
    """Real-world capture layout (vican/dataset.py:102-181).

    Expects ``cameras_intrinsics.json``,
    ``cameras_transformations_to_origin_ground_truth.json``,
    ``aruco_cube_transformations.json`` (the ``'to'`` entries are *inverted*
    into object constraints) and images under ``aruco_images_samples/``.
    Its cameras declare no resolution, so perception groups them by the
    size of their image files.
    """

    def __init__(self, root: str):
        self.root = root
        self.read_cameras()
        self.read_im_data()
        self.read_object_constraints()

    def read_cameras(self):
        self.cams = {}
        with open(os.path.join(self.root, "cameras_intrinsics.json")) as f:
            intrinsics_data = json.load(f)
        with open(os.path.join(self.root,
                               "cameras_transformations_to_origin_ground_truth.json")) as f:
            extrinsics_data = json.load(f)
        for c in extrinsics_data:
            self.cams[c] = Camera(
                id=c,
                intrinsics=np.array(intrinsics_data[c]["intrinsics"]),
                distortion=np.array(intrinsics_data[c]["distortion"]),
                extrinsics=SE3(pose=np.array(extrinsics_data[c])),
                resolution_x=None,
                resolution_y=None,
            )

    def read_object_constraints(self):
        with open(os.path.join(self.root, "aruco_cube_transformations.json")) as f:
            object_data = json.load(f)
        self.object_constraints = {
            m: SE3(pose=np.array(v)).inv() for m, v in object_data["to"].items()
        }

    def read_im_data(self):
        self.im_data = _scan_images(os.path.join(self.root, "aruco_images_samples"), self.cams)
