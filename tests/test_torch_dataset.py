"""The port's dataset loaders against the JAX package's on the same
directories: the render layout of tests/test_dataset.py and a real-capture
(Dojo) layout."""
import json

import numpy as np
import pytest

from vican_tpu import dataset as JDS
from vican_torch import cam as TC
from vican_torch import dataset as TDS
from vican_torch import geometry as TG


@pytest.fixture
def render_layout(tmp_path):
    """A render directory (tests/test_dataset.py:17-43): 3 cameras, images
    at 4 timesteps for 2 of them, a directory and a file to ignore, and two
    object-pose shards."""
    root = tmp_path / "ds"
    root.mkdir()
    rng = np.random.default_rng(0)
    cams = {cid: {"fx": 600.0, "fy": 610.0, "cx": 640.0, "cy": 360.0,
                  "distortion": rng.normal(size=12).tolist(),
                  "R": TG.rodrigues(rng.normal(size=3)).tolist(),
                  "t": rng.normal(size=3).tolist(),
                  "resolution_x": 1280, "resolution_y": 720} for cid in ["0", "1", "7"]}
    (root / "cameras.json").write_text(json.dumps(cams))
    for t in ["0", "1", "5", "10"]:
        (root / t).mkdir()
        for cid in ["1", "0"]:
            (root / t / f"{cid}.jpg").write_bytes(b"\xff\xd8fake")
    (root / "notes").mkdir()
    (root / "README.txt").write_text("x")
    for shard, ts in enumerate([["0", "5"], ["10"]]):
        obj = {t: {"R": TG.rodrigues(rng.normal(size=3)).tolist(),
                   "t": rng.normal(size=3).tolist()} for t in ts}
        (root / f"object_pose_{shard}.json").write_text(json.dumps(obj))
    return str(root)


def _same_cams(ours, theirs):
    assert list(ours) == list(theirs)
    for k, c in theirs.items():
        o = ours[k]
        assert isinstance(o, TC.Camera) and isinstance(o.extrinsics, TG.SE3)
        assert o.id == c.id
        np.testing.assert_array_equal(o.intrinsics, c.intrinsics)
        np.testing.assert_array_equal(o.distortion, c.distortion)
        np.testing.assert_array_equal(o.extrinsics.pose(), c.extrinsics.pose())
        assert (o.resolution_x, o.resolution_y) == (c.resolution_x, c.resolution_y)


def _same_im_data(ours, theirs):
    for key in ("filename", "timestamp", "cam_id"):
        assert ours[key] == theirs[key], key
    assert [c.id for c in ours["cam"]] == [c.id for c in theirs["cam"]]


def test_dataset_matches_jax(render_layout):
    ours, theirs = TDS.Dataset(render_layout), JDS.Dataset(render_layout)
    _same_cams(ours.cams, theirs.cams)
    _same_im_data(ours.im_data, theirs.im_data)
    assert len(ours.im_data["filename"]) == 8
    assert ours.im_data["timestamp"][:2] == ["0", "0"]  # sorted by name, as JAX
    assert list(ours.object) == list(theirs.object) == ["0", "5", "10"]
    for t, pose in theirs.object.items():
        np.testing.assert_array_equal(ours.object[t].pose(), pose.pose())


def test_dataset_without_cameras_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="cameras.json"):
        TDS.Dataset(str(tmp_path))


def test_dojo_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    pose = lambda: TG.SE3(R=TG.rodrigues(rng.normal(size=3)),  # noqa: E731
                          t=rng.normal(size=3)).pose().tolist()
    (tmp_path / "cameras_intrinsics.json").write_text(json.dumps({
        c: {"intrinsics": (np.eye(3) * 500).tolist(), "distortion": rng.normal(size=5).tolist()}
        for c in ("camA", "camB")}))
    (tmp_path / "cameras_transformations_to_origin_ground_truth.json").write_text(
        json.dumps({"camA": pose(), "camB": pose()}))
    (tmp_path / "aruco_cube_transformations.json").write_text(json.dumps({
        "to": {m: pose() for m in ("3", "11")}}))
    for t in ("2", "0"):
        imdir = tmp_path / "aruco_images_samples" / t
        imdir.mkdir(parents=True)
        for c in ("camB", "camA"):
            (imdir / f"{c}.jpg").write_bytes(b"x")
    ours, theirs = TDS.DojoDataset(str(tmp_path)), JDS.DojoDataset(str(tmp_path))
    _same_cams(ours.cams, theirs.cams)
    _same_im_data(ours.im_data, theirs.im_data)
    assert ours.cams["camA"].resolution_x is None
    assert list(ours.object_constraints) == list(theirs.object_constraints)
    for m, c in theirs.object_constraints.items():
        np.testing.assert_array_equal(ours.object_constraints[m].pose(), c.pose())
