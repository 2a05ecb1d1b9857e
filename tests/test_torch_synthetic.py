"""vican_torch.synthetic and the scene helpers of vican_torch.render
against the JAX package on the same seeds: the same problem, the same
trajectories, the same placement decisions, and a rendered capture with
the same layout and JSON files and nearly the same JPEGs."""
import json
import os

import numpy as np
import pytest

from vican_tpu import render as jrender
from vican_tpu import synthetic as jsyn
from vican_tpu.cam import Camera
from vican_torch import render as trender
from vican_torch import synthetic as tsyn
from vican_torch.cam import Camera as TCamera


def _assert_poses_equal(out: dict, ref: dict):
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].pose(), ref[k].pose())


def test_make_problem_equals_jax():
    kw = dict(seed=3, n_cams=12, n_times=50)
    ref, out = jsyn.make_problem(**kw), tsyn.make_problem(**kw)
    assert len(out.edges) > 100
    assert list(out.edges) == list(ref.edges)
    for k, e in ref.edges.items():
        o = out.edges[k]
        np.testing.assert_array_equal(o["pose"].pose(), e["pose"].pose())
        np.testing.assert_array_equal(o["corners"], e["corners"])
        assert o["reprojected_err"] == e["reprojected_err"]
        assert o["im_filename"] == e["im_filename"]
    _assert_poses_equal(out.cams_gt, ref.cams_gt)
    _assert_poses_equal(out.obj_gt, ref.obj_gt)
    _assert_poses_equal(out.constraints(), ref.constraints())


@pytest.mark.parametrize("cam_pos", [(1.1, 0.2, 1.1), (0.0, 0.0, 3.0), (0.0, 0.0, -2.0)])
def test_calibration_sweep_matches_jax(cam_pos):
    ref, out = jsyn.calibration_sweep(40, cam_pos), tsyn.calibration_sweep(40, cam_pos)
    assert list(out) == list(ref)
    for t in ref:
        np.testing.assert_allclose(out[t].pose(), ref[t].pose(), rtol=0, atol=1e-12)


def _json(path):
    with open(path) as f:
        return json.load(f)


def _assert_json_close(out, ref):
    if isinstance(ref, dict):
        assert list(out) == list(ref)
        for k in ref:
            _assert_json_close(out[k], ref[k])
    else:
        np.testing.assert_allclose(np.asarray(out, float), np.asarray(ref, float),
                                   rtol=0, atol=1e-12)


def test_render_cube_scene_matches_jax(tmp_path):
    import cv2 as cv

    kw = dict(res=(640, 360), marker_size=0.138, wander=True)
    rig = [(2.4, 0, 1.2), (0, 2.4, 1.4)]
    ref_root, out_root = str(tmp_path / "jax"), str(tmp_path / "port")
    ref_cams, ref_traj = jsyn.render_cube_scene(ref_root, rig, 2, seed=1, **kw)
    out_cams, out_traj = tsyn.render_cube_scene(out_root, rig, 2, seed=1, device="cpu", **kw)
    _assert_poses_equal(out_traj, ref_traj)
    assert list(out_cams) == list(ref_cams)
    for name in ("cameras.json", "object_pose_0.json"):
        _assert_json_close(_json(os.path.join(out_root, name)),
                           _json(os.path.join(ref_root, name)))
    def listing(root):
        return sorted(os.path.join(t, f) for t in ("0", "1")
                      for f in os.listdir(os.path.join(root, t)))

    names = listing(ref_root)
    assert listing(out_root) == names
    assert len(names) == 4
    for name in names:
        ref = cv.imread(os.path.join(ref_root, name))
        out = cv.imread(os.path.join(out_root, name))
        assert out.shape == ref.shape == (360, 640, 3)
        equal = float((out == ref).all(axis=-1).mean())
        assert equal >= 0.995, (name, equal)
    # an existing root is not rendered again
    mtime = os.path.getmtime(os.path.join(out_root, "cameras.json"))
    tsyn.render_cube_scene(out_root, rig, 2, seed=1, device="cpu", **kw)
    assert os.path.getmtime(os.path.join(out_root, "cameras.json")) == mtime


def _cam_pairs():
    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    ref, out = {}, {}
    for i, pos in enumerate([(2.4, 0, 1.2), (0, 2.4, 1.4), (-2.4, 0.5, 1.0), (0, -6.5, 3.0)]):
        ext = jrender.look_at(pos, (0, 0, 1.0))
        ref[str(i)] = Camera(id=str(i), intrinsics=K, distortion=np.zeros(12), extrinsics=ext,
                             resolution_x=640, resolution_y=360)
        out[str(i)] = TCamera(id=str(i), intrinsics=K, distortion=np.zeros(12),
                              extrinsics=trender.look_at(pos, (0, 0, 1.0)),
                              resolution_x=640, resolution_y=360)
    return ref, out


def test_scene_helpers_equal_jax():
    ref_cams, out_cams = _cam_pairs()
    rng = np.random.default_rng(6)
    for _ in range(200):
        a = (rng.uniform(-1, 1, 3), rng.uniform(0.1, 0.6, 3), jrender.look_at(
            rng.normal(size=3) * 3, rng.normal(size=3)).R())
        b = (rng.uniform(-1, 1, 3), rng.uniform(0.1, 0.6, 3), np.eye(3))
        assert trender.boxes_intersect(*a, *b) == jrender.boxes_intersect(*a, *b)
        p = rng.uniform(-2, 2, 3) + np.array([0, 0, 1.0])
        cutoff = rng.uniform(2.0, 7.0)
        assert trender.cams_seeing(out_cams, p, cutoff) == jrender.cams_seeing(ref_cams, p, cutoff)
    keep_out = [((0.0, 0.0, 1.0), (0.3, 0.3, 0.3)),
                ((0.5, 0.5, 0.5), (0.2, 0.4, 0.2), jrender.look_at((1, 2, 3), (0, 0, 0)).R())]
    kw = dict(keep_out=keep_out, min_views=2, max_tries=50)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(10):
        ref = jrender.cube_pose_candidate(ra, ref_cams, (-1, -1, 0.5), (1, 1, 1.5), **kw)
        out = trender.cube_pose_candidate(rb, out_cams, (-1, -1, 0.5), (1, 1, 1.5), **kw)
        assert (ref is None) == (out is None)
        if ref is not None:
            np.testing.assert_array_equal(out.pose(), ref.pose())
    # nothing can be placed in a region every box covers
    assert trender.cube_pose_candidate(np.random.default_rng(0), out_cams, (-0.1,) * 3,
                                       (0.1,) * 3, keep_out=[((0, 0, 0), (1, 1, 1))],
                                       max_tries=5) is None


def test_render_dataset_shards_and_resume(tmp_path):
    """shard= splits the timesteps into per-shard pose files, resume= skips
    timesteps already written, only_visible_cams= renders only the
    cameras that see the object (vican_tpu/render.py:300-410)."""
    _, cams = _cam_pairs()
    traj = tsyn.calibration_sweep(4, (2.4, 0, 1.2))
    markers = trender.make_cube_markers()
    root = str(tmp_path / "ds")
    for core in (0, 1):
        trender.render_dataset(root, cams, traj, markers, marker_size=0.138, shard=(core, 2),
                               only_visible_cams=True, device="cpu")
    assert sorted(_json(os.path.join(root, "object_pose_0.json"))) == ["0", "2"]
    assert sorted(_json(os.path.join(root, "object_pose_1.json"))) == ["1", "3"]
    # camera 3 stands 6.8 m from the cube: inside the default 7 m cutoff,
    # outside the 5 m one of the resumed run below
    assert sorted(os.listdir(os.path.join(root, "0"))) == [f"{c}.jpg" for c in "0123"]
    os.remove(os.path.join(root, "2", "1.jpg"))
    stamp = {t: os.path.getmtime(os.path.join(root, t, "0.jpg")) for t in ("0", "2")}
    trender.render_dataset(root, cams, traj, markers, marker_size=0.138, shard=(0, 2),
                           resume=True, distance_cutoff=5.0, only_visible_cams=True,
                           device="cpu")
    assert os.path.getmtime(os.path.join(root, "0", "0.jpg")) == stamp["0"]
    assert os.path.exists(os.path.join(root, "2", "1.jpg"))
