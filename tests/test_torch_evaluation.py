"""vican_torch.evaluation against vican_tpu.evaluation on the same poses:
the same reports (errors within 1e-9, equal summaries and printouts) for
perfect, gauge-shifted, noisy and partial estimates, and the same error
when no camera overlaps."""
import numpy as np
import pytest

from vican_tpu import evaluation as jev
from vican_tpu.cam import Camera
from vican_tpu.geometry import SE3, rodrigues
from vican_torch import evaluation as tev
from vican_torch.cam import Camera as TCamera
from vican_torch.geometry import SE3 as TSE3


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return [(rodrigues(rng.normal(size=3)), rng.normal(size=3)) for _ in range(n)]


def _case(kind: str):
    """(gt arrays, est arrays) for one kind of estimate."""
    gt = _arrays(6, 0)
    g_R, g_t = rodrigues(np.array([0.3, -0.2, 0.5])), np.array([1.0, 2.0, 3.0])
    noise = np.random.default_rng(1).normal(size=(6, 2, 3))
    est = []
    for (R, t), (n_r, n_t) in zip(gt, noise):
        if kind in ("shifted", "noisy", "partial"):
            R, t = g_R @ R, g_R @ t + g_t
        if kind in ("noisy", "partial"):
            R, t = rodrigues(1e-2 * n_r) @ R, t + 0.05 * n_t
        est.append((R, t))
    if kind == "partial":
        est = est[:3]
    return gt, est


def _reports(kind: str, cameras: bool):
    gt, est = _case(kind)

    def side(se3, camera):
        poses = {str(i): se3(R=R, t=t) for i, (R, t) in enumerate(gt)}
        if cameras:
            poses = {c: camera(id=c, intrinsics=np.eye(3), distortion=np.zeros(12),
                               extrinsics=p, resolution_x=640, resolution_y=480)
                     for c, p in poses.items()}
        return poses, {str(i): se3(R=R, t=t) for i, (R, t) in enumerate(est)}

    return (jev.evaluate_calibration(*side(SE3, Camera)),
            tev.evaluate_calibration(*side(TSE3, TCamera)))


@pytest.mark.parametrize("cameras", [False, True])
@pytest.mark.parametrize("kind", ["perfect", "shifted", "noisy", "partial"])
def test_reports_match_jax(kind, cameras):
    ref, out = _reports(kind, cameras)
    assert out.missing_cam_ids == ref.missing_cam_ids
    assert out.valid_cam_ids == ref.valid_cam_ids
    np.testing.assert_allclose(out.gauge.pose(), ref.gauge.pose(), rtol=0, atol=1e-9)
    for name in ("r_err_deg", "t_err_cm", "xyz_err_cm"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name), rtol=0, atol=1e-9)
    s_out, s_ref = out.summary(), ref.summary()
    assert list(s_out) == list(s_ref)
    for key in s_ref:
        if key == "missing":
            assert s_out[key] == s_ref[key]
        else:
            for stat in s_ref[key]:
                assert abs(s_out[key][stat] - s_ref[key][stat]) < 1e-9
    assert str(out) == str(ref)
    if kind == "partial":
        assert out.missing_cam_ids == ["3", "4", "5"]
    if kind in ("perfect", "shifted"):
        assert out.r_err_deg.max() < 0.05 and out.t_err_cm.max() < 0.01


def test_no_overlap_raises_like_jax():
    gt, est = _case("perfect")
    with pytest.raises(ValueError):
        jev.evaluate_calibration({"0": SE3(R=gt[0][0], t=gt[0][1])}, {})
    with pytest.raises(ValueError):
        tev.evaluate_calibration({"0": TSE3(R=gt[0][0], t=gt[0][1])},
                                 {"9": TSE3(R=est[0][0], t=est[0][1])})


def test_stats_equal():
    x = np.random.default_rng(3).normal(size=101)
    assert tev.stats(x) == jev.stats(x)
