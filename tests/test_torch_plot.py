"""vican_torch.plot against vican_tpu.plot: the same scatter points from
plot2D, the matplotlib branch of plot_cams_3D, pixel-equal marker
overlays, and detect_and_draw finding the same markers in a rendered JPEG
(the port's detection on the CPU against the JAX package's)."""
import sys

import numpy as np
import pytest

import matplotlib

matplotlib.use("Agg")

from vican_tpu import plot as jplot
from vican_tpu.cam import Camera
from vican_tpu.geometry import SE3, rodrigues
from vican_torch import plot as tplot
from vican_torch import synthetic as tsyn
from vican_torch.cam import Camera as TCamera
from vican_torch.geometry import SE3 as TSE3
from torch_threads import two_threads  # noqa: F401


class RecordingAx:
    """Minimal matplotlib-Axes stand-in capturing scatter() calls."""

    def __init__(self):
        self.calls = []

    def scatter(self, x, y, s, marker=None, c=None):
        self.calls.append((np.asarray(x), np.asarray(y), s, marker, c))


def _arrays(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=3)
    return rodrigues(v / np.linalg.norm(v) * rng.uniform(0.1, np.pi - 0.1)), rng.normal(size=3)


def _cams(cls, se3, n=4):
    return {str(i): cls(id=str(i), intrinsics=np.eye(3), distortion=np.zeros(12),
                        extrinsics=se3(*_arrays(10 + i)), resolution_x=64, resolution_y=64)
            for i in range(n)}


def _se3(cls):
    return lambda R, t: cls(R=R, t=t)


@pytest.mark.parametrize("view", ["xy", "xz", "yz"])
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("kind", ["poses", "cameras"])
def test_plot2d_points_match_jax(view, invert, kind):
    def run(plot, se3, camera):
        data = ({str(i): se3(*_arrays(i)) for i in range(5)} if kind == "poses"
                else _cams(camera, se3))
        ax = RecordingAx()
        plot.plot2D(ax, data, view=view, marker="x", s=30, c="blue", invert=invert,
                    idx=["1", "3"] if kind == "cameras" else None,
                    left_gauge=se3(*_arrays(100)), right_gauge=se3(*_arrays(101)))
        return ax.calls

    (ref,), (out,) = run(jplot, _se3(SE3), Camera), run(tplot, _se3(TSE3), TCamera)
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    assert out[2:] == ref[2:] == (30, "x", "blue")


def test_plot2d_errors_like_jax():
    data = {"a": TSE3(R=np.eye(3), t=np.zeros(3))}
    with pytest.raises(ValueError):
        tplot.plot2D(RecordingAx(), data, view="zz", marker="x", s=1, c="k")
    with pytest.raises(TypeError):
        tplot.plot2D(RecordingAx(), {"a": np.eye(4)}, view="xy", marker="x", s=1, c="k")
    # the JAX package's Camera is not the port's
    with pytest.raises(TypeError):
        tplot.plot2D(RecordingAx(), _cams(Camera, _se3(SE3)), view="xy", marker="x", s=1,
                     c="k")


def test_plot_cams_3d_matplotlib_branch(monkeypatch):
    import matplotlib.pyplot as plt

    monkeypatch.setitem(sys.modules, "plotly", None)
    monkeypatch.setitem(sys.modules, "plotly.express", None)
    figs = [jplot.plot_cams_3D(list(_cams(Camera, _se3(SE3)).values()), scale=0.4),
            tplot.plot_cams_3D(list(_cams(TCamera, _se3(TSE3)).values()), scale=0.4)]
    (ref,), (out,) = (f.axes for f in figs)
    assert out.name == ref.name == "3d"
    assert len(out.lines) == len(ref.lines) == 12
    for lo, lr in zip(out.lines, ref.lines):
        np.testing.assert_array_equal(np.asarray(lo.get_data_3d()), np.asarray(lr.get_data_3d()))
        assert lo.get_color() == lr.get_color()
    for a, b in zip(out.collections[0]._offsets3d, ref.collections[0]._offsets3d):
        np.testing.assert_array_equal(np.asarray(a, float), np.asarray(b, float))
    for f in figs:
        plt.close(f)


@pytest.mark.parametrize("marker_id", ["7", None])
def test_draw_marker_pixel_equal(marker_id):
    quad = np.array([[20.3, 30.9], [90.0, 31.0], [92.5, 100.2], [19.0, 99.0]])
    ref = jplot.draw_marker(np.zeros((120, 160, 3), np.uint8), quad, marker_id)
    out = tplot.draw_marker(np.zeros((120, 160, 3), np.uint8), quad, marker_id)
    np.testing.assert_array_equal(out, ref)
    assert (out[..., 1] == 255).any()


@pytest.fixture(scope="module")
def rendered_jpeg(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plot") / "scene")
    tsyn.render_cube_scene(root, [(2.4, 0.3, 1.3)], 1, seed=5, res=(640, 360),
                           marker_size=0.138, device="cpu")
    return f"{root}/0/0.jpg"


def test_detect_and_draw_matches_jax(rendered_jpeg, capsys, two_threads):
    ref = jplot.detect_and_draw(rendered_jpeg, aruco="DICT_4X4_1000")
    ref_ids = capsys.readouterr().out.strip().splitlines()[-1]
    out = tplot.detect_and_draw(rendered_jpeg, aruco="DICT_4X4_1000", device="cpu")
    out_ids = capsys.readouterr().out.strip().splitlines()[-1]
    assert out_ids == ref_ids
    assert len(eval(out_ids)) >= 8
    assert out.shape == ref.shape == (360, 640, 3) and out.dtype == np.uint8
    equal = float((out == ref).all(axis=-1).mean())
    assert equal >= 0.999, equal
    assert (out[..., 1] == 255).any()


def test_detect_and_draw_tutorial_preprocess_matches_jax(rendered_jpeg, capsys, two_threads):
    """At the tutorial's brightness -150 and contrast 120 both packages'
    ``detect_and_draw`` run the ``pure`` detection: on this frame they find
    marker 5 and not the false 441 that the ``device`` and ``host`` modes
    of both packages report; the drawn gray image is the same preprocess."""
    kw = dict(aruco="DICT_4X4_1000", brightness=-150, contrast=120)
    ref = jplot.detect_and_draw(rendered_jpeg, **kw)
    ref_ids = eval(capsys.readouterr().out.strip().splitlines()[-1])
    out = tplot.detect_and_draw(rendered_jpeg, device="cpu", **kw)
    out_ids = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert out_ids == ref_ids
    assert 5 in out_ids and 441 not in out_ids
    # the overlays are colored, the image under them gray
    unmarked = ((out == out[..., :1]).all(axis=-1) & (ref == ref[..., :1]).all(axis=-1))
    assert unmarked.mean() > 0.9
    np.testing.assert_array_equal(out[unmarked], ref[unmarked])


def test_detect_and_draw_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        tplot.detect_and_draw("/nonexistent/im.jpg", aruco="DICT_4X4_1000", device="cpu")
