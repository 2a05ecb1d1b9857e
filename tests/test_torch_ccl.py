"""The pure mode's device stages against the JAX package's on the same
masks and frames: ``connected_components`` (labels equal after any number
of passes), ``_top_k_labels``, ``extract_quads``, ``extract_split_quads``,
``refit_degenerate_quads`` and ``detect_markers``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv = pytest.importorskip("cv2")

from vican_tpu.cam import Camera
from vican_tpu.geometry import SE3, rodrigues
from vican_tpu.ops import detect as JD
from vican_tpu.ops.dictionary import get_dictionary, marker_bits_table
from vican_tpu.render import look_at, make_cube_markers, render_image
from vican_torch.ops import detect as TD
from vican_torch.ops.threshold import pack_bits
from torch_threads import two_threads  # noqa: F401

ARUCO = "DICT_4X4_1000"
JPARAMS = JD.resolve_error_correction(JD.DetectorParams(), ARUCO)
PARAMS = TD.detector_params_from_jax(JPARAMS._asdict())


@pytest.fixture(autouse=True)
def _two_threads(two_threads):
    yield


def _masks(gray):
    """JAX's threshold masks (Wn, H, W) of a float32 frame."""
    g = jnp.asarray(gray, jnp.float32)
    return np.array(jnp.stack([JD.adaptive_threshold(g, w, JPARAMS.thresh_const)
                               for w in JPARAMS.win_sizes]))


@pytest.fixture(scope="module")
def frame():
    """One 640x360 view of the 24-marker cube (tests/test_torch_detect.py's)."""
    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    cam = Camera(id="0", intrinsics=K, distortion=np.zeros(12),
                 extrinsics=look_at((1.9, 0.4, 1.3), (0, 0, 1.0)),
                 resolution_x=640, resolution_y=360)
    markers = make_cube_markers()
    obj = SE3(R=rodrigues(np.array([0.4, -0.3, 0.5])), t=np.array([0.0, 0.0, 1.0]))
    bits, n = get_dictionary(ARUCO)
    tiles = {}
    for mid in markers:
        tile = np.zeros((n + 2, n + 2), np.uint8)
        tile[1:-1, 1:-1] = bits[int(mid)] * 255
        tiles[mid] = np.kron(tile, np.ones((20, 20), np.uint8))
    img = render_image(cam, {m: obj @ p for m, p in markers.items()}, tiles, 0.138)
    return np.ascontiguousarray(img[:, :, 0])


@pytest.fixture(scope="module")
def frame_labels(frame):
    """JAX's 8- and 4-connected labels of the frame's masks, 10 passes."""
    fg = _masks(frame.astype(np.float32))
    l8 = jax.vmap(lambda f: JD.connected_components(f, 10))(jnp.asarray(fg))
    l4 = jax.vmap(lambda f: JD.connected_components(f, 10, diagonal=False))(jnp.asarray(fg))
    return fg, l8, l4


@pytest.fixture(scope="module")
def close_range(tmp_path_factory):
    """tests/test_perception.py:591-627's close-range oblique scene: a camera
    near the cube, markers at 150-300 px, where extraction degenerates."""
    from vican_tpu.dataset import Dataset
    from vican_tpu.synthetic import render_cube_scene

    root = str(tmp_path_factory.mktemp("close") / "close")
    render_cube_scene(root, [(1.1, 0.15, 1.05)], 4, seed=23, res=(640, 360), marker_size=0.24)
    return [cv.imread(fn, cv.IMREAD_GRAYSCALE) for fn in Dataset(root).im_data["filename"]]


@pytest.mark.parametrize("passes", [1, 3, 10])
@pytest.mark.parametrize("diagonal", [True, False])
def test_connected_components_random_masks(passes, diagonal):
    """Seeded random masks of odd sizes, sparse and dense: labels equal,
    converged or not."""
    rng = np.random.default_rng(passes + 10 * diagonal)
    for shape in [(37, 53), (64, 81)]:
        for density in (0.3, 0.55):
            fg = rng.random(shape) < density
            ref = np.asarray(JD.connected_components(jnp.asarray(fg), passes, diagonal=diagonal))
            out = TD.connected_components(torch.from_numpy(fg), passes, diagonal=diagonal)
            assert out.dtype == torch.int32
            np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("passes", [1, 3, 10])
@pytest.mark.parametrize("diagonal", [True, False])
def test_connected_components_rendered_frame(frame, passes, diagonal):
    """The 7 threshold masks of a rendered 640x360 frame, labeled as one
    batch: labels equal to JAX's per-window labels."""
    fg = _masks(frame.astype(np.float32))
    ref = np.asarray(jax.vmap(
        lambda f: JD.connected_components(f, passes, diagonal=diagonal))(jnp.asarray(fg)))
    out = TD.connected_components(torch.from_numpy(fg), passes, diagonal=diagonal)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_unpack_masks_inverts_pack_bits():
    rng = np.random.default_rng(3)
    fg = torch.from_numpy(rng.random((2, 3, 5, 43)) < 0.4)
    np.testing.assert_array_equal(TD.unpack_masks(pack_bits(fg), 43).numpy(), fg.numpy())


def test_top_k_labels_match_jax(frame_labels):
    _, l8, _ = frame_labels
    H, W = l8.shape[-2:]
    max_area = JPARAMS.max_area_rate * H * W
    for K in (4, 16, 40):
        ref_l, ref_a = jax.vmap(lambda l: JD._top_k_labels(
            l, K, H, W, max_area=max_area, min_area=JPARAMS.min_area))(l8)
        out_l, out_a = TD._top_k_labels(torch.from_numpy(np.array(l8)), K, H, W,
                                        max_area=max_area, min_area=PARAMS.min_area)
        np.testing.assert_array_equal(out_l.numpy(), np.asarray(ref_l))
        np.testing.assert_array_equal(out_a.numpy(), np.asarray(ref_a))


def _assert_candidates_equal(ref, out):
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_extract_quads_match_jax(frame_labels):
    """Every slot of every window: labels, corners, quad and pixel areas,
    valid and re-fit flags."""
    _, l8, _ = frame_labels
    ref = jax.vmap(lambda l: JD.extract_quads(l, JPARAMS))(l8)
    out = TD.extract_quads(torch.from_numpy(np.array(l8)), PARAMS)
    assert int(np.asarray(ref.valid).sum()) >= 10
    _assert_candidates_equal(ref, out)


def test_extract_split_quads_match_jax(frame_labels):
    _, l8, l4 = frame_labels
    ref = jax.vmap(lambda a, b: JD.extract_split_quads(a, b, JPARAMS))(l8, l4)
    out = TD.extract_split_quads(torch.from_numpy(np.array(l8)),
                                 torch.from_numpy(np.array(l4)), PARAMS)
    _assert_candidates_equal(ref, out)


def test_refit_degenerate_quads_match_jax_close_range(close_range):
    """The close-range frames' merged candidates re-fit: the same valid
    set, corners within 0.5 px (measured: equal), and some re-fit
    candidates recovered."""
    @jax.jit
    def jax_refit(fg):
        l8 = jax.vmap(lambda f: JD.connected_components(f, 10))(fg)
        l4 = jax.vmap(lambda f: JD.connected_components(f, 10, diagonal=False))(fg)
        c8 = jax.vmap(lambda l: JD.extract_quads(l, JPARAMS))(l8)
        c4 = jax.vmap(lambda a, b: JD.extract_split_quads(a, b, JPARAMS))(l8, l4)
        cand = JD.QuadCandidates(*(jnp.concatenate([a, b], axis=1) for a, b in zip(c8, c4)))
        return l8, l4, cand, JD.refit_degenerate_quads(cand, l8, l4, JPARAMS)

    recovered = 0
    for img in close_range:
        l8, l4, cand, ref = jax_refit(jnp.asarray(_masks(img.astype(np.float32))))
        t8 = torch.from_numpy(np.array(l8))
        t4 = torch.from_numpy(np.array(l4))
        tc = TD.QuadCandidates(*(torch.cat([a, b], 1) for a, b in zip(
            TD.extract_quads(t8, PARAMS), TD.extract_split_quads(t8, t4, PARAMS))))
        _assert_candidates_equal(cand, tc)
        out = TD.refit_degenerate_quads(tc, t8, t4, PARAMS)
        valid = np.asarray(ref.valid)
        np.testing.assert_array_equal(out.valid.numpy(), valid)
        np.testing.assert_allclose(out.corners.numpy()[valid], np.asarray(ref.corners)[valid],
                                   rtol=0, atol=0.5)
        recovered += int((valid & ~np.asarray(cand.valid)).sum())
    assert recovered >= 1


def _jax_detect(gray):
    table = jnp.asarray(marker_bits_table(ARUCO))
    det = JD.detect_markers(jnp.asarray(gray, jnp.float32), table, 4, JPARAMS)
    keep = np.asarray(det.valid)
    return {int(i): c for i, c in zip(np.asarray(det.ids)[keep], np.asarray(det.corners)[keep])}


def _port_detect(det):
    keep = det.valid.numpy()
    return {int(i): c for i, c in zip(det.ids.numpy()[keep], det.corners.numpy()[keep])}


def test_detect_markers_matches_jax(frame, close_range):
    """The whole pure detection, one frame at a time and as a batch: the same
    ids, corners within test_torch_detect.py's refine/decode bar (1e-3 px;
    the port's quad geometry is float64)."""
    frames = [frame, close_range[1]]
    table = marker_bits_table(ARUCO)
    batch = TD.detect_markers(np.stack(frames).astype(np.float32), table, 4, PARAMS,
                              device="cpu")
    for b, img in enumerate(frames):
        ref = _jax_detect(img)
        one = _port_detect(TD.detect_markers(img.astype(np.float32), table, 4, PARAMS,
                                             device="cpu"))
        assert len(ref) >= 4
        assert set(one) == set(ref)
        for k in ref:
            np.testing.assert_allclose(one[k], ref[k], rtol=0, atol=1e-3)
        in_batch = _port_detect(TD.Detections(*(x[b] for x in batch)))
        assert set(in_batch) == set(one)
        for k in one:
            np.testing.assert_array_equal(in_batch[k], one[k])
