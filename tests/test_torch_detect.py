"""The port's detection stages (host candidates, refine, decode, dedup) on
one rendered 640x360 frame, fed the JAX package's candidates, against the
JAX package's functions; and the tables and parameters they share."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv = pytest.importorskip("cv2")

from vican_tpu import perception as JPc
from vican_tpu.cam import Camera
from vican_tpu.geometry import SE3, rodrigues
from vican_tpu.ops import detect as JD
from vican_tpu.ops import dictionary as JDict
from vican_tpu.render import look_at, make_cube_markers, render_image
from vican_torch import perception as TPc
from vican_torch.ops import detect as TD
from vican_torch.ops import dictionary as TDict
from vican_torch.ops.threshold import multi_threshold
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)

ARUCO = "DICT_4X4_1000"


@pytest.fixture(scope="module")
def frame():
    """One 640x360 view of the 24-marker cube (vican_tpu.render)."""
    from vican_tpu.ops.dictionary import get_dictionary

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
    return np.ascontiguousarray(img[None, :, :, 0])


@pytest.fixture(scope="module")
def candidates(frame):
    params = JD.DetectorParams()
    packed = multi_threshold(torch.from_numpy(frame), params.win_sizes,
                             params.thresh_const).numpy()
    return packed, JPc.quads_from_packed_masks(packed.copy(), 360, 640, params)


def test_candidates_equal(candidates):
    packed, (quads, valid, areas) = candidates
    params = TD.detector_params_from_jax(JD.DetectorParams()._asdict())
    q, v, a = TPc.quads_from_packed_masks(packed, 360, 640, params)
    assert v.sum() >= 10
    np.testing.assert_array_equal(v, valid)
    np.testing.assert_array_equal(q, quads)
    np.testing.assert_array_equal(a, areas)


@pytest.mark.parametrize("refine", ["apriltag", "subpix", "none"])
def test_refine_decode_dedup_match_jax(frame, candidates, refine):
    _, (quads, valid, areas) = candidates
    jparams = JD.resolve_error_correction(JD.DetectorParams(corner_refine=refine), ARUCO)
    params = TD.detector_params_from_jax(jparams._asdict())
    table = JDict.marker_bits_table(ARUCO)
    g = jnp.asarray(frame[0], jnp.float32)

    @jax.jit
    def ref(q, v, a):
        refined = jax.vmap(lambda qq: JD.refine_quad(g, qq, jparams))(q)
        ids, _, corners, ok = JD.decode_quads(g, refined, v, jnp.asarray(table), 4, jparams)
        return refined, JD.dedup_and_compact(corners, ids, ok, a, jparams)

    j_refined, j_det = ref(quads[0], valid[0], areas[0])

    gray = torch.from_numpy(frame).float()
    q = torch.from_numpy(quads[0]).double()
    bi = torch.zeros(len(q), dtype=torch.int64)
    refined = TD.refine_quad(gray, bi, q, params)
    ids, _, corners, ok = TD.decode_quads(gray, bi, refined, torch.from_numpy(valid[0]),
                                          TD.dictionary_codes(table), 4, params)
    det = TD.dedup_and_compact(corners[None], ids[None], ok[None],
                               torch.from_numpy(areas), params)
    keep = np.asarray(j_det.valid)
    assert keep.sum() >= 4
    np.testing.assert_allclose(refined.numpy()[valid[0]], np.asarray(j_refined)[valid[0]],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(det.valid[0].numpy(), keep)
    np.testing.assert_array_equal(det.ids[0].numpy()[keep], np.asarray(j_det.ids)[keep])
    np.testing.assert_allclose(det.corners[0].numpy()[keep], np.asarray(j_det.corners)[keep],
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("aruco", ["DICT_4X4_1000", "DICT_5X5_250", "DICT_6X6_50",
                                   "DICT_7X7_100"])
def test_dictionary_tables_equal(aruco):
    np.testing.assert_array_equal(TDict.marker_bits_table(aruco),
                                  JDict.marker_bits_table(aruco))
    assert TDict.max_correction_bits(aruco) == JDict.max_correction_bits(aruco)
    # packed words give the elementwise compare's Hamming distances
    table = TDict.marker_bits_table(aruco)
    codes = TD.dictionary_codes(table)
    word = table[3, 2]
    n = word.shape[0]
    w = int((word.astype(np.int64) << np.arange(n)).sum())
    ref = (word[None, None] != table).sum(-1).reshape(-1)
    np.testing.assert_array_equal(TD._popcount(codes ^ w).numpy(), ref)


@pytest.mark.parametrize("brightness,contrast", [(0.0, 0.0), (12.0, -20.0), (-30.0, 45.0)])
def test_preprocess_matches_jax(brightness, contrast):
    rng = np.random.default_rng(1)
    for shape in ((2, 9, 11, 3), (9, 11)):
        im = rng.integers(0, 256, shape).astype(np.uint8)
        ref = np.asarray(JD.preprocess(jnp.asarray(im), brightness, contrast))
        out = TD.preprocess(torch.from_numpy(im), brightness, contrast).numpy()
        np.testing.assert_array_equal(out, ref)


def test_detector_params_from_jax():
    jp = JD.DetectorParams(thresh_const=7.0, max_detections=12, corner_refine="subpix",
                           use_pallas_threshold=True, roi_tiers=(64,), mask_tile_rate=0.5,
                           ccl_passes=4, refit_rows=64)
    p = TD.detector_params_from_jax(jp._asdict())
    for f in TD.DetectorParams._fields:
        assert getattr(p, f) == getattr(jp, f), f
    # transport fields are dropped, every other one carries over, the pure
    # mode's among them
    assert set(jp._fields) - set(p._fields) == {
        "use_pallas_threshold", "roi_matmul_sampling", "roi_tiers", "roi_margin",
        "mask_tile_rate"}
    assert (p.ccl_passes, p.refit_rows, p.max_refit_candidates) == (4, 64, 6)
    assert TD.detector_params_from_jax(JD.DetectorParams()._asdict()) == TD.DetectorParams()
    with pytest.raises(ValueError, match="unknown"):
        TD.detector_params_from_jax({**jp._asdict(), "no_such_field": 1})
