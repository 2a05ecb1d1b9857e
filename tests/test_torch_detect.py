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


def _jax_detect(frame, quads, valid, areas, jparams, table):
    """The JAX package's refine, decode and dedup of one frame's candidates
    (``_build_hybrid``'s per-image program): ``Detections`` as numpy."""
    g = jnp.asarray(frame[0], jnp.float32)

    @jax.jit
    def ref(q, v, a):
        refined = jax.vmap(lambda qq: JD.refine_quad(g, qq, jparams))(q)
        ids, _, corners, ok = JD.decode_quads(g, refined, v, jnp.asarray(table), 4, jparams)
        return JD.dedup_and_compact(corners, ids, ok, a, jparams)

    return [np.asarray(x) for x in ref(quads[0], valid[0], areas[0])]


@pytest.mark.parametrize("refine", ["apriltag", "subpix", "none"])
def test_detect_candidates_plain_uint8_matches_float32_and_jax(frame, candidates, refine):
    """``detect_candidates_plain`` on the uint8 frame equals the float32
    call exactly (a grey level cast to float64 is the same either way), and
    the JAX package's program at the bars of
    ``test_refine_decode_dedup_match_jax``."""
    _, (quads, valid, areas) = candidates
    jparams = JD.resolve_error_correction(JD.DetectorParams(corner_refine=refine), ARUCO)
    params = TD.detector_params_from_jax(jparams._asdict())
    table = JDict.marker_bits_table(ARUCO)
    codes = TD.dictionary_codes(table)
    u8 = TD.detect_candidates_plain(torch.from_numpy(frame), quads, valid, areas, codes, 4,
                                    params)
    f32 = TD.detect_candidates_plain(torch.from_numpy(frame).float(), quads, valid, areas,
                                     codes, 4, params)
    for a, b in zip(u8, f32):
        assert a.dtype == b.dtype and torch.equal(a, b)
    j_corners, j_ids, j_valid, _ = _jax_detect(frame, quads, valid, areas, jparams, table)
    keep = j_valid[None]
    assert keep.sum() >= 4
    np.testing.assert_array_equal(u8.valid.numpy(), keep)
    np.testing.assert_array_equal(u8.ids.numpy()[keep], j_ids[None][keep])
    np.testing.assert_allclose(u8.corners.numpy()[keep], j_corners[None][keep], rtol=0, atol=1e-3)


def test_detect_candidates_on_cpu_is_the_plain_version(frame, candidates):
    """The wrapper on CPU tensors (and numpy candidates) returns the plain
    version's Detections and launches nothing."""
    _, (quads, valid, areas) = candidates
    params = TD.resolve_error_correction(TD.DetectorParams(), ARUCO)
    codes = TD.dictionary_codes(TDict.marker_bits_table(ARUCO))
    gray = torch.from_numpy(frame)
    before = TD.detect_candidates.launches
    out = TD.detect_candidates(gray, quads, valid, areas, codes, 4, params)
    ref = TD.detect_candidates_plain(gray, torch.from_numpy(quads), torch.from_numpy(valid),
                                     torch.from_numpy(areas), codes, 4, params)
    assert TD.detect_candidates.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out.corners.shape == (1, params.max_detections, 4, 2) and out.valid.sum() >= 4


def test_batch_without_candidates(frame, candidates):
    """A batch with no valid slot: nothing to refine or decode, every
    output slot not valid with zero corners and ids, the areas as scores in
    slot order, as the JAX package's program keeps none."""
    _, (quads, valid, areas) = candidates
    none = np.zeros_like(valid)
    jparams = JD.resolve_error_correction(JD.DetectorParams(), ARUCO)
    params = TD.detector_params_from_jax(jparams._asdict())
    table = JDict.marker_bits_table(ARUCO)
    out = TD.detect_candidates(torch.from_numpy(frame), quads, none, areas,
                               TD.dictionary_codes(table), 4, params)
    D = params.max_detections
    assert not out.valid.any() and not out.ids.any() and not out.corners.any()
    np.testing.assert_array_equal(out.score.numpy(), areas[:, :D])
    assert not _jax_detect(frame, quads, none, areas, jparams, table)[2].any()


def test_detect_candidates_checks_its_inputs(frame, candidates):
    """A dtype, shape or device the kernel does not take raises on every
    device, before any work."""
    _, (quads, valid, areas) = candidates
    params = TD.resolve_error_correction(TD.DetectorParams(), ARUCO)
    codes = TD.dictionary_codes(TDict.marker_bits_table(ARUCO))
    gray = torch.from_numpy(frame)
    q, v, a = (torch.from_numpy(x) for x in (quads, valid, areas))
    meta = torch.device("meta")
    bad = {
        "gray int16": (gray.to(torch.int16), q, v, a, codes),
        "gray float32": (gray.float(), q, v, a, codes),
        "gray (H, W)": (gray[0], q, v, a, codes),
        "quads float64": (gray, q.double(), v, a, codes),
        "quads (B, Q, 8)": (gray, q.reshape(1, -1, 8), v, a, codes),
        "valid uint8": (gray, q, v.to(torch.uint8), a, codes),
        "areas float64": (gray, q, v, a.double(), codes),
        "areas of other slots": (gray, q, v, a[:, :-1], codes),
        "two frames of candidates": (gray, q.repeat(2, 1, 1, 1), v.repeat(2, 1), a.repeat(2, 1),
                                     codes),
        "codes int32": (gray, q, v, a, codes.int()),
        "codes (size, 4)": (gray, q, v, a, codes.reshape(-1, 4)),
        "quads on another device": (gray, q.to(meta), v, a, codes),
        "codes on another device": (gray, q, v, a, codes.to(meta)),
    }
    for args in bad.values():
        with pytest.raises(ValueError, match="detect_candidates"):
            TD.detect_candidates(*args, 4, params)
    with pytest.raises(ValueError, match="corner_refine"):
        TD.detect_candidates(gray, q, v, a, codes, 4, params._replace(corner_refine="sharp"))


def test_detect_tables_are_the_plain_versions_values():
    """detect.cu's tables hold, in order, the values the plain version
    computes: the edge fit's sample positions and offsets, the
    cornerSubPix weights row by row, the decode positions at frac 1 and
    0.5."""
    p = TD.DetectorParams(refine_samples=7, refine_offsets=3, subpix_win=2, decode_samples=4)
    tab = TD.detect_tables(p, "cpu")
    ts, offs = TD._edge_probes(7, 3, torch.float64, "cpu")
    w = TD._subpix_window(2, torch.float64, "cpu")[2]
    want = torch.cat([ts, offs, w.reshape(-1), TD._decode_positions(4, 1.0, torch.float64, "cpu"),
                      TD._decode_positions(4, 0.5, torch.float64, "cpu")])
    assert tab.dtype == torch.float64 and torch.equal(tab, want)
    assert tab.numel() == 7 + 3 + 25 + 4 + 4
    np.testing.assert_allclose(offs.numpy(), [-1.0, 0.0, 1.0])
    np.testing.assert_allclose(TD._decode_positions(4, 0.5, torch.float64, "cpu").numpy(),
                               0.25 + 0.5 * (np.arange(4) + 0.5) / 4)
    assert TD.detect_tables(p, "cpu") is tab
    assert set(TD.REFINE_KINDS) == {"apriltag", "subpix", "none"}


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
