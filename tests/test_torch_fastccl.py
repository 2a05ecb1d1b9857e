"""The port's host labeler, ``vican_torch/_native/fastccl.c``, against the
JAX package's C labeler and against the port's scipy labeler, slot for slot
and byte for byte, on the threshold masks of rendered 640x360 frames (and
a ragged 643-column copy of them)."""
import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from vican_tpu import perception as JP
from vican_tpu.ops.detect import DetectorParams as JParams
from vican_torch import _native as tnative
from vican_torch import perception as TP
from vican_torch import render as TR
from vican_torch.ops.detect import DetectorParams, detector_params_from_jax
from vican_torch.ops.threshold import multi_threshold
from vican_tpu.render import make_cube_markers
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)
from test_torch_perception import MARKER_SIZE, _cams, _traj

WIDTHS = [640, 643]  # the frames' width, and a ragged one (W % 8 != 0)


@pytest.fixture(scope="module")
def frames():
    """6 views (3 cameras x 2 timesteps) of the 24-marker cube, 360x640."""
    return TR.render_frames(_cams(distorted_last=True), _traj(2, 11), make_cube_markers(),
                            marker_size=MARKER_SIZE, device="cpu")[0].numpy()


def _gray(frames, W):
    """The frames at width ``W``: edge columns repeated on the right."""
    return np.ascontiguousarray(np.pad(frames, ((0, 0), (0, 0), (0, W - frames.shape[2])),
                                       mode="edge"))


@pytest.fixture(scope="module", params=WIDTHS, ids=[f"W={w}" for w in WIDTHS])
def masks(frames, request):
    """``(packed (B, 7, H, ceil(W/8)), H, W)``: the port's threshold (the
    kernel's plain version) of the frames at width ``W``."""
    gray = _gray(frames, request.param)
    p = DetectorParams()
    packed = multi_threshold(torch.from_numpy(gray), p.win_sizes, p.thresh_const).numpy()
    return packed, gray.shape[1], gray.shape[2]


@pytest.fixture
def no_native(monkeypatch):
    """The port without its C modules: a fresh cache of the port's
    ``_native`` only (the JAX package's stays cached, see
    test_torch_jax_native.py)."""
    monkeypatch.setenv("VICAN_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "_cache", {})
    assert tnative.get_fastccl() is None and tnative.get_fastthresh() is None


def _slots(out):
    """(corners, areas, counts) of one labeler call."""
    return (np.frombuffer(out[0], np.float32), np.frombuffer(out[1], np.int32),
            tuple(out[2:]))


@pytest.mark.parametrize("entry", ["quad_candidates_packed2", "quad_candidates_packed"])
def test_c_labeler_matches_jax_and_scipy(masks, jax_native, entry):
    """Every (frame, window): the port's C entry point, the JAX package's
    and the port's scipy labeler give the same bytes (corners, areas, n8,
    n4; ``quad_candidates_packed`` has no split slots: scipy with K2 = 0)."""
    packed, H, W = masks
    ours, theirs = getattr(tnative.get_fastccl(), entry), getattr(jax_native["fastccl"], entry)
    p = DetectorParams()
    K, K2 = p.max_candidates, (p.max_candidates_4conn if entry.endswith("2") else 0)
    max_area = p.max_area_rate * H * W
    Wb = packed.shape[-1]
    emitted = 0
    for b in range(packed.shape[0]):
        for wi in range(packed.shape[1]):
            rows = np.ascontiguousarray(packed[b, wi])
            args = (H, W, Wb, K, K2) if K2 else (H, W, Wb, K)
            c = _slots(ours(rows, *args, p.min_area, max_area))
            j = _slots(theirs(rows.copy(), *args, p.min_area, max_area))
            fg = np.unpackbits(rows, axis=-1, bitorder="little")[:, :W]
            s = _slots(TP._candidates_scipy(fg, K, K2, p.min_area, max_area))
            if not K2:
                s = (s[0], s[1], s[2][:1])
            for a, other in ((c, j), (c, s)):
                np.testing.assert_array_equal(a[0], other[0], err_msg=f"{(b, wi)}")
                np.testing.assert_array_equal(a[1], other[1], err_msg=f"{(b, wi)}")
                assert a[2] == other[2], (b, wi)
            emitted += sum(c[2])
    assert emitted >= 50


def test_quads_from_packed_masks_matches_jax(masks):
    """The port's packed reader (C labeler, lazy re-fit unpacks) equals the
    JAX package's function exactly: quads, valid, areas."""
    packed, H, W = masks
    jparams = JParams()
    ref = JP.quads_from_packed_masks(packed.copy(), H, W, jparams)
    out = TP.quads_from_packed_masks(packed, H, W, detector_params_from_jax(jparams._asdict()))
    assert TP.last_labeler == "c"
    assert out[1].sum() >= 20
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_scipy_labeler_equals_c(masks, no_native):
    """With the C module gone, both readers take the scipy labeler and give
    the C path's bytes."""
    packed, H, W = masks
    p = DetectorParams()
    ref = JP.quads_from_packed_masks(packed.copy(), H, W, JParams())
    scipy_out = TP.quads_from_packed_masks(packed, H, W, p)
    assert TP.last_labeler == "scipy"
    for a, b in zip(scipy_out, ref):
        np.testing.assert_array_equal(a, b)


def test_quads_from_masks_c_and_scipy_agree(masks, monkeypatch):
    """The unpacked entry point: the C branch (which packs the batch for
    ``quad_candidates_batch``) and the scipy branch give the same
    candidates, and the JAX function's."""
    packed, H, W = masks
    fg = np.unpackbits(packed[:2], axis=-1, bitorder="little")[..., :W]
    p = DetectorParams()
    c_out = TP.quads_from_masks(fg, p)
    assert TP.last_labeler == "c"
    monkeypatch.setattr(TP, "_get_ccl", lambda: None)
    s_out = TP.quads_from_masks(fg, p)
    assert TP.last_labeler == "scipy"
    ref = JP.quads_from_masks(fg, JParams())
    for a, b, r in zip(c_out, s_out, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r)


# ---- the packed scan, 64 bits at a time, and the one linking sweep ----

SCAN_WIDTHS = [1280, 640, 1920, 1283, 65]  # 1283: a 161-byte row; 65: one bit past a word
SCAN_ROWS = 16
# K, K2 and areas wide enough that almost every component of the small
# masks below is emitted, and the gates see it
SCAN_P = DetectorParams(min_area=4.0, max_area_rate=1.0)
SCAN_JP = JParams(min_area=4.0, max_area_rate=1.0)
WORD_BITS = (0, 7, 8, 63, 64, 127)


def _paint(fg, y, s, e):
    """Foreground on row ``y`` over ``[s, e]``, clipped to the mask."""
    W = fg.shape[1]
    if s < W:
        fg[y, s:min(e, W - 1) + 1] = 1


def _scan_edges(W):
    """Runs that start, end or cross at bits 0, 7, 8, 63, 64 and 127 of a
    row (and at the row's last bit), alone on their rows and several to a
    row."""
    fg = np.zeros((SCAN_ROWS, W), np.uint8)
    for y, (s, e) in enumerate([(0, 0), (0, 7), (7, 8), (8, 63), (63, 64), (64, 127),
                                (127, 127), (60, 70), (120, 130), (W - 1, W - 1)]):
        _paint(fg, y, s, e)
    for s, e in [(0, 0), (7, 8), (63, 64), (127, 127), (W - 2, W - 1)]:
        _paint(fg, 11, s, e)
    for s, e in [(1, 6), (9, 62), (65, 126), (128, W - 1)]:
        _paint(fg, 13, s, e)
    return fg


def _scan_ones(W):
    """All-ones rows: a block of four, one alone, and the last row."""
    fg = np.zeros((SCAN_ROWS, W), np.uint8)
    fg[2:6] = fg[8] = fg[-1] = 1
    return fg


def _scan_singles(W):
    """Single pixels at the word edges, one or several a row, some touching
    only at a corner."""
    fg = np.zeros((SCAN_ROWS, W), np.uint8)
    for y, x in enumerate(WORD_BITS + (W - 1,)):
        _paint(fg, y, x, x)
    for x in WORD_BITS:
        _paint(fg, 9, x, x)
        _paint(fg, 10, x + 1, x + 1)
    return fg


def _scan_diagonal(W):
    """Blocks joined only at a corner across a word boundary (bits 63|64,
    127|128, and 7|8): one component 8-connected, two 4-connected."""
    fg = np.zeros((SCAN_ROWS, W), np.uint8)
    for top, bottom, s, e in [(1, 5, 54, 63), (6, 10, 64, 73), (1, 5, 118, 127),
                              (6, 10, 128, 137), (12, 13, 0, 7), (14, 15, 8, 17)]:
        for y in range(top, bottom + 1):
            _paint(fg, y, s, e)
    return fg


SCAN_MASKS = {"edges": _scan_edges, "ones": _scan_ones, "singles": _scan_singles,
              "diagonal": _scan_diagonal}


def _scan_batch(fg):
    """A (2, 2) batch of the mask and its flips, as bit-packed rows."""
    batch = np.stack([fg, fg[:, ::-1], fg[::-1], fg[::-1, ::-1]]).reshape(2, 2, *fg.shape)
    return np.ascontiguousarray(np.packbits(batch, axis=-1, bitorder="little"))


def _random_batch(density, W, seed=240):
    """A seeded (2, 3) batch of random masks, each bit foreground with
    probability ``density``."""
    fg = (np.random.default_rng(seed).random((2, 3, SCAN_ROWS, W)) < density).astype(np.uint8)
    return np.ascontiguousarray(np.packbits(fg, axis=-1, bitorder="little"))


def _gated(packed, H, W, params, threads, times=None):
    """``quad_candidates_gated_batch`` of the port over ``threads`` threads:
    ``(quads, valid, areas)``."""
    B, Wn, _, Wb = packed.shape
    Ks = params.max_candidates + params.max_candidates_4conn
    quads = np.empty((B, Wn * Ks, 4, 2), np.float32)
    areas = np.empty((B, Wn * Ks), np.float32)
    valid = np.empty((B, Wn * Ks), bool)
    stats = np.empty(len(TP.GATE_COUNTS), np.int64)
    args = [np.ascontiguousarray(packed[:, :, :H]), B, Wn, H, W, Wb, params.max_candidates,
            params.max_candidates_4conn, params.min_area, params.max_area_rate * H * W,
            params.border_margin, TP._min_hollow_side(params), quads, areas, valid, stats,
            threads]
    tnative.get_fastccl().quad_candidates_gated_batch(*args, *([] if times is None else [times]))
    return quads, valid, areas


def _assert_scan_matches(packed, H, W, jax_native, monkeypatch):
    """Every mask of ``packed``: the port's ``quad_candidates_packed2``
    gives the JAX package's module's bytes and the scipy labeler's; the
    port's gated batch at 1 and 4 threads gives the JAX package's
    ``quads_from_packed_masks`` and the scipy labeler with the numpy gates.
    Returns the candidates the 8-connected and split slots emitted."""
    monkeypatch.setattr(TP, "gate_counts", dict.fromkeys(TP.GATE_COUNTS, 0))
    p = SCAN_P
    K, K2, max_area = p.max_candidates, p.max_candidates_4conn, p.max_area_rate * H * W
    Wb = packed.shape[-1]
    fg = np.unpackbits(packed, axis=-1, bitorder="little")[..., :W]
    emitted = np.zeros(2, int)
    for b in range(packed.shape[0]):
        for wi in range(packed.shape[1]):
            rows = np.ascontiguousarray(packed[b, wi])
            args = (H, W, Wb, K, K2, p.min_area, max_area)
            c = _slots(tnative.get_fastccl().quad_candidates_packed2(rows, *args))
            j = _slots(jax_native["fastccl"].quad_candidates_packed2(rows.copy(), *args))
            s = _slots(TP._candidates_scipy(fg[b, wi], K, K2, p.min_area, max_area))
            for other in (j, s):
                np.testing.assert_array_equal(c[0], other[0], err_msg=f"{(b, wi)}")
                np.testing.assert_array_equal(c[1], other[1], err_msg=f"{(b, wi)}")
                assert c[2] == other[2], (b, wi)
            emitted += c[2]
    ref = JP.quads_from_packed_masks(packed.copy(), H, W, SCAN_JP)
    scipy_ref = TP._gated_candidates(*TP._scipy_slots(fg, p), lambda b, wi: fg[b, wi], H, W, p)
    for threads in (1, 4):
        out = _gated(packed, H, W, p, threads)
        for a, r, s in zip(out, ref, scipy_ref):
            assert a.dtype == r.dtype
            np.testing.assert_array_equal(a, r, err_msg=f"{threads} threads, jax")
            np.testing.assert_array_equal(a, s, err_msg=f"{threads} threads, scipy")
    return emitted


@pytest.mark.parametrize("W", SCAN_WIDTHS)
@pytest.mark.parametrize("name", list(SCAN_MASKS))
def test_packed_scan_on_hand_built_masks(name, W, jax_native, monkeypatch):
    """Runs at a word's edges, all-ones rows, single pixels and corner-only
    joins across a word boundary, at each of :data:`SCAN_WIDTHS`: the
    same bytes from the port's labeler, the JAX package's and the scipy
    labeler, per mask and through the gated batch at 1 and 4 threads."""
    fg = SCAN_MASKS[name](W)
    emitted = _assert_scan_matches(_scan_batch(fg), SCAN_ROWS, W, jax_native, monkeypatch)
    assert emitted[0] > 0
    if name == "diagonal":
        assert emitted[1] > 0  # the corner joins split under 4-connectivity


@pytest.mark.parametrize("W", SCAN_WIDTHS)
@pytest.mark.parametrize("density", [0.05, 0.45, 0.95])
def test_packed_scan_on_random_masks(density, W, jax_native, monkeypatch):
    """Seeded random masks at 5%, 45% and 95% foreground: the same bytes
    from the three labelers, per mask and through the gated batch."""
    emitted = _assert_scan_matches(_random_batch(density, W), SCAN_ROWS, W, jax_native,
                                   monkeypatch)
    assert emitted.sum() > 0


@pytest.mark.parametrize("W", [65, 640, 1283])
def test_bits_past_the_width_are_ignored(W, jax_native):
    """Rows wider than ``ceil(W / 8)`` bytes, with foreground in the bits
    from ``W`` on: the port's labeler reads only ``[0, W)``, as the JAX
    package's module does, and gives the bytes of the same rows with those
    bits cleared."""
    rng = np.random.default_rng(W)
    fg = (rng.random((SCAN_ROWS, W)) < 0.45).astype(np.uint8)
    clean = np.packbits(fg, axis=-1, bitorder="little")
    Wb = clean.shape[1] + 3
    dirty = np.concatenate([clean, rng.integers(0, 256, (SCAN_ROWS, 3), dtype=np.uint8)], 1)
    if W % 8:
        dirty[:, clean.shape[1] - 1] |= np.uint8((0xFF << (W % 8)) & 0xFF)
    dirty = np.ascontiguousarray(dirty)
    padded = np.ascontiguousarray(np.pad(clean, ((0, 0), (0, 3))))
    p = SCAN_P
    args = (SCAN_ROWS, W, Wb, p.max_candidates, p.max_candidates_4conn, p.min_area,
            p.max_area_rate * SCAN_ROWS * W)
    ours = tnative.get_fastccl().quad_candidates_packed2(dirty, *args)
    assert ours == jax_native["fastccl"].quad_candidates_packed2(dirty.copy(), *args)
    assert ours == tnative.get_fastccl().quad_candidates_packed2(padded, *args)
    assert sum(ours[2:]) > 0


def _numpy_runs(packed, H, W) -> int:
    """The runs of foreground in every row of every mask: the rising edges
    of the unpacked rows, each padded with a zero at both ends."""
    fg = np.unpackbits(packed[:, :, :H], axis=-1, bitorder="little")[..., :W].astype(np.int8)
    padded = np.pad(fg, [(0, 0)] * (fg.ndim - 1) + [(1, 1)])
    return int(np.count_nonzero(np.diff(padded, axis=-1) == 1))


@pytest.mark.parametrize("source", ["rendered", "random"])
def test_runs_counter_counts_the_runs(source, masks, monkeypatch):
    """The gated batch's ``runs`` (the times buffer's last entry, and the
    ``runs`` counter of ``quads_from_packed_masks``) is numpy's count of
    the runs in the batch's rows; the quads, areas and valid flags are the
    same bytes with and without the times buffer."""
    monkeypatch.setattr(TP, "gate_counts", dict.fromkeys(TP.GATE_COUNTS, 0))
    if source == "rendered":
        packed, H, W = masks
        p = DetectorParams()
    else:
        W = masks[2]
        packed, H, p = _random_batch(0.45, W, seed=W), SCAN_ROWS, SCAN_P
    want = _numpy_runs(packed, H, W)
    assert want > 1000
    without = _gated(packed, H, W, p, 3)
    times = np.full(5, -1.0)
    out = _gated(packed, H, W, p, 3, times)
    for a, b in zip(out, without):
        np.testing.assert_array_equal(a, b)
    assert times[4] == want and times[2] == 3
    counters = {}
    out = TP.quads_from_packed_masks(packed, H, W, p, counters)
    assert TP.last_labeler == "c" and counters["runs"] == want
    for a, b in zip(out, without):
        np.testing.assert_array_equal(a, b)
