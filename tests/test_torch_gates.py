"""The C gates and degenerate re-fit of perception's host candidates
(``vican_torch/_native/quad_gates.h``, reached through ``fastccl.c``'s
``quad_candidates_gated_batch`` and ``gate_candidates_batch``) against the
port's numpy ``_gated_candidates`` and the JAX package's gates
(``vican_tpu/perception.py``: ``quads_from_packed_masks``,
``_collect_window_candidates``), byte for byte on quads, valid and areas.

The inputs: the threshold masks of rendered 640x360 frames (and a ragged
643-column copy), then hand-built masks, each made to take one branch of
the re-fit, some with slots written by hand where the labeler cannot give
them (a seed in another component, a crop that never holds the component,
a float32 perimeter exactly on the outline bar).  Each case counts its
branches through the C module's counters and holds the count to what it
was built for and to the numpy re-fits' own count."""
import numpy as np
import pytest

pytest.importorskip("cv2")

from vican_tpu import perception as JP
from vican_tpu.ops.detect import DetectorParams as JParams
from vican_torch import _native as tnative
from vican_torch import perception as TP
from vican_torch.ops.detect import DetectorParams
from test_torch_fastccl import frames, masks  # noqa: F401  (fixtures)
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)

P = DetectorParams()
K, K2 = P.max_candidates, P.max_candidates_4conn
KS = K + K2


def _pack(fg: np.ndarray) -> np.ndarray:
    """A (H, W) mask as the (1, 1, H, ceil(W/8)) packed batch."""
    return np.packbits(fg[None, None].astype(bool), axis=-1, bitorder="little")


def _unpacked(packed, H, W):
    return lambda b, wi: np.unpackbits(packed[b, wi, :H], axis=-1, bitorder="little")[:, :W]


def _labeled(packed, H, W):
    """The C labeler's slots ``(quads, areas int32, counts)`` of a batch."""
    B, Wn, _, Wb = packed.shape
    quads = np.empty((B, Wn * KS, 4, 2), np.float32)
    areas = np.empty((B, Wn * KS), np.int32)
    counts = np.empty((B, Wn, 2), np.int32)
    tnative.get_fastccl().quad_candidates_batch(packed, B, Wn, H, W, Wb, K, K2, P.min_area,
                                                P.max_area_rate * H * W, quads, areas, counts)
    return quads, areas, counts


def _c_gates(packed, H, W, slots):
    """``gate_candidates_batch`` on ``slots``: ``((quads, valid, areas),
    counters)``."""
    quads, areas, counts = slots
    B, Wn, _, Wb = packed.shape
    quads = quads.copy()
    out_areas = np.empty(areas.shape, np.float32)
    valid = np.empty(areas.shape, bool)
    stats = np.empty(len(TP.GATE_COUNTS), np.int64)
    tnative.get_fastccl().gate_candidates_batch(
        packed, B, Wn, H, W, Wb, K, K2, P.min_area, P.border_margin, 4.0 * max(P.win_sizes),
        quads, areas, counts, out_areas, valid, stats)
    return (quads, valid, out_areas), dict(zip(TP.GATE_COUNTS, stats.tolist()))


def _numpy_gates(packed, H, W, slots, monkeypatch):
    """The port's ``_gated_candidates`` on ``slots`` and the outcome of each
    of its re-fits (True: a quad, False: None)."""
    refits = []
    refit = TP._refit_degenerate_quad

    def counted(*args, **kw):
        q2 = refit(*args, **kw)
        refits.append(q2 is not None)
        return q2

    with monkeypatch.context() as m:
        m.setattr(TP, "_refit_degenerate_quad", counted)
        out = TP._gated_candidates(*(a.copy() for a in slots), _unpacked(packed, H, W), H, W, P)
    return out, refits


def _jax_gates(packed, H, W, slots):
    """The JAX package's ``_collect_window_candidates`` fed ``slots``."""
    quads, areas, counts = slots
    B, Wn = counts.shape[:2]

    def extract(b, wi):
        s = slice(wi * KS, (wi + 1) * KS)
        return (quads[b, s].tobytes(), areas[b, s].tobytes(), int(counts[b, wi, 0]),
                int(counts[b, wi, 1]))

    return JP._collect_window_candidates(B, Wn, H, W, JParams(), extract, K2=K2,
                                         mask_of=_unpacked(packed, H, W))


def _assert_bytes(out, ref, what):
    for name, a, b in zip(("quads", "valid", "areas"), out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert a.tobytes() == b.tobytes(), (what, name, np.argwhere(a != b)[:5])


def _assert_counts_agree(counts, refits):
    """The C counters against the numpy re-fits: as many tried, and as many
    that gave a quad."""
    assert counts["refits"] == len(refits)
    assert counts["accepted"] + counts["rejected"] == sum(refits)
    assert counts["refits"] == (counts["accepted"] + counts["rejected"] + counts["mismatch"]
                                + counts["exhausted"] + counts["no_hull"])


def test_gated_batch_equals_numpy_and_jax(masks, monkeypatch):
    """Rendered masks: the gated batch entry (labeler, gates and re-fits in
    one call, as perception's feed runs it) equals the numpy gates on the
    labeler's slots, the JAX package's ``quads_from_packed_masks`` and the
    gates entry on the same slots; the re-fits run and agree in number."""
    packed, H, W = masks
    monkeypatch.setattr(TP, "gate_counts", dict.fromkeys(TP.GATE_COUNTS, 0))
    out = TP.quads_from_packed_masks(packed, H, W, P)
    assert (TP.last_labeler, TP.last_gates) == ("c", "c")
    slots = _labeled(np.ascontiguousarray(packed[:, :, :H]), H, W)
    ref, refits = _numpy_gates(packed, H, W, slots, monkeypatch)
    _assert_bytes(out, ref, "numpy")
    _assert_bytes(out, JP.quads_from_packed_masks(packed.copy(), H, W, JParams()), "jax")
    gated, counts = _c_gates(packed, H, W, slots)
    _assert_bytes(gated, out, "gates entry")
    assert counts == TP.gate_counts
    _assert_counts_agree(counts, refits)
    assert counts["refits"] >= 10 and counts["accepted"] >= 1 and out[1].sum() >= 20


def _polygon(H, W, pts) -> np.ndarray:
    """The pixels (integer centres) inside a polygon, even-odd rule."""
    y, x = np.mgrid[:H, :W]
    inside = np.zeros((H, W), bool)
    pts = np.asarray(pts, np.float64)
    for (x0, y0), (x1, y1) in zip(pts, np.roll(pts, -1, 0)):
        if y0 != y1:
            xc = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
            inside ^= ((y0 > y) != (y1 > y)) & (x < xc)
    return inside


def _trapezoid(H=240, W=360, x0=40, y0=40):
    """A thin trapezoid, 200 px wide and 12 rows high, as an extreme oblique
    view leaves a marker: its long side exceeds its diagonal, so the
    labeler's farthest-point corners collapse (p3 lands on p1)."""
    fg = np.zeros((H, W), bool)
    for r in range(12):
        fg[y0 + r, x0 + r * 10 // 12:x0 + 201 - r * 10 // 12] = True
    return fg


def _slots(quads, areas, n8=1, n4=0):
    """Hand-written slots of one window: quads in the first slots."""
    q = np.zeros((1, KS, 4, 2), np.float32)
    a = np.zeros((1, KS), np.int32)
    q[0, :len(quads)] = quads
    a[0, :len(areas)] = areas
    return q, a, np.array([[[n8, n4]]], np.int32)


def case_trapezoid():
    """Re-fit accepted: the hull's maximum-area quad is the trapezoid."""
    return _trapezoid(), None, dict(refits=1, accepted=1, widened=0, clamped=0)


def case_clipped_by_crop():
    """Two overlapping quadrilaterals (from a seeded search) whose labeler
    corners miss a lobe of the component by more than the 32 px margin: the
    crop widens once, then the re-fit is accepted."""
    fg = (_polygon(240, 360, [(301.0, 141.7), (278.3, 199.2), (232.1, 230.9), (274.0, 104.1)])
          | _polygon(240, 360, [(279.4, 121.5), (160.2, 17.1), (251.6, 6.2), (265.9, 28.5)]))
    return fg, None, dict(refits=1, widened=1, accepted=1)


def case_widened_three_times():
    """A degenerate slot written around the trapezoid's left end with the
    whole component's area: the crop widens at 64, 128 and 256 px before it
    holds the component, then the re-fit is accepted."""
    fg = _trapezoid(H=640, W=800, x0=300, y0=300)
    slots = _slots([[[300, 300], [300, 300], [320, 300], [310, 311]]], [int(fg.sum())])
    return fg, slots, dict(refits=1, widened=3, accepted=1, clamped=0)


def case_image_edge():
    """The trapezoid against the image's left edge: the crop stops there
    without widening, and the re-fit quad fails the border margin."""
    return (_trapezoid(x0=0), None,
            dict(refits=1, widened=0, clamped=1, rejected=1, accepted=0))


def case_split_slot():
    """The trapezoid joined to a 30 px square through one diagonal pixel
    pair: 8-connected one component, 4-connected two; the trapezoid's
    split slot is re-fit 4-connected and accepted."""
    fg = _trapezoid()
    last = np.nonzero(fg[51])[0][-1]
    fg[52:82, last + 1:last + 31] = True
    return fg, None, dict(conn4=1, accepted=1)


def case_collinear_sliver():
    """A one-pixel diagonal line of 90 pixels: its hull has 2 points, None."""
    fg = np.zeros((240, 360), bool)
    i = np.arange(90)
    fg[60 + i, 100 + i] = True
    return fg, None, dict(refits=1, no_hull=1, accepted=0)


def case_seed_elsewhere():
    """Two slots written by hand on the trapezoid's mask, both degenerate:
    one with another component's area (the seed's component is whole in
    the crop, so no widening), one whose seed pixel is background; both
    None."""
    fg = _trapezoid()
    deg = [[40, 40], [40, 40], [240, 40], [50, 51]]
    slots = _slots([deg, [[10, 10], [10, 10], [30, 10], [20, 20]]],
                   [int(fg.sum()) + 7, 100], n8=2)
    return fg, slots, dict(refits=2, mismatch=2, widened=0, accepted=0)


def case_never_held():
    """A degenerate slot inside a 700 x 1260 block with the block's area:
    every crop up to the 256 px margin is clipped, so None."""
    fg = np.zeros((720, 1280), bool)
    fg[10:710, 10:1270] = True
    slots = _slots([[[600, 300], [600, 300], [640, 300], [620, 320]]], [int(fg.sum())])
    return fg, slots, dict(refits=1, widened=3, exhausted=1)


OUTLINE_QUAD = [[240, 354], [202, 291], [186, 103], [446, 196]]
OUTLINE_AREA = 798  # the quad's float32 perimeter, exactly


def case_outline_bar():
    """A hand-written slot whose float32 perimeter lands exactly on its area
    (798) at a quad area past the outline side: the outline rule passes in
    float32, where a float64 perimeter (798.00003) would fail it."""
    fg = np.zeros((480, 640), bool)
    return fg, _slots([OUTLINE_QUAD], [OUTLINE_AREA]), dict(refits=0)


UNFUSED_QUAD = [[4367, 4739], [4370, 4740], [4373, 4741], [4377, 4742]]


def case_unfused_winding():
    """A slot that was not emitted, with collinear corners past 4096 px:
    its float32 shoelace is 0 when every product is rounded, as numpy
    rounds them, and -1 when one product of a term is fused with its
    subtraction, which would flip its winding (the gates' no-contraction
    rule, quad_gates.h)."""
    return np.zeros((8, 8), bool), _slots([UNFUSED_QUAD], [0], n8=0), dict(refits=0)


CASES = {f.__name__[5:]: f for f in (
    case_trapezoid, case_clipped_by_crop, case_widened_three_times, case_image_edge,
    case_split_slot, case_collinear_sliver, case_seed_elsewhere, case_never_held,
    case_outline_bar, case_unfused_winding)}


@pytest.mark.parametrize("name", list(CASES))
def test_hand_built_case(name, monkeypatch):
    """One hand-built mask (and slots where the labeler cannot give them):
    the C gates equal the numpy gates and the JAX package's, byte for byte,
    and take the branches the case was built for.  Where the labeler gives
    the slots, the gated batch entry, as perception's feed calls it, gives
    the same bytes and counts, and so does the JAX package's
    ``quads_from_packed_masks``."""
    fg, slots, want = CASES[name]()
    H, W = fg.shape
    packed = _pack(fg)
    labeled = slots is None
    if labeled:
        slots = _labeled(packed, H, W)
        assert slots[2].sum() >= 1
    out, counts = _c_gates(packed, H, W, slots)
    ref, refits = _numpy_gates(packed, H, W, slots, monkeypatch)
    _assert_bytes(out, ref, "numpy")
    _assert_bytes(out, _jax_gates(packed, H, W, slots), "jax")
    _assert_counts_agree(counts, refits)
    assert {k: counts[k] for k in want} == want, counts
    if labeled:
        monkeypatch.setattr(TP, "gate_counts", dict.fromkeys(TP.GATE_COUNTS, 0))
        gated = TP.quads_from_packed_masks(packed, H, W, P)
        assert TP.last_gates == "c" and TP.gate_counts == counts
        _assert_bytes(gated, out, "gated batch")
        _assert_bytes(gated, JP.quads_from_packed_masks(packed.copy(), H, W, JParams()), "jax")
    if name == "outline_bar":
        q = out[0][0, 0].astype(np.float64)
        perim64 = np.linalg.norm(np.roll(q, -1, 0) - q, axis=-1).sum()
        assert out[1][0, 0] and OUTLINE_AREA < perim64
    if name == "unfused_winding":
        assert out[0][0, 0].tolist() == UNFUSED_QUAD


def _gated_batch(packed, H, W, threads):
    """``quad_candidates_gated_batch`` over ``threads`` threads: ``((quads,
    valid, areas), counters)``."""
    B, Wn, _, Wb = packed.shape
    quads = np.empty((B, Wn * KS, 4, 2), np.float32)
    areas = np.empty((B, Wn * KS), np.float32)
    valid = np.empty((B, Wn * KS), bool)
    stats = np.empty(len(TP.GATE_COUNTS), np.int64)
    tnative.get_fastccl().quad_candidates_gated_batch(
        np.ascontiguousarray(packed[:, :, :H]), B, Wn, H, W, Wb, K, K2, P.min_area,
        P.max_area_rate * H * W, P.border_margin, 4.0 * max(P.win_sizes), quads, areas, valid,
        stats, threads)
    return (quads, valid, areas), dict(zip(TP.GATE_COUNTS, stats.tolist()))


THREADS = (1, 2, 3, 8)  # 3 does not divide P's 224 masks a batch, 8 not the rendered 42


def _assert_threads_agree(packed, H, W, monkeypatch):
    """The gated batch entry at every thread count of :data:`THREADS`: the
    one-thread bytes and counters, which are the numpy gates' on the
    labeler's slots.  Returns the one-thread counters."""
    one, counts = _gated_batch(packed, H, W, 1)
    ref, refits = _numpy_gates(packed, H, W, _labeled(packed, H, W), monkeypatch)
    _assert_bytes(one, ref, "numpy")
    _assert_counts_agree(counts, refits)
    for threads in THREADS[1:]:
        out, c = _gated_batch(packed, H, W, threads)
        _assert_bytes(out, one, f"{threads} threads")
        assert c == counts, threads
    return counts


def test_threaded_batch_equals_one_thread(masks, monkeypatch):
    """Rendered masks (6 frames x 7 windows): the same bytes and re-fit
    counts over 1, 2, 3 and 8 threads, and those of the numpy gates."""
    packed, H, W = masks
    counts = _assert_threads_agree(packed, H, W, monkeypatch)
    assert counts["refits"] >= 10 and counts["accepted"] >= 1


@pytest.mark.parametrize("name", list(CASES))
def test_threaded_batch_on_hand_built_mask(name, monkeypatch):
    """Each hand-built mask, six copies as a (2, 3) batch so that threads
    label copies at once: the same bytes and counts over 1, 2, 3 and 8
    threads, the numpy gates' on the labeler's slots, and every copy the
    same as the first."""
    fg = CASES[name]()[0]
    H, W = fg.shape
    packed = np.ascontiguousarray(np.broadcast_to(_pack(fg), (2, 3, H, -(-W // 8))))
    _assert_threads_agree(packed, H, W, monkeypatch)
    out = _gated_batch(packed, H, W, 8)[0]
    for a in out:
        rows = a.reshape(6, KS, -1)
        assert (rows == rows[:1]).all(), name


def test_threads_follow_the_affinity(masks, monkeypatch):
    """Perception hands the labeler as many threads as the process may run
    on, at most one a mask, and no setting changes that."""
    packed, H, W = masks
    monkeypatch.setattr(TP, "gate_counts", dict.fromkeys(TP.GATE_COUNTS, 0))
    monkeypatch.setattr(TP.os, "sched_getaffinity", lambda pid: {0, 2, 5})
    assert TP._host_threads(224) == 3 and TP._host_threads(2) == 2 and TP._host_threads(0) == 1
    ccl = tnative.get_fastccl()
    seen = []
    entry = ccl.quad_candidates_gated_batch

    def spy(*args):
        seen.append(args[16])  # the thread count, before the optional times buffer
        return entry(*args)

    monkeypatch.setattr(ccl, "quad_candidates_gated_batch", spy)
    out = TP.quads_from_packed_masks(packed, H, W, P)
    assert seen == [3]
    _assert_bytes(out, _gated_batch(packed, H, W, 1)[0], "perception")
    with pytest.raises(ValueError, match="threads"):
        _gated_batch(packed, H, W, 0)


def test_the_times_buffer_leaves_bytes_and_counters_alone(masks, monkeypatch):
    """The optional times buffer of the gated batch entry: the same bytes
    and re-fit counters as without it, the threads' ticks in the labeler
    and in the gates, no more than the threads times the call's own ticks,
    the threads that ran and the runs labeled; through
    ``quads_from_packed_masks(counters=...)``, :data:`gate_counts` keeps its
    keys and adds the same values as a call without counters."""
    packed, H, W = masks
    B, Wn, _, Wb = packed.shape
    without, counts = _gated_batch(packed, H, W, 3)
    quads = np.empty((B, Wn * KS, 4, 2), np.float32)
    areas = np.empty((B, Wn * KS), np.float32)
    valid = np.empty((B, Wn * KS), bool)
    stats = np.empty(len(TP.GATE_COUNTS), np.int64)
    times = np.full(5, -1.0)
    tnative.get_fastccl().quad_candidates_gated_batch(
        np.ascontiguousarray(packed[:, :, :H]), B, Wn, H, W, Wb, K, K2, P.min_area,
        P.max_area_rate * H * W, P.border_margin, 4.0 * max(P.win_sizes), quads, areas, valid,
        stats, 3, times)
    _assert_bytes((quads, valid, areas), without, "with times")
    assert dict(zip(TP.GATE_COUNTS, stats.tolist())) == counts
    assert times[0] > 0 and times[1] > 0 and times[2] == 3
    assert times[0] + times[1] <= 3 * times[3]
    assert times[4] >= B * Wn
    with pytest.raises(ValueError, match="times"):
        tnative.get_fastccl().quad_candidates_gated_batch(
            np.ascontiguousarray(packed[:, :, :H]), B, Wn, H, W, Wb, K, K2, P.min_area,
            P.max_area_rate * H * W, P.border_margin, 4.0 * max(P.win_sizes), quads, areas,
            valid, stats, 3, np.empty(4))

    added = []
    for counters in (None, {}):
        monkeypatch.setattr(TP, "gate_counts", dict.fromkeys(TP.GATE_COUNTS, 0))
        out = TP.quads_from_packed_masks(packed, H, W, P, counters)
        assert list(TP.gate_counts) == list(TP.GATE_COUNTS)
        added.append(dict(TP.gate_counts))
        _assert_bytes(out, without, "perception")
    assert added[0] == added[1] == counts
    assert set(counters) == {"labeler_s", "gates_s", "threads", "runs"}
    assert counters["runs"] == times[4]
    assert counters["threads"] == TP._host_threads(B * Wn)
