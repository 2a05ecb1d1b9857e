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
