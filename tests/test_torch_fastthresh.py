"""The port's host threshold, ``vican_torch/_native/fastthresh.c``, against
its numpy stand-in, the JAX package's C module and the plain version of the
port's threshold kernel: 0 differing bytes on rendered 640x360 frames and
ragged copies of them; and ``host_candidates`` against the JAX package's."""
import numpy as np
import pytest
import torch

from vican_tpu import perception as JP
from vican_tpu.ops.detect import DetectorParams as JParams
from vican_torch import _native as tnative
from vican_torch import perception as TP
from vican_torch.ops.detect import DetectorParams, detector_params_from_jax
from vican_torch.ops.threshold import multi_threshold
from test_torch_fastccl import frames, no_native  # noqa: F401  (fixtures)
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)

SHAPES = [(360, 640), (361, 643), (7, 5)]


def _gray(frames, H, W):
    """The frames cut or edge-padded to ``(H, W)``, as one contiguous batch
    of 3 frames; seeded noise below the windows' size."""
    if H < 33:
        return np.random.default_rng(0).integers(0, 256, (3, H, W), dtype=np.uint8)
    g = frames[:3, :H, :W]
    return np.ascontiguousarray(np.pad(g, ((0, 0), (0, H - g.shape[1]), (0, W - g.shape[2])),
                                       mode="edge"))


def _c(module, g, wins, C):
    B, H, W = g.shape
    return np.stack([np.frombuffer(module.threshold_pack(np.ascontiguousarray(x), H, W,
                                                         wins, float(C)), np.uint8)
                     .reshape(len(wins), H, -(-W // 8)) for x in g])


@pytest.mark.parametrize("H,W", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_host_threshold_bytes_equal(frames, jax_native, H, W):
    """Default windows and integral C (10): the port's C module, its numpy
    stand-in, the JAX package's C module and ``multi_threshold``'s plain
    version give the same bytes, and ``host_threshold`` returns them."""
    g = _gray(frames, H, W)
    p = DetectorParams()
    wins = tuple(p.win_sizes)
    ours = _c(tnative.get_fastthresh(), g, wins, p.thresh_const)
    assert ours.shape == (len(g), len(wins), H, -(-W // 8))
    numpy_ = np.stack([TP._threshold_pack_numpy(x, wins, p.thresh_const) for x in g])
    jax_c = _c(jax_native["fastthresh"], g, wins, p.thresh_const)
    plain = multi_threshold(torch.from_numpy(g), wins, p.thresh_const).numpy()
    for other in (numpy_, jax_c, plain, TP.host_threshold(g, p)):
        assert int((ours != other).sum()) == 0
    assert ours.any() and not ours.all()


@pytest.mark.parametrize("C", [10.0, 7.5, -3.25])
def test_host_threshold_matches_jax_numpy(frames, no_native, C):
    """Without the C module ``host_threshold`` takes the numpy stand-in,
    which is the JAX package's own byte for byte, a non-integral C (the
    float64 test of fastthresh.c) included."""
    g = _gray(frames, 360, 643)
    p = DetectorParams(thresh_const=C)
    ref = np.stack([JP._threshold_pack_numpy(x, tuple(p.win_sizes), C) for x in g])
    np.testing.assert_array_equal(TP.host_threshold(g, p), ref)


@pytest.mark.parametrize("C", [7.5, -3.25])
def test_float_c_matches_jax_c(frames, jax_native, C):
    """A non-integral C: the port's and the JAX package's C modules agree
    with the numpy stand-in (all three test in float64)."""
    g = _gray(frames, 360, 643)
    wins = tuple(DetectorParams().win_sizes)
    ours = _c(tnative.get_fastthresh(), g, wins, C)
    np.testing.assert_array_equal(ours, _c(jax_native["fastthresh"], g, wins, C))
    np.testing.assert_array_equal(
        ours, np.stack([TP._threshold_pack_numpy(x, wins, C) for x in g]))


@pytest.mark.parametrize("H,W", SHAPES[:2], ids=[f"{h}x{w}" for h, w in SHAPES[:2]])
def test_host_candidates_match_jax(frames, H, W):
    """``host_candidates`` (threshold and labeler in C) equals the JAX
    package's on the same frames: quads, valid and areas exactly."""
    g = _gray(frames, H, W)
    jparams = JParams()
    ref = JP.host_candidates(g.copy(), jparams)
    out = TP.host_candidates(g, detector_params_from_jax(jparams._asdict()))
    assert TP.last_labeler == "c"
    assert out[1].sum() >= 20
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
