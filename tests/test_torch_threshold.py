"""The port's multi-window threshold (``vican_torch.ops.threshold``) against
the JAX package: the plain version is exact against ``adaptive_threshold``
and against the device mode's packed masks, and within the Pallas
kernel's own agreement bar of the interpret-mode kernel."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vican_tpu.ops.detect import DetectorParams, adaptive_threshold
from vican_tpu.ops.pallas.threshold import multi_threshold as jax_multi_threshold
from vican_tpu.perception import _build_threshold
from vican_torch.ops.threshold import WIN_SIZES, multi_threshold, multi_threshold_plain


def _marker_frame():
    """A (144, 256) frame with one dictionary marker (a 60 px tile)."""
    from vican_torch.ops.dictionary import get_dictionary

    bits, _ = get_dictionary("DICT_4X4_1000")
    tile = np.zeros((6, 6), np.uint8)
    tile[1:-1, 1:-1] = bits[7] * 255
    img = np.full((144, 256), 170, np.uint8)
    img[30:90, 60:120] = np.kron(tile, np.ones((10, 10), np.uint8))
    return img


def _frames(shape):
    if shape == "marker":
        return _marker_frame()[None]
    rng = np.random.default_rng(sum(shape))
    return rng.integers(0, 256, (2, *shape)).astype(np.uint8)


def _unpack(packed, W):
    return np.unpackbits(packed, axis=-1, bitorder="little")[..., :W].astype(bool)


@pytest.mark.parametrize("shape", [(96, 256), (73, 130), "marker"])
@pytest.mark.parametrize("C", [10.0, 7.5])
def test_plain_equals_adaptive_threshold_stack(shape, C):
    gray = _frames(shape)
    out = multi_threshold_plain(torch.from_numpy(gray), WIN_SIZES, C).numpy()
    ref = np.stack([
        np.stack([np.asarray(adaptive_threshold(jnp.asarray(g, jnp.float32), w, C))
                  for w in WIN_SIZES]) for g in gray])
    assert out.shape == (len(gray), len(WIN_SIZES), gray.shape[1], -(-gray.shape[2] // 8))
    np.testing.assert_array_equal(_unpack(out, gray.shape[2]), ref)
    # bits of the columns past W are zero
    np.testing.assert_array_equal(np.unpackbits(out, axis=-1, bitorder="little")
                                  [..., gray.shape[2]:], 0)


@pytest.mark.parametrize("shape", [(96, 256), (73, 130), "marker"])
def test_packed_equals_device_mode_program(shape):
    gray = _frames(shape)
    B, H, W = gray.shape
    packed, _ = _build_threshold(B, H, W, DetectorParams(), use_pallas=False)(jnp.asarray(gray))
    np.testing.assert_array_equal(multi_threshold(torch.from_numpy(gray)).numpy(),
                                  np.asarray(packed))


def test_agrees_with_the_interpret_mode_kernel():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (96, 256)).astype(np.uint8)
    ref = np.asarray(jax_multi_threshold(jnp.asarray(img, jnp.float32), WIN_SIZES, 10.0,
                                         interpret=True)) > 0.5
    out = _unpack(multi_threshold(torch.from_numpy(img[None])).numpy()[0], 256)
    # the TPU kernel multiplies by the reciprocal and may differ at exact
    # ties (tests/test_pallas.py:18); the port follows adaptive_threshold
    assert (out == ref).mean() > 0.999


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        multi_threshold(torch.zeros((2, 8, 8), dtype=torch.float32))
    with pytest.raises(ValueError):
        multi_threshold(torch.zeros((1, 8, 8), dtype=torch.uint8), win_sizes=(3, 35))
    before = multi_threshold.launches
    multi_threshold(torch.zeros((1, 8, 8), dtype=torch.uint8))
    assert multi_threshold.launches == before  # the CPU takes the plain version
