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
from vican_torch.ops.threshold import (CTAS_PER_SM, SEGMENT_ROWS, SMEM_LIMIT, STEP_ROWS,
                                       WIN_SIZES, _alignment, multi_threshold,
                                       multi_threshold_plain, threshold_plan)
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)


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


PLAN_SHAPES = [(1, 1, 1), (3, 1, 40), (1, 33, 517), (2, 721, 1283), (32, 720, 1280),
               (40, 720, 1280), (40, 33, 517), (1, 720, 1280), (2, 96, 256), (12, 720, 1280),
               (32, 1080, 1920)]


def _plan_coverage(plan, H, W):
    """How often threshold.cu's loops, driven by ``plan``, write each
    output pixel of one frame: CTA (band, segment) walks its rows a step of
    STEP_ROWS at a time, lane i taking row i of the step; warp j takes the
    32 columns 32 j .. 32 j + 31 of the band when they start inside the
    frame."""
    bands, segs, _ = plan.grid
    hits = np.zeros((H, W), np.int64)
    lanes = np.arange(STEP_ROWS)
    for seg in range(segs):
        ya = seg * plan.rows
        for t in range(1, plan.rows // STEP_ROWS + 1):
            y = ya + STEP_ROWS * (t - 1) + lanes
            y = y[(y < H) & (y < ya + plan.rows)]
            for band in range(bands):
                for j in range(plan.threads // 32):
                    x0 = band * plan.band + 32 * j
                    if x0 < W:
                        hits[y[:, None], np.arange(x0, min(x0 + 32, W))[None, :]] += 1
    return hits


@pytest.mark.parametrize("B,H,W", PLAN_SHAPES)
def test_threshold_plan_covers_every_pixel_once(B, H, W):
    plan = threshold_plan(B, H, W, len(WIN_SIZES), 16)
    assert plan.grid[2] == B and plan.rows % STEP_ROWS == 0
    assert (plan.grid[1] - 1) * plan.rows < H <= plan.grid[1] * plan.rows  # no empty segment
    assert plan.grid[0] * plan.band >= W > (plan.grid[0] - 1) * plan.band
    assert (_plan_coverage(plan, H, W) == 1).all()


def test_threshold_plan_takes_the_fewest_waves_times_steps():
    """At the scene's batch: 96-row segments, 1280 CTAs in 4.85 waves of
    264 (the cut with the fewest waves times steps there); at 2 x 721 x
    1283, 64-row ones (96 rows give 96 CTAs for 132 SMs, 32 rows 276 for
    264 slots: two waves); at B = 1, where no longer cut fills the SMs,
    32-row ones."""
    plan = threshold_plan(32, 720, 1280, 7, 16)
    assert plan.rows == SEGMENT_ROWS == 96 and plan.grid == (5, 8, 32)
    assert 5 * 8 * 32 >= 2 * CTAS_PER_SM * 132  # two waves and more
    assert threshold_plan(2, 721, 1283, 7, 1).grid == (6, 12, 2)
    assert threshold_plan(1, 720, 1280, 7, 16).rows == STEP_ROWS  # one wave at B = 1
    assert threshold_plan(1, 720, 1280, 7, 16, sms=40).rows == SEGMENT_ROWS


@pytest.mark.parametrize("rows", [32, 64, 96, 256, 736, 4096])
def test_threshold_plan_rows_override_covers_every_pixel_once(rows):
    plan = threshold_plan(2, 721, 1283, 7, 1, rows=rows)
    assert plan.rows == min(rows, 736) and plan.grid == (6, -(-721 // plan.rows), 2)
    assert plan.max_prefix < 2 ** 23
    assert (_plan_coverage(plan, 721, 1283) == 1).all()


@pytest.mark.parametrize("rows", [0, 48, 2 ** 16])  # 2^16 rows: column sums reach 2^23
def test_threshold_plan_rejects_a_bad_rows_override(rows):
    with pytest.raises(ValueError):
        threshold_plan(2, 721, 1283, 7, 1, rows=rows)


@pytest.mark.parametrize("B,H,W", PLAN_SHAPES)
def test_threshold_plan_resources_and_ranges(B, H, W):
    plan = threshold_plan(B, H, W, 8, 16)
    assert plan.smem <= SMEM_LIMIT and CTAS_PER_SM * (plan.smem + 1024) <= 228 * 1024
    assert plan.threads == 256 and max(plan.grid[1], plan.grid[2]) <= 65535
    # running column sums below 2^23 (exact floats by the kernel's bit
    # trick), box sums and C win^2 (|C| <= 2^13) exact in float32
    assert plan.max_prefix < 2 ** 23 and plan.max_box + 2 ** 13 * 33 ** 2 < 2 ** 24
    # every SM busy where the batch has the CTAs for it
    ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert ctas >= min(132, plan.grid[0] * B * -(-H // STEP_ROWS))


@pytest.mark.parametrize("W,offset,aligned", [
    (1280, 0, True), (1280, 1, False), (1280, 8, False), (1283, 0, False), (256, 0, True),
    (40, 0, False), (16, 0, True)])
def test_threshold_plan_picks_the_load_path(W, offset, aligned):
    """16-byte loads only where every row starts 16-byte aligned."""
    base = torch.zeros((2, 3, W + 16), dtype=torch.uint8)
    ptr = base.data_ptr() + offset
    assert threshold_plan(2, 3, W, 7, _alignment(ptr)).aligned == (aligned and
                                                                     _alignment(ptr) == 16)
    assert threshold_plan(2, 3, W, 7, 16).aligned == (W % 16 == 0)


def test_odd_storage_offset_takes_the_byte_path():
    """gray[1:] of a 2 x 721 x 1283 batch starts 721 * 1283 bytes in: odd."""
    gray = torch.zeros((2, 721, 1283), dtype=torch.uint8)[1:]
    assert gray.is_contiguous() and gray.data_ptr() % 2 == 1
    assert not threshold_plan(1, 721, 1283, 7, _alignment(gray.data_ptr())).aligned
    # gray[1:] of an aligned 1280-wide batch stays aligned (720 * 1280 % 16 == 0)
    assert threshold_plan(1, 720, 1280, 7, _alignment(16 + 720 * 1280)).aligned
    with pytest.raises(ValueError):
        threshold_plan(0, 720, 1280, 7, 16)
