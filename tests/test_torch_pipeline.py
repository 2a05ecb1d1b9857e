"""Perception's feed/drain pipeline (``vican_torch.perception._edges``, the
port of vican_tpu/perception.py:1725-1758) on the CPU: the port's pipelined
``estimate_pose_mp`` against the JAX package's on the same files, every
pipeline depth against the default one, errors raised from the worker, the
C labeler's batch entry point against its per-window calls and the JAX
package's module, the lock around the port's C builds, and the timer's
stages."""
import copy
import os
import sys
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from vican_tpu.cam import estimate_pose_mp
from vican_tpu.dataset import Dataset
from vican_tpu.render import make_cube_markers, render_dataset
from vican_torch import _native as tnative
from vican_torch import cam as TC
from vican_torch import perception as TP
from vican_torch.ops.detect import DetectorParams
from vican_torch.ops.threshold import multi_threshold
from vican_torch.utils import PhaseTimer
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)
from test_torch_perception import (KW, MARKER_SIZE, _assert_identical_edges,
                                   _assert_same_edges, _cams, _decode_threads, _jpegs,
                                   _port_cams, _traj)
from torch_threads import two_threads  # noqa: F401

DRAIN = {"wait for feed", "detect program", "PnP", "dict"}


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """3 cameras (one with the 12-coefficient distortion) x 2 timesteps at
    640x360, rendered to JPEGs by vican_tpu.render (the recipe of
    tests/test_torch_perception.py)."""
    root = str(tmp_path_factory.mktemp("render") / "ds")
    render_dataset(root, _cams(distorted_last=True), _traj(2, 3), make_cube_markers(),
                   marker_size=MARKER_SIZE, marker_px=120)
    return Dataset(root)


def _port(rendered, **kw):
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    return TC.estimate_pose_mp(files, cams, marker_ids=None, device="cpu", **dict(KW, **kw))


@pytest.mark.parametrize("mode", ["device", "host", "pure"])
def test_pipelined_port_matches_pipelined_jax(rendered, mode, two_threads):
    """Batches of 2 (three batches, more than the default depth of 2): the
    port's pipeline and the JAX package's give the same edges in the same
    order, within the bars of the perception tests."""
    files, cams = rendered.im_data["filename"], rendered.im_data["cam"]
    ref = estimate_pose_mp(files, cams, pipeline_mode=mode, marker_ids=None,
                           **dict(KW, batch_size=2))
    out = _port(rendered, pipeline_mode=mode, batch_size=2)
    _assert_same_edges(ref, out)
    assert list(out) == list(ref)


@pytest.fixture(scope="module")
def default_depth(rendered):
    """The port's edges at the default depth, per batch size."""
    return {bs: _port(rendered, batch_size=bs) for bs in (1, 4, 8)}


@pytest.mark.parametrize("depth", ["1", "2", "5"])
@pytest.mark.parametrize("batch_size", [1, 4, 8], ids=["6 batches", "2 batches", "1 batch"])
def test_every_depth_gives_identical_edges(rendered, default_depth, monkeypatch, depth,
                                           batch_size):
    """Depths 1, 2 and 5 over 6, 2 and 1 batches (more, as many and fewer
    batches than the depth): the same dict, key for key and bit for bit,
    as the default depth."""
    monkeypatch.setenv("VICAN_TPU_PIPELINE_DEPTH", depth)
    assert TP._pipeline_depth() == int(depth)
    out = _port(rendered, batch_size=batch_size)
    assert len(out) > 10
    _assert_identical_edges(default_depth[batch_size], out)


@pytest.mark.parametrize("value,depth", [(None, 2), ("", 2), ("0", 2), ("-3", 1), ("7", 7)])
def test_pipeline_depth_reads_the_jax_variable(monkeypatch, value, depth):
    """``VICAN_TPU_PIPELINE_DEPTH`` as vican_tpu/perception.py:1739 reads
    it: unset, empty or 0 is the default 2, anything below 1 is 1."""
    if value is None:
        monkeypatch.delenv("VICAN_TPU_PIPELINE_DEPTH", raising=False)
    else:
        monkeypatch.setenv("VICAN_TPU_PIPELINE_DEPTH", value)
    assert TP._pipeline_depth() == depth


def _feed_threads():
    return [t for t in threading.enumerate() if t.name.startswith("vican-feed")]


@pytest.mark.parametrize("source", ["array", "frames", "gray files"])
@pytest.mark.parametrize("nb,B,world,rank", [(5, 5, 1, 0), (3, 5, 1, 0), (5, 6, 2, 0),
                                             (5, 6, 2, 1), (3, 6, 3, 1), (2, 6, 3, 2)],
                         ids=["whole batch", "tail pad", "rank share", "rank share, padded",
                              "rank share, one real frame", "rank share, all pad"])
def test_a_batch_assembled_into_a_given_buffer_has_the_old_bytes(tmp_path, source, nb, B,
                                                                 world, rank):
    """A batch of ``nb`` frames (from an array, as a slice of it; from a
    sequence of frames; or gray files, decoded on a pool and handed on as
    the rank's share of the decoded batch) written into a given buffer
    (``perception._share`` of the batch, then ``_assemble``) has the bytes
    of the code before it: the slice, ``torch.stack`` or decode of the
    frames, padded to ``B`` with copies of the last by ``np.concatenate``,
    then the rank's ``B / world`` rows; and every byte of the buffer is
    written."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(nb + 10 * B + 100 * rank)
    capture = rng.integers(0, 256, (9, 6, 7), dtype=np.uint8)
    idx = list(range(2, 2 + nb))
    if source == "array":
        old = capture[idx[0]:idx[-1] + 1]
    elif source == "frames":
        frames = [torch.as_tensor(f) for f in capture]
        old = torch.stack([frames[i] for i in idx]).numpy()
    else:
        files = [str(tmp_path / f"{i}.png") for i in idx]
        for i, f in zip(idx, files):
            cv2.imwrite(f, capture[i])
        with ThreadPoolExecutor(2) as pool:
            decoded = TP._decode_batch(pool, files, True)
        old = capture[idx[0]:idx[-1] + 1]
    old = np.concatenate([old, np.repeat(old[-1:], B - nb, axis=0)])
    Bs = B // world
    old = old[rank * Bs:(rank + 1) * Bs]
    share = TP._share(nb, rank * Bs, Bs)
    ids = idx[share]
    given = torch.full((Bs, 6, 7), 7, dtype=torch.uint8)
    if source == "array":
        out = TP._assemble(capture[ids[0]:ids[-1] + 1], given)
    elif source == "frames":
        out = TP._assemble([frames[i] for i in ids], given)
    else:
        out = TP._assemble(decoded[share], given)
    assert out is given
    np.testing.assert_array_equal(given.numpy(), old)


@pytest.mark.parametrize("brightness,contrast", [(-150, 120), (30, -40)])
@pytest.mark.parametrize("nb,B,world,rank", [(5, 5, 1, 0), (3, 5, 1, 0), (5, 6, 2, 0),
                                             (5, 6, 2, 1), (3, 6, 3, 1), (2, 6, 3, 2)],
                         ids=["whole batch", "tail pad", "rank share", "rank share, padded",
                              "rank share, one real frame", "rank share, all pad"])
def test_the_decode_tasks_write_the_preprocessed_bytes(tmp_path, nb, B, world, rank,
                                                       brightness, contrast):
    """Colour JPEG files decoded on a pool with the preprocess in each
    file's task (``perception._decode_gray`` into the rank's rows of a given
    batch, then ``_pad``): the bytes of ``host_preprocess(load_images(files),
    b, c)`` padded to ``B`` with copies of the last frame, the rank's
    ``B / world`` rows, and those of the JAX package's ``host_preprocess``
    of the same decode; every byte of the batch written, on a pool of more
    threads than cores; ``table_frames`` counts the rank's frames, the
    other files only decoded."""
    from concurrent.futures import ThreadPoolExecutor

    from vican_tpu.perception import host_preprocess as jax_preprocess

    files = _jpegs(str(tmp_path), [(40, 56)] * nb)
    decoded = TP.load_images(files)
    ref = TP.host_preprocess(decoded, float(brightness), float(contrast))
    np.testing.assert_array_equal(ref, jax_preprocess(decoded, float(brightness),
                                                      float(contrast)))
    ref = np.concatenate([ref, np.repeat(ref[-1:], B - nb, axis=0)])
    Bs = B // world
    ref = ref[rank * Bs:(rank + 1) * Bs]
    share = TP._share(nb, rank * Bs, Bs)
    table = TP._contrast_brightness(np.arange(256, dtype=np.uint8), float(brightness),
                                    float(contrast))
    given = torch.full((Bs, 40, 56), 7, dtype=torch.uint8)
    counts = {}
    # more threads than cores, switching every microsecond
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(2 * len(os.sched_getaffinity(0)) + 1) as pool:
            shape, frames = TP._decode_gray(pool, files, table, share, given.numpy(), counts)
    finally:
        sys.setswitchinterval(interval)
    assert shape == (40, 56, 3)
    assert counts["table_frames"] == len(frames) == len(range(nb)[share])
    assert counts["files"] == nb
    assert all(np.shares_memory(f, given.numpy()) for f in frames)
    assert TP._pad(given, len(frames)) is given
    np.testing.assert_array_equal(given.numpy(), ref)


@pytest.mark.parametrize("probe", ["declared", "probed", "probed wrong"])
@pytest.mark.parametrize("brightness,contrast", [(-150, 120), (-10, 10)])
@pytest.mark.parametrize("batch_size", [2, 4], ids=["3 batches", "padded tail"])
def test_colour_files_give_the_edges_of_their_preprocessed_frames(rendered, monkeypatch,
                                                                  batch_size, brightness,
                                                                  contrast, probe):
    """The file entry with a brightness and a contrast gives, key for key
    and bit for bit, ``estimate_pose_gray`` of ``host_preprocess(
    load_images(files), b, c)``: with declared resolutions, with sizes
    probed from the files, and with a probe that reads another size than
    the decode (its batches restacked at the decoded size)."""
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    kw = dict(KW, batch_size=batch_size)
    del kw["brightness"], kw["contrast"]
    gray = TP.host_preprocess(TP.load_images(files), float(brightness), float(contrast))
    ref = TP.estimate_pose_gray(gray, files, cams, device="cpu", **kw)
    if probe != "declared":
        cams = [copy.copy(c) for c in cams]
        for c in cams:
            c.resolution_x = c.resolution_y = None
    if probe == "probed wrong":
        monkeypatch.setattr(TP, "_probe_image_size", lambda fn: (352, 648))
    timer = PhaseTimer(verbose=False, device="cpu")
    out = TP.estimate_pose_batched(files, cams, device="cpu", timer=timer,
                                   brightness=brightness, contrast=contrast, **kw)
    assert len(ref) > 5
    _assert_identical_edges(ref, out)
    assert {(e["height"], e["width"]) for e in timer.events if e["name"] == "upload"} == {
        (360, 640)}


def test_wrong_resolution_raises_from_the_worker(rendered):
    """Cameras that declare 320x180 for 640x360 files: the feed thread's
    check raises the JAX package's ValueError, message and all, from the
    call, and leaves no feed thread behind."""
    files = rendered.im_data["filename"]
    cams = [copy.copy(c) for c in rendered.im_data["cam"]]
    for c in cams:
        c.resolution_x, c.resolution_y = 320, 180
    with pytest.raises(ValueError, match="declares resolution 320x180") as ref:
        estimate_pose_mp(files, cams, marker_ids=None, **dict(KW, batch_size=2))
    with pytest.raises(ValueError, match="declares resolution 320x180") as out:
        TC.estimate_pose_mp(files, _port_cams(cams), marker_ids=None, device="cpu",
                            **dict(KW, batch_size=2))
    assert str(out.value) == str(ref.value)
    assert not _feed_threads()


def test_missing_file_raises_from_the_worker(rendered):
    """A missing file in the third batch (the first two already fed and
    drained) raises FileNotFoundError from the call, as in the JAX
    package, and no feed or decode thread is left."""
    files = list(rendered.im_data["filename"])
    files[5] = os.path.join(os.path.dirname(files[5]), "missing.jpg")
    cams = rendered.im_data["cam"]
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        estimate_pose_mp(files, cams, marker_ids=None, **dict(KW, batch_size=2))
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        TC.estimate_pose_mp(files, _port_cams(cams), marker_ids=None, device="cpu",
                            **dict(KW, batch_size=2))
    assert not _feed_threads()
    assert not _decode_threads()


def test_timer_events_carry_their_stage(rendered):
    """Every perception phase is a ``feed`` or a ``drain`` event with its
    start; both stages appear, each with its own phases (the decode, the
    host candidates, the C labeler with its gates, run on the feed alone;
    the wait for the feed on the drain)."""
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    timer = PhaseTimer(verbose=False, device="cpu")
    TP.estimate_pose_batched(files, cams, device="cpu", timer=timer, **dict(KW, batch_size=2))
    stages = {}
    for e in timer.events:
        stages.setdefault(e["stage"], set()).add(e["name"])
        assert e["start"] > 0 and e["seconds"] >= 0
    assert set(stages) == {"feed", "drain"}
    assert stages["feed"] == {"decode", "upload", "threshold kernel", "masks to host",
                              "host candidates", "candidates upload"}
    assert stages["drain"] == DRAIN
    assert sum(e["name"] == "dict" for e in timer.events) == 3


@pytest.mark.parametrize("labeler", ["c", "scipy"])
def test_every_batch_records_its_spans_and_counters(rendered, monkeypatch, labeler, two_threads):
    """The file entry over three batches of 2, brightness and contrast set
    so that the preprocess runs: once a batch, the feed's "decode",
    "preprocess" and "candidates upload" (nested in "host candidates") and
    the drain's "wait for feed", every feed and drain event of a batch
    with its index; "host candidates" counts the labeler's and the gates'
    seconds, the threads and the valid slots, with the C labeler and with
    scipy; "dict" counts the batch's detections."""
    if labeler == "scipy":
        monkeypatch.setenv("VICAN_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(tnative, "_cache", {})
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    timer = PhaseTimer(verbose=False, device="cpu")
    edges = TP.estimate_pose_batched(files, cams, device="cpu", timer=timer,
                                     **dict(KW, batch_size=2, brightness=-10, contrast=10))
    assert TP.last_labeler == labeler
    per_batch = {}
    for e in timer.events:
        per_batch.setdefault(e["batch"], []).append(e)
    assert sorted(per_batch) == [0, 1, 2]
    for bi, events in per_batch.items():
        names = [e["name"] for e in events]
        for name in ("decode", "preprocess", "candidates upload", "wait for feed",
                     "host candidates", "detect program", "dict"):
            assert names.count(name) == 1, (bi, name, names)
        ev = {e["name"]: e for e in events}
        assert {ev[n]["stage"] for n in ("decode", "preprocess", "candidates upload")} == {
            "feed"}
        assert ev["wait for feed"]["stage"] == "drain"
        assert ev["candidates upload"]["parent"] == "host candidates"
        assert all(ev[n]["parent"] is None for n in ("decode", "preprocess", "upload",
                                                      "host candidates", "wait for feed",
                                                      "detect program", "PnP", "dict"))
        counts = ev["host candidates"]
        assert counts["labeler_s"] > 0 and counts["gates_s"] > 0
        assert counts["labeler_s"] + counts["gates_s"] <= counts["threads"] * counts["seconds"]
        assert counts["threads"] == (TP._host_threads(2 * 7) if labeler == "c" else 1)
        assert counts["candidates"] > 0
        assert all(e["device_seconds"] is None for e in events)
    assert sum(e["detections"] for e in timer.events if e["name"] == "dict") == len(edges)
    assert len(edges) > 10


@pytest.mark.parametrize("batch_size,frames", [(2, [2, 2, 2]), (4, [4, 2])])
def test_every_preprocess_counts_its_table_frames(rendered, batch_size, frames):
    """Brightness -10 and contrast 10: every batch's "preprocess" event
    counts in ``table_frames`` the batch's frames, the short last one's
    too, all of them sent through the table."""
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    timer = PhaseTimer(verbose=False, device="cpu")
    TP.estimate_pose_batched(files, cams, device="cpu", timer=timer,
                             **dict(KW, batch_size=batch_size, brightness=-10, contrast=10))
    events = sorted((e for e in timer.events if e["name"] == "preprocess"),
                    key=lambda e: e["batch"])
    assert [e["batch"] for e in events] == list(range(len(frames)))
    assert [e["table_frames"] for e in events] == frames


@pytest.mark.parametrize("brightness", [-10, 0], ids=["colour", "gray"])
@pytest.mark.parametrize("batch_size,frames", [(2, [2, 2, 2]), (4, [4, 2])])
def test_every_decode_counts_its_files_and_workers(rendered, batch_size, frames, brightness):
    """Every batch's "decode" event counts in ``files`` the batch's frames,
    the short last one's too, and in ``workers`` the threads that decoded
    them, between 1 and one a core or a file; colour and straight-to-gray
    decodes alike, and the call leaves no decode thread behind.  In
    ``table_frames`` it counts the frames its tasks sent through the
    preprocess's table: every frame of a colour batch, none of a gray
    one."""
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    timer = PhaseTimer(verbose=False, trace=True, device="cpu")
    TP.estimate_pose_batched(files, cams, device="cpu", timer=timer,
                             **dict(KW, batch_size=batch_size, brightness=brightness,
                                    contrast=-brightness))
    events = sorted((e for e in timer.events if e["name"] == "decode"),
                    key=lambda e: e["batch"])
    assert [e["batch"] for e in events] == list(range(len(frames)))
    assert [e["files"] for e in events] == frames
    assert [e["table_frames"] for e in events] == (frames if brightness else [0] * len(frames))
    cores = len(os.sched_getaffinity(0))
    assert all(1 <= e["workers"] <= min(cores, e["files"]) for e in events)
    assert all(e["stage"] == "feed" and e["parent"] is None for e in events)
    assert not _decode_threads()


def test_no_preprocess_without_brightness_or_contrast(rendered):
    """Brightness = contrast = 0: the files decode straight to gray, and no
    "preprocess" event appears."""
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    timer = PhaseTimer(verbose=False, device="cpu")
    TP.estimate_pose_batched(files, cams, device="cpu", timer=timer,
                             **dict(KW, batch_size=2, brightness=0, contrast=0))
    names = {e["name"] for e in timer.events}
    assert "decode" in names and "preprocess" not in names


def test_verbose_phase_lines_stay_whole(capsys):
    """Phases ending on several threads at once print whole lines."""
    timer = PhaseTimer(verbose=True)

    def run(i):
        for _ in range(50):
            with timer.phase(f"phase {i}", stage="feed"):
                pass

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 200
    assert all(line.startswith("phase ") and line.endswith("s).") for line in lines)


@pytest.fixture(scope="module")
def packed_batch(rendered):
    """The threshold masks (the kernel's plain version) of the 6 frames, at
    their width and at a ragged 643 columns."""
    import cv2

    gray = np.stack([cv2.imread(f, cv2.IMREAD_GRAYSCALE) for f in rendered.im_data["filename"]])
    ragged = np.ascontiguousarray(np.pad(gray, ((0, 0), (0, 0), (0, 3)), mode="edge"))
    p = DetectorParams()
    return [(multi_threshold(torch.from_numpy(g), p.win_sizes, p.thresh_const).numpy(),
             g.shape[1], g.shape[2]) for g in (gray, ragged)]


def _batch(ccl, packed, H, W, K, K2, p):
    B, Wn, _, Wb = packed.shape
    quads = np.full((B, Wn * (K + K2), 4, 2), np.nan, np.float32)
    areas = np.full((B, Wn * (K + K2)), -1, np.int32)
    counts = np.full((B, Wn, 2), -1, np.int32)
    ccl.quad_candidates_batch(packed, B, Wn, H, W, Wb, K, K2, p.min_area,
                              p.max_area_rate * H * W, quads, areas, counts)
    return quads, areas, counts


@pytest.mark.parametrize("K2", [8, 0], ids=["split slots", "no split slots"])
def test_batch_entry_equals_per_window_calls(packed_batch, jax_native, K2):
    """``quad_candidates_batch`` fills, byte for byte, what the per-window
    ``quad_candidates_packed2`` of the port and of the JAX package return,
    window after window (``K2 = 0``: ``quad_candidates_packed``)."""
    ours, theirs = tnative.get_fastccl(), jax_native["fastccl"]
    p = DetectorParams()
    K = p.max_candidates
    for packed, H, W in packed_batch:
        quads, areas, counts = _batch(ours, packed, H, W, K, K2, p)
        B, Wn, _, Wb = packed.shape
        Ks = K + K2
        emitted = 0
        for b in range(B):
            for wi in range(Wn):
                rows = np.ascontiguousarray(packed[b, wi])
                args = (rows, H, W, Wb, K, K2) if K2 else (rows, H, W, Wb, K)
                for mod in (ours, theirs):
                    fn = mod.quad_candidates_packed2 if K2 else mod.quad_candidates_packed
                    ref = fn(*args, p.min_area, p.max_area_rate * H * W)
                    sl = slice(wi * Ks, (wi + 1) * Ks)
                    assert quads[b, sl].tobytes() == ref[0], (b, wi)
                    assert areas[b, sl].tobytes() == ref[1], (b, wi)
                    assert tuple(counts[b, wi]) == (tuple(ref[2:]) if K2 else (ref[2], 0))
                emitted += counts[b, wi].sum()
        assert emitted >= 50


def test_two_threads_labeling_at_once_give_the_serial_bytes(packed_batch):
    """The batch entry point runs with the GIL released: two threads
    labeling the two batches at once, many times over, each get the bytes
    of a serial call."""
    ccl = tnative.get_fastccl()
    p = DetectorParams()
    K, K2 = p.max_candidates, p.max_candidates_4conn
    serial = [_batch(ccl, *case, K, K2, p) for case in packed_batch]
    results: dict = {}

    def label(i):
        results[i] = [_batch(ccl, *packed_batch[i], K, K2, p) for _ in range(5)]

    threads = [threading.Thread(target=label, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, runs in results.items():
        for run in runs:
            for a, b in zip(run, serial[i]):
                assert a.tobytes() == b.tobytes()
    assert len(results) == 2


def test_c_builds_are_built_and_loaded_once(monkeypatch):
    """Sixteen threads asking for the C modules of an empty cache at once:
    each module is built and loaded by one of them, and all get the same
    module object."""
    import sys

    monkeypatch.setattr(tnative, "_cache", {})
    builds = []
    real_build = tnative._build

    def counting_build(name):
        builds.append(name)
        return real_build(name)

    monkeypatch.setattr(tnative, "_build", counting_build)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got: list = []
    try:
        threads = [threading.Thread(target=lambda: got.append(
            (tnative.get_fastccl(), tnative.get_fastthresh()))) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(builds) == ["fastccl", "fastthresh"]
    assert len(got) == 16 and got[0][0] is not None and got[0][1] is not None
    assert all(a is got[0][0] and b is got[0][1] for a, b in got)
