"""The perception slice as a whole: the port's ``estimate_pose_mp`` (every
pipeline mode, on the CPU) against the JAX package's modes on the same
rendered files; the port's renderer against the JAX package's; the port's
``Dataset`` against the JAX package's on the rendered directory."""
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

cv = pytest.importorskip("cv2")

from vican_tpu.cam import Camera, estimate_pose_mp
from vican_tpu.dataset import Dataset
from vican_tpu.geometry import SE3, distance_SO3, rodrigues
from vican_tpu.render import look_at, make_cube_markers, render_dataset, render_image
from vican_torch import _native as tnative
from vican_torch import cam as TC
from vican_torch import dataset as TDS
from vican_torch import perception as TP
from vican_torch import render as TR
from vican_torch.utils import PhaseTimer
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)
from torch_threads import two_threads  # noqa: F401

MARKER_SIZE = 0.138
DIST = np.array([-0.25, 0.08, 1.5e-3, -1.2e-3, -0.012, -0.02, 0.004, -0.001,
                 0.0, 0.0, 0.0, 0.0])  # tests/test_perception.py:132
KW = dict(aruco="DICT_4X4_1000", marker_size=MARKER_SIZE,
          corner_refine="CORNER_REFINE_APRILTAG", flags="SOLVEPNP_IPPE_SQUARE",
          brightness=0, contrast=0, batch_size=4, verbose=False)


def _cams(distorted_last=False):
    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    cams = {}
    for i, pos in enumerate([(2.4, 0, 1.2), (0, 2.4, 1.4), (-2.4, 0.5, 1.0)]):
        dist = DIST if distorted_last and i == 2 else np.zeros(12)
        cams[str(i)] = Camera(id=str(i), intrinsics=K, distortion=dist.copy(),
                              extrinsics=look_at(pos, (0, 0, 1.0)),
                              resolution_x=640, resolution_y=360)
    return cams


def _traj(n, seed):
    rng = np.random.default_rng(seed)
    traj = {}
    for t in range(n):
        v = rng.normal(size=3)
        v = v / np.linalg.norm(v) * rng.uniform(0, np.pi)
        traj[str(t)] = SE3(R=rodrigues(v), t=np.array(
            [rng.uniform(-0.4, 0.4), rng.uniform(-0.4, 0.4), 1.0 + rng.uniform(-0.2, 0.2)]))
    return traj


def _port_cams(cams):
    return [TC.Camera(id=c.id, intrinsics=c.intrinsics, distortion=c.distortion,
                      extrinsics=c.extrinsics, resolution_x=c.resolution_x,
                      resolution_y=c.resolution_y) for c in cams]


def _assert_same_edges(ref, out):
    assert len(ref) > 10
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k]["corners"], ref[k]["corners"], rtol=0, atol=1e-3)
        d = distance_SO3(np.asarray(out[k]["pose"].R(), np.float64),
                         np.asarray(ref[k]["pose"].R(), np.float64))
        assert d < 0.01, (k, d)
        np.testing.assert_allclose(out[k]["pose"].t(), ref[k]["pose"].t(), rtol=0, atol=1e-4)
        assert abs(out[k]["reprojected_err"] - ref[k]["reprojected_err"]) < 1e-3
        assert out[k]["im_filename"] == ref[k]["im_filename"]


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """3 cameras (one with the 12-coefficient distortion) x 2 timesteps at
    640x360, rendered to JPEGs by vican_tpu.render (as
    tests/test_perception.py:22-43 does)."""
    root = str(tmp_path_factory.mktemp("render") / "ds")
    render_dataset(root, _cams(distorted_last=True), _traj(2, 3), make_cube_markers(),
                   marker_size=MARKER_SIZE, marker_px=120)
    return Dataset(root)


def test_estimate_pose_mp_matches_jax_device_mode(rendered):
    files, cams = rendered.im_data["filename"], rendered.im_data["cam"]
    ids = [str(i) for i in range(20)]
    ref = estimate_pose_mp(files, cams, pipeline_mode="device", marker_ids=ids, **KW)
    out = TC.estimate_pose_mp(files, _port_cams(cams), marker_ids=ids, device="cpu", **KW)
    _assert_same_edges(ref, out)
    # output order follows the batches and slots, as in JAX
    assert list(out) == list(ref)


def test_port_renderer_matches_opencv_renderer():
    """The port's torch renderer against vican_tpu.render.render_image (cv2)
    on the same cameras and scenes: measured 0.99996-0.99999 of pixels
    equal and at most 1 grey level apart with OpenCV 5.0 (edge pixels,
    where cv2's float arithmetic rounds differently)."""
    cams = _cams(distorted_last=True)
    markers = make_cube_markers()
    tiles = TR.marker_tiles(list(markers))
    equal = []
    for cam, obj in zip(cams.values(), _traj(3, 7).values()):
        world = {m: obj @ p for m, p in markers.items()}
        ref = render_image(cam, world, tiles, MARKER_SIZE)
        out = TR.render_image(cam, world, tiles, MARKER_SIZE, device="cpu").numpy()
        assert out.shape == ref.shape[:2] and out.dtype == np.uint8
        diff = np.abs(out.astype(int) - ref[..., 0].astype(int))
        assert diff.max() <= 8
        equal.append((diff == 0).mean())
    assert min(equal) > 0.998, equal


def test_port_frames_detected_like_jax(tmp_path):
    """Frames from the port's renderer: the port's gray-batch stage and the
    JAX device mode (reading the same frames as lossless PNGs) give the same
    edges; the file stage agrees with the gray stage."""
    cams = _cams(distorted_last=True)
    frames, names, frame_cams = TR.render_frames(cams, _traj(2, 11), make_cube_markers(),
                                                 marker_size=MARKER_SIZE, device="cpu")
    files = []
    for img, name in zip(frames.numpy(), names):
        path = os.path.join(str(tmp_path), name.replace(".jpg", ".png"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv.imwrite(path, img)
        files.append(path)
    kw = {k: v for k, v in KW.items() if k not in ("brightness", "contrast")}
    ref = estimate_pose_mp(files, frame_cams, pipeline_mode="device", marker_ids=None,
                           brightness=0, contrast=0, **kw)
    out = TP.estimate_pose_gray(frames, files, _port_cams(frame_cams), device="cpu", **kw)
    _assert_same_edges(ref, out)
    via_files = TC.estimate_pose_mp(files, _port_cams(frame_cams), marker_ids=None,
                                    device="cpu", brightness=0, contrast=0, **kw)
    assert list(via_files) == list(out)


def test_estimate_pose_worker_is_one_frame_of_the_batch(rendered):
    files, cams = rendered.im_data["filename"][:3], _port_cams(rendered.im_data["cam"][:3])
    args = {k: v for k, v in KW.items() if k not in ("batch_size", "verbose")}
    batch = TC.estimate_pose_mp(files, cams, marker_ids=None, device="cpu", **KW)
    one = TC.estimate_pose_worker(files[1], cams[1], device="cpu", **args)
    assert one and set(one) == {k for k, v in batch.items() if v["im_filename"] == files[1]}
    for k in one:
        np.testing.assert_array_equal(one[k]["corners"], batch[k]["corners"])


def test_unported_modes_and_missing_card_raise(rendered, monkeypatch, two_threads):
    """The ``pure`` mode runs; a ``mesh`` that is not a ``DeviceMesh``, an
    unknown mode and a missing card raise."""
    files, cams = rendered.im_data["filename"][:1], _port_cams(rendered.im_data["cam"][:1])
    pure = TC.estimate_pose_mp(files, cams, marker_ids=None, pipeline_mode="pure",
                               device="cpu", **KW)
    assert len(pure) >= 4
    with pytest.raises(ValueError, match="unknown perception pipeline mode"):
        TC.estimate_pose_mp(files, cams, marker_ids=None, pipeline_mode="tiles",
                            device="cpu", **KW)
    with pytest.raises(TypeError, match="DeviceMesh"):
        TC.estimate_pose_mp(files, cams, marker_ids=None, mesh=object(), device="cpu", **KW)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.estimate_pose_mp(files, cams, marker_ids=None, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.render_frames({"0": cams[0]}, _traj(1, 3), make_cube_markers(),
                         marker_size=MARKER_SIZE)


def test_pure_mode_matches_jax_pure_mode(rendered, two_threads):
    """``pipeline_mode="pure"`` against the JAX package's pure mode on the
    same files: the same edges (keys, order, corners within 1e-3 px,
    poses)."""
    files, cams = rendered.im_data["filename"], rendered.im_data["cam"]
    ref = estimate_pose_mp(files, cams, pipeline_mode="pure", marker_ids=None, **KW)
    timer = PhaseTimer(verbose=False, device=torch.device("cpu"))
    gray = np.stack([cv.imread(f, cv.IMREAD_GRAYSCALE) for f in files])
    out = TP.estimate_pose_gray(gray, files, _port_cams(cams), device="cpu", timer=timer,
                                pipeline_mode="pure",
                                **{k: v for k, v in KW.items()
                                   if k not in ("brightness", "contrast")})
    _assert_same_edges(ref, out)
    assert list(out) == list(ref)
    phases = {e["name"] for e in timer.events}
    assert {"threshold kernel", "device candidates", "detect program"} <= phases
    assert not phases & {"masks to host", "host threshold", "host candidates"}


def test_pure_mode_matches_device_mode_close_range(tmp_path, two_threads):
    """The port's ``pure`` against its ``device`` mode on the close-range
    scene of tests/test_perception.py:591-627: the same marker set, corners
    within 0.5 px (the JAX package's bar between its two modes)."""
    from vican_tpu.synthetic import render_cube_scene

    root = str(tmp_path / "close")
    render_cube_scene(root, [(1.1, 0.15, 1.05)], 4, seed=23, res=(640, 360), marker_size=0.24)
    ds = Dataset(root)
    kw = dict(KW, marker_size=0.24, marker_ids=[str(i) for i in range(24)])
    files, cams = ds.im_data["filename"], _port_cams(ds.im_data["cam"])
    dev = TC.estimate_pose_mp(files, cams, pipeline_mode="device", device="cpu", **kw)
    pure = TC.estimate_pose_mp(files, cams, pipeline_mode="pure", device="cpu", **kw)
    assert len(dev) >= 8
    assert set(pure) == set(dev), (sorted(set(pure) - set(dev)), sorted(set(dev) - set(pure)))
    for k in pure:
        np.testing.assert_allclose(pure[k]["corners"], dev[k]["corners"], rtol=0, atol=0.5)


def test_resolve_mode_falls_back_to_pure_without_a_labeler(monkeypatch):
    """Neither the C labeler nor scipy: every hybrid mode falls back to
    ``pure`` with a warning, as vican_tpu/perception.py:1197-1211 does;
    ``pure`` itself needs no labeler, and ``auto`` is ``device`` otherwise."""
    import builtins

    assert TP._resolve_mode("auto") == "device"
    monkeypatch.setattr(TP, "_get_ccl", lambda: None)
    real_import = builtins.__import__

    def no_scipy(name, *args, **kwargs):
        if name.startswith("scipy"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_scipy)
    for mode in ("auto", "device", "host", "roi"):
        with pytest.warns(UserWarning, match="falling back to the pure-device path"):
            assert TP._resolve_mode(mode) == "pure"
    assert TP._resolve_mode("pure") == "pure"


MODES = ("device", "host", "roi", "auto")


@pytest.fixture(scope="module")
def port_modes(rendered):
    """The port's edges from the rendered files in every pipeline mode."""
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    return {m: TC.estimate_pose_mp(files, cams, marker_ids=None, pipeline_mode=m,
                                   device="cpu", **KW) for m in MODES}


def _assert_identical_edges(ref, out):
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k]["corners"], ref[k]["corners"])
        np.testing.assert_array_equal(out[k]["pose"].pose(), ref[k]["pose"].pose())
        assert out[k]["reprojected_err"] == ref[k]["reprojected_err"]
        assert out[k]["im_filename"] == ref[k]["im_filename"]


@pytest.mark.parametrize("mode", MODES[1:])
def test_port_modes_give_identical_edges(port_modes, mode):
    """host, roi and auto give the device mode's edges exactly: the host
    threshold's masks are the kernel's, byte for byte, at the default C."""
    assert len(port_modes["device"]) > 10
    _assert_identical_edges(port_modes["device"], port_modes[mode])


@pytest.mark.parametrize("mode", ["host", "roi"])
def test_port_host_modes_match_jax(rendered, port_modes, mode):
    """The port's host and roi modes against the JAX package's (its roi
    mode uploads tiles, its host mode the frame) on the same files."""
    files, cams = rendered.im_data["filename"], rendered.im_data["cam"]
    ref = estimate_pose_mp(files, cams, pipeline_mode=mode, marker_ids=None, **KW)
    _assert_same_edges(ref, port_modes[mode])


def _phases(rendered, mode, corner_refine):
    files, cams = rendered.im_data["filename"][:3], _port_cams(rendered.im_data["cam"][:3])
    timer = PhaseTimer(verbose=False, device="cpu")
    kw = dict(KW, corner_refine=corner_refine)
    edges = TP.estimate_pose_batched(files, cams, pipeline_mode=mode, device="cpu",
                                     timer=timer, **kw)
    return edges, {e["name"] for e in timer.events}


def test_roi_with_subpix_runs_the_device_program(rendered):
    """cornerSubPix samples without bound, so roi hands it to the device
    program (vican_tpu/perception.py:1285-1290); other refiners run the host
    program."""
    edges, names = _phases(rendered, "roi", "CORNER_REFINE_SUBPIX")
    assert "threshold kernel" in names and "host threshold" not in names
    device, _ = _phases(rendered, "device", "CORNER_REFINE_SUBPIX")
    assert edges and list(edges) == list(device)
    for k in device:
        np.testing.assert_array_equal(edges[k]["corners"], device[k]["corners"])
    _, names = _phases(rendered, "roi", "CORNER_REFINE_APRILTAG")
    assert "host threshold" in names and "threshold kernel" not in names
    assert set(TP.PHASES) >= names


def test_scipy_forced_run_equals_c_run(rendered, port_modes, monkeypatch):
    """Without the port's C modules (the JAX package's stay cached) the
    host mode runs the numpy threshold and the scipy labeler, with the C
    run's edges."""
    monkeypatch.setenv("VICAN_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "_cache", {})
    files, cams = rendered.im_data["filename"], _port_cams(rendered.im_data["cam"])
    out = TC.estimate_pose_mp(files, cams, marker_ids=None, pipeline_mode="host",
                              device="cpu", **KW)
    assert TP.last_labeler == "scipy"
    _assert_identical_edges(port_modes["host"], out)


def test_port_dataset_reads_rendered_directory(rendered):
    """The port's Dataset on the rendered directory: the JAX package's file
    list, timestamps, cameras and ground-truth object poses."""
    ds = TDS.Dataset(rendered.root)
    assert ds.im_data["filename"] == rendered.im_data["filename"]
    assert ds.im_data["timestamp"] == rendered.im_data["timestamp"]
    assert ds.im_data["cam_id"] == rendered.im_data["cam_id"]
    assert [c.id for c in ds.im_data["cam"]] == [c.id for c in rendered.im_data["cam"]]
    assert set(ds.cams) == set(rendered.cams) and set(ds.object) == set(rendered.object)
    for k, c in rendered.cams.items():
        ours = ds.cams[k]
        assert isinstance(ours, TC.Camera)
        np.testing.assert_array_equal(ours.intrinsics, c.intrinsics)
        np.testing.assert_array_equal(ours.distortion, c.distortion)
        np.testing.assert_array_equal(ours.extrinsics.pose(), c.extrinsics.pose())
        assert (ours.resolution_x, ours.resolution_y) == (c.resolution_x, c.resolution_y)
    for t, pose in rendered.object.items():
        np.testing.assert_array_equal(ds.object[t].pose(), pose.pose())


def _jpegs(root, sizes):
    """One colour JPEG (quality 95) a ``(H, W)`` of ``sizes``, each of
    other content: a gradient turned by its index under seeded noise."""
    rng = np.random.default_rng(5)
    files = []
    for i, (h, w) in enumerate(sizes):
        y, x = np.mgrid[:h, :w]
        base = (x * np.cos(i) + y * np.sin(i)) * 255.0 / (h + w)
        im = np.stack([base, base[::-1], 255 - base], -1) + rng.normal(0, 30, (h, w, 3))
        files.append(os.path.join(root, f"frame_{i}.jpg"))
        assert cv.imwrite(files[-1], np.clip(im, 0, 255).astype(np.uint8),
                          [cv.IMWRITE_JPEG_QUALITY, 95])
    return files


def _decode_threads():
    return [t for t in threading.enumerate() if t.name.startswith("vican-decode")]


@pytest.mark.parametrize("grayscale", [False, True], ids=["colour", "gray"])
def test_pooled_decode_is_byte_for_byte_one_imread_at_a_time(tmp_path, grayscale):
    """Nine JPEG files of different content, decoded on the pool of
    ``load_images`` and by one ``cv.imread`` after another: the same
    batch, byte for byte, with each flag; no decode thread is left.  The
    same on a pool of one thread, whose counters read 9 files and 1
    worker, and on one of more threads than cores."""
    files = _jpegs(str(tmp_path), [(72, 96)] * 9)
    flag = cv.IMREAD_GRAYSCALE if grayscale else cv.IMREAD_COLOR
    ref = np.stack([cv.imread(f, flag) for f in files])
    assert len({ref[i].tobytes() for i in range(len(files))}) == len(files)
    out = TP.load_images(files, grayscale=grayscale)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    assert not _decode_threads()
    # a pool of one thread, then one of more threads than cores switching
    # every microsecond, where a batch allocated twice would lose frames
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for threads in (1, 2 * len(os.sched_getaffinity(0)) + 1):
            with ThreadPoolExecutor(threads) as pool:
                for _ in range(5):
                    counts = {}
                    out = TP._decode_batch(pool, files, grayscale, counts)
                    np.testing.assert_array_equal(out, ref)
                    assert counts["files"] == 9
                    assert 1 <= counts["workers"] <= min(threads, 9)
            assert threads > 1 or counts["workers"] == 1
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("fault", ["two sizes", "missing file"])
def test_pooled_decode_raises_what_one_imread_at_a_time_raised(tmp_path, fault):
    """A batch of two frame sizes raises the ValueError of the sequential
    loader, word for word; a missing file (a later one also of another
    size) raises FileNotFoundError naming it; no decode thread is left."""
    files = _jpegs(str(tmp_path), [(72, 96)] * 5 + [(96, 72)] * 4)
    if fault == "two sizes":
        shapes = {cv.imread(f, cv.IMREAD_COLOR).shape for f in files}
        with pytest.raises(ValueError) as err:
            TP.load_images(files)
        assert str(err.value) == (
            f"mixed image shapes in batch: {shapes}. Cameras that declare "
            "resolution_x/y must match their image files; cameras with "
            "undeclared resolution are grouped by actual image size "
            "automatically (see estimate_pose_batched).")
    else:
        files[3] = os.path.join(str(tmp_path), "missing.jpg")
        with pytest.raises(FileNotFoundError, match="could not read image: .*missing.jpg"):
            TP.load_images(files)
    assert not _decode_threads()


@pytest.mark.parametrize("fused", [True, False], ids=["colour, in the tasks", "gray"])
@pytest.mark.parametrize("fault", ["missing file", "two sizes", "declared resolution"])
def test_the_file_entry_raises_what_decode_then_preprocess_raised(tmp_path, fault, fused):
    """Colour files with a brightness and a contrast (each decode task also
    maps its file and converts it to gray) and gray files alike: a missing
    file (later files also of another size) raises ``load_images``'
    FileNotFoundError, a batch of two sizes its ValueError, and cameras
    that declare another size than their files decode to the
    declared-resolution ValueError, word for word; no decode or feed thread
    is left."""
    from vican_torch.geometry import SE3 as TSE3

    files = _jpegs(str(tmp_path), [(72, 96)] * 5 + [(96, 72)] * 4)
    W, H = 96, 72
    if fault == "missing file":
        files[3] = os.path.join(str(tmp_path), "missing.jpg")
    if fault == "declared resolution":
        files, (W, H) = files[:5], (72, 96)
        expected = (f"camera '0' declares resolution 72x96 but {files[0]!r} decodes to 96x72 "
                    "— fix the camera record, or leave resolution_x/y as None to group by "
                    "actual image size")
        kind = ValueError
    else:
        with pytest.raises((FileNotFoundError, ValueError)) as ref:
            TP.load_images(files, grayscale=not fused)
        expected, kind = str(ref.value), type(ref.value)
    cams = [TC.Camera(id=str(i), intrinsics=np.eye(3), distortion=np.zeros(12),
                      extrinsics=TSE3(pose=np.eye(4)), resolution_x=W, resolution_y=H)
            for i in range(len(files))]
    b, c = (-150, 120) if fused else (0, 0)
    with pytest.raises(kind) as out:
        TP.estimate_pose_batched(files, cams, device="cpu",
                                 **dict(KW, batch_size=len(files), brightness=b, contrast=c))
    assert type(out.value) is kind and str(out.value) == expected
    assert not _decode_threads()
    assert not [t for t in threading.enumerate() if t.name.startswith("vican-feed")]


@pytest.mark.parametrize("brightness,contrast", [(-150, 120), (0, 0), (30, -40)])
def test_host_preprocess_of_gray_frames_needs_no_opencv(monkeypatch, brightness, contrast):
    """Gray (N, H, W) frames go through the brightness/contrast transform
    without OpenCV (it converts only BGR frames), bit-equal to the JAX
    package's host_preprocess, which imports OpenCV in any case."""
    from vican_tpu.perception import host_preprocess

    gray = np.random.default_rng(2).integers(0, 256, (3, 37, 53), dtype=np.uint8)
    ref = host_preprocess(gray, float(brightness), float(contrast))
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = TP.host_preprocess(gray, float(brightness), float(contrast))
    assert out.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ImportError):
        TP.host_preprocess(np.repeat(gray[..., None], 3, axis=-1), float(brightness),
                           float(contrast))


def _preprocess_input(kind: str) -> np.ndarray:
    """BGR frames in which every byte value appears in each channel beside
    random colours, gray frames with every byte value, a strided view of
    BGR frames, and int16 and float32 batches past [0, 255] for the float32
    path."""
    rng = np.random.default_rng(7)
    if kind in ("bgr", "bgr view"):
        x = rng.integers(0, 256, (3, 19, 41, 3), dtype=np.uint8)
        every = np.arange(256, dtype=np.uint8)
        x[0].reshape(-1, 3)[:256] = np.stack([np.roll(every, 85 * k) for k in range(3)], -1)
        return x[:, :, ::-1] if kind == "bgr view" else x
    if kind == "gray":
        x = rng.integers(0, 256, (3, 37, 53), dtype=np.uint8)
        x[1].reshape(-1)[:256] = np.arange(256)
        return x
    if kind == "int16":
        return rng.integers(-40, 300, (2, 19, 41, 3), dtype=np.int16)
    return rng.uniform(-40.0, 300.0, (2, 19, 41, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["bgr", "bgr view", "gray", "int16", "float32"])
@pytest.mark.parametrize("brightness,contrast", [
    (-150, 120), (30, -40), (0, 120), (-150, 0), (12.5, 33.3), (-127, -127),
    (-300, 0), (300, 0)], ids=lambda v: str(v))
def test_host_preprocess_is_bit_equal_to_jax(kind, brightness, contrast):
    """The port's host_preprocess (a 256-entry table on uint8 frames, the
    float32 expression on other dtypes) gives the JAX package's bytes at
    every (brightness, contrast) of the grid, clipping every value to 0
    (-300, 0) and to 255 (300, 0) among them, into a new batch and into a
    given one; ``table_frames`` counts the frames that went through the
    table: every uint8 frame, no other."""
    from vican_tpu.perception import host_preprocess

    images = _preprocess_input(kind)
    ref = host_preprocess(images, float(brightness), float(contrast))
    counts = {}
    out = TP.host_preprocess(images, float(brightness), float(contrast), counts)
    assert out.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    # written into a given batch (a staged upload's), every byte of it
    given = np.full(ref.shape, 7, np.uint8)
    assert TP.host_preprocess(images, float(brightness), float(contrast), out=given) is given
    np.testing.assert_array_equal(given, ref)
    assert counts["table_frames"] == (len(images) if images.dtype == np.uint8 else 0)
    if (brightness, contrast) in ((-300, 0), (300, 0)):
        assert np.all(out == (0 if brightness < 0 else 255))


# ------------------------------------------- a rig of two frame sizes

RIG_K = {(320, 180): np.array([[210.0, 0, 160], [0, 210.0, 90], [0, 0, 1]]),
         (640, 360): np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])}
# (camera, position, resolution, distorted), in the order its frames arrive
RIG = [("s0", (1.6, 0, 1.2), (320, 180), False), ("big", (0, 2.4, 1.4), (640, 360), True),
       ("s1", (-1.2, 1.1, 1.0), (320, 180), False), ("s2", (0.2, -1.6, 1.5), (320, 180), False)]
RIG_KW = {k: v for k, v in KW.items() if k not in ("brightness", "contrast", "batch_size")}


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """3 cameras at 320x180 and one distorted at 640x360, 4 timesteps,
    frames interleaved as they arrive (timesteps outer), rendered by the
    port's renderer and written as lossless PNGs whose paths name them;
    and the port's edges through ``estimate_pose_gray``'s sequence form,
    batch 5, so that each size ends in a padded tail batch."""
    root = tmp_path_factory.mktemp("rig")
    cams = [TC.Camera(id=c, intrinsics=RIG_K[res], distortion=(DIST if d else np.zeros(12)).copy(),
                      extrinsics=TR.look_at(p, (0, 0, 1.0)), resolution_x=res[0],
                      resolution_y=res[1]) for c, p, res, d in RIG]
    markers = TR.make_cube_markers()
    tiles = TR.marker_tiles(list(markers))
    frames, files, frame_cams = [], [], []
    for t, obj in _traj(4, 5).items():
        world = {m: obj @ p for m, p in markers.items()}
        for cam in cams:
            frames.append(TR.render_image(cam, world, tiles, MARKER_SIZE, device="cpu").numpy())
            path = root / t / f"{cam.id}.png"
            path.parent.mkdir(exist_ok=True)
            cv.imwrite(str(path), frames[-1])
            files.append(str(path))
            frame_cams.append(cam)
    timer = PhaseTimer(verbose=False, device="cpu")
    out = TP.estimate_pose_gray(frames, files, frame_cams, device="cpu", timer=timer,
                                batch_size=5, **RIG_KW)
    return frames, files, frame_cams, out, timer.events


def test_a_rig_of_two_sizes_is_the_union_of_one_call_per_size(rig):
    """The sequence form groups the frames by size (first seen first) and
    runs the groups' batches through one pipeline: its dict is, key for key
    and value for value and in order, that of one array call per size; the
    feed stacks each batch once ("stack", with its size and frame count)
    and every upload carries its batch's size."""
    frames, files, cams, out, events = rig
    union = {}
    for size in ((180, 320), (360, 640)):
        idx = [i for i, f in enumerate(frames) if f.shape == size]
        union.update(TP.estimate_pose_gray(np.stack([frames[i] for i in idx]),
                                           [files[i] for i in idx], [cams[i] for i in idx],
                                           device="cpu", batch_size=5, **RIG_KW))
    assert {k[0] for k in union} == {c for c, *_ in RIG}
    assert len(union) > 40
    _assert_identical_edges(union, out)
    for name in ("stack", "upload"):
        got = sorted((e["batch"], e["height"], e["width"]) for e in events if e["name"] == name)
        assert got == [(0, 180, 320), (1, 180, 320), (2, 180, 320), (3, 360, 640)]
    assert [e["frames"] for e in sorted((e for e in events if e["name"] == "stack"),
                                        key=lambda e: e["batch"])] == [5, 5, 2, 4]


def test_the_file_entry_groups_a_rig_like_the_frames(rig):
    """``estimate_pose_batched`` on the same frames as lossless PNGs
    (brightness and contrast 0) groups them through the same one pipeline
    and returns the same dict, which is the JAX package's on those files
    (vican_tpu/perception.py:1267-1280 groups them a call per size)."""
    frames, files, cams, out, _ = rig
    timer = PhaseTimer(verbose=False, device="cpu")
    via_files = TP.estimate_pose_batched(files, cams, brightness=0, contrast=0, device="cpu",
                                         timer=timer, batch_size=5, **RIG_KW)
    _assert_identical_edges(out, via_files)
    assert sorted(e["batch"] for e in timer.events if e["name"] == "decode") == [0, 1, 2, 3]
    jax_cams = [Camera(id=c.id, intrinsics=c.intrinsics, distortion=c.distortion,
                       extrinsics=SE3(R=np.asarray(c.extrinsics.R()),
                                      t=np.asarray(c.extrinsics.t())),
                       resolution_x=c.resolution_x,
                       resolution_y=c.resolution_y) for c in cams]
    ref = estimate_pose_mp(files, jax_cams, pipeline_mode="device", marker_ids=None,
                           brightness=0, contrast=0, batch_size=5, **RIG_KW)
    _assert_same_edges(ref, via_files)
    assert list(via_files) == list(ref)


def test_an_array_keeps_its_slices_and_records_no_stack(rig):
    frames, files, cams, _, _ = rig
    idx = [i for i, f in enumerate(frames) if f.shape == (180, 320)]
    timer = PhaseTimer(verbose=False, device="cpu")
    TP.estimate_pose_gray(np.stack([frames[i] for i in idx]), [files[i] for i in idx],
                          [cams[i] for i in idx], device="cpu", timer=timer, batch_size=5,
                          **RIG_KW)
    names = [e["name"] for e in timer.events]
    assert "stack" not in names and names.count("upload") == 3
    assert all((e["height"], e["width"]) == (180, 320)
               for e in timer.events if e["name"] == "upload")


@pytest.mark.parametrize("entry", ["frames", "array", "files, gray", "files, colour"])
def test_the_cpu_path_pins_nothing(rig, monkeypatch, entry):
    """On the CPU no batch goes through page-locked memory: nothing asks
    for it, and every "upload" counts ``pinned`` 0 and its batch's
    ``bytes``, the padded tail batches' (batch 5: 5, 5, 2 small frames,
    then 4 large) too; the sequence of frames, an array of one size and the
    file entry, which decodes straight to gray or preprocesses colour."""
    frames, files, cams, _, _ = rig
    asked = []
    empty, pin = torch.empty, torch.Tensor.pin_memory

    def spy_empty(*args, **kwargs):
        asked.append(bool(kwargs.get("pin_memory")))
        return empty(*args, **kwargs)

    def spy_pin(self, *args, **kwargs):
        asked.append(True)
        return pin(self, *args, **kwargs)

    monkeypatch.setattr(torch, "empty", spy_empty)
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy_pin)
    timer = PhaseTimer(verbose=False, device="cpu")
    kw = dict(RIG_KW, device="cpu", timer=timer, batch_size=5)
    sizes = [(180, 320)] * 3 + [(360, 640)]
    if entry == "frames":
        TP.estimate_pose_gray(frames, files, cams, **kw)
    elif entry == "array":
        idx = [i for i, f in enumerate(frames) if f.shape == (180, 320)]
        TP.estimate_pose_gray(np.stack([frames[i] for i in idx]), [files[i] for i in idx],
                              [cams[i] for i in idx], **kw)
        sizes = sizes[:3]
    else:
        level = 0 if entry == "files, gray" else 10
        TP.estimate_pose_batched(files, cams, brightness=-level, contrast=level, **kw)
    uploads = sorted((e for e in timer.events if e["name"] == "upload"), key=lambda e: e["batch"])
    assert [(e["height"], e["width"]) for e in uploads] == sizes
    assert [e["bytes"] for e in uploads] == [5 * h * w for h, w in sizes]
    assert [e["pinned"] for e in uploads] == [0] * len(sizes)
    assert asked and not any(asked)


@pytest.mark.parametrize("bad", ["three dimensions", "float32", "int16 tensor", "one name short"])
def test_a_frame_that_is_not_2d_uint8_raises(rig, bad):
    frames, files, cams, _, _ = rig
    frames = list(frames[:4])
    if bad == "three dimensions":
        frames[1] = np.stack([frames[1]] * 3, axis=-1)
    elif bad == "float32":
        frames[2] = frames[2].astype(np.float32)
    elif bad == "int16 tensor":
        frames[3] = torch.as_tensor(frames[3]).to(torch.int16)
    with pytest.raises(ValueError):
        TP.estimate_pose_gray(frames, files[:4 if bad != "one name short" else 3], cams[:4],
                              device="cpu", batch_size=5, **RIG_KW)
