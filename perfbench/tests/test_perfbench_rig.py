"""The rig cell, ``panoptic511.frames``, on the CPU at a small dome:
``python -m pytest perfbench/tests -q``.

- the dome's renderer gives ``scene.render_image``'s frames byte for byte,
  and the configuration's dome holds its 511 cameras at their two sizes,
  interleaved in capture order;
- a short run of the rig cell comes out correct, and each fault planted
  under it (an answer altered, half of a batch left out, one frame size
  left out) comes out not correct; the control does not pass at either
  size;
- a traced run reads the new per-layer metrics and the room cells' host
  layers, and a program without the new spans and counters leaves the new
  metrics out;
- the threshold's work a launch is weighted by each size's launches.
"""
from __future__ import annotations

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import harness, roofline  # noqa: E402

CELL = "panoptic511.frames"
# 6 cameras at 320x240 and 2 at 640x480 over 2 timesteps
SMALL = {"config": {"panels": 2, "vga_per_panel": 3, "panel_grid": [3, 1], "hd_cameras": 2,
                    "timesteps": 2, "vga_resolution": [320, 240], "hd_resolution": [640, 480],
                    "batch_size": 4},
         "traffic": {"sample_frames": 8}}
NEW_METRICS = ("feed.stack_ms", "batch.small_frames_ms", "batch.large_frames_ms")


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _config(**small):
    cfg = json.load(open(os.path.join(ROOT, "perfbench/configs/panoptic511.json")))
    cfg.update(small)
    return cfg


def _run(capsys, trace=0):
    rc = harness.main(["--workload", CELL, "--seed", str(2**31 + 7), "--seconds", "0.5",
                       "--trace", str(trace)], device="cpu", overrides=SMALL)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_the_dome_holds_its_cameras_in_capture_order():
    from perfbench.gen import dome

    cams = dome.cameras(_config())
    sizes = [(c["W"], c["H"]) for c in cams]
    assert sizes.count((640, 480)) == 480 and sizes.count((1920, 1080)) == 31
    assert len({c["id"] for c in cams}) == 511
    # the two models interleave: no run of one size holds every frame of it
    hd = [i for i, s in enumerate(sizes) if s == (1920, 1080)]
    assert hd[0] > 0 and hd[-1] < 510 and max(np.diff(hd)) < 60
    # every camera at the dome's radius, looking at its centre
    target = np.asarray(_config()["target"])
    for c in cams:
        pos, fwd = c["extrinsics"][:3, 3], c["extrinsics"][:3, 2]
        assert abs(np.linalg.norm(pos - target) - 2.75) < 1e-9
        assert np.allclose(fwd, (target - pos) / np.linalg.norm(target - pos))


def test_the_dome_renders_render_image_frames(two_threads):
    from perfbench.gen import dome, scene

    cfg = _config(**SMALL["config"])
    frames, names, cam_of, cams = dome.render(cfg, 2**31 + 3, "cpu")
    assert len(frames) == 16 and {f.shape for f in frames} == {(240, 320), (480, 640)}
    markers = scene.cube_markers(cfg["cube_size"])
    tiles = scene.marker_tiles(list(markers), cfg["marker_px"])
    traj = scene.cube_trajectory(cfg["timesteps"], 2**31 + 3, tuple(cfg["target"]),
                                 cfg["wander"])
    for frame, name, ci in zip(frames, names, cam_of):
        t = int(name.split("/")[0])
        world = {m: (traj[t] @ mp).astype(np.float32) for m, mp in markers.items()}
        want = scene.render_image(cams[ci], world, tiles, cfg["marker_size"], "cpu")
        assert frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, want.numpy())
        assert (frame != 170).mean() > 0.02  # the cube is in view


def test_a_short_rig_run_comes_out_correct(capsys, two_threads):
    result = _run(capsys)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"images_per_s", "setup_s"} <= set(result["metrics"])


def _pnp_altered(orig, *args, **kw):
    out = orig(*args, **kw)
    out[:, 19] += 1e-3  # every pose's x translation, 1 mm
    return out


def _half_the_batch(orig, gray, quads, valid, *args, **kw):
    valid = torch.as_tensor(np.asarray(valid)).clone()
    valid[valid.shape[0] // 2:] = False
    return orig(gray, quads, valid, *args, **kw)


def _one_size_left_out(orig, keys, B):
    batches = orig(keys, B)
    return [b for b in batches if keys[b[0]] == keys[batches[0][0]]]


FAULTS = {
    "an answer altered": ("vican_torch.ops.pnp", "pnp_block", _pnp_altered),
    "half of the batch left out": ("vican_torch.ops.detect", "detect_candidates",
                                   _half_the_batch),
    "one frame size left out": ("vican_torch.perception", "_group_batches", _one_size_left_out),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_rig_fault_comes_out_not_correct(capsys, two_threads, monkeypatch, fault):
    import importlib

    module, name, broken = FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, functools.partial(broken, getattr(mod, name)))
    result = _run(capsys)
    assert result["correct"] is False, result["checks"]


def test_the_control_fails_at_each_size(two_threads):
    spec = harness.load_spec()
    _, config, traffic = harness.cell_parts(spec, CELL)
    config.update(SMALL["config"])
    traffic.update(SMALL["traffic"])
    driver = harness.load_module("drivers", traffic["driver"])
    state = driver.setup(config, traffic, 2**31 + 11, "cpu", False)
    readings = driver.control(state)
    for size in ("320x240", "640x480"):
        assert any(readings[f"{n}.{size}"] > limit for n, limit in config["limits"].items()), \
            (size, readings)


def test_a_traced_rig_run_reads_the_new_metrics(capsys, two_threads):
    result = _run(capsys, trace=1)
    assert result["correct"] is True
    for name in NEW_METRICS:
        assert result["metrics"][name]["value"] >= 0, name
    assert result["metrics"]["batch.small_frames_ms"]["value"] > 0


# the room cells' per-layer metrics that the rig cell reports too, and
# those of them that read something on the CPU (the rest read the card)
SHARED = ("capture_p90_s", "feed.host_candidates_ms", "feed.upload_ms", "threshold.roofline",
          "drain.detect_ms", "detect.kernel_ms", "drain.pnp_ms", "device_idle.perceive",
          "feed.labeler_ms", "feed.gates_ms", "feed.candidates_upload_ms",
          "drain.wait_feed_ms", "drain.detect_device_ms", "drain.pnp_device_ms")
SHARED_ON_THE_CPU = {"feed.host_candidates_ms", "feed.upload_ms", "drain.detect_ms",
                     "drain.pnp_ms", "feed.labeler_ms", "feed.gates_ms",
                     "feed.candidates_upload_ms", "drain.wait_feed_ms"}


def test_a_traced_rig_run_reads_the_room_cells_layers(capsys, two_threads):
    """The rig cell lists every perception layer the room cells read
    (``feed.decode_ms`` and ``feed.preprocess_ms`` aside: it decodes
    nothing); a traced CPU run reads the host's, and ``capture_p90_s``
    where the window holds two captures."""
    spec = harness.load_spec()
    listed = {m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [])}
    assert set(SHARED) | set(NEW_METRICS) == listed
    result = _run(capsys, trace=1)
    read = set(result["metrics"]) & set(SHARED)
    assert SHARED_ON_THE_CPU <= read <= SHARED_ON_THE_CPU | {"capture_p90_s"}
    assert all(result["metrics"][m]["value"] > 0 for m in read)


# a frames run's events as a program without the stack span and the
# upload's size counters records them
OLD_RUN = {"phases": [{"name": "upload", "stage": "feed", "start": 0.0, "seconds": 0.01,
                       "batch": b, "capture": 0} for b in range(2)]
           + [{"name": "dict", "stage": "drain", "start": 0.1 * b, "seconds": 0.002,
               "batch": b, "capture": 0} for b in range(2)]}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_program_without_the_spans_leaves_the_new_metrics_out(name):
    reader = harness.load_module("metrics", name)
    assert reader.read(OLD_RUN) is None
    assert reader.read({}) is None


def test_the_threshold_work_is_weighted_by_launches():
    from perfbench.reference import perception as ref_perception

    drivers = harness.load_module("drivers", "perceive_rig")
    s = drivers.State()
    s.config = _config(batch_size=32)
    s.sizes = [(640, 480)] * 480 + [(1920, 1080)] * 31
    wins = ref_perception.detector_params(s.config).win_sizes
    small = roofline.threshold_work(32, 480, 640, wins)
    large = roofline.threshold_work(32, 1080, 1920, wins)
    work = drivers._threshold_work(s)
    for key in ("ops", "bytes"):
        assert work[key] == pytest.approx((15 * small[key] + large[key]) / 16, rel=1e-12)
