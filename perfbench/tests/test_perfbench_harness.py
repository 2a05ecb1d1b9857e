"""The benchmark's own tests, on the CPU at small sizes (``gpu``-marked ones
on the card): ``python -m pytest perfbench/tests -q``.

- a cell, a configuration, a traffic mix and a metric added as files alone
  are found and run by the harness;
- the frozen scene gives the port's renderer's frames, and the shop's
  problem keeps its sizes and its cameras' stretches;
- nothing under ``perfbench/`` imports JAX or the JAX package, and the
  reference imports nothing of the port;
- a short run of each driver ends in one result line with the contract's
  keys, and comes out correct;
- the control (the reference in the precision below) and each fault the
  cells can have, planted under a run, come out not correct.
"""
from __future__ import annotations

import ast
import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

KEYS = ("correct", "attempted", "failed", "metrics", "device")
SMALL = {
    "room8_720p.frames": {"config": {"cameras": 3, "timesteps": 1, "resolution": [640, 360],
                                     "batch_size": 2},
                          "traffic": {"sample_frames": 3}},
    "room8_720p.jpeg": {"config": {"cameras": 3, "timesteps": 1, "resolution": [640, 360],
                                   "batch_size": 2},
                        "traffic": {"sample_frames": 3}},
    "large_shop.solve": {"config": {"n_cams": 12, "n_times": 240, "floor": [6.0, 4.5],
                                    "n_edges": 3000}},
}


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _run(capsys, workload, seed=2**31 + 7, trace=0, overrides=None):
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], device="cpu",
                      overrides=overrides if overrides is not None else SMALL[workload])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


# ---------------------------------------------------------------- imports

def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _sources(sub=""):
    base = os.path.join(ROOT, "perfbench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        bad = set(_imports(path)) & {"vican_torch", *harness.FORBIDDEN}
        assert not bad, f"{path} imports {bad}"


def test_import_check_compares_whole_top_level_names(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text("import vican_torch.ops\nfrom jaxtyping import x\nimport jax.numpy\n"
                    "importlib.import_module('vican_tpu.bipgo')\n")
    # the port's name begins with the JAX package's and is not it
    assert set(_imports(str(path))) & set(harness.FORBIDDEN) == {"jax", "vican_tpu"}


# ------------------------------------------------------------- generators

def test_frozen_scene_gives_the_port_frames():
    from perfbench.gen import scene
    from vican_torch import render
    from vican_torch.cam import Camera

    cfg = json.load(open(os.path.join(ROOT, "perfbench/configs/room8_720p.json")))
    cfg.update(cameras=3, timesteps=2, resolution=[320, 180])
    frames, names, cam_of, cams = scene.render(cfg, 2**31 + 3, "cpu")
    port_cams = {c["id"]: Camera(id=c["id"], intrinsics=c["K"], distortion=c["dist"].copy(),
                                 extrinsics=render.look_at(c["extrinsics"][:3, 3], cfg["target"]),
                                 resolution_x=c["W"], resolution_y=c["H"]) for c in cams}
    traj = render.cube_trajectory(2, seed=2**31 + 3, wander=True)
    want, want_names, _ = render.render_frames(port_cams, traj, render.make_cube_markers(),
                                               marker_size=cfg["marker_size"], device="cpu")
    assert names == want_names
    assert torch.equal(frames, want)


def test_the_shop_keeps_its_sizes_and_sees_in_stretches():
    from perfbench.drivers import solve
    from perfbench.gen import shop

    cfg = dict(json.load(open(os.path.join(ROOT, "perfbench/configs/large_shop.json"))),
               **SMALL["large_shop.solve"]["config"])
    a = shop.make(cfg, 2**31 + 5)
    b = shop.make(cfg, 2**31 + 5)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    C, T = cfg["n_cams"], cfg["n_times"]
    assert len(a["ci"]) == cfg["n_edges"] == len(solve.dict_arrays(a)["ci"])
    assert set(a["ci"].tolist()) == set(range(C)) and set(a["ti"].tolist()) == set(range(T))
    # a camera sees the cube in a few contiguous stretches of the walk
    stretches = [1 + int((np.diff(np.unique(a["ti"][a["ci"] == c])) > 5).sum())
                 for c in range(C)]
    assert np.median(stretches) <= 4
    # the measured poses are the ground truth's, up to the noise
    R_gt = np.einsum("eji,ejk,ekl->eil", a["Rc"][a["ci"]], a["Ro"][a["ti"]], a["Rm"][a["mi"]])
    assert np.abs(a["R"] - R_gt).max() < 0.1


# ------------------------------------------------------- data-driven files

def test_a_cell_config_traffic_and_metric_added_as_files_run(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(ROOT, "perfbench/configs/room8_720p.json")))
    cfg.update(name="room3_small", cameras=3, timesteps=1, resolution=[640, 360], batch_size=2)
    (root / "perfbench/configs/room3_small.json").write_text(json.dumps(cfg))
    traffic = json.load(open(os.path.join(ROOT, "perfbench/traffic/frames.json")))
    traffic.update(sample_frames=2)
    (root / "perfbench/traffic/frames_small.json").write_text(json.dumps(traffic))
    (root / "perfbench/metrics/captures_done.py").write_text(
        '"""captures_done: calls the window finished."""\n\n\n'
        "def read(run):\n    return len(run['calls'])\n")
    spec["configs"].append({"name": "room3_small", "source": "a test", "reduced": [],
                            "file": "perfbench/configs/room3_small.json", "why": "a test"})
    spec["workloads"].append({"name": "room3_small.frames_small", "config": "room3_small",
                              "traffic": "frames_small", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("room3_small.frames_small")
    spec["end_to_end"].append({"name": "captures_done", "unit": "calls", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["room3_small.frames_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "import torch; torch.set_num_threads(2);"
            "from perfbench import harness;"
            "sys.exit(harness.main(['--workload', 'room3_small.frames_small', '--seed', '9',"
            " '--seconds', '0.5', '--trace', '0'], device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code, str(root), ROOT], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["captures_done"]["value"] >= 1
    assert set(result["metrics"]) == {"images_per_s", "setup_s", "captures_done"}


def test_without_a_card_the_command_exits_with_no_result():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench/run.py"), "--workload",
                          "room8_720p.frames", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# ------------------------------------------------------------ short runs

@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_short_run_ends_in_one_result_line(capsys, two_threads, monkeypatch, workload):
    result = _run(capsys, workload)
    assert all(k in result for k in KEYS)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"]


def test_a_traced_run_reports_the_layers_it_can_read(capsys, two_threads):
    result = _run(capsys, "room8_720p.frames", trace=1)
    assert result["correct"] is True
    # the card's metrics read nothing on the CPU and are left out
    assert set(result["metrics"]) == {"feed.host_candidates_ms", "feed.upload_ms",
                                      "drain.detect_ms", "drain.pnp_ms"}
    assert "breakdown" in result and "busy_s" in result["device"]


# ------------------------------------------------- the control and faults

def _state(workload, seed=2**31 + 11):
    spec = harness.load_spec()
    _, config, traffic = harness.cell_parts(spec, workload)
    for key, part in SMALL[workload].items():
        {"config": config, "traffic": traffic}[key].update(part)
    driver = harness.load_module("drivers", traffic["driver"])
    state = driver.setup(config, traffic, seed, "cpu", False)
    return driver, state, config


@pytest.mark.parametrize("workload", ["room8_720p.frames", "large_shop.solve"])
def test_the_control_fails_the_check(two_threads, monkeypatch, workload):
    driver, state, config = _state(workload)
    readings = driver.control(state)
    assert any(readings[n] > limit for n, limit in config["limits"].items()), readings


def _pnp_altered(orig, *args, **kw):
    out = orig(*args, **kw)
    out[:, 19] += 1e-3  # every pose's x translation, 1 mm
    return out


def _half_the_batch(orig, gray, quads, valid, *args, **kw):
    valid = torch.as_tensor(np.asarray(valid)).clone()
    valid[valid.shape[0] // 2:] = False
    return orig(gray, quads, valid, *args, **kw)


PERCEPTION_FAULTS = {
    "an answer altered": ("vican_torch.ops.pnp", "pnp_block", _pnp_altered),
    "half of the batch left out": ("vican_torch.ops.detect", "detect_candidates",
                                   _half_the_batch),
    "a step that returns its state unchanged": (
        "vican_torch.ops.detect", "refine_quad", lambda orig, gray, bi, quads, params: quads),
}


@pytest.mark.parametrize("fault", sorted(PERCEPTION_FAULTS))
def test_a_perception_fault_comes_out_not_correct(capsys, two_threads, monkeypatch, fault):
    import importlib

    module, name, broken = PERCEPTION_FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, functools.partial(broken, getattr(mod, name)))
    result = _run(capsys, "room8_720p.frames")
    assert result["correct"] is False, result["checks"]


def _solve_state_unchanged(orig, *args, **kw):
    res = orig(*args, **kw)  # the rotations handed on as the iteration started them
    eye = torch.eye(3, dtype=res.r_cam.dtype, device=res.r_cam.device)
    return res._replace(r_cam=eye.expand_as(res.r_cam).clone(),
                        r_time=eye.expand_as(res.r_time).clone())


def _solve_half_the_edges(orig, src_edges, *args, **kw):
    keys = list(src_edges)
    return orig({k: src_edges[k] for k in keys[: len(keys) // 2]}, *args, **kw)


def _solve_altered(orig, packed, result, t_est):
    t_est = t_est.clone()
    t_est[0] += 1.0  # one camera's translation, 1 m
    return orig(packed, result, t_est)


SOLVE_FAULTS = {
    "a step that returns its state unchanged": ("vican_torch.solver.core", "so3_sync",
                                                _solve_state_unchanged),
    "half of the batch left out": ("vican_torch.bipgo", "pack_problem", _solve_half_the_edges),
    "an answer altered": ("vican_torch.bipgo", "_poses_out", _solve_altered),
}


@pytest.mark.parametrize("fault", sorted(SOLVE_FAULTS))
def test_a_solve_fault_comes_out_not_correct(capsys, two_threads, monkeypatch, fault):
    import importlib

    module, name, broken = SOLVE_FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, functools.partial(broken, getattr(mod, name)))
    result = _run(capsys, "large_shop.solve")
    assert result["correct"] is False, result["checks"]


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["room8_720p.frames", "large_shop.solve", "room8_720p.jpeg"])
def test_a_cell_on_the_card_comes_out_correct(card, capsys, workload):
    rc = harness.main(["--workload", workload, "--seed", str(2**31 + 13), "--seconds", "3",
                       "--trace", "0"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
