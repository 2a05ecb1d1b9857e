"""vican_torch.serialization against vican_tpu.serialization: a ``.pt``
saved by the JAX package loads into the port's pose type without
importing JAX or the JAX package; ``.pt`` and ``.npz`` round trips in the
port; the port's ``.npz`` loads in the JAX package with equal arrays."""
import os
import subprocess
import sys

import numpy as np
import pytest

from vican_tpu import serialization as jser
from vican_tpu.synthetic import make_problem
from vican_torch import serialization as tser
from vican_torch import synthetic as tsyn
from vican_torch.geometry import SE3 as TSE3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_dict(out: dict, ref: dict, exact_pose=True):
    assert list(out) == list(ref)
    for k, e in ref.items():
        o = out[k]
        if exact_pose:
            np.testing.assert_array_equal(o["pose"].pose(), e["pose"].pose())
        else:  # the .npz format keeps float32 poses
            np.testing.assert_array_equal(o["pose"].pose(),
                                          np.asarray(e["pose"].pose(), np.float32))
        np.testing.assert_array_equal(np.asarray(o["corners"], np.float32),
                                      np.asarray(e["corners"], np.float32))
        assert o["im_filename"] == e["im_filename"]


def test_jax_pt_loads_into_the_port_without_jax(tmp_path):
    edges = make_problem(seed=3, n_cams=4, n_times=6).edges
    path = str(tmp_path / "cam_marker_edges.pt")
    jser.save_edges(path, edges)
    code = (
        "import sys\n"
        "from vican_torch.serialization import load_edges\n"
        "from vican_torch.geometry import SE3\n"
        f"edges = load_edges({path!r})\n"
        "assert all(type(v['pose']) is SE3 for v in edges.values())\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vican_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(edges))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(len(edges))
    loaded = tser.load_edges(path)
    assert all(type(v["pose"]) is TSE3 for v in loaded.values())
    _assert_same_dict(loaded, edges)
    for k, e in edges.items():
        assert loaded[k]["reprojected_err"] == e["reprojected_err"]


@pytest.mark.parametrize("ext", [".pt", ".npz"])
def test_port_round_trips(tmp_path, ext):
    edges = tsyn.make_problem(seed=4, n_cams=5, n_times=8).edges
    path = str(tmp_path / f"edges{ext}")
    if ext == ".pt":
        tser.save_edges(path, edges)
    else:
        tser.save_edges_npz(path, edges)
    loaded = tser.load_edges(path)
    _assert_same_dict(loaded, edges, exact_pose=ext == ".pt")
    for k, e in edges.items():
        want = e["reprojected_err"] if ext == ".pt" else float(np.float32(e["reprojected_err"]))
        assert loaded[k]["reprojected_err"] == want


def test_port_npz_loads_in_jax(tmp_path):
    edges = tsyn.make_problem(seed=5, n_cams=5, n_times=8).edges
    path = str(tmp_path / "edges.npz")
    tser.save_edges_npz(path, edges)
    ref, out = jser.load_edges(path), tser.load_edges(path)
    assert list(ref) == list(out)
    for k in ref:
        np.testing.assert_array_equal(out[k]["pose"].pose(), ref[k]["pose"].pose())
        np.testing.assert_array_equal(out[k]["corners"], ref[k]["corners"])
        assert out[k]["reprojected_err"] == ref[k]["reprojected_err"]
        assert out[k]["im_filename"] == ref[k]["im_filename"]
    # and the JAX package's .npz in the port: the same bytes either way
    jpath = str(tmp_path / "jax.npz")
    jser.save_edges_npz(jpath, make_problem(seed=5, n_cams=5, n_times=8).edges)
    _assert_same_dict(tser.load_edges(jpath), out)
