"""The port's C edge packer (``vican_torch/_native/fastpack.c``) and its
callable recognizer (``vican_torch.solver.specs``) against the JAX
package's, and against the port's pure-Python packer."""
import numpy as np
import pytest

import vican_torch._native as tnative
from vican_torch.ops.shoelace import polygon_area as t_area
from vican_torch.solver import packing as tpacking
from vican_torch.solver import specs as tspecs
from vican_tpu.ops.shoelace import polygon_area as j_area
from vican_tpu.solver import specs as jspecs
from vican_tpu.solver.packing import pack_problem as jpack
from vican_tpu.synthetic import make_problem
from test_torch_jax_native import jax_native  # noqa: F401  (autouse: JAX's C modules)

FIELDS = ("cam_ids", "time_ids", "marker_ids", "edata", "eidx", "R_con", "t_con",
          "root_idx", "k_r_scale", "has_quats", "R_e_raw")

AREA_R = 'lambda e: 0.001 * polygon_area(e["corners"]) ** 1.0'
AREA_T = 'lambda e: 0.001 * polygon_area(e["corners"]) ** 2.0'


def _form(src, area):
    """A user lambda whose ``polygon_area`` is the given package's."""
    return eval(src, {"polygon_area": area})


@pytest.fixture(scope="module")
def prob():
    return make_problem(seed=21, n_cams=7, n_times=40, n_markers=6)


def _python_only(monkeypatch):
    """Make the next pack_problem take the pure-Python packer."""
    monkeypatch.setenv("VICAN_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "_cache", {})


def _assert_same(a, b):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


def test_c_packer_builds_and_runs(prob):
    assert tnative.get_fastpack() is not None, tnative.build_errors
    tpacking.pack_problem(prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0,
                          lambda e: True, dtype=np.float32)
    assert tpacking.last_packer == "c"


def test_no_native_switch_takes_the_python_packer(prob, monkeypatch):
    _python_only(monkeypatch)
    tpacking.pack_problem(prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0,
                          lambda e: True, dtype=np.float32)
    assert tpacking.last_packer == "python"


# Plain callables run per edge on both sides; the recognized forms run
# inline in C on both sides (each package's lambdas built with its own
# polygon_area): identical arrays, field for field.
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("forms", ["plain", "recognized"])
def test_c_packer_matches_jax(prob, dtype, forms):
    if forms == "plain":
        t_args = j_args = (lambda e: 1.0 + e["corners"][0, 0] * 1e-3,
                           lambda e: 2.0 - e["corners"][0, 1] * 1e-4,
                           lambda e: e["reprojected_err"] < 0.03)
    else:
        t_args = (_form(AREA_R, t_area), _form(AREA_T, t_area),
                  lambda e: e["reprojected_err"] < 0.02)
        j_args = (_form(AREA_R, j_area), _form(AREA_T, j_area), t_args[2])
        assert tspecs.recognize_noise(t_args[0]) == ("area_pow", 0.001, 1.0)
    a = tpacking.pack_problem(prob.edges, prob.constraints(), *t_args, dtype=dtype)
    assert tpacking.last_packer == "c"
    b = jpack(prob.edges, prob.constraints(), *j_args, dtype=dtype)
    assert 0 < a.num_edges < len(prob.edges)  # the filter really fires
    _assert_same(a, b)


# The C pass converts the float64 pose to quaternions in doubles; the
# Python pass stages the rotations in the solver dtype first.  Measured:
# 1.2e-7 (float32, one rounding) and 2.2e-16 (float64) in the quaternion
# columns, everything else identical.  Bars as tests/test_packing.py:41.
@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-6), (np.float64, 1e-14)])
def test_c_packer_matches_python_packer(prob, monkeypatch, dtype, bar):
    args = (lambda e: 1.0 + e["corners"][0, 0] * 1e-3, lambda e: 2.0 - e["corners"][0, 1] * 1e-4,
            lambda e: e["reprojected_err"] < 0.03)
    c = tpacking.pack_problem(prob.edges, prob.constraints(), *args, dtype=dtype)
    _python_only(monkeypatch)
    py = tpacking.pack_problem(prob.edges, prob.constraints(), *args, dtype=dtype)
    assert tpacking.last_packer == "python"
    for k in FIELDS:
        if k != "edata":
            x, y = getattr(c, k), getattr(py, k)
            assert np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y, k
    assert c.edata.dtype == py.edata.dtype
    np.testing.assert_array_equal(c.edata[:, 4:], py.edata[:, 4:])
    assert np.abs(c.edata[:, :4] - py.edata[:, :4]).max() < bar


def test_non_orthonormal_rotations_c_matches_python(prob, monkeypatch):
    """The raw-matrix path: rotations that fail the orthonormality gate ship
    as they are, from either packer, and the callables run once per edge."""
    from vican_tpu.geometry import SE3

    edges = {}
    for i, (k, v) in enumerate(prob.edges.items()):
        v = dict(v)
        if i % 11 == 0:
            M = v["pose"].R() * 1.05  # uniformly scaled: fails the gate
            v["pose"] = SE3(R=np.eye(3), t=v["pose"].t())
            v["pose"]._R = M
            v["pose"]._pose[:3, :3] = M
        edges[k] = v
    calls = []

    def nm(e):
        calls.append(1)
        return 1.0

    c = tpacking.pack_problem(edges, prob.constraints(), nm, lambda e: 1.0, lambda e: True,
                              dtype=np.float32)
    assert len(calls) == len(edges)
    _python_only(monkeypatch)
    py = tpacking.pack_problem(edges, prob.constraints(), nm, lambda e: 1.0, lambda e: True,
                               dtype=np.float32)
    assert not c.has_quats and not py.has_quats
    np.testing.assert_array_equal(c.R_e_raw, py.R_e_raw)
    np.testing.assert_array_equal(c.edata, py.edata)
    np.testing.assert_array_equal(c.eidx, py.eidx)


def test_recognizers_agree_with_jax():
    """The same forms, each written with its own package's polygon_area,
    give the same spec tuples; a lambda over the other package's
    polygon_area is not recognized (the C packer would compute another
    function than the one the user wrote)."""
    srcs = [AREA_R, 'lambda e: polygon_area(e["corners"]) ** 6.0', 'lambda e: 1.0',
            'lambda e: 2.0 * e["reprojected_err"]']
    for src in srcs:
        assert (tspecs.recognize_noise(_form(src, t_area))
                == jspecs.recognize_noise(_form(src, j_area))), src
    assert tspecs.recognize_noise(_form(AREA_R, j_area)) is None
    assert jspecs.recognize_noise(_form(AREA_R, t_area)) is None
    for fn in (lambda e: e["reprojected_err"] < 0.05, lambda e: True,
               lambda e: e["reprojected_err"] > 0.05):
        assert tspecs.recognize_filter(fn) == jspecs.recognize_filter(fn)
    assert tspecs.recognize_noise(tspecs.CornerAreaPower(0.001, 2)) == ("area_pow", 0.001, 2.0)
    assert tspecs.recognize_noise(tspecs.ConstNoise(3.5)) == ("const", 3.5)
    assert tspecs.recognize_filter(tspecs.ReprojErrBelow(0.1)) == ("reproj_lt", 0.1)
    assert tspecs.recognize_filter(tspecs.KeepAll()) == ("true",)


def test_recognized_forms_pack_as_their_callables(prob, monkeypatch):
    """Inline evaluation in C against the same lambdas called per edge
    (recognition blinded): identical arrays."""
    args = (_form(AREA_R, t_area), _form(AREA_T, t_area), lambda e: e["reprojected_err"] < 0.02)
    fast = tpacking.pack_problem(prob.edges, prob.constraints(), *args, dtype=np.float32)
    monkeypatch.setattr(tspecs, "recognize_noise", lambda fn: None)
    monkeypatch.setattr(tspecs, "recognize_filter", lambda fn: None)
    called = tpacking.pack_problem(prob.edges, prob.constraints(), *args, dtype=np.float32)
    assert tpacking.last_packer == "c"
    _assert_same(fast, called)
