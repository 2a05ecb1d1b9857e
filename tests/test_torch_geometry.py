"""vican_torch.geometry's SO(3) helpers against vican_tpu.geometry on the
same inputs: the Langevin sampler draws the same samples from the same
numpy generator, the axis rotations and the degree conversion are equal,
and the SO(3) projection agrees to 1e-12 in float64."""
import numpy as np
import pytest

from vican_tpu import geometry as jg
from vican_torch import geometry as tg


@pytest.mark.parametrize("k", [1.0, 50.0, 1e4])
def test_langevin_draws_the_same_samples(k):
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(8):
        np.testing.assert_array_equal(tg.langevin(k, a), jg.langevin(k, b))
    # the generators were consumed alike
    assert a.random() == b.random()


def test_langevin_global_rng_is_a_rotation():
    np.random.seed(5)
    R = tg.langevin(100.0)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert np.linalg.det(R) > 0


@pytest.mark.parametrize("theta", [0.0, 0.3, -1.2, np.pi, 4.0])
def test_axis_rotations_and_degrees_equal(theta):
    for name in ("rotx", "roty", "rotz"):
        out, ref = getattr(tg, name)(theta), getattr(jg, name)(theta)
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out, ref)
    assert tg.deg2rad(np.degrees(theta)) == jg.deg2rad(np.degrees(theta))
    assert tg.rad2deg(theta) == jg.rad2deg(theta)


def test_project_so3_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(32):
        x = rng.standard_normal((3, 3))
        out, ref = tg.project_SO3(x), jg.project_SO3(x)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(out @ out.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(out) > 0
