"""Native C++ geometry runtime vs the Python/JAX implementations.

The native library (``native/mpc_native.cpp``, built via ``make``) is the
framework's counterpart of the reference's C++ pybind11 modules — pycrcc
collision checks (reference ``test/test_mpc_planner.py:36-47``) and the
pycrccosy curvilinear coordinate system (``configuration.py:264-277``).
These tests build it on demand and cross-check every exported entry point
against the pure-Python/JAX fallbacks it shadows.
"""
import numpy as np
import pytest

from mpc_tpu.utils import native


@pytest.fixture(scope="module")
def lib_available():
    try:
        native.build()
    except Exception as e:  # g++ is baked into the image; fail loudly
        pytest.fail(f"native build failed: {e}")
    assert native.available()


def _straight_traj(n=20, y=0.0, v=10.0, dt=0.1):
    t = np.arange(n) * dt
    x = 5.0 + v * t
    states = np.zeros((n, 5))
    states[:, 0] = x
    states[:, 1] = y
    states[:, 3] = v
    return states


def test_obstacle_collision_matches_python(lib_available):
    from mpc_tpu.utils.collision import trajectory_collides_obstacle

    states = _straight_traj()
    # obstacle straddling the path mid-way -> hit; well off the path -> miss
    for center, want_hit in [((12.0, 0.0), True), ((12.0, 8.0), False)]:
        step_native = native.traj_obstacle_collision(
            states, 4.3, 1.8, center, 6.0, 3.5, 0.0)
        hit_py, step_py = trajectory_collides_obstacle(
            states, 4.3, 1.8, np.asarray(center), 6.0, 3.5, 0.0)
        assert (step_native >= 0) == want_hit
        assert hit_py == want_hit
        assert step_native == (step_py if hit_py else -1)


def test_boundary_collision_matches_python(lib_available):
    from mpc_tpu.utils.collision import trajectory_crosses_boundary

    states = _straight_traj(y=0.0)
    near = np.array([[0.0, 0.7], [30.0, 0.7]])   # inside half ego width
    far = np.array([[0.0, 5.0], [30.0, 5.0]])
    for boundary, want_hit in [(near, True), (far, False)]:
        step_native = native.traj_boundary_collision(
            states, 4.3, 1.8, boundary)
        hit_py, step_py = trajectory_crosses_boundary(
            states, 4.3, 1.8, boundary)
        assert (step_native >= 0) == want_hit
        assert hit_py == want_hit
        assert step_native == (step_py if hit_py else -1)


def test_deviation_matches_python(lib_available):
    from mpc_tpu.utils.metrics import deviation_euclidean

    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 1.0, 40)
    path = np.stack([50.0 * t, 3.0 * np.sin(4.0 * t)], axis=1)
    states = _straight_traj(n=15)
    states[:, :2] += rng.normal(scale=0.5, size=(15, 2))
    dev_native = native.deviation_to_path(states, path)
    dev_py = deviation_euclidean(states, path)
    np.testing.assert_allclose(dev_native, dev_py, atol=1e-9)


def test_curvilinear_projection_matches_jax(lib_available):
    import jax.numpy as jnp

    from mpc_tpu.utils.geometry import arclength_projection_jnp

    t = np.linspace(0.0, 1.0, 30)
    path = np.stack([40.0 * t, 2.0 * np.sin(5.0 * t)], axis=1)
    points = np.array([[3.0, 1.5], [17.0, -2.0], [35.0, 0.4], [-2.0, 0.0]])
    s_native, d_native = native.curvilinear_project(path, points)
    for i, q in enumerate(points):
        s_jax = float(arclength_projection_jnp(
            jnp.asarray(path, jnp.float64), jnp.asarray(q, jnp.float64)))
        # the jnp side evaluates in float32 unless x64 is enabled
        assert abs(s_native[i] - s_jax) < 1e-4
    # signed lateral offset: |d| equals the exact point-to-segment distance
    # (NOT deviation_euclidean, which matches the reference's nearest-vertex
    # metric, mpc_planner.py:184-197)
    a, b = path[:-1], path[1:]
    ab = b - a
    ab2 = np.sum(ab * ab, axis=1)
    for i, q in enumerate(points):
        t_seg = np.clip(np.sum((q - a) * ab, axis=1) / ab2, 0.0, 1.0)
        proj = a + t_seg[:, None] * ab
        d_exact = np.sqrt(np.sum((proj - q) ** 2, axis=1)).min()
        assert abs(abs(d_native[i]) - d_exact) < 1e-9
