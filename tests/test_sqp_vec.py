"""Lanes-trailing batched solve vs the vmapped reference implementation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_tpu.ops import riccati as R
from mpc_tpu.ops import riccati_vec as RV
from mpc_tpu.ops import sqp
from mpc_tpu.ops import sqp_vec
from tests.test_riccati import _random_problem
from tests.test_sqp import straight_params


def test_backward_vec_matches_vmap():
    rng = np.random.default_rng(51)
    B, H = 6, 12
    probs = [_random_problem(rng, H) for _ in range(B)]
    st = [jnp.asarray(np.stack([p[i] for p in probs]), jnp.float32)
          for i in range(11)]
    Q, Rm, M, qx, qu, QH, qH, A, Bm, r, dx0 = st
    quad = R.StageQuad(Q=Q, R=Rm, M=M, qx=qx, qu=qu)
    dyn = R.LinDyn(A=A, B=Bm, r=r)
    ref = jax.vmap(lambda q, a, b, d: R.backward_pass(q, a, b, d, 1e-6))(
        quad, QH, qH, dyn)
    vec = RV.backward_pass_vec(quad, QH, qH, dyn, 1e-6)
    np.testing.assert_allclose(np.asarray(vec.K), np.asarray(ref.K),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(vec.d), np.asarray(ref.d),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(vec.dV1), np.asarray(ref.dV1),
                               rtol=1e-2)


def test_rollout_vec_matches_reference():
    rng = np.random.default_rng(52)
    B, H = 4, 10
    cfg = sqp.SolverConfig(horizon=H)
    x0 = jnp.asarray(rng.standard_normal((B, 5)) * 0.1
                     + np.array([0, 0, 0, 15, 0]), jnp.float32)
    U = jnp.asarray(0.1 * rng.standard_normal((B, H, 2)), jnp.float32)
    X = jax.vmap(lambda p, u: sqp._rollout(cfg, p, u))(x0, U)
    K = jnp.asarray(0.1 * rng.standard_normal((B, H, 2, 5)), jnp.float32)
    d = jnp.asarray(0.1 * rng.standard_normal((B, H, 2)), jnp.float32)
    u_lo, u_hi, _, _ = cfg.bounds.as_arrays(jnp.float32)
    alphas = (1.0, 0.35, 0.12)
    Xa, Ua = RV.feedback_rollout_vec(None, cfg.dt, cfg.wheelbase, x0, X, U,
                                     K, d, alphas, u_lo, u_hi, "rk4")
    for ai, a in enumerate(alphas):
        Xr, Ur = jax.vmap(
            lambda p, Xb, Ub, Kb, db: sqp._feedback_rollout(
                cfg, p, Xb, Ub, Kb, db, a))(x0, X, U, K, d)
        np.testing.assert_allclose(np.asarray(Ua[ai]), np.asarray(Ur),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(Xa[ai]), np.asarray(Xr),
                                   rtol=1e-4, atol=1e-4)


def test_solve_batch_vec_matches_reference():
    cfg = sqp.SolverConfig(horizon=10)
    base = straight_params(10, v=17.0)
    n = 4
    from mpc_tpu.parallel import batch as pb
    params = pb.replicate_ocp(base, n)
    params = pb.perturb_x0(params, jax.random.PRNGKey(3),
                           jnp.array([0.4, 0.1, 0.0, 0.3, 0.0]))
    states = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape),
        sqp.init_state(cfg))
    ref = sqp.solve_batch(cfg, params, states)
    vec = sqp_vec.solve_batch_vec_jit(cfg, params, states)
    np.testing.assert_allclose(np.asarray(vec.U), np.asarray(ref.U),
                               rtol=1e-3, atol=1e-3)
    # status codes may flip between 0/1 when kkt_stat sits at the tolerance
    # boundary (float32 noise); the feasible/infeasible sign must agree
    np.testing.assert_array_equal(np.asarray(vec.status) >= 0,
                                  np.asarray(ref.status) >= 0)


def test_closed_loop_batch_vec_matches_reference():
    from mpc_tpu.planner import closed_loop as cl
    from mpc_tpu.utils import synthetic
    lcfg, params = synthetic.make_bench_loop(n_steps=6, horizon=10,
                                             n_lanes=4, method="al")
    r1 = cl.closed_loop_batch(lcfg, params)
    r2 = cl.closed_loop_batch_vec(lcfg, params)
    np.testing.assert_allclose(np.asarray(r2.X), np.asarray(r1.X), atol=5e-3)
    np.testing.assert_array_equal(np.asarray(r2.status) >= 0,
                                  np.asarray(r1.status) >= 0)


def _fan(p, cfg, n=4, key=0):
    from mpc_tpu.parallel import batch as pb
    params = pb.perturb_x0(pb.replicate_ocp(p, n), jax.random.PRNGKey(key),
                           jnp.asarray([0.5, 0.2, 0.0, 0.5, 0.02],
                                       jnp.float32))
    state = jax.vmap(lambda _: sqp.init_state(cfg))(jnp.arange(n))
    return params, state


def _straight_corridor(dtype=jnp.float32, y_left=2.5, y_right=-4.0):
    """Two straight boundary lines (left above, right below), inside-positive
    signs."""
    n = 64
    xs = np.linspace(1e3, -1e3, n)
    left = np.stack([xs, np.full(n, y_left)], 1)
    right = np.stack([-xs, np.full(n, y_right)], 1)
    return (jnp.asarray(np.stack([left, right]), dtype),
            jnp.ones((2,), dtype))


def _assert_matches(vec, ref):
    np.testing.assert_allclose(np.asarray(vec.U), np.asarray(ref.U),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(vec.X), np.asarray(ref.X),
                               rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(np.asarray(vec.viol), np.asarray(ref.viol),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(vec.cost), np.asarray(ref.cost),
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("formulation,integrator,alphas", [
    ("forcespro", "rk4", (1.0, 0.35, 0.12, 0.04, 0.012, 1e-3)),
    ("casadi", "euler", (1.0, 0.35, 0.12, 0.04, 0.012, 1e-3)),
    ("forcespro", "rk4", ()),   # unguarded full RTI step (maxqps=1)
])
def test_vec_matches_reference_per_formulation(formulation, integrator,
                                               alphas):
    """Both formulations, and the unguarded step, through the lanes-
    trailing engine vs the vmapped per-lane solver (obstacle active)."""
    H = 12
    cfg = sqp.SolverConfig(horizon=H, formulation=formulation,
                           integrator=integrator,
                           use_terminal_cost=(formulation == "forcespro"),
                           sqp_iters=2, al_iters=2, alphas=alphas)
    p = straight_params(H, v=16.0)
    p = p._replace(x0=p.x0.at[3].set(14.0),
                   obs_centers=jnp.array([[10.0, -1.6]] * 3))
    params, state = _fan(p, cfg)
    _assert_matches(sqp_vec.solve_batch_vec_jit(cfg, params, state),
                    sqp.solve_batch(cfg, params, state))


def test_vec_moving_obstacle_matches_reference():
    """(B, H+1, 3, 2) per-stage obstacle centers through the engine."""
    H = 8
    cfg = sqp.SolverConfig(horizon=H, sqp_iters=2, al_iters=2)
    p = straight_params(H, v=14.0)
    ts = jnp.arange(H + 1, dtype=jnp.float32)[:, None, None]
    p = p._replace(obs_centers=jnp.array([[11.0, -1.8]] * 3)[None]
                   + ts * jnp.array([0.3, 0.05]))
    params, state = _fan(p, cfg, n=2)
    _assert_matches(sqp_vec.solve_batch_vec_jit(cfg, params, state),
                    sqp.solve_batch(cfg, params, state))


def test_vec_boundary_rows_match_reference():
    """Active road-boundary rows: the boundary row binds and pulls the
    lateral position below the reference line, identically in both."""
    H = 8
    cfg = sqp.SolverConfig(horizon=H, sqp_iters=2, al_iters=2,
                           boundary_rows=True)
    p = straight_params(H, v=14.0)
    p = p._replace(x_ref=p.x_ref.at[:, 1].set(1.8),
                   obs_centers=jnp.full((3, 2), -1e4))
    bnds, signs = _straight_corridor()
    params, state = _fan(p._replace(boundaries=bnds, boundary_signs=signs),
                         cfg, n=2)
    vec = sqp_vec.solve_batch_vec_jit(cfg, params, state)
    _assert_matches(vec, sqp.solve_batch(cfg, params, state))
    assert float(jnp.max(vec.X[..., 1])) < 1.6


def test_vec_st_model_matches_reference():
    """The 7-state ST model family through the engine."""
    from mpc_tpu.models.vehicle import VEHICLE_2
    from tests.test_st_model import _lane_ocp
    H = 8
    cfg = sqp.SolverConfig(horizon=H, model="st", vehicle=VEHICLE_2,
                           sqp_iters=2, al_iters=2)
    p = _lane_ocp(H, v=14.0)._replace(
        obs_centers=jnp.array([[11.0, -1.8]] * 3))
    params, state = _fan(p, cfg, n=2)
    vec = sqp_vec.solve_batch_vec_jit(cfg, params, state)
    ref = sqp.solve_batch(cfg, params, state)
    assert vec.X.shape[-1] == 7
    _assert_matches(vec, ref)


def test_vec_warm_start_improves():
    """Re-solving from the returned state keeps improving (RTI contract)."""
    H = 10
    cfg = sqp.SolverConfig(horizon=H, sqp_iters=2, al_iters=2)
    params, state = _fan(straight_params(H, v=15.0), cfg, n=2)
    s1 = sqp_vec.solve_batch_vec_jit(cfg, params, state)
    s2 = sqp_vec.solve_batch_vec_jit(cfg, params, s1.state)
    assert float(jnp.max(s2.kkt_stat)) <= float(jnp.max(s1.kkt_stat)) + 1e-5


@pytest.mark.parametrize("method,expected", [
    ("al", sqp_vec.solve_batch_vec),
    ("ip", None),   # no batched-native IP engine: vmapped per-lane path
])
def test_select_engine(method, expected):
    from mpc_tpu.planner import closed_loop as cl
    assert cl.select_engine(sqp.SolverConfig(horizon=4,
                                             method=method)) is expected
