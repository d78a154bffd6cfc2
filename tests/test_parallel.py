"""Mesh sharding tests on the virtual 8-device CPU mesh (conftest)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_tpu.ops import sqp
from mpc_tpu.parallel import batch as pb
from mpc_tpu.parallel import mesh as pm
from tests.test_sqp import straight_params


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    m = pm.make_mesh()
    assert m.shape == {"dp": 8, "sp": 1}
    m2 = pm.make_mesh((4, 2))
    assert m2.shape == {"dp": 4, "sp": 2}
    with pytest.raises(ValueError):
        pm.make_mesh((3, 2))


def test_sharded_solve_matches_vmap():
    cfg = sqp.SolverConfig(horizon=10)
    base = straight_params(10, v=18.0)
    n = 16
    params = pb.replicate_ocp(base, n)
    # perturb position/velocity only: perturbing delta at v=18 can make the
    # pinned initial state violate the friction circle (genuinely infeasible
    # lanes converge to slightly different points under different fusion
    # orders in float32)
    scale = jnp.array([0.5, 0.5, 0.0, 0.2, 0.0])
    params = pb.perturb_x0(params, jax.random.PRNGKey(0), scale)
    state = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape),
        sqp.init_state(cfg))

    mesh = pm.make_mesh()
    sol_sharded = pb.solve_batch_sharded(cfg, params, state, mesh)
    # sharded == unsharded through the SAME engine (sqp_vec on CPU) ...
    from mpc_tpu.ops import sqp_vec
    sol_vec = sqp_vec.solve_batch_vec(cfg, params, state)
    np.testing.assert_allclose(np.asarray(sol_sharded.U),
                               np.asarray(sol_vec.U), rtol=1e-4, atol=1e-5)
    # ... and close to the per-lane vmapped solver (engine tolerance)
    sol_plain = sqp.solve_batch(cfg, params, state)
    np.testing.assert_allclose(np.asarray(sol_sharded.U),
                               np.asarray(sol_plain.U), rtol=5e-3, atol=5e-3)
    # outputs actually live sharded over dp
    assert not sol_sharded.U.sharding.is_fully_replicated


def test_summary_collectives():
    cfg = sqp.SolverConfig(horizon=10)
    base = straight_params(10)
    n = 8
    params = pb.replicate_ocp(base, n)
    state = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape),
        sqp.init_state(cfg))
    mesh = pm.make_mesh()
    sol = pb.solve_batch_sharded(cfg, params, state, mesh)
    summary = pb.summarize(sol, mesh)
    assert int(summary.n_converged) + int(summary.n_infeasible) <= n
    assert float(summary.max_viol) < 1e-2
    assert np.isfinite(float(summary.mean_cost))


def test_closed_loop_batch_sharded():
    import os
    from asset_paths import CFG, SCN
    from mpc_tpu.io.config import load_config
    from mpc_tpu.planner import closed_loop as cl
    c = load_config(os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"),
                    SCN)
    lcfg = cl.make_loop_config(c, noised=True)
    n = 8
    one = cl.make_loop_params(c, lcfg, seed=0)
    params = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), one)
    # distinct noise keys per lane
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    params = params._replace(noise_key=keys)
    mesh = pm.make_mesh()
    res = pb.closed_loop_batch_sharded(lcfg, params, mesh)
    X = np.asarray(res.X)
    assert X.shape == (n, 30, 5)
    # lanes differ (independent noise) but all reach the goal region
    assert np.abs(X[0] - X[1]).max() > 1e-4
    assert np.all(np.abs(X[:, -1, 0] - 87.8) < 3.0)

def test_sharded_ip_solve_matches_vmap():
    """The hard-constrained method has no batched-native engine, so the
    sharded solve partitions the vmapped per-lane IP over dp; it must
    match the unsharded vmapped solve."""
    cfg = sqp.SolverConfig(horizon=6, method="ip", ip_sqp_iters=1,
                           ip_iters=4)
    base = straight_params(6, v=15.0)
    n = 8
    params = pb.replicate_ocp(base, n)
    params = pb.perturb_x0(params, jax.random.PRNGKey(2),
                           jnp.array([0.5, 0.3, 0.0, 0.2, 0.0]))
    state = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape),
        sqp.init_state(cfg))
    ref = sqp.solve_batch(cfg, params, state)
    mesh = pm.make_mesh((4, 1), devices=jax.devices()[:4])
    got = pb.solve_batch_sharded(cfg, params, state, mesh)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.status),
                                  np.asarray(ref.status))
    assert not got.U.sharding.is_fully_replicated
