"""Noise-robustness seed sweeps for the closed loop.

The reference injects Gaussian actuation noise (sigma 0.1 LF / 0.05 CA,
``optimizer.py:345-354, 611-615``) but never checks the noised trajectory —
its collision check result is printed, not asserted
(``test/test_mpc_planner.py:46-47``).  Here noised runs are quality-gated:
across seeds, the overtaking maneuver must keep clearing the obstacle.

These sweeps guard two specific failure modes found during development:
  * RTI commitment collapse: with too few SQP re-linearizations per step
    (``ip_sqp_iters`` < 5), a noise kick can fold the iterate back into the
    blocked lane and the planner sails through the obstacle band.
  * cold-start basins: without the obstacle-free warmup solve, deep-horizon
    cold starts from a straight-line init fight the obstacle from a saddle
    and some lanes never find the avoidance side.
"""
import os

import numpy as np
import pytest

from mpc_tpu.io.config import load_config
from mpc_tpu.planner import closed_loop as cl

from asset_paths import CFG, GOLD, SCN  # noqa: F401
OBS = np.array([59.948, 0.083])  # ZAM_Over-1_1 obstacle center


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_noised_ca_overtake_clears_obstacle(seed):
    """FP-mode CA with boundary corridor + actuation noise: every seed must
    commit to the overtake and clear the obstacle."""
    c = load_config("configs/config_CA_ZAM_Over-1_1_forcespro.yaml",
                    SCN)
    lcfg = cl.make_loop_config(c, noised=True)
    params = cl.make_loop_params(c, lcfg, seed=seed)
    res = cl.closed_loop_jit(lcfg, params)
    X = np.asarray(res.X)
    d = np.linalg.norm(X[:, :2] - OBS, axis=1)
    assert float(d.min()) > 3.0, (seed, float(d.min()))


@pytest.mark.parametrize("seed", [0, 1])
def test_noised_casadi_ca_clears_obstacle(seed):
    """CasADi-parity CA (AL method) under the reference's noise sigma."""
    c = load_config(os.path.join(CFG,
                                 "config_CA_ZAM_Over-1_1.yaml"),
                    SCN)
    lcfg = cl.make_loop_config(c, noised=True)
    params = cl.make_loop_params(c, lcfg, seed=seed)
    res = cl.closed_loop_jit(lcfg, params)
    X = np.asarray(res.X)
    d = np.linalg.norm(X[:, :2] - OBS, axis=1)
    assert float(d.min()) > 3.0, (seed, float(d.min()))


def test_deep_horizon_batch_fully_feasible():
    """Synthetic H=30 batch (the bench workload): the obstacle-free warmup
    must leave every lane feasible at every step."""
    from mpc_tpu.utils import synthetic

    lcfg, params = synthetic.make_bench_loop(
        n_steps=6, horizon=30, n_lanes=64, method="al")
    assert lcfg.warmup_obstacle_free
    res = cl.closed_loop_batch_vec(lcfg, params)
    status = np.asarray(res.status)
    viol = np.asarray(res.viol)
    assert (status >= 0).all(), f"{int((status < 0).sum())} infeasible steps"
    assert float(viol.max()) < 0.05


@pytest.mark.parametrize("alphas", [(1.0,), ()])
def test_bench_operating_point_quality(alphas):
    """The bench's true-RTI operating point — al(1,1), headlined with the
    UNGUARDED full step (alphas=(), the reference deployment's maxqps=1
    semantics) and also checked with the merit-guarded variant
    (alphas=(1.0,)) — must match the (3,4) oracle budget closely on the
    bench workload and stay fully feasible (bench.py's headline is only
    meaningful with this property; chip_smoke.py checks feasibility at
    full size on the GPU)."""
    import numpy as np

    from mpc_tpu.planner import closed_loop as cl
    from mpc_tpu.utils import synthetic

    # T >= 20 matters: shorter tracks compress the overtake geometry so
    # the obstacle sits almost on top of the cold start — the known-hard
    # configuration every budget struggles with (PARITY.md "where
    # infeasibility lives"); the bench runs T=100 of the same geometry
    B, T, H = 16, 20, 30
    lcfg_rti, params = synthetic.make_bench_loop(
        n_steps=T, horizon=H, n_lanes=B, method="al",
        al_iters=1, sqp_iters=1, alphas=alphas)
    lcfg_oracle, _ = synthetic.make_bench_loop(
        n_steps=T, horizon=H, n_lanes=B, method="al",
        al_iters=3, sqp_iters=4)
    r1 = cl.closed_loop_batch_vec(lcfg_rti, params)
    r2 = cl.closed_loop_batch_vec(lcfg_oracle, params)
    assert (np.asarray(r1.status) >= 0).all()
    assert (np.asarray(r2.status) >= 0).all()
    dxy = np.abs(np.asarray(r1.X)[..., :2]
                 - np.asarray(r2.X)[..., :2]).max()
    assert dxy < 5e-3, dxy  # mm-scale equivalence


def test_hard_bench_operating_point_quality():
    """bench.py's hard-constrained headline point — IP true RTI at
    1 warm QP x 4 Newton steps with the UNGUARDED full step (the
    reference's maxqps=1 semantics) — must stay fully feasible and match
    the 5x10 IP oracle budget closely on the bench workload (chip_smoke.py
    checks feasibility at full size on the GPU)."""
    from mpc_tpu.utils import synthetic

    B, T, H = 16, 20, 30
    lcfg_rti, params = synthetic.make_bench_loop(
        n_steps=T, horizon=H, n_lanes=B, method="ip",
        ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True, ip_alphas=())
    lcfg_oracle, _ = synthetic.make_bench_loop(
        n_steps=T, horizon=H, n_lanes=B, method="ip",
        ip_sqp_iters=5, ip_iters=10)
    r1 = cl.closed_loop_batch_vec(lcfg_rti, params)
    r2 = cl.closed_loop_batch_vec(lcfg_oracle, params)
    assert (np.asarray(r1.status) >= 0).all(), \
        int((np.asarray(r1.status) < 0).sum())
    assert (np.asarray(r2.status) >= 0).all()
    dxy = np.abs(np.asarray(r1.X)[..., :2]
                 - np.asarray(r2.X)[..., :2]).max()
    assert dxy < 2e-2, dxy  # cm-scale vs the oracle (IP relinearizes once)


def test_ca_stress_budget_binds_and_preset_survives():
    """The ca_stress workload must actually
    DIFFERENTIATE iteration budgets — ungated true-RTI leaves infeasible
    steps where the swerve builds — and the shipped deployment treatment
    (applied-prefix gating, the same gate_stages=1 lever RTI1_CA_SETTINGS
    ships) must survive it 100% feasible with realized clearance at the
    bound."""
    import jax
    import jax.numpy as jnp

    from mpc_tpu.models import constraints as C
    from mpc_tpu.utils import synthetic

    B, T, H = 32, 100, 30
    lcfg_plain, params = synthetic.make_bench_loop(
        n_steps=T, horizon=H, n_lanes=B, method="al", workload="ca_stress",
        al_iters=1, sqp_iters=1, alphas=(1.0,))
    lcfg_gated, _ = synthetic.make_bench_loop(
        n_steps=T, horizon=H, n_lanes=B, method="al", workload="ca_stress",
        al_iters=1, sqp_iters=1, alphas=(1.0,), gate_stages=1)
    r_plain = cl.closed_loop_batch_vec(lcfg_plain, params)
    r_gated = cl.closed_loop_batch_vec(lcfg_gated, params)
    # budget binds: the ungated full-plan gate reports infeasible steps
    # while the obstacle slides into the horizon (CPU-8 measured ~6%)
    n_bad = int((np.asarray(r_plain.status) < 0).sum())
    assert n_bad > 0, "stress workload no longer differentiates budgets"
    # the shipped treatment survives
    assert (np.asarray(r_gated.status) >= 0).all(), \
        int((np.asarray(r_gated.status) < 0).sum())
    # realized safety: min ego-circle-to-obstacle-circle distance at or
    # above the bound (tiny slack for the gated prefix semantics)
    scfg = lcfg_gated.solver
    X = jnp.asarray(np.asarray(r_gated.X))
    obs = params.obs_centers[0]

    def ego_centers(x):
        return C.circle_centers(x[0], x[1], scfg.ego_length,
                                scfg.ego_width, x[4])

    ec = jax.vmap(jax.vmap(ego_centers))(X)
    d = jnp.linalg.norm(ec[:, :, :, None, :] - obs[None, None, None],
                        axis=-1)
    bound = float(np.asarray(params.min_dist)[0])
    assert float(d.min()) > bound - 0.02, (float(d.min()), bound)
