"""Interior-point stagewise QP vs dense scipy oracle."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_tpu.ops import ipqp
from mpc_tpu.ops.sqp import NROWS

NX, NU = 5, 2


def _random_qp(rng, H, with_rows=True):
    def spd(n, scale=1.0):
        m = rng.standard_normal((n, n))
        return scale * (m @ m.T + n * np.eye(n))

    Q = np.stack([spd(NX) for _ in range(H)])
    R = np.stack([spd(NU) for _ in range(H)])
    M = 0.1 * rng.standard_normal((H, NX, NU))
    qx = rng.standard_normal((H, NX))
    qu = rng.standard_normal((H, NU))
    QH = spd(NX)
    qH = rng.standard_normal(NX)
    A = np.stack([np.eye(NX) + 0.1 * rng.standard_normal((NX, NX))
                  for _ in range(H)])
    B = rng.standard_normal((H, NX, NU))
    r = 0.1 * rng.standard_normal((H, NX))
    J = 0.5 * rng.standard_normal((H + 1, NROWS, NX + NU))
    h0 = rng.standard_normal((H + 1, NROWS))
    if with_rows:
        lo = h0 - 0.3 - rng.random((H + 1, NROWS))
        hi = h0 + 0.3 + rng.random((H + 1, NROWS))
        # make some bounds one-sided
        lo[:, ::3] = -np.inf
        hi[:, 1::3] = np.inf
    else:
        lo = np.full((H + 1, NROWS), -np.inf)
        hi = np.full((H + 1, NROWS), np.inf)
    return ipqp.QpData(*[jnp.asarray(v, jnp.float32) for v in
                         (Q, R, M, qx, qu, QH, qH, A, B, r, J, h0, lo, hi)])


def _dense_oracle(qp):
    """Solve the QP with scipy minimize(trust-constr) on the dense form."""
    from scipy.optimize import LinearConstraint, minimize

    H = qp.A.shape[0]
    nz = (H + 1) * NX + H * NU

    def ix(k):
        return slice(k * NX, (k + 1) * NX)

    def iu(k):
        return slice((H + 1) * NX + k * NU, (H + 1) * NX + (k + 1) * NU)

    Hm = np.zeros((nz, nz))
    g = np.zeros(nz)
    Q, R, M, qx, qu = (np.asarray(v, np.float64) for v in
                       (qp.Q, qp.R, qp.M, qp.qx, qp.qu))
    QH, qH, A, B, r = (np.asarray(v, np.float64) for v in
                       (qp.QH, qp.qH, qp.A, qp.B, qp.r))
    J, h0, lo, hi = (np.asarray(v, np.float64) for v in
                     (qp.J, qp.h0, qp.lo, qp.hi))
    for k in range(H):
        Hm[ix(k), ix(k)] += Q[k]
        Hm[iu(k), iu(k)] += R[k]
        Hm[ix(k), iu(k)] += M[k]
        Hm[iu(k), ix(k)] += M[k].T
        g[ix(k)] += qx[k]
        g[iu(k)] += qu[k]
    Hm[ix(H), ix(H)] += QH
    g[ix(H)] += qH

    # equality: dynamics + dx0 = 0
    nc = (H + 1) * NX
    C = np.zeros((nc, nz))
    d = np.zeros(nc)
    C[0:NX, ix(0)] = np.eye(NX)
    for k in range(H):
        row = slice((k + 1) * NX, (k + 2) * NX)
        C[row, ix(k + 1)] = np.eye(NX)
        C[row, ix(k)] = -A[k]
        C[row, iu(k)] = -B[k]
        d[row] = r[k]

    # inequality rows: lo - h0 <= J dz <= hi - h0 (terminal J's u-cols hit
    # dU[H-1], mirroring ipqp._rows_value)
    Grows = []
    lorows = []
    hirows = []
    for k in range(H + 1):
        for rr in range(NROWS):
            gr = np.zeros(nz)
            gr[ix(k)] = J[k, rr, :NX]
            ku = min(k, H - 1)
            gr[iu(ku)] += J[k, rr, NX:]
            Grows.append(gr)
            lorows.append(lo[k, rr] - h0[k, rr])
            hirows.append(hi[k, rr] - h0[k, rr])

    cons = [LinearConstraint(C, d, d),
            LinearConstraint(np.asarray(Grows), np.asarray(lorows),
                             np.asarray(hirows))]
    res = minimize(lambda z: 0.5 * z @ Hm @ z + g @ z,
                   np.zeros(nz), jac=lambda z: Hm @ z + g,
                   constraints=cons, method="trust-constr",
                   options={"maxiter": 600, "gtol": 1e-9, "xtol": 1e-12})
    z = res.x
    dX = z[:(H + 1) * NX].reshape(H + 1, NX)
    dU = z[(H + 1) * NX:].reshape(H, NU)
    return dX, dU


@pytest.mark.parametrize("H", [3, 8])
def test_ip_matches_oracle(H):
    rng = np.random.default_rng(11 + H)
    qp = _random_qp(rng, H)
    st = ipqp.solve_qp(qp, n_iters=20)
    dX_o, dU_o = _dense_oracle(qp)
    np.testing.assert_allclose(np.asarray(st.dU), dU_o, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(st.dX), dX_o, rtol=2e-2, atol=2e-2)


def test_ip_unconstrained_matches_riccati():
    rng = np.random.default_rng(21)
    qp = _random_qp(rng, 6, with_rows=False)
    st = ipqp.solve_qp(qp, n_iters=8)
    from mpc_tpu.ops import riccati
    quad = riccati.StageQuad(Q=qp.Q, R=qp.R, M=qp.M, qx=qp.qx, qu=qp.qu)
    dyn = riccati.LinDyn(A=qp.A, B=qp.B, r=qp.r)
    dX, dU, _ = riccati.solve_lqr(quad, qp.QH, qp.qH, dyn,
                                  jnp.zeros(NX, jnp.float32), 0.0)
    np.testing.assert_allclose(np.asarray(st.dU), np.asarray(dU),
                               rtol=1e-3, atol=1e-3)


def test_ip_respects_bounds():
    rng = np.random.default_rng(31)
    qp = _random_qp(rng, 8)
    st = ipqp.solve_qp(qp, n_iters=20)
    c = np.asarray(ipqp._rows_value(qp, st.dX, st.dU))
    lo, hi = np.asarray(qp.lo), np.asarray(qp.hi)
    viol = np.maximum(np.maximum(lo - c, c - hi), 0.0)
    viol = np.where(np.isfinite(viol), viol, 0.0)
    assert viol.max() < 5e-3


def test_ip_batched_vmap():
    rng = np.random.default_rng(41)
    qps = [_random_qp(rng, 5) for _ in range(3)]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    sts = jax.vmap(lambda q: ipqp.solve_qp(q, n_iters=15))(batch)
    for i, q in enumerate(qps):
        st_i = ipqp.solve_qp(q, n_iters=15)
        np.testing.assert_allclose(np.asarray(sts.dU[i]),
                                   np.asarray(st_i.dU), rtol=1e-4, atol=1e-4)


def test_ip_mode_status_semantics_match_al():
    """IP-mode kkt_stat is a real Lagrangian-stationarity residual (was
    hardwired 0.0): converged solves report small-but-NONZERO kkt_stat and
    status==1 requires BOTH stationarity and feasibility, the same contract
    as method='al' (reference analogs: IPOPT's convergence criteria,
    optimizer.py:556-558; FORCESPRO's exitflag, FORCESNLPsolver.h:96-100)."""
    from mpc_tpu.ops import sqp
    from tests.test_sqp import straight_params

    p = straight_params(10, v=15.0)
    cfg = sqp.SolverConfig(horizon=10, method="ip")
    sol = sqp.solve(cfg, p, sqp.init_state(cfg))
    stat = float(sol.kkt_stat)
    assert stat > 0.0                      # measured, not hardwired
    assert stat < cfg.tol_stat_ip          # benign instance: converges
    assert float(sol.viol) < cfg.tol_feas
    assert int(sol.status) == 1

    # a lane far from stationarity must NOT report status 1 even if feasible
    cfg_weak = sqp.SolverConfig(horizon=10, method="ip", ip_sqp_iters=1,
                                ip_iters=1)
    p_hard = p._replace(
        x0=p.x0.at[1].set(2.5).at[4].set(0.4))  # off-path, heading error
    sol_weak = sqp.solve(cfg_weak, p_hard, sqp.init_state(cfg_weak))
    if float(sol_weak.viol) < cfg_weak.tol_feas:
        assert float(sol_weak.kkt_stat) >= cfg_weak.tol_stat_ip or \
            int(sol_weak.status) == 1
    # and the residual is larger than the converged one
    assert float(sol_weak.kkt_stat) > stat


def test_ip_infeasible_start_boundary():
    """Infeasible-start relaxation (ipqp.init_ip): a cold start whose
    rollout crosses a road boundary must still converge at the default
    5x10 budget.

    Before the relaxation, violated rows started at slack s_min=1e-2 with
    dual mu0/s_min = 100, making the row weight sigma = z/s = 1e4 — the
    stiffened Newton system truncated every fraction-to-boundary step and
    the default budget ended infeasible (status -7, ~0.4 m boundary
    violation) on exactly this instance.
    """
    from mpc_tpu.ops import sqp
    from tests.test_sqp_vec import _straight_corridor
    from tests.test_sqp import straight_params

    H = 12
    p = straight_params(H, v=15.0)
    # heading 0.35 rad at 15 m/s: the zero-input cold rollout drifts ~6 m
    # up and crosses the upper boundary line (6.5 - r_ego = 5.3) near the
    # end of the horizon; recovery is dynamically feasible
    p = p._replace(x0=p.x0.at[4].set(0.35))
    bnds, signs = _straight_corridor(y_left=6.5, y_right=-6.5)
    p = p._replace(boundaries=bnds, boundary_signs=signs)
    cfg = sqp.SolverConfig(horizon=H, method="ip", boundary_rows=True)
    sol = sqp.solve(cfg, p, sqp.init_state(cfg))
    assert int(sol.status) >= 0, f"status {int(sol.status)}"
    assert float(sol.viol) < cfg.tol_infeas
    # and the plain (boundary-free) solve still converges as before
    cfg0 = sqp.SolverConfig(horizon=H, method="ip")
    sol0 = sqp.solve(cfg0, straight_params(H, v=15.0), sqp.init_state(cfg0))
    assert int(sol0.status) == 1
