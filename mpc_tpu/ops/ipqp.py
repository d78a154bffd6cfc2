"""Primal-dual interior-point stagewise QP + real-time-iteration SQP.

This is the "condensed-QP / Riccati-sweep backend" of the north star: the
role IPOPT plays for the reference's CasADi path and the generated
SQP_NLP solver plays for FORCESPRO (``optimizer.py:558``, ``optimizer.py:
197-245``) — but batched, fixed-iteration, and compiled by XLA.

Each SQP iteration linearizes dynamics + constraint rows at the current
trajectory and solves the resulting two-sided-row stagewise QP

    min  1/2 dz' H dz + g' dz
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + r_k,   dx_0 = 0
         lo <= J_k dz_k + h_k <= hi

with a slack primal-dual interior-point method (HPIPM-style):
  * each IP Newton step reduces, after eliminating slacks and row duals, to
    an equality-constrained stagewise QP with row-weighted Hessian
    H + J' diag(sigma) J — solved exactly by the existing Riccati sweep;
  * fraction-to-boundary steps keep slacks/duals strictly positive;
  * the barrier parameter follows the average complementarity gap;
  * iteration counts are FIXED (no data-dependent control flow), so
    thousands of lanes run in lockstep under vmap.

Unlike the augmented-Lagrangian path (``ops.sqp``), the applied step
respects the *linearized* constraints to IP tolerance at every MPC step —
the property that makes warm-started real-time iteration robust when
constraints activate suddenly (obstacle entering the horizon).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_tpu.ops import riccati

NX = 5  # KS default; every kernel below derives the actual NX/NU from QpData
NU = 2
_WARM_KAPPA = 100.0  # warm-start dual clip band around the central path
# float32 overflow guards (HPIPM-style iterate safeguards): on a
# degenerate row the dual can blow up super-exponentially (dz ~ -sigma*ds
# grows z by sigma each step, and sigma = z/s feeds back), overflowing
# sigma to inf in f32 — one inf in J'SJ turns the whole Riccati sweep NaN
# and the NaN then persists in the dual state (observed: 1 lane in 8 of
# a virtual-mesh dry run's open-loop batch).
# Guards: floor slacks at _S_FLOOR and cap duals at _Z_MAX (the same 1e6
# the AL path's lam_max soft-slack clamp uses), bounding sigma <= 1e16 —
# safely inside f32 range while leaving ordinary iterates untouched
# (converged active-row duals are O(1..1e4); capping sigma itself would
# bind on ordinary rows, sigma = z^2/mu >= 1e8 whenever z >= 1 at
# mu = 1e-8, and shift converged trajectories).
_S_FLOOR = 1e-10
_Z_MAX = 1e6


class QpData(NamedTuple):
    """Stagewise QP data (single lane).

    H_*: cost blocks per stage; J: (H+1, NROWS, NX+NU) row Jacobians
    (terminal rows use only the dx columns); h0/lo/hi: (H+1, NROWS).
    """

    Q: jax.Array      # (H, NX, NX)
    R: jax.Array      # (H, NU, NU)
    M: jax.Array      # (H, NX, NU)
    qx: jax.Array     # (H, NX)
    qu: jax.Array     # (H, NU)
    QH: jax.Array     # (NX, NX)
    qH: jax.Array     # (NX,)
    A: jax.Array      # (H, NX, NX)
    B: jax.Array      # (H, NX, NU)
    r: jax.Array      # (H, NX)
    J: jax.Array      # (H+1, NROWS, NX+NU)
    h0: jax.Array     # (H+1, NROWS)
    lo: jax.Array     # (H+1, NROWS)
    hi: jax.Array     # (H+1, NROWS)


class IpState(NamedTuple):
    dX: jax.Array     # (H+1, NX)
    dU: jax.Array     # (H, NU)
    s_lo: jax.Array   # (H+1, NROWS) slacks for c - lo
    s_hi: jax.Array   # (H+1, NROWS) slacks for hi - c
    z_lo: jax.Array   # (H+1, NROWS) duals
    z_hi: jax.Array   # (H+1, NROWS)
    mu: jax.Array     # () barrier parameter


def _rows_value(qp: QpData, dX, dU):
    """c_k = J_k dz_k + h0_k for all stages (terminal uses dU[H-1])."""
    dU_ext = jnp.concatenate([dU, dU[-1:]], axis=0)
    dz = jnp.concatenate([dX, dU_ext], axis=1)          # (H+1, NX+NU)
    return jnp.einsum("krz,kz->kr", qp.J, dz) + qp.h0


def init_ip(qp: QpData, mu0: float = 1.0, s_min: float = 1e-2,
            z_lo0: jax.Array | None = None,
            z_hi0: jax.Array | None = None) -> IpState:
    """Cold (default) or dual-warm-started IP state.

    Warm start (``z_lo0``/``z_hi0`` given, e.g. shifted duals from the
    previous MPC step): carried duals are clipped to a band of factor
    ``_WARM_KAPPA`` around the central-path value mu0/s.  Rows that were
    active keep (capped) large duals — the RTI lever that lets a single
    warm QP per step stay feasible — while the clip bounds the initial
    complementarity spread, preventing the multiplicative dual blow-up that
    raw carried duals cause on rows violated at the new linearization
    (dz ~ -(z/s) ds grows z by |ds|/s per Newton step when s = s_min).
    Zero carried duals (cold state) reduce to the cold init exactly.

    Infeasible-start relaxation: rows VIOLATED at the linearization point
    (margin <= 0) get slack 1.0 and the central dual mu0 — NOT the clamped
    tiny slack s_min with its mu0/s_min = 100 dual.  A tiny-slack start on
    a violated row makes the row weight sigma = z/s = 1e4, which stiffens
    the Newton system and truncates every fraction-to-boundary step; the
    relaxed start lets the slack-consistency residual rs = s - (c - lo)
    drive the row back linearly.  Feasible-but-tight rows (0 < margin <
    s_min, e.g. warm starts riding an active bound) keep the clamped tiny
    slack — their sigma is the legitimate central path.  (Without the
    relaxation, a cold start that crosses a road boundary needs ~4x the
    Newton budget to recover — see tests/test_ipqp.py::
    test_ip_infeasible_start_boundary.)
    """
    dX = jnp.zeros((qp.A.shape[0] + 1, qp.Q.shape[-1]), qp.A.dtype)
    dU = jnp.zeros((qp.A.shape[0], qp.R.shape[-1]), qp.A.dtype)
    c = qp.h0
    m_lo = jnp.isfinite(qp.lo)
    m_hi = jnp.isfinite(qp.hi)
    s_lo = jnp.where(m_lo, jnp.where(c - qp.lo <= 0, 1.0,
                                     jnp.maximum(c - qp.lo, s_min)), 1.0)
    s_hi = jnp.where(m_hi, jnp.where(qp.hi - c <= 0, 1.0,
                                     jnp.maximum(qp.hi - c, s_min)), 1.0)
    z_lo = mu0 / s_lo
    z_hi = mu0 / s_hi
    if z_lo0 is not None:
        z_lo = jnp.clip(jnp.where(z_lo0 > 0, z_lo0, z_lo),
                        z_lo / _WARM_KAPPA, z_lo * _WARM_KAPPA)
    if z_hi0 is not None:
        z_hi = jnp.clip(jnp.where(z_hi0 > 0, z_hi0, z_hi),
                        z_hi / _WARM_KAPPA, z_hi * _WARM_KAPPA)
    z_lo = jnp.where(m_lo, z_lo, 0.0)
    z_hi = jnp.where(m_hi, z_hi, 0.0)
    return IpState(dX=dX, dU=dU, s_lo=s_lo, s_hi=s_hi, z_lo=z_lo,
                   z_hi=z_hi, mu=jnp.asarray(mu0, qp.A.dtype))


def _cost_grad(qp: QpData, dX, dU):
    """Gradient of the QP objective at the current primal, per stage."""
    gx = (jnp.einsum("kij,kj->ki", qp.Q, dX[:-1])
          + jnp.einsum("kij,kj->ki", qp.M, dU) + qp.qx)
    gu = (jnp.einsum("kji,kj->ki", qp.M, dX[:-1])
          + jnp.einsum("kij,kj->ki", qp.R, dU) + qp.qu)
    gH = qp.QH @ dX[-1] + qp.qH
    return gx, gu, gH


def ip_iteration(qp: QpData, st: IpState, reg: float,
                 sigma: float = 0.2, tau: float = 0.995) -> IpState:
    """One primal-dual Newton step on the QP (fixed-shape)."""
    NX = qp.Q.shape[-1]  # 5 (KS) or 7 (ST); shadows the module default
    m_lo = jnp.isfinite(qp.lo)
    m_hi = jnp.isfinite(qp.hi)
    c = _rows_value(qp, st.dX, st.dU)
    rs_lo = jnp.where(m_lo, st.s_lo - (c - qp.lo), 0.0)
    rs_hi = jnp.where(m_hi, st.s_hi - (qp.hi - c), 0.0)

    sig_lo = jnp.where(m_lo, st.z_lo / st.s_lo, 0.0)
    sig_hi = jnp.where(m_hi, st.z_hi / st.s_hi, 0.0)
    sigma_rows = sig_lo + sig_hi                       # (H+1, NROWS)

    mu = st.mu
    # Newton RHS row force after eliminating (ds, dz): the current duals
    # z cancel exactly against the -z term of the dz elimination
    # (z + dz = mu/s + sig*(J ddz) + sig*rs), leaving mu/s + sig*rs per
    # side.  Round 2 added z back in (w = z + q_rows), which converges to
    # the right primal but as a doubled-barrier scheme with half-scale
    # duals — ~10x slower at fixed Newton budgets (oracle sweep, round 3:
    # max dU err at 6 iterations 0.0067 vs 0.0003).
    w_rows = (jnp.where(m_hi, mu / st.s_hi, 0.0)
              - jnp.where(m_lo, mu / st.s_lo, 0.0)
              + sig_hi * rs_hi - sig_lo * rs_lo)

    # stage quadratic: cost + row terms
    JtSJ = jnp.einsum("krz,kr,krw->kzw", qp.J, sigma_rows, qp.J)
    Jtw = jnp.einsum("krz,kr->kz", qp.J, w_rows)

    gx, gu, gH = _cost_grad(qp, st.dX, st.dU)
    Qs = qp.Q + JtSJ[:-1, :NX, :NX]
    Rs = qp.R + JtSJ[:-1, NX:, NX:]
    Ms = qp.M + JtSJ[:-1, :NX, NX:]
    qx = gx + Jtw[:-1, :NX]
    qu = gu + Jtw[:-1, NX:]
    QHs = qp.QH + JtSJ[-1, :NX, :NX]
    qHs = gH + Jtw[-1, :NX]

    quad = riccati.StageQuad(Q=Qs, R=Rs, M=Ms, qx=qx, qu=qu)
    # defects of the current primal (zero if steps preserve linear dynamics,
    # but computed for safety)
    defect = (jnp.einsum("kij,kj->ki", qp.A, st.dX[:-1])
              + jnp.einsum("kij,kj->ki", qp.B, st.dU) + qp.r
              - st.dX[1:])
    dyn = riccati.LinDyn(A=qp.A, B=qp.B, r=defect)
    ddX, ddU, _ = riccati.solve_lqr(quad, QHs, qHs, dyn,
                                    jnp.zeros(NX, qp.A.dtype), reg)

    # recover slack/dual steps
    ddU_ext = jnp.concatenate([ddU, ddU[-1:]], axis=0)
    ddz = jnp.concatenate([ddX, ddU_ext], axis=1)
    Jd = jnp.einsum("krz,kz->kr", qp.J, ddz)
    ds_lo = jnp.where(m_lo, Jd - rs_lo, 0.0)
    ds_hi = jnp.where(m_hi, -Jd - rs_hi, 0.0)
    dz_lo = jnp.where(m_lo, mu / st.s_lo - st.z_lo
                      - sig_lo * ds_lo, 0.0)
    dz_hi = jnp.where(m_hi, mu / st.s_hi - st.z_hi
                      - sig_hi * ds_hi, 0.0)

    # fraction-to-boundary step length (scalar per lane)
    def max_step(v, dv, mask):
        ratio = jnp.where(mask & (dv < 0), -v / jnp.where(dv < 0, dv, -1.0),
                          jnp.inf)
        return jnp.min(ratio)

    alpha = jnp.minimum(1.0, tau * jnp.minimum(
        jnp.minimum(max_step(st.s_lo, ds_lo, m_lo),
                    max_step(st.s_hi, ds_hi, m_hi)),
        jnp.minimum(max_step(st.z_lo, dz_lo, m_lo),
                    max_step(st.z_hi, dz_hi, m_hi))))

    s_lo = jnp.where(m_lo, jnp.maximum(st.s_lo + alpha * ds_lo, _S_FLOOR),
                     1.0)
    s_hi = jnp.where(m_hi, jnp.maximum(st.s_hi + alpha * ds_hi, _S_FLOOR),
                     1.0)
    z_lo = jnp.where(m_lo, jnp.minimum(st.z_lo + alpha * dz_lo, _Z_MAX),
                     0.0)
    z_hi = jnp.where(m_hi, jnp.minimum(st.z_hi + alpha * dz_hi, _Z_MAX),
                     0.0)

    # barrier update from the average complementarity gap
    n_act = (jnp.sum(m_lo) + jnp.sum(m_hi)).astype(qp.A.dtype)
    gap = (jnp.sum(jnp.where(m_lo, s_lo * z_lo, 0.0))
           + jnp.sum(jnp.where(m_hi, s_hi * z_hi, 0.0))) / n_act
    mu_new = jnp.maximum(sigma * gap, 1e-8)

    return IpState(dX=st.dX + alpha * ddX, dU=st.dU + alpha * ddU,
                   s_lo=s_lo, s_hi=s_hi, z_lo=z_lo, z_hi=z_hi, mu=mu_new)


def solve_qp(qp: QpData, n_iters: int = 10, reg: float = 1e-7,
             mu0: float = 1.0,
             z_lo0: jax.Array | None = None,
             z_hi0: jax.Array | None = None) -> IpState:
    """Fixed-iteration IP solve of the stagewise QP (single lane)."""
    st = init_ip(qp, mu0, z_lo0=z_lo0, z_hi0=z_hi0)

    def body(s, _):
        return ip_iteration(qp, s, reg), None

    st, _ = jax.lax.scan(body, st, None, length=n_iters)
    return st
