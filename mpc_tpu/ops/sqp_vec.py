"""Batched-native AL-SQP solve using the lanes-trailing hot kernels.

``sqp.solve`` is written per-lane and vmapped — correct but layout-hostile
inside the sequential scans (see ``ops.riccati_vec``).  This module is the
throughput path: the same algorithm with the backward sweep and the
line-search rollouts running in lanes-trailing form over the whole batch.
Equivalence with the vmapped reference implementation is tested in
``tests/test_sqp_vec.py``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from mpc_tpu.ops import riccati_vec
from mpc_tpu.ops import sqp as S


def _gn_iteration_vec(cfg: S.SolverConfig, params: S.OcpParams,
                      lam_lo, lam_hi, mu, X, U):
    """One batched Gauss-Newton step; all arrays carry a leading lane axis."""
    quad, QH, qH = jax.vmap(
        lambda X1, U1, p1, ll, lh, m1: S._build_quadratic(
            cfg, X1, U1, p1, ll, lh, m1))(X, U, params, lam_lo, lam_hi, mu)
    dyn = jax.vmap(lambda X1, U1: S._linearize_dynamics(cfg, X1, U1))(X, U)
    gains = riccati_vec.backward_pass_vec(quad, QH, qH, dyn, cfg.reg)

    u_lo, u_hi, _, _ = cfg.bounds.as_arrays(X.dtype)
    if len(cfg.alphas) == 0:
        # unguarded full RTI step (maxqps=1 semantics; mirrors sqp.py's
        # ``alphas=()`` branch): scrub NaN gains, apply alpha=1
        # unconditionally, no merit rollouts
        K = jnp.nan_to_num(gains.K, nan=0.0, posinf=0.0, neginf=0.0)
        d = jnp.nan_to_num(gains.d, nan=0.0, posinf=0.0, neginf=0.0)
        Xa, Ua = riccati_vec.feedback_rollout_vec(
            None, cfg.dt, cfg.wheelbase, params.x0, X, U, K, d,
            (1.0,), u_lo, u_hi, cfg.integrator, cfg.model, cfg.vehicle)
        return Xa[0], Ua[0]
    Xa, Ua = riccati_vec.feedback_rollout_vec(
        None, cfg.dt, cfg.wheelbase, params.x0, X, U, gains.K, gains.d,
        cfg.alphas, u_lo, u_hi, cfg.integrator, cfg.model, cfg.vehicle)

    merit_fn = jax.vmap(jax.vmap(
        lambda X1, U1, p1, ll, lh, m1: S._merit(cfg, X1, U1, p1, ll, lh, m1),
        in_axes=(0, 0, None, None, None, None)),
        in_axes=(1, 1, 0, 0, 0, 0), out_axes=1)
    # Xa: (A, B, ...) -> vmap lanes (axis 1) outer, alphas inner is awkward;
    # simpler: flatten alpha into the merit computation per lane
    merits = jax.vmap(
        lambda Xl, Ul, p1, ll, lh, m1: jax.vmap(
            lambda X1, U1: S._merit(cfg, X1, U1, p1, ll, lh, m1))(Xl, Ul),
        in_axes=(1, 1, 0, 0, 0, 0))(Xa, Ua, params, lam_lo, lam_hi, mu)
    # merits: (B, A)
    merit0 = jax.vmap(
        lambda X1, U1, p1, ll, lh, m1: S._merit(cfg, X1, U1, p1, ll, lh, m1)
    )(X, U, params, lam_lo, lam_hi, mu)
    best = jnp.argmin(merits, axis=1)                       # (B,)
    lane = jnp.arange(X.shape[0])
    improved = merits[lane, best] < merit0                  # (B,)
    Xb = jnp.swapaxes(Xa, 0, 1)[lane, best]                 # (B, H+1, NX)
    Ub = jnp.swapaxes(Ua, 0, 1)[lane, best]
    w = improved[:, None, None]
    X_new = jnp.where(w, Xb, X)
    U_new = jnp.where(w, Ub, U)
    return X_new, U_new


@S.full_f32_contractions
def solve_batch_vec(cfg: S.SolverConfig, params: S.OcpParams,
                    state: S.SqpState) -> S.Solution:
    """Batched AL solve (lanes-trailing hot path); same contract as
    ``sqp.solve_batch``.  AL method only (the IP path has its own shape)."""
    if cfg.method != "al":
        return S.solve_batch(cfg, params, state)

    params = S.normalize_params(cfg, params)
    rollout = jax.vmap(lambda p, U1: S._rollout(cfg, p.x0, U1))
    X0 = rollout(params, state.U)

    def outer(carry, _):
        X, U, lam_lo, lam_hi, mu, prev_viol = carry

        def inner(c, _):
            Xc, Uc = c
            Xn, Un = _gn_iteration_vec(cfg, params, lam_lo, lam_hi, mu,
                                       Xc, Uc)
            return (Xn, Un), None

        (X, U), _ = jax.lax.scan(inner, (X, U), None, length=cfg.sqp_iters)

        h, lo, hi = jax.vmap(
            lambda X1, U1, p1: S._all_rows(cfg, X1, U1, p1))(X, U, params)
        t_hi = lam_hi + mu * (h - hi)
        t_lo = lam_lo + mu * (lo - h)
        lam_hi = jnp.clip(jnp.where(t_hi > 0, t_hi, 0.0), 0.0, cfg.lam_max)
        lam_lo = jnp.clip(jnp.where(t_lo > 0, t_lo, 0.0), 0.0, cfg.lam_max)
        viol_row = jnp.maximum(jnp.maximum(lo - h, h - hi), 0.0)
        viol_row = jnp.where(jnp.isfinite(viol_row), viol_row, 0.0)
        stalled = viol_row > cfg.viol_improve * prev_viol
        active = viol_row > cfg.tol_feas
        mu = jnp.where(stalled & active, mu * cfg.mu_factor, mu)
        mu = jnp.clip(mu, cfg.mu0, cfg.mu_max)
        return (X, U, lam_lo, lam_hi, mu, viol_row), None

    init = (X0, state.U, state.lam_lo, state.lam_hi, state.mu,
            state.prev_viol)
    (X, U, lam_lo, lam_hi, mu, prev_viol), _ = jax.lax.scan(
        outer, init, None, length=cfg.al_iters)

    stat, viol = jax.vmap(
        lambda p1, X1, U1, ll, lh, m1: S._kkt_residuals(
            cfg, p1, X1, U1, ll, lh, m1))(params, X, U, lam_lo, lam_hi, mu)
    converged = (stat < cfg.tol_stat) & (viol < cfg.tol_feas)
    feasible = viol < jnp.asarray(cfg.tol_infeas, X.dtype)
    status = jnp.where(converged, 1, jnp.where(feasible, 0, -7)).astype(
        jnp.int32)

    new_state = S.SqpState(U=U, lam_lo=lam_lo, lam_hi=lam_hi, mu=mu,
                           prev_viol=prev_viol)
    cost = jax.vmap(lambda X1, U1, p1: S._objective(cfg, X1, U1, p1))(
        X, U, params)
    merit = jax.vmap(
        lambda X1, U1, p1, ll, lh, m1: S._merit(cfg, X1, U1, p1, ll, lh, m1)
    )(X, U, params, lam_lo, lam_hi, mu)
    return S.Solution(X=X, U=U, state=new_state, status=status,
                      kkt_stat=stat, viol=viol, cost=cost, merit=merit)


solve_batch_vec_jit = partial(jax.jit, static_argnums=0)(solve_batch_vec)
