"""Riccati-sweep LQR backend for the SQP engine.

This is the batched replacement for the factorization work that the
reference outsources to IPOPT's interior-point linear solver (CasADi path,
``MPC_Planner/optimizer.py:558``) and to the FORCESPRO generated C solver's
stagewise QP (``optimizer.py:197-245``): the equality-constrained stagewise QP

    min  sum_k 1/2 [dx;du]_k' [[Q, M],[M', R]]_k [dx;du]_k + [qx;qu]_k'[dx;du]_k
         + 1/2 dx_H' Q_H dx_H + q_H' dx_H
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + r_k,   dx_0 = dx0

is solved exactly by one backward Riccati recursion + one forward rollout.
Everything is ``lax.scan`` over stages and ``vmap``-able over a batch of
problem instances (lanes); all shapes are static.

The input-space inverse is closed-form (nu = 2), so there is no LAPACK call
anywhere on the hot path.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class StageQuad(NamedTuple):
    """Stagewise quadratic model (stacked over the horizon, leading axis H).

    Q:  (H, nx, nx)  state Hessian blocks
    R:  (H, nu, nu)  input Hessian blocks
    M:  (H, nx, nu)  state-input cross blocks
    qx: (H, nx)      state gradients
    qu: (H, nu)      input gradients
    """

    Q: jax.Array
    R: jax.Array
    M: jax.Array
    qx: jax.Array
    qu: jax.Array


class LinDyn(NamedTuple):
    """Linearized dynamics dx' = A dx + B du + r, stacked over the horizon."""

    A: jax.Array  # (H, nx, nx)
    B: jax.Array  # (H, nx, nu)
    r: jax.Array  # (H, nx) defect / affine term


class RiccatiGains(NamedTuple):
    K: jax.Array   # (H, nu, nx) feedback gains
    d: jax.Array   # (H, nu)     feedforward terms
    dV1: jax.Array  # () predicted cost decrease, linear term  sum d'qu
    dV2: jax.Array  # () predicted cost decrease, quadratic term sum d'Quu d


def _inv2x2(m: jax.Array) -> jax.Array:
    """Closed-form 2x2 inverse (nu = 2); avoids any linear-solve primitive."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / det
    row0 = jnp.stack([d, -b], axis=-1)
    row1 = jnp.stack([-c, a], axis=-1)
    return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]


def _inv_nu(m: jax.Array) -> jax.Array:
    if m.shape[-1] == 2:
        return _inv2x2(m)
    # general fallback (still jittable; used only for exotic input dims)
    return jnp.linalg.inv(m)


def backward_pass(quad: StageQuad, QH: jax.Array, qH: jax.Array,
                  dyn: LinDyn, reg: float | jax.Array) -> RiccatiGains:
    """Backward Riccati recursion with input-space regularization.

    ``reg`` plays the role of FORCESPRO's ``sqp_nlp.reg_hessian``
    (``optimizer.py:238``, 5e-6 in the reference).
    Returns gains plus the predicted value decrease terms used by the
    line search (dV(alpha) = alpha * dV1 + alpha^2/2 * dV2).
    """

    def step(carry, stage):
        P, p = carry
        Q, R, M, qx, qu, A, B, r = stage
        Pr_p = p + P @ r
        PA = P @ A
        PB = P @ B
        Qxx = Q + A.T @ PA
        Quu = R + B.T @ PB
        Qux = M.T + B.T @ PA
        gx = qx + A.T @ Pr_p
        gu = qu + B.T @ Pr_p
        Quu_reg = Quu + reg * jnp.eye(Quu.shape[-1], dtype=Quu.dtype)
        Quu_inv = _inv_nu(Quu_reg)
        K = -(Quu_inv @ Qux)
        d = -(Quu_inv @ gu)
        P_new = Qxx + Qux.T @ K
        # symmetrize to control float32 drift over long horizons
        P_new = 0.5 * (P_new + P_new.T)
        p_new = gx + Qux.T @ d
        dv1 = d @ gu
        dv2 = d @ (Quu_reg @ d)
        return (P_new, p_new), (K, d, dv1, dv2)

    stages = (quad.Q, quad.R, quad.M, quad.qx, quad.qu, dyn.A, dyn.B, dyn.r)
    (_, _), (K, d, dv1, dv2) = jax.lax.scan(
        step, (QH, qH), stages, reverse=True)
    return RiccatiGains(K=K, d=d, dV1=jnp.sum(dv1), dV2=jnp.sum(dv2))


def solve_lqr(quad: StageQuad, QH: jax.Array, qH: jax.Array, dyn: LinDyn,
              dx0: jax.Array, reg: float | jax.Array):
    """Full LQR solve: backward sweep then linear forward rollout.

    Returns (dX, dU) with dX: (H+1, nx), dU: (H, nu) — the exact minimizer of
    the stagewise QP.  Used directly by tests (against a dense KKT oracle) and
    by the SQP's linear step prediction.
    """
    gains = backward_pass(quad, QH, qH, dyn, reg)

    def fwd(dx, stage):
        K, d, A, B, r = stage
        du = K @ dx + d
        dx_next = A @ dx + B @ du + r
        return dx_next, (dx, du)

    dx_H, (dX, dU) = jax.lax.scan(
        fwd, dx0, (gains.K, gains.d, dyn.A, dyn.B, dyn.r))
    dX = jnp.concatenate([dX, dx_H[None]], axis=0)
    return dX, dU, gains
