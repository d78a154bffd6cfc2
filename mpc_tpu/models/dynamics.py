"""Vehicle dynamics as pure jnp functions.

Replacement for the reference's CasADi symbolic dynamics
(``MPC_Planner/configuration.py:339-398``).  Instead of building a symbolic
graph per solve (the reference rebuilds the CasADi NLP every MPC step,
``optimizer.py:605``), these are plain traced functions: XLA compiles them once
and ``jax.jacfwd`` provides exact linearizations for the SQP.

State  x = [xPos, yPos, delta, v, psi]   (5,)
Input  u = [deltaDot, aLong]             (2,)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mpc_tpu.models.vehicle import VehicleParams

NX = 5     # KS state count
NX_ST = 7  # ST state count (adds [psiDot, beta])
NU = 2     # number of inputs (shared by both models)


def nx_of(model: str) -> int:
    """State dimension of a dynamics model ('ks' -> 5, 'st' -> 7)."""
    if model == "ks":
        return NX
    if model == "st":
        return NX_ST
    raise ValueError(f"unknown dynamics model '{model}' (want 'ks'|'st')")


def ks_ode(x: jax.Array, u: jax.Array, wheelbase: float) -> jax.Array:
    """Kinematic single-track ODE.

    Parity with reference ``configuration.py:353-368`` (``KS_casadi``):
        xdot   = v * cos(psi)
        ydot   = v * sin(psi)
        ddelta = u0
        vdot   = u1
        psidot = v / l * tan(delta)
    """
    v = x[..., 3]
    delta = x[..., 2]
    psi = x[..., 4]
    return jnp.stack(
        [
            v * jnp.cos(psi),
            v * jnp.sin(psi),
            u[..., 0] + jnp.zeros_like(v),
            u[..., 1] + jnp.zeros_like(v),
            v / wheelbase * jnp.tan(delta),
        ],
        axis=-1,
    )


def st_ode(x: jax.Array, u: jax.Array, p: VehicleParams) -> jax.Array:
    """Single-track model with tire dynamics.

    Parity with reference ``configuration.py:370-398`` (``ST_casadi``).
    State x = [xPos, yPos, delta, v, psi, psiDot, beta] (7,).
    The reference branches on ``abs(v) < 0.1`` in Python; here the low-speed
    kinematic fallback is a ``jnp.where`` blend so the function stays jittable
    with static shapes.
    """
    g = 9.81
    mu = p.tire.p_dy1
    C_Sf = -p.tire.p_ky1 / p.tire.p_dy1
    C_Sr = C_Sf
    lf, lr = p.a, p.b
    l = lf + lr
    h, m, I = p.h_s, p.m, p.I_z

    delta, v, psi, psi_dot, beta = (
        x[..., 2], x[..., 3], x[..., 4], x[..., 5], x[..., 6])
    u0, u1 = u[..., 0], u[..., 1]

    # --- low-speed kinematic branch (reference configuration.py:379-385) ---
    # KS-cog dynamics with slip angle beta held kinematically.
    beta_kin = jnp.arctan(jnp.tan(delta) * lr / l)
    v_safe = jnp.where(jnp.abs(v) < 1e-3, 1e-3, v)
    f_ks = jnp.stack(
        [
            v * jnp.cos(beta_kin + psi),
            v * jnp.sin(beta_kin + psi),
            u0 + jnp.zeros_like(v),
            u1 + jnp.zeros_like(v),
            v * jnp.cos(beta_kin) * jnp.tan(delta) / l,
        ],
        axis=-1,
    )
    d_beta = (lr * u0) / (l * jnp.cos(delta) ** 2
                          * (1.0 + (jnp.tan(delta) ** 2 * lr / l) ** 2))
    dd_psi = (1.0 / l) * (
        u1 * jnp.cos(beta) * jnp.tan(delta)
        - v * jnp.sin(beta) * d_beta * jnp.tan(delta)
        + v * jnp.cos(beta) * u0 / jnp.cos(delta) ** 2
    )
    f_low = jnp.concatenate(
        [f_ks, jnp.stack([dd_psi, d_beta], axis=-1)], axis=-1)

    # --- high-speed tire branch (reference configuration.py:387-397) ---
    f_high = jnp.stack(
        [
            v * jnp.cos(beta + psi),
            v * jnp.sin(beta + psi),
            u0 + jnp.zeros_like(v),
            u1 + jnp.zeros_like(v),
            psi_dot,
            -mu * m / (v_safe * I * (lr + lf))
            * (lf ** 2 * C_Sf * (g * lr - u1 * h)
               + lr ** 2 * C_Sr * (g * lf + u1 * h)) * psi_dot
            + mu * m / (I * (lr + lf))
            * (lr * C_Sr * (g * lf + u1 * h)
               - lf * C_Sf * (g * lr - u1 * h)) * beta
            + mu * m / (I * (lr + lf)) * lf * C_Sf * (g * lr - u1 * h) * delta,
            (mu / (v_safe ** 2 * (lr + lf))
             * (C_Sr * (g * lf + u1 * h) * lr - C_Sf * (g * lr - u1 * h) * lf)
             - 1.0) * psi_dot
            - mu / (v_safe * (lr + lf))
            * (C_Sr * (g * lf + u1 * h) + C_Sf * (g * lr - u1 * h)) * beta
            + mu / (v_safe * (lr + lf)) * (C_Sf * (g * lr - u1 * h)) * delta,
        ],
        axis=-1,
    )
    low_speed = (jnp.abs(v) < 0.1)[..., None]
    return jnp.where(low_speed, f_low, f_high)


def ks_to_st_state(x: jax.Array, wheelbase: float, lr: float) -> jax.Array:
    """Lift a 5-state KS state to the 7-state ST state kinematically.

    psiDot = v tan(delta) / l and beta = arctan(tan(delta) l_r / l) — the
    same consistency relations the reference's ST low-speed branch assumes
    (``configuration.py:379-385``).
    """
    delta, v = x[..., 2], x[..., 3]
    psi_dot = v * jnp.tan(delta) / wheelbase
    beta = jnp.arctan(jnp.tan(delta) * lr / wheelbase)
    return jnp.concatenate([x, jnp.stack([psi_dot, beta], axis=-1)], axis=-1)


def euler_step(x: jax.Array, u: jax.Array, dt: float,
               wheelbase: float) -> jax.Array:
    """Forward-Euler discretization of the KS model.

    Parity with the reference CasADi plant/defect ``x_{k+1} = x_k + f(x,u)*T``
    (``optimizer.py:380-382`` and ``shift_movement`` at ``optimizer.py:645-655``).
    """
    return x + dt * ks_ode(x, u, wheelbase)


def rk4_step(x: jax.Array, u: jax.Array, dt: float,
             wheelbase: float) -> jax.Array:
    """Classic RK4 discretization of the KS model.

    Parity with the reference FORCESPRO integrator (``optimizer.py:90-98``:
    ``forcespro.nlp.integrators.RK4`` with stepsize 0.1).
    """
    k1 = ks_ode(x, u, wheelbase)
    k2 = ks_ode(x + 0.5 * dt * k1, u, wheelbase)
    k3 = ks_ode(x + 0.5 * dt * k2, u, wheelbase)
    k4 = ks_ode(x + dt * k3, u, wheelbase)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def make_step_fn(integrator: str, dt: float, wheelbase: float,
                 model: str = "ks", vehicle=None):
    """Return a discrete-time step function ``x_next = F(x, u)``.

    integrator: 'rk4' (FORCESPRO parity) or 'euler' (CasADi parity).
    model: 'ks' (5-state kinematic single-track — the only model either
    reference solver ever invokes, ``optimizer.py:98, 536``) or 'st'
    (7-state single-track with tire dynamics — the reference defines
    ``ST_casadi`` at ``configuration.py:370-398`` but never wires it to a
    planner; here it is a first-class model family).  'st' requires
    ``vehicle`` (a ``VehicleParams``).
    """
    if model == "ks":
        ode = lambda x, u: ks_ode(x, u, wheelbase)  # noqa: E731
    elif model == "st":
        if vehicle is None:
            raise ValueError("model='st' requires vehicle=VehicleParams")
        ode = lambda x, u: st_ode(x, u, vehicle)  # noqa: E731
    else:
        raise ValueError(f"unknown dynamics model '{model}' (want 'ks'|'st')")
    if integrator == "rk4":
        def step(x, u):
            k1 = ode(x, u)
            k2 = ode(x + 0.5 * dt * k1, u)
            k3 = ode(x + 0.5 * dt * k2, u)
            k4 = ode(x + dt * k3, u)
            return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return step
    if integrator == "euler":
        return lambda x, u: x + dt * ode(x, u)
    raise ValueError(f"unknown integrator '{integrator}' (want 'rk4'|'euler')")


def linearize_step(step_fn, x: jax.Array, u: jax.Array):
    """Exact linearization of the discrete dynamics around (x, u).

    Returns (A, B, c) with  x_next ~= A @ dx + B @ du + c,  c = F(x, u).
    Replaces CasADi's symbolic Jacobians / FORCESPRO's AD (the reference never
    forms these explicitly; IPOPT/FORCESPRO do it internally).
    """
    A = jax.jacfwd(step_fn, argnums=0)(x, u)
    B = jax.jacfwd(step_fn, argnums=1)(x, u)
    c = step_fn(x, u)
    return A, B, c
