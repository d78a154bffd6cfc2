"""Batched augmented-Lagrangian SQP solver (iLQR/Riccati backend).

This engine replaces BOTH reference inner solvers:
  * CasADi + IPOPT interior point (``MPC_Planner/optimizer.py:513-560``): the
    reference rebuilds the symbolic NLP and re-instantiates IPOPT inside every
    closed-loop step (``optimizer.py:605``); here the whole solver is traced
    once and jit-compiled by XLA.
  * FORCESPRO SQP_NLP generated C solver (``optimizer.py:197-245``): BFGS
    Hessian, 1 QP per step, reg_hessian 5e-6 — emulated by real-time-iteration
    configs (few Gauss-Newton iterations, warm start) with exact Gauss-Newton
    Hessians instead of BFGS.

Design (fixed shapes, batched lanes):
  - Inequalities (friction circle, obstacle circles, box bounds) are handled
    with an augmented Lagrangian: fixed outer multiplier updates x fixed inner
    Gauss-Newton iterations, so the compiled program has NO data-dependent
    control flow.  Infeasible lanes cannot poison a batch: each lane carries
    its own multipliers and a status code (the reference instead hard-asserts
    ``exitflag == 1``, ``optimizer.py:330``).
  - The equality-constrained QP at each iteration is solved by a Riccati
    sweep (``mpc_tpu.ops.riccati``), not a generic sparse factorization.
  - Line search evaluates a fixed ladder of step sizes in parallel (vmap over
    alpha) against the AL merit and picks the best — no sequential
    backtracking loop.
  - Everything vmaps over a leading lane axis; `solve_batch` is the
    chip-saturating entry point.
"""
from __future__ import annotations

import dataclasses
from functools import partial, wraps
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mpc_tpu.models import constraints as C
from mpc_tpu.models import costs as cost_mod
from mpc_tpu.models import dynamics as dyn_mod
from mpc_tpu.ops import riccati

NX = dyn_mod.NX
NU = dyn_mod.NU
# 10 formulation rows (friction + 9 circle rows) + 4 box rows (u0,u1,delta,v)
NROWS = C.NUM_INEQ + 4


def full_f32_contractions(fn):
    """Trace ``fn`` with its float32 matrix contractions at full precision.

    XLA may otherwise run float32 dots in TF32 on the GPU (about three
    decimal digits), which the status tolerances — calibrated on CPU
    float32 (``tol_stat``, ``tol_feas`` below) — were not written for.
    The precision is fixed when the contractions are traced.
    """
    @wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


def nrows(cfg) -> int:
    """Stage row count: base rows + optional road-boundary rows."""
    return NROWS + (C.NUM_BOUNDARY if cfg.boundary_rows else 0)


def row_scales(cfg, dtype=jnp.float32) -> jax.Array:
    """Per-row violation scales (IPOPT-style constraint scaling), (NROWS,).

    Status gates and the ip-mode exact-penalty line search compare
    violations ACROSS rows, but the friction row's units are (m/s^2)^2
    (forcespro form) / m/s^2 (casadi form) while every other row is meters
    (circle/boundary distances) or near-unit box ranges.  Scaling the
    friction row by its bound magnitude makes `viol` bound-relative for it
    and keeps meter rows absolute.  Reference analog: IPOPT applies its
    constr_viol_tol to scaled constraints, and the recorded forcespro CA
    deployment tolerates 27% applied-friction overshoot (max 168 vs
    a_max^2 = 132, ``tests/ref_goldens/2D_plots_forcespro_ZAM_Over-1_1_
    collision_avoidance``) while holding meter-scale clearance — bound-
    relative friction is exactly that priority.
    """
    import numpy as _np
    s = _np.ones((nrows(cfg),), _np.float64)
    s[0] = cfg.a_max ** 2 if cfg.formulation == "forcespro" else cfg.a_max
    return jnp.asarray(s, dtype)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (hashable; baked into the XLA program)."""

    horizon: int
    dt: float = 0.1
    wheelbase: float = 2.578
    integrator: str = "rk4"          # 'rk4' (forcespro) | 'euler' (casadi)
    model: str = "ks"                # dynamics family: 'ks' (5-state
                                     # kinematic single-track; the only model
                                     # the reference planner invokes,
                                     # optimizer.py:98, 536) | 'st' (7-state
                                     # single-track with tire dynamics; the
                                     # reference defines it at
                                     # configuration.py:370-398 but never
                                     # wires it — here a first-class family)
    vehicle: object = None           # VehicleParams (frozen dataclass,
                                     # hashable); required for model='st'
    formulation: str = "forcespro"   # constraint algebra variant
    ego_length: float = 4.508
    ego_width: float = 1.610
    a_max: float = 11.5
    bounds: C.BoxBounds = dataclasses.field(
        default_factory=lambda: C.BoxBounds(
            u_lo=(-0.4, -11.5), u_hi=(0.4, 11.5),
            x_lo=(-float("inf"), -float("inf"), -1.066, 0.0, -float("inf")),
            x_hi=(float("inf"), float("inf"), 1.066, 50.8, float("inf"))))
    use_terminal_cost: bool = True   # False for CasADi parity (dead P term,
                                     # reference optimizer.py:510)
    sqp_iters: int = 4               # inner Gauss-Newton iterations per AL step
    al_iters: int = 3                # outer multiplier/penalty updates
    reg: float = 1e-6                # Quu regularization (ref: 5e-6 BFGS reg)
    mu0: float = 10.0                # initial AL penalty
    mu_factor: float = 8.0           # penalty growth for stalled rows
    mu_max: float = 1e5              # per-row penalty ceiling
    viol_improve: float = 0.25       # row counts as improving if its
                                     # violation fell to this fraction
    lam_max: float = 1e6             # multiplier clamp (soft-slack behavior)
    # geometric ladder tuned against golden-parity + batch-feasibility sweeps
    # (tests/test_closed_loop.py quality gates); widen for stiffer penalties
    alphas: Tuple[float, ...] = (1.0, 0.35, 0.12, 0.04, 0.012, 1e-3)
    tol_stat: float = 0.5            # KKT stationarity tolerance (status).
                                     # CALIBRATED against measured warm
                                     # steady-state residual distributions
                                     # (tools/calibrate_status.py,
                                     # STATUS_CALIB.json): converged warm
                                     # AL solves on the reference LF tracks
                                     # cluster at p50 0.004-0.07 in cost-
                                     # gradient units, while still-moving
                                     # steps sit >= 3; 0.5 separates the
                                     # clusters with margin.  (The round-2
                                     # default 1e-4 was never met at any
                                     # production budget — status==1
                                     # carried no information.)
    tol_stat_ip: float = 1.0         # Lagrangian-stationarity tolerance for
                                     # ip-mode status==1 (gradient of the
                                     # dual-weighted Lagrangian).  Same
                                     # calibration: ip warm steady-state
                                     # p50 is 0.12-0.9 on the LF tracks
                                     # (72%/51% of warm steps converge at
                                     # 1.0), hard-maneuver steps >= 17.
    tol_feas: float = 1e-4           # constraint violation tolerance (status)
    tol_infeas: float = 0.05         # violation above which a lane reports
                                     # status -7 (genuinely infeasible)
    lqr_backend: str = "scan"        # 'scan' (sequential Riccati) | 'pscan'
                                     # (log-depth associative scan; shard the
                                     # stage axis for long horizons)
    stage_axis: str | None = None    # mesh axis name to shard the (H+1)
                                     # stage axis over (horizon/stage
                                     # parallelism, the sequence-parallel
                                     # idiom of SURVEY.md §2.3): the QP
                                     # stage blocks get a sharding
                                     # constraint on this axis, so under a
                                     # ('dp','sp') mesh the pscan combine
                                     # steps become ICI collectives.
                                     # Requires an ambient mesh context
                                     # (``with mesh:``) at jit time.
    boundary_rows: bool = False      # enable road-boundary rows (the
                                     # reference ships these commented out,
                                     # optimizer.py:113-161)
    method: str = "al"               # 'al' (augmented-Lagrangian iLQR) |
                                     # 'ip' (RTI-SQP over the interior-point
                                     # stagewise QP, ops.ipqp — hard
                                     # linearized constraints per step)
    ip_sqp_iters: int = 5            # SQP linearizations per solve (ip mode).
                                     # 5, not 3: under actuation noise the
                                     # head-on-obstacle overtake needs the
                                     # extra re-linearizations to keep
                                     # committing to the avoidance side — at
                                     # 3, noise kicks can collapse the RTI
                                     # iterate back into the blocked lane
                                     # (seed-swept in tests/test_robustness)
    ip_iters: int = 10               # IP Newton steps per QP (ip mode)
    ip_warm_duals: bool = False      # warm-start the FIRST QP's row duals
                                     # from the previous MPC step's final
                                     # duals (carried shifted in
                                     # state.lam_lo/lam_hi) — the lever that
                                     # makes 1-QP-per-step true RTI feasible
                                     # (FORCESPRO maxqps=1 deploys warm-
                                     # started BFGS duals the same way,
                                     # optimizer.py:237)
    ip_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
                                     # ip-mode RTI line-search ladder.  The
                                     # default 5-rung exact-penalty ladder is
                                     # the robust cold-start choice; at the
                                     # warm 1-QP deployment point a single
                                     # rung (1.0,) (full step if it improves
                                     # the merit) — or the empty tuple ()
                                     # for the reference's own semantics
                                     # (apply the RTI step UNCONDITIONALLY,
                                     # no merit guard at all: FORCESPRO
                                     # maxqps=1, optimizer.py:237) — removes
                                     # most of the per-step rollout work
    ip_ls_rho: float = 300.0         # exact-penalty weight in the ip-mode
                                     # line search (objective + rho * viol).
                                     # Too large (1e3) accepts any
                                     # feasibility gain regardless of cost:
                                     # on the ZAM CA overtake the counter-
                                     # steer overshoots ~1.2 m OFF the road
                                     # (y 6.4 vs the golden's 4.2, left edge
                                     # 5.4); at 300 the same run stays on
                                     # the road, fully feasible, 1.5 m of
                                     # the golden (round-2 rho sweep)

    def __post_init__(self):
        # YAML ``solver_settings:`` delivers ladders as lists; the config
        # must stay hashable (it is a jit static argument)
        for f in ("alphas", "ip_alphas"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        if self.integrator not in ("rk4", "euler"):
            raise ValueError(f"unknown integrator '{self.integrator}'")
        if self.model not in ("ks", "st"):
            raise ValueError(f"unknown model '{self.model}' (ks|st)")
        if self.model == "st" and self.vehicle is None:
            raise ValueError("model='st' requires vehicle=VehicleParams")
        if self.formulation not in ("forcespro", "casadi"):
            raise ValueError(f"unknown formulation '{self.formulation}'")
        if self.lqr_backend not in ("scan", "pscan"):
            raise ValueError(f"unknown lqr_backend '{self.lqr_backend}'")
        if self.method not in ("al", "ip"):
            raise ValueError(f"unknown method '{self.method}' (al|ip)")
        if self.sqp_iters < 1 or self.al_iters < 1:
            raise ValueError("sqp_iters and al_iters must be >= 1")


class SqpState(NamedTuple):
    """Warm-startable solver state (pytree; one lane)."""

    U: jax.Array         # (H, NU) input trajectory
    lam_lo: jax.Array    # (H+1, NROWS) multipliers for lo - h <= 0
    lam_hi: jax.Array    # (H+1, NROWS) multipliers for h - hi <= 0
    mu: jax.Array        # (H+1, NROWS) per-row AL penalties (ALGENCAN-style:
                         # only rows whose violation stalls get stiffened —
                         # a single global penalty either under-drives active
                         # rows or blows up line searches on inactive ones)
    prev_viol: jax.Array  # (H+1, NROWS) violation at the last outer update


class OcpParams(NamedTuple):
    """Per-solve runtime parameters (pytree; one lane).

    x0:    (NX,) current state (reference FORCESPRO ``xinit``,
           ``optimizer.py:289``; CasADi init pin, ``optimizer.py:378``)
    x_ref: (H+1, NX) reference rows; row k is the tracking target for state
           X_k (callers encode the reference's one-step-ahead indexing,
           ``optimizer.py:299-302, 509``)
    obs_centers: (3, 2) static obstacle circle centers, or (H+1, 3, 2) for a
           MOVING obstacle (per-stage predicted centers — capability beyond
           the reference, which ignores dynamic obstacles entirely)
    min_dist: () r_ego + r_obs
    weights: cost weights pytree
    """

    x0: jax.Array
    x_ref: jax.Array
    obs_centers: jax.Array
    min_dist: jax.Array
    weights: cost_mod.Weights
    boundaries: jax.Array | None = None  # (2, NB, 2) padded road-boundary
                                         # polylines (boundary_rows configs)
    boundary_signs: jax.Array | None = None  # (2,) +-1: positive = inside


class Solution(NamedTuple):
    X: jax.Array          # (H+1, NX) optimal states
    U: jax.Array          # (H, NU) optimal inputs
    state: SqpState       # warm-start state for the next solve
    status: jax.Array     # () int32: 1 converged, 0 max-iters, -7 infeasible
    kkt_stat: jax.Array   # () stationarity residual (inf-norm)
    viol: jax.Array       # () max constraint violation
    cost: jax.Array       # () objective value at the solution
    merit: jax.Array      # () final AL merit


# ---------------------------------------------------------------------------
# Model assembly
# ---------------------------------------------------------------------------


def _step_fn(cfg: SolverConfig):
    return dyn_mod.make_step_fn(cfg.integrator, cfg.dt, cfg.wheelbase,
                                cfg.model, cfg.vehicle)


def solver_nx(cfg: SolverConfig) -> int:
    """State dimension of the configured dynamics model."""
    return dyn_mod.nx_of(cfg.model)


def normalize_params(cfg: SolverConfig, params: OcpParams) -> OcpParams:
    """Widen 5-column KS-schema params to the configured model's NX.

    Lets every caller keep the reference's 5-state OCP schema (x_ref rows
    ``[px, py, 0, v_des, psi_des]``, ``optimizer.py:299-302``) for the ST
    model too: extra state columns (psiDot, beta) get zero reference and
    zero weight, and a short x0 is completed kinematically
    (psiDot = v tan(delta)/l, beta = arctan(tan(delta) l_r/l) — the same
    consistency relations the reference's ST low-speed branch uses,
    ``configuration.py:379-385``).
    """
    nxv = solver_nx(cfg)
    have = params.x_ref.shape[-1]
    if have == nxv:
        return params
    if have != dyn_mod.NX:
        raise ValueError(
            f"x_ref has {have} state columns; want {dyn_mod.NX} or {nxv}")
    pad = nxv - have
    dtype = params.x_ref.dtype
    x_ref = jnp.concatenate(
        [params.x_ref,
         jnp.zeros(params.x_ref.shape[:-1] + (pad,), dtype)], axis=-1)
    w = params.weights
    zeros = jnp.zeros(w.q.shape[:-1] + (pad,), w.q.dtype)
    weights = cost_mod.Weights(q=jnp.concatenate([w.q, zeros], axis=-1),
                               r=w.r,
                               qN=jnp.concatenate([w.qN, zeros], axis=-1))
    x0 = params.x0
    if x0.shape[-1] == have:
        veh = cfg.vehicle
        lr = veh.b if veh is not None else 0.5 * cfg.wheelbase
        x0 = dyn_mod.ks_to_st_state(x0, cfg.wheelbase, lr)
    return params._replace(x0=x0, x_ref=x_ref, weights=weights)


def _stage_rows(cfg: SolverConfig, x, u, obs: C.ObstacleParams,
                stage_idx: jax.Array, boundaries=None, boundary_signs=None):
    """All NROWS two-sided rows for one stage: formulation rows + boxes.

    stage_idx: scalar int; stage H is the terminal stage (u rows masked, and
    FORCESPRO's dangling terminal input is modeled as a = 0 — see module doc
    of ``mpc_tpu.models.constraints``).
    """
    is_term = stage_idx >= cfg.horizon
    u_eff = jnp.where(is_term, jnp.zeros_like(u), u)
    if cfg.formulation == "forcespro":
        h, lo, hi = C.stage_ineq_forcespro(
            x, u_eff, obs, cfg.ego_length, cfg.ego_width, cfg.wheelbase,
            cfg.a_max)
    elif cfg.formulation == "casadi":
        h, lo, hi = C.stage_ineq_casadi(
            x, u_eff, obs, cfg.ego_length, cfg.ego_width, cfg.wheelbase,
            cfg.a_max, friction_active=(stage_idx == 0))
    else:
        raise ValueError(f"unknown formulation '{cfg.formulation}'")

    u_lo, u_hi, x_lo, x_hi = cfg.bounds.as_arrays(x.dtype)
    # box rows: [u0, u1, delta, v]; u rows masked at the terminal stage
    box_h = jnp.stack([u_eff[0], u_eff[1], x[2], x[3]])
    box_lo = jnp.stack([
        jnp.where(is_term, -jnp.inf, u_lo[0]),
        jnp.where(is_term, -jnp.inf, u_lo[1]),
        x_lo[2], x_lo[3]])
    box_hi = jnp.stack([
        jnp.where(is_term, jnp.inf, u_hi[0]),
        jnp.where(is_term, jnp.inf, u_hi[1]),
        x_hi[2], x_hi[3]])
    hs = [h, box_h]
    los = [lo, box_lo]
    his = [hi, box_hi]
    if cfg.boundary_rows:
        if boundaries is None or boundary_signs is None:
            raise ValueError(
                "boundary_rows=True needs params.boundaries + signs")
        r_ego, _ = C.approx_circle_radius(cfg.ego_length, cfg.ego_width)
        bh, blo, bhi = C.boundary_rows(x, cfg.ego_length, cfg.ego_width,
                                       boundaries, boundary_signs, r_ego)
        hs.append(bh)
        los.append(blo)
        his.append(bhi)
    return (jnp.concatenate(hs), jnp.concatenate(los), jnp.concatenate(his))


def _stage_obs(params: OcpParams, k):
    """Obstacle circle centers for predicted stage k ((3, 2))."""
    if params.obs_centers.ndim == 3:  # moving obstacle: per-stage centers
        return C.ObstacleParams(centers=params.obs_centers[k],
                                min_dist=params.min_dist)
    return C.ObstacleParams(centers=params.obs_centers,
                            min_dist=params.min_dist)


def _all_rows(cfg: SolverConfig, X, U, params: OcpParams):
    """Constraint rows for all H+1 stages: h, lo, hi each (H+1, NROWS)."""
    U_ext = jnp.concatenate([U, U[-1:]], axis=0)  # stage H reuses U[H-1]
    idx = jnp.arange(cfg.horizon + 1)
    return jax.vmap(lambda x, u, k: _stage_rows(
        cfg, x, u, _stage_obs(params, k), k, params.boundaries,
        params.boundary_signs))(X, U_ext, idx)


def _al_terms(h, lo, hi, lam_lo, lam_hi, mu):
    """AL penalty value, d(psi)/dh and active-set GN diagonal, elementwise.

    For one-sided c <= 0 with multiplier lam >= 0:
        psi = (1/2mu) * (max(0, lam + mu c)^2 - lam^2)
    Infinite bounds are handled by guarding every product with the active
    mask (no inf * 0 NaNs).
    """
    c_hi = h - hi
    c_lo = lo - h
    t_hi = lam_hi + mu * c_hi
    t_lo = lam_lo + mu * c_lo
    act_hi = t_hi > 0
    act_lo = t_lo > 0
    m_hi = jnp.where(act_hi, t_hi, 0.0)
    m_lo = jnp.where(act_lo, t_lo, 0.0)
    psi = (m_hi * m_hi - lam_hi * lam_hi
           + m_lo * m_lo - lam_lo * lam_lo) / (2.0 * mu)
    grad_h = m_hi - m_lo
    gn_diag = mu * (act_hi.astype(h.dtype) + act_lo.astype(h.dtype))
    return psi, grad_h, gn_diag


def _objective(cfg: SolverConfig, X, U, params: OcpParams):
    w = params.weights
    stage = jnp.sum(cost_mod.stage_cost(X[:-1], U, params.x_ref[:-1], w))
    if cfg.use_terminal_cost:
        stage = stage + cost_mod.terminal_cost(X[-1], params.x_ref[-1], w)
    return stage


def _merit(cfg: SolverConfig, X, U, params: OcpParams, lam_lo, lam_hi, mu):
    h, lo, hi = _all_rows(cfg, X, U, params)
    psi, _, _ = _al_terms(h, lo, hi, lam_lo, lam_hi, mu)
    return _objective(cfg, X, U, params) + jnp.sum(psi)


def _rollout(cfg: SolverConfig, x0, U):
    step = _step_fn(cfg)

    def f(x, u):
        x_next = step(x, u)
        return x_next, x

    xH, X = jax.lax.scan(f, x0, U)
    return jnp.concatenate([X, xH[None]], axis=0)


def _feedback_rollout(cfg: SolverConfig, x0, X_bar, U_bar, K, d, alpha):
    """Nonlinear rollout with LQR feedback: the iLQR forward pass.

    Controls are clamped to their box inside the rollout (box-DDP style):
    input bounds are then satisfied exactly at every iterate — mirroring how
    both reference solvers treat variable bounds natively (FORCESPRO lb/ub,
    ``optimizer.py:108-109``; IPOPT lbx/ubx) — and the stiffest rows never
    enter the AL penalty, which keeps large-penalty line searches stable.
    """
    step = _step_fn(cfg)
    u_lo, u_hi, _, _ = cfg.bounds.as_arrays(x0.dtype)

    def f(x, stage):
        xb, ub, Kk, dk = stage
        u = jnp.clip(ub + alpha * dk + Kk @ (x - xb), u_lo, u_hi)
        x_next = step(x, u)
        return x_next, (x, u)

    xH, (X, U) = jax.lax.scan(f, x0, (X_bar[:-1], U_bar, K, d))
    X = jnp.concatenate([X, xH[None]], axis=0)
    return X, U


# ---------------------------------------------------------------------------
# Quadratic model assembly (one Gauss-Newton iteration)
# ---------------------------------------------------------------------------


def _build_quadratic(cfg: SolverConfig, X, U, params: OcpParams,
                     lam_lo, lam_hi, mu):
    """Stagewise AL-Gauss-Newton quadratic model around (X, U)."""
    w = params.weights
    dtype = X.dtype
    nxv = X.shape[-1]

    def rows_z(z, k):
        x, u = z[:nxv], z[nxv:]
        hh, _, _ = _stage_rows(cfg, x, u, _stage_obs(params, k), k,
                               params.boundaries, params.boundary_signs)
        return hh

    idx = jnp.arange(cfg.horizon + 1)
    U_ext = jnp.concatenate([U, U[-1:]], axis=0)
    Z = jnp.concatenate([X, U_ext], axis=1)  # (H+1, NX+NU)

    h, lo, hi = _all_rows(cfg, X, U, params)
    _, grad_h, gn_diag = _al_terms(h, lo, hi, lam_lo, lam_hi, mu)
    J = jax.vmap(jax.jacfwd(rows_z))(Z, idx)  # (H+1, NROWS, NX+NU)

    # constraint contributions: grad J' g_h, hessian J' diag(gn) J
    g_con = jnp.einsum("krz,kr->kz", J, grad_h)
    H_con = jnp.einsum("krz,kr,krw->kzw", J, gn_diag, J)

    # exact cost terms (quadratic objective -> exact Hessian)
    dx = X - params.x_ref
    g_cost_x = 2.0 * w.q * dx                      # (H+1, NX)
    g_cost_u = 2.0 * w.r * U                       # (H, NU)
    Q_cost = 2.0 * jnp.diag(w.q).astype(dtype)
    R_cost = 2.0 * jnp.diag(w.r).astype(dtype)

    Qs = Q_cost[None] + H_con[:-1, :nxv, :nxv]
    Rs = R_cost[None] + H_con[:-1, nxv:, nxv:]
    Ms = H_con[:-1, :nxv, nxv:]
    qx = g_cost_x[:-1] + g_con[:-1, :nxv]
    qu = g_cost_u + g_con[:-1, nxv:]

    if cfg.use_terminal_cost:
        QH_cost = 2.0 * jnp.diag(w.qN).astype(dtype)
        gH_cost = 2.0 * w.qN * dx[-1]
    else:
        QH_cost = jnp.zeros((nxv, nxv), dtype)
        gH_cost = jnp.zeros((nxv,), dtype)
    QH = QH_cost + H_con[-1, :nxv, :nxv]
    qH = gH_cost + g_con[-1, :nxv]

    quad = riccati.StageQuad(Q=Qs, R=Rs, M=Ms, qx=qx, qu=qu)
    return quad, QH, qH


def _linearize_dynamics(cfg: SolverConfig, X, U):
    step = _step_fn(cfg)
    A = jax.vmap(jax.jacfwd(step, argnums=0))(X[:-1], U)
    B = jax.vmap(jax.jacfwd(step, argnums=1))(X[:-1], U)
    # iLQR keeps X consistent with U, so defects r are zero by construction.
    r = jnp.zeros_like(X[:-1])
    return riccati.LinDyn(A=A, B=B, r=r)


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------


def _stage_constrain(cfg: SolverConfig, tree):
    """Pin stage-leading arrays to the configured mesh axis (GSPMD hint).

    Under ``vmap`` the lane axis is inserted unconstrained, so lanes keep
    their 'dp' sharding from the inputs while stages spread over
    ``cfg.stage_axis``."""
    if cfg.stage_axis is None:
        return tree
    from jax.sharding import PartitionSpec as P

    def c(x):
        return jax.lax.with_sharding_constraint(
            x, P(cfg.stage_axis, *([None] * (x.ndim - 1))))

    return jax.tree.map(c, tree)


def _gn_iteration(cfg: SolverConfig, params: OcpParams, lam_lo, lam_hi, mu,
                  X, U):
    """One Gauss-Newton step: build QP, Riccati sweep, parallel line search."""
    quad, QH, qH = _build_quadratic(cfg, X, U, params, lam_lo, lam_hi, mu)
    dyn = _linearize_dynamics(cfg, X, U)
    if cfg.lqr_backend == "pscan":
        from mpc_tpu.ops import pscan
        quad = _stage_constrain(cfg, quad)
        dyn = _stage_constrain(cfg, dyn)
        gains = pscan.backward_pass_pscan(quad, QH, qH, dyn, cfg.reg)
    else:
        gains = riccati.backward_pass(quad, QH, qH, dyn, cfg.reg)

    if len(cfg.alphas) == 0:
        # unguarded full RTI step (reference maxqps=1 semantics — step
        # applied with NO merit test, optimizer.py:237, 326-342; mirrors
        # ``ip_alphas=()``).  NaN/inf gains are scrubbed to 0 like the IP
        # path's dU direction.
        K = jnp.nan_to_num(gains.K, nan=0.0, posinf=0.0, neginf=0.0)
        d = jnp.nan_to_num(gains.d, nan=0.0, posinf=0.0, neginf=0.0)
        Xa, Ua = _feedback_rollout(cfg, params.x0, X, U, K, d,
                                   jnp.asarray(1.0, X.dtype))
        return Xa, Ua, _merit(cfg, Xa, Ua, params, lam_lo, lam_hi, mu)

    alphas = jnp.array(cfg.alphas, dtype=X.dtype)

    def try_alpha(a):
        Xa, Ua = _feedback_rollout(cfg, params.x0, X, U, gains.K, gains.d, a)
        return _merit(cfg, Xa, Ua, params, lam_lo, lam_hi, mu), Xa, Ua

    merits, Xs, Us = jax.vmap(try_alpha)(alphas)
    merit0 = _merit(cfg, X, U, params, lam_lo, lam_hi, mu)
    best = jnp.argmin(merits)
    improved = merits[best] < merit0
    X_new = jnp.where(improved, Xs[best], X)
    U_new = jnp.where(improved, Us[best], U)
    return X_new, U_new, jnp.where(improved, merits[best], merit0)


@full_f32_contractions
def _kkt_residuals(cfg: SolverConfig, params: OcpParams, X, U,
                   lam_lo, lam_hi, mu):
    """Stationarity (of the AL) and primal feasibility residuals."""
    def merit_of_U(Uf):
        Xf = _rollout(cfg, params.x0, Uf)
        return _merit(cfg, Xf, Uf, params, lam_lo, lam_hi, mu)

    g = jax.grad(merit_of_U)(U)
    stat = jnp.max(jnp.abs(g))
    h, lo, hi = _all_rows(cfg, X, U, params)
    viol = jnp.maximum(jnp.maximum(lo - h, h - hi), 0.0)
    viol = jnp.where(jnp.isfinite(viol), viol, 0.0)
    return stat, jnp.max(viol / row_scales(cfg, viol.dtype))


def _solve_ip(cfg: SolverConfig, params: OcpParams,
              state: SqpState) -> Solution:
    """RTI-SQP over the interior-point stagewise QP (``ops.ipqp``).

    Each SQP iteration linearizes cost/dynamics/rows at the trajectory and
    takes the full QP step (real-time-iteration, like FORCESPRO's
    ``maxqps=1`` warm-started deployment, ``optimizer.py:237``); multiple-
    shooting defects are carried in the QP's dynamics residual channel.
    """
    from mpc_tpu.ops import ipqp

    params = normalize_params(cfg, params)
    w = params.weights
    dtype = params.x0.dtype
    step = _step_fn(cfg)
    H = cfg.horizon
    nxv = solver_nx(cfg)

    X = _rollout(cfg, params.x0, state.U)
    U = state.U

    def rows_z(z, k):
        x, u = z[:nxv], z[nxv:]
        hh, _, _ = _stage_rows(cfg, x, u, _stage_obs(params, k), k,
                               params.boundaries, params.boundary_signs)
        return hh

    idx = jnp.arange(H + 1)

    nr = nrows(cfg)

    def sqp_iter(carry, _):
        X, U, z_lo_c, z_hi_c = carry
        A = jax.vmap(jax.jacfwd(step, argnums=0))(X[:-1], U)
        B = jax.vmap(jax.jacfwd(step, argnums=1))(X[:-1], U)
        defect = jax.vmap(step)(X[:-1], U) - X[1:]

        U_ext = jnp.concatenate([U, U[-1:]], axis=0)
        Z = jnp.concatenate([X, U_ext], axis=1)
        h0, lo, hi = _all_rows(cfg, X, U, params)
        J = jax.vmap(jax.jacfwd(rows_z))(Z, idx)

        dx = X - params.x_ref
        Q_cost = jnp.broadcast_to(2.0 * jnp.diag(w.q).astype(dtype),
                                  (H, nxv, nxv))
        R_cost = jnp.broadcast_to(2.0 * jnp.diag(w.r).astype(dtype),
                                  (H, NU, NU))
        M_cost = jnp.zeros((H, nxv, NU), dtype)
        qx = 2.0 * w.q * dx[:-1]
        qu = 2.0 * w.r * U
        if cfg.use_terminal_cost:
            QH = 2.0 * jnp.diag(w.qN).astype(dtype)
            qH = 2.0 * w.qN * dx[-1]
        else:
            QH = jnp.zeros((nxv, nxv), dtype)
            qH = jnp.zeros((nxv,), dtype)

        qp = ipqp.QpData(Q=Q_cost, R=R_cost, M=M_cost, qx=qx, qu=qu,
                         QH=QH, qH=qH, A=A, B=B, r=defect,
                         J=J, h0=h0, lo=lo, hi=hi)
        st = ipqp.solve_qp(qp, n_iters=cfg.ip_iters, reg=cfg.reg,
                           z_lo0=(z_lo_c if cfg.ip_warm_duals else None),
                           z_hi0=(z_hi_c if cfg.ip_warm_duals else None))
        dU_dir = jnp.nan_to_num(st.dU, nan=0.0, posinf=0.0, neginf=0.0)
        # exact-penalty filter line search on the TRUE nonlinear problem:
        # the QP respects linearized rows, but quartic rows (friction) can
        # overshoot under a full RTI step.  Candidates are evaluated on the
        # dynamics-consistent rollout of the clamped inputs.
        u_lo_, u_hi_, _, _ = cfg.bounds.as_arrays(dtype)
        rho = jnp.asarray(cfg.ip_ls_rho, dtype)
        scales = row_scales(cfg, dtype)

        def try_alpha(a):
            Ua = jnp.clip(U + a * dU_dir, u_lo_, u_hi_)
            Xa = _rollout(cfg, params.x0, Ua)
            hh, ll, hh2 = _all_rows(cfg, Xa, Ua, params)
            v = jnp.maximum(jnp.maximum(ll - hh, hh - hh2), 0.0)
            # bound-relative friction (row_scales): meter-scale clearance
            # outweighs (m/s^2)^2-scale friction overshoot in the penalty,
            # mirroring the reference deployment's effective priority
            v = jnp.where(jnp.isfinite(v), v, 0.0) / scales
            phi = _objective(cfg, Xa, Ua, params) + rho * jnp.sum(v)
            phi = jnp.where(jnp.isnan(phi), jnp.inf, phi)
            return phi, Xa, Ua

        if len(cfg.ip_alphas) == 0:
            # unguarded RTI: apply the full step unconditionally — the
            # reference deployment's exact semantics (maxqps=1 with no
            # merit test, optimizer.py:237, 326-342)
            U_new = jnp.clip(U + dU_dir, u_lo_, u_hi_)
            X_new = _rollout(cfg, params.x0, U_new)
        else:
            alphas = jnp.asarray(cfg.ip_alphas, dtype)
            phis, Xs, Us = jax.vmap(try_alpha)(alphas)
            phi0, _, _ = try_alpha(jnp.asarray(0.0, dtype))
            best = jnp.argmin(phis)
            take = phis[best] < phi0
            X_new = jnp.where(take, Xs[best], X)
            U_new = jnp.where(take, Us[best], U)
        # carry the QP's row duals: they estimate the NLP multipliers at the
        # final iterate (IPOPT reports convergence on exactly this Lagrangian
        # residual, reference optimizer.py:556-558)
        return (X_new, U_new, st.z_lo, st.z_hi), None

    # carried duals: shifted finals from the previous MPC step live in
    # state.lam_lo/lam_hi (stored below); zeros on a cold start
    z0_lo = state.lam_lo if cfg.ip_warm_duals else jnp.zeros((H + 1, nr),
                                                             dtype)
    z0_hi = state.lam_hi if cfg.ip_warm_duals else jnp.zeros((H + 1, nr),
                                                             dtype)
    (X, U, z_lo, z_hi), _ = jax.lax.scan(sqp_iter, (X, U, z0_lo, z0_hi),
                                         None, length=cfg.ip_sqp_iters)

    # final consistency rollout (closes multiple-shooting defects) + clamp
    u_lo, u_hi, _, _ = cfg.bounds.as_arrays(dtype)
    U = jnp.clip(U, u_lo, u_hi)
    X = _rollout(cfg, params.x0, U)

    h, lo, hi = _all_rows(cfg, X, U, params)
    viol = jnp.maximum(jnp.maximum(lo - h, h - hi), 0.0)
    viol = jnp.where(jnp.isfinite(viol), viol, 0.0)
    viol_max = jnp.max(viol / row_scales(cfg, dtype))

    # Lagrangian stationarity with the final QP's row duals (lam = z_hi -
    # z_lo): grad_U [ f(X(U), U) + sum lam . h(X(U), U) ], the same residual
    # IPOPT's convergence test uses (optimizer.py:556-558) and the dual-
    # feasibility half of FORCESPRO's exitflag contract (FORCESNLPsolver.h:
    # 96-100).  Inactive rows carry ~0 duals, so the masked rows (infinite
    # bounds) contribute nothing.
    lam_rows = z_hi - z_lo

    def lagrangian_of_U(Uf):
        Xf = _rollout(cfg, params.x0, Uf)
        hf, _, _ = _all_rows(cfg, Xf, Uf, params)
        return (_objective(cfg, Xf, Uf, params)
                + jnp.sum(lam_rows * jnp.where(jnp.isfinite(hf), hf, 0.0)))

    stat = jnp.max(jnp.abs(jax.grad(lagrangian_of_U)(U)))

    converged = (stat < cfg.tol_stat_ip) & (viol_max < cfg.tol_feas)
    feasible = viol_max < jnp.asarray(cfg.tol_infeas, dtype)
    status = jnp.where(converged, 1,
                       jnp.where(feasible, 0, -7)).astype(jnp.int32)

    # store the final QP duals so the next MPC step can warm-start them
    # (shift-and-hold applies to lam_lo/lam_hi in _shift_state)
    new_state = state._replace(U=U, lam_lo=z_lo, lam_hi=z_hi,
                               prev_viol=viol)
    return Solution(X=X, U=U, state=new_state, status=status,
                    kkt_stat=stat, viol=viol_max,
                    cost=_objective(cfg, X, U, params),
                    merit=_objective(cfg, X, U, params))


@full_f32_contractions
def solve(cfg: SolverConfig, params: OcpParams, state: SqpState) -> Solution:
    """Solve one NMPC problem (single lane). Fixed iteration structure:

        for outer in range(al_iters):      # multiplier/penalty updates
            for inner in range(sqp_iters): # Gauss-Newton + Riccati + LS

    With ``cfg.method == 'ip'`` the AL loop is replaced by the RTI-SQP over
    the interior-point stagewise QP (see ``_solve_ip``).
    """
    if cfg.method == "ip":
        return _solve_ip(cfg, params, state)
    params = normalize_params(cfg, params)
    X0 = _rollout(cfg, params.x0, state.U)

    def outer(carry, _):
        X, U, lam_lo, lam_hi, mu, prev_viol = carry

        def inner(c, _):
            Xc, Uc = c
            Xn, Un, _ = _gn_iteration(cfg, params, lam_lo, lam_hi, mu, Xc, Uc)
            return (Xn, Un), None

        (X, U), _ = jax.lax.scan(inner, (X, U), None, length=cfg.sqp_iters)

        # first-order multiplier update + per-row penalty growth: stiffen
        # only rows whose violation did not improve enough (ALGENCAN rule)
        h, lo, hi = _all_rows(cfg, X, U, params)
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

    stat, viol = _kkt_residuals(cfg, params, X, U, lam_lo, lam_hi, mu)
    converged = (stat < cfg.tol_stat) & (viol < cfg.tol_feas)
    feasible = viol < jnp.asarray(cfg.tol_infeas, X.dtype)
    status = jnp.where(converged, 1, jnp.where(feasible, 0, -7)).astype(
        jnp.int32)

    new_state = SqpState(U=U, lam_lo=lam_lo, lam_hi=lam_hi, mu=mu,
                         prev_viol=prev_viol)
    return Solution(X=X, U=U, state=new_state, status=status,
                    kkt_stat=stat, viol=viol,
                    cost=_objective(cfg, X, U, params),
                    merit=_merit(cfg, X, U, params, lam_lo, lam_hi, mu))


def init_state(cfg: SolverConfig, U0: jax.Array | None = None,
               dtype=jnp.float32) -> SqpState:
    """Fresh solver state (cold start)."""
    H = cfg.horizon
    U = jnp.zeros((H, NU), dtype) if U0 is None else U0.astype(dtype)
    nr = nrows(cfg)
    return SqpState(
        U=U,
        lam_lo=jnp.zeros((H + 1, nr), dtype),
        lam_hi=jnp.zeros((H + 1, nr), dtype),
        mu=jnp.full((H + 1, nr), cfg.mu0, dtype),
        # zeros => any initially-violated row counts as stalled on the first
        # outer update and gets stiffened immediately
        prev_viol=jnp.zeros((H + 1, nr), dtype))


@partial(jax.jit, static_argnums=0)
def solve_batch(cfg: SolverConfig, params: OcpParams,
                state: SqpState) -> Solution:
    """vmap over a leading lane axis — the chip-saturating entry point.

    Thousands of independent NMPC instances (scenarios x perturbations) are
    solved in lockstep; per-lane status replaces the reference's global
    ``assert exitflag == 1`` abort (``optimizer.py:330``).
    """
    return jax.vmap(lambda p, s: solve(cfg, p, s))(params, state)
