"""Synthetic benchmark/test scenarios (no XML needed).

Builds ZAM-like overtaking tracks of arbitrary length and horizon for
benchmarks, perturbation fans, and pod-scale runs — the "thousands of
perturbed scenarios" axis of BASELINE.json's north star.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mpc_tpu.models.costs import Weights
from mpc_tpu.ops import sqp
from mpc_tpu.planner import closed_loop as cl
from mpc_tpu.planner import reference as ref_mod

ZAM_LIKE_WEIGHTS = {
    "weight_x": 2.3, "weight_y": 2.3, "weight_steering_angle": 500.0,
    "weight_velocity": 0.1, "weight_heading_angle": 160.0,
    "weight_velocity_steering_angle": 0.8, "weight_long_acceleration": 0.8,
    "weight_x_terminate": 80.0, "weight_y_terminate": 80.0,
    "weight_steering_angle_terminate": 100.0,
    "weight_velocity_terminate": 0.01,
    "weight_heading_angle_terminate": 110.0}


def overtake_track(n_steps: int, v: float = 15.0, dt: float = 0.1
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference path with an overtake swerve around an in-lane obstacle.

    Returns (path (T,2), orientation (T,), obstacle_center (2,)).  The
    obstacle sits at 40% of the track; the path clears it laterally by
    ~3.5 m like the ZAM overtake line.
    """
    T = n_steps
    s = np.arange(T) * v * dt
    x = 30.0 + s
    L = s[-1] if T > 1 else 1.0
    obs_s = 0.4 * L
    # smooth swerve: 0 -> 3.0 m lateral around the obstacle, partway back.
    # The obstacle sits clearly BELOW the travel line (like ZAM, where the
    # in-lane obstacle is offset from the overtake line): a head-on obstacle
    # is a zero-gradient saddle for any smooth local solver.
    y = (-1.15
         + 4.15 * _smooth01((s - (obs_s - 24.0)) / 16.0)
         - 2.0 * _smooth01((s - (obs_s + 10.0)) / 15.0))
    path = np.stack([x, y], axis=1)
    seg = np.diff(path, axis=0)
    psi = np.arctan2(seg[:, 1], seg[:, 0])
    psi = np.concatenate([psi, psi[-1:]])
    obstacle = np.array([30.0 + obs_s, -1.9])
    return path, psi, obstacle


def _smooth01(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def stress_track(n_steps: int, v: float = 15.0, dt: float = 0.1,
                 offset: float = 0.9, pre_avoid: float = 1.2
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CA-STRESS variant: the reference line UNDER-avoids by design.

    A nominally straight lane with an in-lane obstacle ``offset`` meters
    below the line, placed so it ENTERS the planning horizon mid-loop (the
    T=10 geometry PARITY.md identifies as "where infeasibility lives").
    The reference swerves only ``pre_avoid`` meters — deliberately short
    of the ``offset + clearance`` the CA rows demand — so tracking the
    reference alone violates the constraints and the solver must push the
    trajectory ~1 m further out from the constraint rows while the
    obstacle slides into the window.  This is the workload where the
    per-step iteration budget actually binds (unlike
    :func:`overtake_track`, whose fully pre-avoiding line is
    quality-saturated at one GN iteration).

    Returns (path (T,2), orientation (T,), obstacle_center (2,)).
    """
    T = n_steps
    s = np.arange(T) * v * dt
    x = 30.0 + s
    L = s[-1] if T > 1 else 1.0
    obs_s = 0.55 * L
    # partial swerve: peaks at the obstacle, returns afterwards
    y = (-1.15
         + pre_avoid * _smooth01((s - (obs_s - 24.0)) / 16.0)
         - pre_avoid * _smooth01((s - (obs_s + 10.0)) / 15.0))
    path = np.stack([x, y], axis=1)
    seg = np.diff(path, axis=0)
    psi = np.arctan2(seg[:, 1], seg[:, 0])
    psi = np.concatenate([psi, psi[-1:]])
    obstacle = np.array([30.0 + obs_s, -1.15 - offset])
    return path, psi, obstacle


def make_bench_loop(n_steps: int, horizon: int, n_lanes: int,
                    mode: str = "forcespro", dtype=jnp.float32,
                    workload: str = "overtake", **solver_overrides):
    """(LoopConfig, batched LoopParams) for the closed-loop benchmark.

    workload: 'overtake' (pre-avoiding reference line — throughput
    saturation) or 'ca_stress' (straight line at an in-lane obstacle —
    the budget-binding quality workload, :func:`stress_track`).
    """
    v, dt = 15.0, 0.1
    track_fn = {"overtake": overtake_track,
                "ca_stress": stress_track}[workload]
    path, psi, obstacle = track_fn(n_steps + horizon + 2, v, dt)

    if mode == "forcespro":
        H = horizon
        integ = "rk4"
        use_term = True
    else:
        H = horizon
        integ = "euler"
        use_term = False
    # loop-level robustification knobs ride the same override channel as
    # in closed_loop.make_loop_config
    loop_kw = {k: solver_overrides.pop(k)
               for k in ("gate_stages", "rti_margin", "rti_amax_scale",
                         "cold_start_solves")
               if k in solver_overrides}
    scfg = sqp.SolverConfig(
        horizon=H, dt=dt, integrator=integ, formulation=mode,
        use_terminal_cost=use_term, **solver_overrides)
    loop_kw.setdefault("cold_start_solves", 4)
    lcfg = cl.LoopConfig(solver=scfg, mode=mode, n_steps=n_steps,
                         noise_std=0.0, plant_integrator=integ,
                         **loop_kw)

    track = ref_mod.build_track(path, psi, v, H, mode, dtype)
    from mpc_tpu.models.constraints import circle_centers
    centers = circle_centers(jnp.asarray(obstacle[0], dtype),
                             jnp.asarray(obstacle[1], dtype),
                             6.0, 3.5, jnp.asarray(0.0, dtype))
    x_init = jnp.asarray([path[0, 0], path[0, 1], 0.0, v, psi[0]], dtype)
    if scfg.model == "st":
        from mpc_tpu.models import dynamics as dyn_mod
        x_init = dyn_mod.ks_to_st_state(x_init, scfg.wheelbase,
                                        scfg.vehicle.b)
    one = cl.LoopParams(
        x_init=x_init,
        track=track,
        obs_centers=centers,
        min_dist=jnp.asarray(3.3, dtype),
        weights=Weights.from_dict(ZAM_LIKE_WEIGHTS, dtype),
        noise_key=jax.random.PRNGKey(0))
    batch = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_lanes,) + x.shape), one)
    # perturb starts: position / velocity / heading jitter per lane
    key = jax.random.PRNGKey(1)
    nx = int(one.x_init.shape[-1])
    scale = np.zeros(nx)
    scale[:5] = [0.5, 0.15, 0.0, 0.5, 0.01]
    pert = jax.random.normal(key, (n_lanes, nx), dtype) * jnp.asarray(
        scale, dtype)
    batch = batch._replace(x_init=batch.x_init + pert,
                           noise_key=jax.random.split(key, n_lanes))
    return lcfg, batch
