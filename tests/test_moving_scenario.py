"""Shipped moving-obstacle scenario, end-to-end.

``scenarios/SYN_Moving-1.xml`` carries a dynamic obstacle with a real
recorded ``<trajectory>`` (a 6 m/s lead vehicle riding near the curb);
``configs/config_CA_SYN_Moving-1.yaml`` enables
``track_dynamic_obstacle`` so the solver constrains against the
obstacle's PREDICTED per-stage positions.  The reference freezes dynamic
obstacles at their initial state (configuration.py:472-476) — the frozen
behavior demonstrably collides with where the lead vehicle actually is.
"""
import dataclasses

import numpy as np

from asset_paths import CFG, SCN
from mpc_tpu.io.config import load_config
from mpc_tpu.planner import closed_loop as cl
from mpc_tpu.utils import native


def _per_step_obstacle_hit(cfg, X):
    """First step colliding with the obstacle AT ITS POSE at that step."""
    traj = np.asarray(cfg.obstacle_trajectory, dtype=float)
    ob = cfg.static_obstacle
    for t in range(X.shape[0]):
        ot = traj[min(t, len(traj) - 1)]
        if native.traj_obstacle_collision(
                X[t:t + 1], cfg.vehicle.l, cfg.vehicle.w,
                (ot[0], ot[1]), ob["length"], ob["width"], ot[2]) >= 0:
            return t
    return -1


def test_moving_scenario_assets_load():
    cfg = load_config(f"{CFG}/config_CA_SYN_Moving-1.yaml", SCN)
    assert cfg.obstacle_trajectory is not None
    traj = np.asarray(cfg.obstacle_trajectory)
    assert traj.shape[1] == 3 and traj.shape[0] >= 100
    # the lead vehicle actually moves (~6 m/s along x)
    assert traj[-1, 0] - traj[0, 0] > 30.0
    lcfg = cl.make_loop_config(cfg, noised=False)
    params = cl.make_loop_params(cfg, lcfg)
    assert params.obs_track is not None
    assert params.obs_track.shape == (
        cfg.iter_length + lcfg.solver.horizon + 2, 3, 2)


def test_moving_scenario_overtake_collision_free():
    """Track-aware planning overtakes the moving lead vehicle cleanly;
    the reference's frozen-obstacle behavior collides with the REAL lead."""
    cfg = load_config(f"{CFG}/config_CA_SYN_Moving-1.yaml", SCN)
    lcfg = cl.make_loop_config(cfg, noised=False)
    params = cl.make_loop_params(cfg, lcfg)

    res = cl.closed_loop_jit(lcfg, params)
    X = np.asarray(res.X, dtype=float)
    status = np.asarray(res.status)
    assert int(status.min()) >= 0, np.where(status < 0)[0]
    assert _per_step_obstacle_hit(cfg, X) == -1
    # the ego actually swerved out to pass (lane center is y=-1.75; the
    # lead rides at y=-2.85): closest approach happens off-center
    traj = np.asarray(cfg.obstacle_trajectory)
    d = np.asarray([np.hypot(X[t, 0] - traj[min(t, len(traj) - 1), 0],
                             X[t, 1] - traj[min(t, len(traj) - 1), 1])
                    for t in range(X.shape[0])])
    t_close = int(d.argmin())
    assert X[t_close, 1] > -1.0, X[t_close]
    # it passed: ahead of the lead by the end
    assert X[-1, 0] > traj[min(X.shape[0] - 1, len(traj) - 1), 0] + 10.0

    # reference-parity behavior (frozen at initial state): collides with
    # the real moving lead — the capability gap this scenario pins
    frozen = cl.closed_loop_jit(lcfg, params._replace(obs_track=None))
    Xf = np.asarray(frozen.X, dtype=float)
    assert _per_step_obstacle_hit(cfg, Xf) >= 0
