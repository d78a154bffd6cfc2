"""Configuration layer: YAML settings + scenario -> PlanningConfig.

Replaces the reference's ``Configuration`` /
``create_optimization_configuration_vehicle`` orchestration
(``MPC_Planner/configuration.py:401-623``) with a plain dataclass pipeline:
route planning, reference-path clipping/resampling, desired-velocity
derivation (including the reference's round-up quirk), orientation, vehicle
parameters (registry instead of ``eval``, ``configuration.py:458``), obstacle
dict, and the 12-weight schema.  The reference's YAML files load unchanged.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from mpc_tpu.io import yaml_lite
from mpc_tpu.io.scenario import Scenario, load_scenario, PlanningProblem
from mpc_tpu.io.route import plan_route
from mpc_tpu.models.vehicle import VehicleParams, get_vehicle
from mpc_tpu.utils.geometry import (
    chaikins_corner_cutting, compute_orientation_from_polyline,
    compute_polyline_length, find_closest_point, resample_polyline)


@dataclasses.dataclass
class PlanningConfig:
    """Validated planning configuration (reference ``PlanningConfiguration``,
    ``configuration.py:106-336``, as an immutable dataclass)."""

    scenario_name: str
    use_case: str                  # 'lane_following' | 'collision_avoidance'
    framework: str                 # 'forcespro' | 'casadi' (formulation mode)
    noised: bool
    predict_horizon: int
    delta_t: float
    iter_length: int
    desired_velocity: float
    origin_reference_path: np.ndarray   # route-planner output (pre-clip)
    reference_path: np.ndarray          # clipped + resampled (T, 2)
    orientation: np.ndarray             # (T,) heading per path point
    vehicle: VehicleParams
    wheelbase: float
    reference_point: str
    static_obstacle: Dict[str, float]
    weights: Dict[str, float]
    # initial state of the planning problem
    init_position: np.ndarray
    init_velocity: float
    init_orientation: float
    init_acceleration: float
    # road boundary polylines for the host-side collision oracle
    left_road_boundary: Optional[np.ndarray] = None
    right_road_boundary: Optional[np.ndarray] = None
    # optional solver-side road-boundary constraints (the reference ships
    # this constraint set commented out, optimizer.py:113-161)
    boundary_constraints: bool = False
    # optional moving-obstacle tracking: (T_traj, 3) rows [x, y, psi] per
    # scenario time step.  The reference treats even dynamic obstacles as
    # frozen at their initial state (configuration.py:472-476); enabling
    # ``track_dynamic_obstacle: true`` in the YAML uses the recorded
    # trajectory instead (capability beyond the reference)
    obstacle_trajectory: Optional[np.ndarray] = None
    # dynamics family for the solver + plant: 'ks' (5-state kinematic
    # single-track — the only model the reference planner invokes,
    # optimizer.py:98, 536) or 'st' (7-state single-track with tire
    # dynamics — defined by the reference at configuration.py:370-398 but
    # never wired; first-class here via YAML ``dynamics_model: st``)
    dynamics_model: str = "ks"
    # progress-based reference windowing (path tracking): window base = the
    # ego's closest path index instead of the loop step.  No reference
    # analog — see planner/reference.py progress_index
    progress_window: bool = False
    # curvature-aware desired-velocity profile (slow down into corners);
    # see planner/reference.py speed_profile.  No reference analog (its
    # configured scenarios are straight roads)
    curvature_speed_limit: bool = False
    a_lat_max: float = 4.0   # comfort lateral-accel cap for the profile
    # per-point desired-velocity profile matching reference_path rows; set
    # by the curvature speed planner (None => constant desired_velocity)
    v_profile: Optional[np.ndarray] = None
    # free-form solver overrides from the YAML ``solver_settings:`` section
    # (e.g. iteration budgets ``ip_sqp_iters``, ``lqr_backend``) — applied as
    # defaults by ``closed_loop.make_loop_config``.  No reference analog
    # (FORCESPRO bakes its budgets into codegen, optimizer.py:197-245).
    solver_settings: Dict[str, object] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if self.dynamics_model not in ("ks", "st"):
            raise ValueError(
                f"dynamics_model must be ks|st, got {self.dynamics_model!r}")
        if self.framework not in ("casadi", "forcespro"):
            raise ValueError(
                f"framework must be casadi|forcespro, got {self.framework!r}")
        if self.use_case not in ("lane_following", "collision_avoidance"):
            raise ValueError(
                "use_case must be lane_following|collision_avoidance, "
                f"got {self.use_case!r}")
        if self.reference_path.ndim != 2 or self.reference_path.shape[1] != 2:
            raise ValueError("reference_path must be (n, 2)")
        if self.predict_horizon < 1:
            raise ValueError("predict_horizon must be >= 1")


def load_settings(path: str) -> Dict:
    with open(path, "r") as f:
        return yaml_lite.loads(f.read())


def _mean_lateral_offset(poly: np.ndarray, path: np.ndarray,
                         normals: np.ndarray) -> float:
    """Mean signed lateral offset of ``poly``'s points from ``path``
    (positive = left of travel direction)."""
    idx = np.argmin(
        ((poly[:, None, :] - path[None, :, :]) ** 2).sum(-1), axis=1)
    off = ((poly - path[idx]) * normals[idx]).sum(-1)
    return float(off.mean())


def _road_edges(scenario: Scenario, route_ids, reference_path: np.ndarray):
    """(left, right) road-edge polylines: the extreme-offset lanelet edges
    among the route's lanelets and their immediate lateral neighbors."""
    from mpc_tpu.utils.geometry import compute_orientation_from_polyline

    cand = set(route_ids)
    for lid in list(cand):
        l = scenario.lanelets.get(lid)
        if l is None:
            continue
        for a in (l.adj_left, l.adj_right):
            if a is not None and a in scenario.lanelets:
                cand.add(a)
    if not cand:
        return None, None
    path = np.asarray(reference_path, dtype=float)
    ori = compute_orientation_from_polyline(path)
    normals = np.stack([-np.sin(ori), np.cos(ori)], axis=1)
    best = []
    for lid in cand:
        l = scenario.lanelets[lid]
        for poly in (l.left_vertices, l.right_vertices):
            if poly is None or len(poly) < 2:
                continue
            best.append((_mean_lateral_offset(
                np.asarray(poly, float), path, normals), poly))
    if not best:
        return None, None
    best.sort(key=lambda t: t[0])
    right = np.asarray(best[0][1], dtype=float)
    left = np.asarray(best[-1][1], dtype=float)
    return left, right


def clip_reference_path(origin_path: np.ndarray, init_position: np.ndarray,
                        goal_position: np.ndarray) -> np.ndarray:
    """Clip the route path between initial and goal positions.

    Parity with ``configuration.py:584-623`` including the direction-aware
    index fixups: the path is prepended with the exact init position and
    appended with the exact goal position; interior indices are nudged so the
    kept vertices lie strictly between them.
    """
    start_index = find_closest_point(origin_path, init_position)
    end_index = find_closest_point(origin_path, goal_position)

    if goal_position[0] >= init_position[0]:  # left-to-right path
        if (origin_path[start_index] - init_position >= 0).sum() != 2:
            start_index += 1
        if (origin_path[end_index] - goal_position <= 0).sum() != 2:
            end_index -= 1
    else:  # right-to-left path
        if (origin_path[start_index] - init_position <= 0).sum() != 2:
            start_index += 1
        if (origin_path[end_index] - goal_position >= 0).sum() != 2:
            end_index -= 1
    return np.concatenate([
        init_position.reshape(1, 2),
        origin_path[start_index:end_index + 1],
        goal_position.reshape(1, 2)], axis=0)


def derive_desired_velocity(clipped_path: np.ndarray, time_step_limit: int,
                            delta_t: float) -> float:
    """v_des = len(path) / ((T_limit - 1) * dt), rounded UP at 4 decimals.

    Parity with ``configuration.py:524-544``.
    """
    length = compute_polyline_length(clipped_path)
    v = length / ((time_step_limit - 1) * delta_t)
    if v > round(v, 4):
        v = round(v, 4) + 0.0001
    else:
        v = round(v, 4)
    return v


def build_config(settings: Dict, scenario: Scenario,
                 planning_problem: Optional[PlanningProblem] = None
                 ) -> PlanningConfig:
    """Assemble a PlanningConfig from YAML settings + parsed scenario.

    Pipeline parity with ``create_optimization_configuration_vehicle``
    (``configuration.py:415-487``) and
    ``find_reference_path_and_desired_velocity``
    (``configuration.py:499-552``).
    """
    pp = planning_problem or scenario.planning_problems[0]
    if pp.id not in settings["vehicle_settings"]:
        raise KeyError(
            f"Cannot find settings for planning problem {pp.id}")
    vehicle_settings = settings["vehicle_settings"][pp.id]
    gps = settings["general_planning_settings"]
    use_case = settings["scenario_settings"]["use_case"]

    # --- route ---
    route = plan_route(scenario, pp.initial_position,
                       pp.goal.position_center, pp.goal.position_lanelets)
    origin_path = route.reference_path

    # goal position selection parity (configuration.py:590-600): rectangle
    # center when available, otherwise the route end (lanelet goals)
    if pp.goal.position_center is not None:
        goal_position = np.asarray(pp.goal.position_center, dtype=float)
    else:
        goal_position = origin_path[-1]

    clipped = clip_reference_path(origin_path, pp.initial_position.astype(
        float), goal_position)

    delta_t = scenario.dt if scenario.dt else 0.1
    time_step_limit = (pp.goal.time_end if pp.goal.time_end is not None
                       else pp.goal.time_start)
    # YAML override: scenarios with no goal time window (e.g. the shipped
    # ZAM_Tutorial-1_2_T-1 planning problem has no goalState at all) have
    # no derivable time budget — the config must supply one
    time_step_limit = int(gps.get("time_step_limit", time_step_limit))
    if time_step_limit < 2:
        raise ValueError(
            f"goal time budget is {time_step_limit} steps; the scenario's "
            "planning problem carries no usable goal time window — set "
            "general_planning_settings.time_step_limit in the YAML")
    desired_velocity = derive_desired_velocity(clipped, time_step_limit,
                                               delta_t)

    if vehicle_settings.get("resampling_reference_path", True):
        smoothed = chaikins_corner_cutting(clipped)
        reference_path = resample_polyline(
            smoothed, step=desired_velocity * delta_t)
    else:
        reference_path = clipped

    vehicle = get_vehicle(vehicle_settings["vehicle_model"])

    # curvature speed planning: re-time the reference path by integrating a
    # curvature/steering-rate-limited speed profile, so per-step targets
    # natively encode corner speeds (spacing = v(s) * dt).  No reference
    # analog — its configured scenarios are straight roads and its spacing
    # always encodes the constant v_des (configuration.py:548-549).
    v_profile = None
    if gps.get("curvature_speed_limit", False):
        from mpc_tpu.planner.reference import speed_profile
        prof = speed_profile(
            reference_path, desired_velocity,
            a_lat_max=float(gps.get("a_lat_max", 4.0)),
            a_long_max=0.5 * vehicle.longitudinal.a_max,
            wheelbase=float(vehicle_settings["wheelbase"]),
            steer_rate_max=vehicle.steering.v_max)
        s_axis = np.concatenate([[0.0], np.cumsum(np.hypot(
            *np.diff(reference_path, axis=0).T))])
        pts, vs = [], []
        s_cur = 0.0
        while s_cur < s_axis[-1] and len(pts) < 100000:
            pts.append([np.interp(s_cur, s_axis, reference_path[:, 0]),
                        np.interp(s_cur, s_axis, reference_path[:, 1])])
            v_here = max(float(np.interp(s_cur, s_axis, prof)), 0.3)
            vs.append(v_here)
            s_cur += v_here * delta_t
        reference_path = np.asarray(pts, dtype=float)
        v_profile = np.asarray(vs, dtype=float)

    orientation = compute_orientation_from_polyline(reference_path)

    # --- obstacle dict (configuration.py:471-483) ---
    obstacle_trajectory = None
    if use_case == "collision_avoidance":
        obs = scenario.obstacles[0]
        static_obstacle = {
            "position_x": float(obs.initial_state.position[0]),
            "position_y": float(obs.initial_state.position[1]),
            "length": float(obs.shape.length),
            "width": float(obs.shape.width),
            "orientation": float(obs.initial_state.orientation),
        }
        if gps.get("track_dynamic_obstacle", False) and obs.trajectory:
            states = [obs.initial_state] + list(obs.trajectory)
            obstacle_trajectory = np.asarray(
                [[s.position[0], s.position[1], s.orientation]
                 for s in states], dtype=float)
    else:
        static_obstacle = {"position_x": -100.0, "position_y": 0.0,
                           "length": 0.0, "width": 0.0, "orientation": 0.0}

    # optional reference detour (``reference_detour: true``): bend the
    # reference laterally around a near-head-on obstacle so the solver
    # starts in the avoidance basin.  The reference has no analog — its
    # configured CA scenario offsets the obstacle ~1.2 m from the path,
    # which seeds the basin implicitly; a dead-ahead obstacle (e.g. the
    # shipped-but-unconfigured ZAM_Tutorial_Urban-3_2) is a symmetric
    # saddle for any local solver.  Hard constraints still enforce the
    # true clearance.
    # road boundaries.  The reference hardcodes lanelets[1]/[0]
    # right_vertices (configuration.py:432-433) — correct only for its
    # two-lane ZAM road where lanelet 1 is the REVERSED oncoming lane (its
    # "right" edge is the far road edge).  For same-direction neighbors
    # (e.g. ZAM_Tutorial_Urban) that picks the lane DIVIDER as the road
    # edge.  Generalized: among the route's lanelets and their immediate
    # neighbors, take the edge polylines with the extreme mean lateral
    # offsets from the reference path (leftmost / rightmost = road edges).
    # (Computed before the detour pre-pass, which uses them to pick the
    # side of the road with room for the swerve.)
    left_b, right_b = _road_edges(scenario, route.lanelet_ids,
                                  reference_path)

    if (gps.get("reference_detour", False)
            and use_case == "collision_avoidance"):
        from mpc_tpu.models.constraints import approx_circle_radius
        from mpc_tpu.utils.geometry import (detour_side_from_road,
                                            lateral_detour)
        r_obs, _ = approx_circle_radius(static_obstacle["length"],
                                        static_obstacle["width"])
        r_ego, _ = approx_circle_radius(vehicle.l, vehicle.w)
        obs_pt = np.array([static_obstacle["position_x"],
                           static_obstacle["position_y"]])
        # road-aware side choice: detour into the side with room for the
        # full swerve (e.g. the neighbor lane), not off the shoulder
        side = detour_side_from_road(
            np.asarray(reference_path, float), obs_pt, left_b, right_b,
            required_clearance=r_ego + r_obs + 0.5,
            half_width=0.5 * vehicle.w)
        reference_path = lateral_detour(
            reference_path, obs_pt,
            required_clearance=r_ego + r_obs + 0.5, side=side)
        orientation = compute_orientation_from_polyline(reference_path)

    return PlanningConfig(
        scenario_name=settings["scenario_settings"]["scenario_name"],
        use_case=use_case,
        framework=gps["framework_name"],
        noised=bool(gps["noised"]),
        predict_horizon=int(gps["predict_horizon"]),
        delta_t=float(delta_t),
        iter_length=int(reference_path.shape[0]),
        desired_velocity=float(desired_velocity),
        origin_reference_path=origin_path,
        reference_path=np.asarray(reference_path, dtype=float),
        orientation=np.asarray(orientation, dtype=float),
        vehicle=vehicle,
        wheelbase=float(vehicle_settings["wheelbase"]),
        reference_point=vehicle_settings.get("reference_point", "rear"),
        static_obstacle=static_obstacle,
        weights=dict(settings["weights_setting"]),
        init_position=pp.initial_position.astype(float),
        init_velocity=float(pp.initial_velocity),
        init_orientation=float(pp.initial_orientation),
        init_acceleration=float(pp.initial_acceleration),
        left_road_boundary=left_b,
        right_road_boundary=right_b,
        boundary_constraints=bool(
            gps.get("boundary_constraints", False)),
        obstacle_trajectory=obstacle_trajectory,
        dynamics_model=str(gps.get("dynamics_model", "ks")),
        progress_window=bool(gps.get("progress_window", False)),
        curvature_speed_limit=bool(gps.get("curvature_speed_limit", False)),
        a_lat_max=float(gps.get("a_lat_max", 4.0)),
        v_profile=v_profile,
        solver_settings=dict(settings.get("solver_settings") or {}),
    )


def load_config(config_path: str, scenario_dir: str) -> PlanningConfig:
    """One-call loader: YAML + scenario XML -> PlanningConfig."""
    settings = load_settings(config_path)
    name = settings["scenario_settings"]["scenario_name"]
    scenario = load_scenario(os.path.join(scenario_dir, name + ".xml"))
    return build_config(settings, scenario)
