"""Planner facade, metrics, collision oracle, and CLI tests."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mpc_tpu.utils import collision as col
from mpc_tpu.utils import metrics as met

from asset_paths import CFG, GOLD, SCN  # noqa: F401

def test_rect_collision_basic():
    assert col.rectangles_collide([0, 0], 4, 2, 0.0, [3, 0], 4, 2, 0.0)
    assert not col.rectangles_collide([0, 0], 4, 2, 0.0, [10, 0], 4, 2, 0.0)
    # rotated near-miss vs hit
    assert col.rectangles_collide([0, 0], 4, 2, np.pi / 4, [2.0, 2.0], 2, 2,
                                  0.0)
    assert not col.rectangles_collide([0, 0], 4, 2, 0.0, [0, 2.5], 4, 2, 0.0)


def test_trajectory_obstacle_sweep():
    states = np.zeros((10, 5))
    states[:, 0] = np.arange(10) * 2.0  # drive +x through (10, 0)
    hit, step = col.trajectory_collides_obstacle(
        states, 4.5, 1.6, np.array([10.0, 0.0]), 4.0, 2.0, 0.0)
    assert hit and 3 <= step <= 6
    # zero-size obstacle (lane-following dummy) never collides
    hit, step = col.trajectory_collides_obstacle(
        states, 4.5, 1.6, np.array([10.0, 0.0]), 0.0, 0.0, 0.0)
    assert not hit and step == -1


def test_boundary_crossing():
    states = np.zeros((5, 5))
    states[:, 0] = np.arange(5) * 2.0
    states[:, 1] = np.arange(5) * 1.0  # drifting up into the boundary
    boundary = np.array([[0.0, 3.0], [20.0, 3.0]])
    hit, step = col.trajectory_crosses_boundary(states, 4.5, 1.6, boundary)
    assert hit
    far = np.array([[0.0, 30.0], [20.0, 30.0]])
    hit, _ = col.trajectory_crosses_boundary(states, 4.5, 1.6, far)
    assert not hit


def test_metrics_shapes():
    states = np.zeros((20, 5))
    states[:, 0] = np.arange(20)
    ref = np.stack([np.arange(20) + 0.1, np.zeros(20)], axis=1)
    rx, ry = met.rmsd_xy(states, ref)
    assert rx == pytest.approx(0.1 * np.sqrt(20 / 19), rel=1e-6)
    assert ry == 0.0
    dev = met.deviation_euclidean(states, ref)
    assert dev.shape == (20,)
    stats = met.solve_time_stats(np.full(10, 0.002))
    assert stats["mean_ms"] == pytest.approx(2.0)


def test_planner_facade_and_artifacts(tmp_path):
    from mpc_tpu.io.config import load_config
    from mpc_tpu.planner.planner import MPCPlanner
    c = load_config(os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"),
                    SCN)
    planner = MPCPlanner(c, noised=False)
    result = planner.plan()
    assert result.states.shape == (30, 5)
    assert not result.collided_obstacle
    assert not result.collided_boundary
    assert result.rmsd is not None and result.rmsd["x"] < 0.4
    d = planner.save_artifacts(result, str(tmp_path))
    for f in ["planned states.txt", "control inputs.txt", "solve time.txt",
              "deviation.txt", "RMSD.txt"]:
        assert os.path.exists(os.path.join(d, f)), f
    # reference text format round-trip
    g = np.loadtxt(os.path.join(d, "planned states.txt"))
    np.testing.assert_allclose(g, result.states)


def test_cli_smoke(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "mpc_tpu.planner.cli",
         "--config", os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"),
         "--scenario-dir", SCN,
         "--deterministic"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout)
    assert summary["steps"] == 30
    assert summary["collided_obstacle"] is False


def test_cli_rti1_smoke(tmp_path):
    """--rti1 deployment preset through the CLI: collision-free run with
    every step feasible on the forcespro-framework LF config, and a clean
    error on a casadi-framework config."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_fp = os.path.join(str(tmp_path), "lf_fp.yaml")
    with open(os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml")) as f:
        text = f.read()
    with open(cfg_fp, "w") as f:
        f.write(text.replace("framework_name: casadi",
                             "framework_name: forcespro"))
    proc = subprocess.run(
        [sys.executable, "-m", "mpc_tpu.planner.cli",
         "--config", cfg_fp, "--scenario-dir", SCN,
         "--deterministic", "--rti1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout)
    assert summary["collided_obstacle"] is False
    assert "-7" not in summary["solver_status_counts"]  # json str keys
    # casadi-framework config: clean error, not a bad run
    proc2 = subprocess.run(
        [sys.executable, "-m", "mpc_tpu.planner.cli",
         "--config", os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"),
         "--scenario-dir", SCN, "--deterministic", "--rti1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert proc2.returncode == 1
    assert "forcespro-framework" in proc2.stderr
