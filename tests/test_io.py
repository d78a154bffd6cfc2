"""Scenario reader / route planner / config layer tests."""
import os

import numpy as np
import pytest

from mpc_tpu.io.scenario import load_scenario
from mpc_tpu.io.route import plan_route, shortest_route
from mpc_tpu.io.config import (build_config, clip_reference_path,
                               derive_desired_velocity, load_config,
                               load_settings)

from asset_paths import CFG, GOLD, SCN  # noqa: F401

def test_parse_zam_scenario():
    s = load_scenario(os.path.join(SCN, "ZAM_Over-1_1.xml"))
    assert s.dt == 0.1
    assert set(s.lanelets) == {1000, 1001}
    assert len(s.obstacles) == 1
    ob = s.obstacles[0]
    assert ob.role == "static"
    np.testing.assert_allclose(ob.initial_state.position,
                               [59.948, 0.08323])
    assert (ob.shape.length, ob.shape.width) == (6.0, 3.5)
    pp = s.planning_problems[0]
    assert pp.id == 1
    np.testing.assert_allclose(pp.initial_position, [29.9948, -1.1501])
    assert pp.initial_velocity == 20.0
    np.testing.assert_allclose(pp.goal.position_center, [87.8, 3.3])
    assert pp.goal.time_end == 30


def test_parse_usa_scenario():
    s = load_scenario(os.path.join(SCN, "USA_Lanker-2_18_T-1.xml"))
    assert len(s.lanelets) == 112
    pp = s.planning_problems[0]
    assert pp.id == 21007
    assert pp.goal.position_center is None
    assert pp.goal.position_lanelets == [3456, 3468, 3462]
    assert pp.goal.time_end == 70
    # lanelet lookup by position
    assert s.find_lanelets_by_position(np.array([0.0, 0.0])) == [3672]


def test_route_zam_single_lanelet():
    s = load_scenario(os.path.join(SCN, "ZAM_Over-1_1.xml"))
    pp = s.planning_problems[0]
    r = plan_route(s, pp.initial_position, pp.goal.position_center,
                   pp.goal.position_lanelets)
    # goal is dead ahead in the same (curving) lanelet
    assert r.lanelet_ids == [1000]
    # path passes near init and goal
    d_init = np.min(np.linalg.norm(
        r.reference_path - pp.initial_position, axis=1))
    d_goal = np.min(np.linalg.norm(
        r.reference_path - pp.goal.position_center, axis=1))
    assert d_init < 1.0 and d_goal < 1.0


def test_route_usa_lane_changes():
    s = load_scenario(os.path.join(SCN, "USA_Lanker-2_18_T-1.xml"))
    pp = s.planning_problems[0]
    r = plan_route(s, pp.initial_position, None, pp.goal.position_lanelets)
    assert r.lanelet_ids[0] == 3672
    assert r.lanelet_ids[-1] in pp.goal.position_lanelets
    # early path follows 3672's dipping centerline (y < 0 around x ~ 10),
    # i.e. lane-change blending must not distort the route start
    xs, ys = r.reference_path[:, 0], r.reference_path[:, 1]
    mask = (xs > 8) & (xs < 12)
    assert mask.any() and ys[mask].min() < -1.5


def test_shortest_route_unreachable():
    s = load_scenario(os.path.join(SCN, "ZAM_Over-1_1.xml"))
    with pytest.raises(ValueError, match="No route"):
        shortest_route(s, 1000, [999999])


def test_clip_reference_path_quirks():
    # parity with configuration.py:584-623 (left-to-right branch)
    path = np.array([[0.0, 0.0], [1.0, 0.1], [2.0, 0.2], [3.0, 0.3],
                     [4.0, 0.4]])
    init = np.array([0.5, 0.05])
    goal = np.array([3.5, 0.35])
    out = clip_reference_path(path, init, goal)
    np.testing.assert_allclose(out[0], init)
    np.testing.assert_allclose(out[-1], goal)
    # interior points strictly between init and goal
    assert out[1:-1, 0].min() >= 0.5 and out[1:-1, 0].max() <= 3.5


def test_desired_velocity_round_up():
    # parity with configuration.py:538-544: round UP at 4 decimals
    path = np.array([[0.0, 0.0], [10.0, 0.0]])  # length 10
    v = derive_desired_velocity(path, time_step_limit=31, delta_t=0.1)
    assert v == pytest.approx(10.0 / 3.0, abs=2e-4)
    assert v >= 10.0 / 3.0  # rounded up, never down
    v2 = derive_desired_velocity(path, time_step_limit=11, delta_t=0.1)
    assert v2 == 10.0  # exact


def test_config_iter_lengths_match_goldens():
    c = load_config(os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"),
                    SCN)
    assert c.iter_length == 30  # golden planned states.txt has 30 rows
    assert abs(c.desired_velocity - 20.0) < 0.1
    cu = load_config(
        os.path.join(CFG, "config_LF_USA_Lanker-2_18_T-1.yaml"),
        SCN)
    assert cu.iter_length == 70
    assert cu.framework == "casadi" and cu.use_case == "lane_following"


def test_config_validation():
    settings = load_settings(
        os.path.join(CFG, "config_LF_ZAM_Over-1_1.yaml"))
    s = load_scenario(os.path.join(SCN, "ZAM_Over-1_1_LF.xml"))
    settings["general_planning_settings"]["framework_name"] = "ipopt"
    with pytest.raises(ValueError, match="framework"):
        build_config(settings, s)
    settings["general_planning_settings"]["framework_name"] = "casadi"
    settings["scenario_settings"]["use_case"] = "parking"
    with pytest.raises(ValueError, match="use_case"):
        build_config(settings, s)


def test_synthetic_scenario_generator(tmp_path):
    import subprocess, sys
    out = tmp_path / "SYN_Test-1.xml"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "tools/make_scenario.py", "--out", str(out),
         "--length", "100", "--curvature", "0.001", "--obstacle", "0.5",
         "--v0", "15"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    s = load_scenario(str(out))
    assert set(s.lanelets) == {1000, 1001}
    assert len(s.obstacles) == 1
    pp = s.planning_problems[0]
    assert pp.goal.position_center is not None
    # the generated scenario is plannable end-to-end
    r = plan_route(s, pp.initial_position, pp.goal.position_center,
                   pp.goal.position_lanelets)
    assert r.lanelet_ids[0] in (1000, 1001)


def test_parse_every_shipped_scenario():
    """All six reference XMLs parse (incl. the unconfigured ones —
    USA_Peach, ZAM_Tutorial*; SURVEY.md §2.1 scenario row)."""
    import glob

    files = sorted(glob.glob(os.path.join(SCN, "*.xml")))
    assert len(files) >= 6
    for f in files:
        s = load_scenario(f)
        assert len(s.lanelets) >= 1, f
        # every scenario has at least a planning problem with an init state
        assert s.planning_problems, f
        pp = s.planning_problems[0]
        assert np.isfinite(pp.initial_position).all(), f


_CONFIGS = sorted(f for f in os.listdir(CFG) if f.endswith(".yaml"))


def test_ten_shipped_configs():
    assert len(_CONFIGS) == 10


@pytest.mark.parametrize("name", _CONFIGS)
def test_yaml_lite_matches_safe_load(name):
    """The package's config reader equals ``yaml.safe_load`` on every
    shipped config (PyYAML is a test-only dependency)."""
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(CFG, name)) as f:
        text = f.read()
    assert load_settings(os.path.join(CFG, name)) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, 2]\n",            # flow sequence
    "a: {b: 1}\n",            # flow mapping
    "a: &x 1\nb: *x\n",       # anchor / alias
    "a: |\n  two\n  lines\n",  # literal block scalar
    "a: foo\n  bar\n",        # plain multi-line scalar
    "a:\n  - 1\n",            # block sequence
    "a: !!str 1\n",           # tag
    "a: 0x10\n",              # non-decimal number
])
def test_yaml_lite_refuses_unsupported_syntax(text):
    from mpc_tpu.io import yaml_lite
    with pytest.raises(ValueError):
        yaml_lite.loads(text)
