"""Command-line entry point.

Replaces the reference's edit-a-constant-and-run-unittest workflow
(``test/test_mpc_planner.py:16``: scenario choice by editing a string) with a
proper CLI:

    python -m mpc_tpu.planner.cli --config configs/config_LF_ZAM_Over-1_1.yaml \
        --scenario-dir /path/to/scenarios --out /tmp/out [--gif]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mpc_tpu.io.config import load_config
from mpc_tpu.planner.planner import MPCPlanner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mpc_tpu.planner.cli",
        description="Batched NMPC motion planner for CommonRoad scenarios")
    ap.add_argument("--config", required=True, help="planner YAML config")
    ap.add_argument("--scenario-dir", required=True,
                    help="directory containing CommonRoad scenario XMLs")
    ap.add_argument("--out", default=None,
                    help="write reference-format artifacts to this directory")
    ap.add_argument("--horizon", type=int, default=None,
                    help="override prediction horizon")
    ap.add_argument("--seed", type=int, default=0, help="noise PRNG seed")
    ap.add_argument("--deterministic", action="store_true",
                    help="disable actuation noise regardless of the config")
    ap.add_argument("--rti1", action="store_true",
                    help="1-warm-QP-per-step deployment preset (the "
                         "reference's maxqps=1): RTI1_SETTINGS for lane "
                         "following, RTI1_CA_SETTINGS (N=14 horizon, "
                         "applied-prefix status gate) for collision "
                         "avoidance")
    ap.add_argument("--gif", action="store_true",
                    help="render per-step PNGs + animated GIF (slow)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a jax.profiler trace of the solve")
    ap.add_argument("--debug-nans", action="store_true",
                    help="enable jax debug_nans (slow; aborts on NaN)")
    args = ap.parse_args(argv)

    import jax
    from mpc_tpu.utils import runtime
    runtime.enable_compile_cache()
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)

    try:
        config = load_config(args.config, args.scenario_dir)
    except FileNotFoundError as e:
        print(f"error: {e.filename or e}: no such file", file=sys.stderr)
        return 1
    except (KeyError, ValueError) as e:
        print(f"error: invalid configuration: {e}", file=sys.stderr)
        return 1
    overrides = {}
    if args.rti1:
        if config.framework != "forcespro":
            # the presets are tuned for the hard-constrained forcespro
            # formulation (RK4, terminal cost, 9-pair rows); under the
            # casadi formulation they leave infeasible steps
            print("error: --rti1 requires a forcespro-framework config "
                  f"(this one is '{config.framework}'); set "
                  "framework_name: forcespro in the YAML",
                  file=sys.stderr)
            return 1
        from mpc_tpu.planner import closed_loop as _cl
        overrides = dict(_cl.RTI1_CA_SETTINGS
                         if config.use_case == "collision_avoidance"
                         else _cl.RTI1_SETTINGS)
    # an explicit --horizon wins over a preset horizon
    preset_h = overrides.pop("horizon", None)
    horizon = args.horizon if args.horizon is not None else preset_h
    planner = MPCPlanner(config, horizon=horizon,
                         noised=False if args.deterministic else None,
                         seed=args.seed, **overrides)
    if args.profile_dir:
        with jax.profiler.trace(args.profile_dir):
            result = planner.plan()
        print(f"profiler trace written to {args.profile_dir}",
              file=sys.stderr)
    else:
        result = planner.plan()

    summary = {
        "scenario": config.scenario_name,
        "use_case": config.use_case,
        "framework": config.framework,
        "steps": int(result.states.shape[0]),
        "wall_time_s": round(result.wall_time_s, 4),
        "ms_per_step": round(1e3 * result.wall_time_s
                             / result.states.shape[0], 3),
        "rmsd": result.rmsd,
        "final_position": [round(float(v), 3) for v in result.states[-1, :2]],
        "collided_obstacle": result.collided_obstacle,
        "collided_boundary": result.collided_boundary,
        "solver_status_counts": {
            int(k): int(v) for k, v in zip(
                *np.unique(result.status, return_counts=True))},
    }
    print(json.dumps(summary, indent=2))

    if args.out:
        d = planner.save_artifacts(result, args.out)
        print(f"artifacts written to {d}", file=sys.stderr)
        from mpc_tpu.utils.viz import plot_analysis
        plot_analysis(config, result.states, result.inputs,
                      result.solve_time, result.deviation, d)
        if args.gif:
            import os
            from mpc_tpu.io.scenario import load_scenario
            from mpc_tpu.utils.viz import render_gif
            scenario = load_scenario(os.path.join(
                args.scenario_dir, config.scenario_name + ".xml"))
            gif = render_gif(config, result.states, args.out, scenario)
            print(f"gif written to {gif}", file=sys.stderr)
    return 0 if not (result.collided_obstacle or result.collided_boundary) \
        else 2


if __name__ == "__main__":
    raise SystemExit(main())
