"""Calibrate status==1 semantics: measure warm steady-state KKT residuals.

Production budgets once never reported status==1, so the converged/
max-iters distinction carried no information.  This tool runs the
production closed loops and prints the per-step stationarity-residual
distribution of WARM solves (steps >= 5; the cold-start transient is
excluded), split by method, plus the convergence rate at the configured
tolerances.  ``sqp.SolverConfig.tol_stat`` / ``tol_stat_ip`` defaults are
calibrated against these numbers (see STATUS_CALIB.json).

Usage: JAX_PLATFORMS=cpu python tools/calibrate_status.py
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

from mpc_tpu.io.config import load_config
from mpc_tpu.planner import closed_loop as cl


def measure(config, framework, label, **solver_overrides):
    cfg = load_config(os.path.join(REPO, "configs", config),
                      os.path.join(REPO, "scenarios"))
    cfg = type(cfg)(**{**cfg.__dict__, "framework": framework})
    lcfg = cl.make_loop_config(cfg, noised=False, **solver_overrides)
    params = cl.make_loop_params(cfg, lcfg)
    res = cl.closed_loop_jit(lcfg, params)
    stat = np.asarray(res.stat)[5:]          # warm steady state
    status = np.asarray(res.status)
    scfg = lcfg.solver
    tol = scfg.tol_stat_ip if scfg.method == "ip" else scfg.tol_stat
    out = {
        "point": label, "method": scfg.method,
        "stat_p50": round(float(np.percentile(stat, 50)), 6),
        "stat_p90": round(float(np.percentile(stat, 90)), 6),
        "stat_max": round(float(stat.max()), 6),
        "tol_stat": tol,
        "warm_conv_rate": round(float(np.mean(
            np.asarray(res.status)[5:] == 1)), 3),
        "n_converged": int((status == 1).sum()),
        "n_steps": int(len(status)),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    rows = [
        measure("config_LF_ZAM_Over-1_1.yaml", "casadi", "zamlf_casadi_al"),
        measure("config_LF_ZAM_Over-1_1.yaml", "forcespro",
                "zamlf_fp_ip_default"),
        measure("config_LF_ZAM_Over-1_1.yaml", "forcespro",
                "zamlf_fp_ip2x6w", ip_sqp_iters=2, ip_iters=6,
                ip_warm_duals=True),
        measure("config_LF_ZAM_Over-1_1.yaml", "forcespro",
                "zamlf_fp_al23", method="al", al_iters=2, sqp_iters=3),
        measure("config_LF_USA_Lanker-2_18_T-1.yaml", "forcespro",
                "usalf_fp_ip_default"),
        measure("config_CA_ZAM_Over-1_1.yaml", "forcespro",
                "zamca_fp_ip_default"),
    ]
    with open(os.path.join(REPO, "STATUS_CALIB.json"), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
