"""Regenerate the repo's deterministic regression goldens.

Run from the repo root:  python tools/make_goldens.py

Covers BOTH reference formulations (casadi and forcespro modes), mirroring
the six committed reference golden sets (reference source:
``test/2D_plots_{casadi,forcespro}_*``).

Goldens are recorded in float64 (``jax.enable_x64``): the CA closed loop is
chaotic enough that float32 rounding differences across machines / XLA
versions amplify by ~1e6 over 30 steps, which would make float32 goldens
machine-specific.  In float64 the same amplification leaves cross-platform
error at ~1e-9, far below the 1e-4 tolerance in
``tests/test_closed_loop.py::test_deterministic_regression_goldens``.
"""
import os
import sys

# goldens are CPU float64: accelerator numerics diverge visibly on the
# chaotic CA loops
os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mpc_tpu.io.config import load_config
from mpc_tpu.planner import closed_loop as cl

CFG = os.path.join(REPO, "configs")
SCN = os.path.join(REPO, "scenarios")

# (config, golden tag, formulation override or None)
CASES = [
    ("config_LF_ZAM_Over-1_1.yaml", "zam_lf_casadi", None),
    ("config_CA_ZAM_Over-1_1.yaml", "zam_ca_casadi", None),
    ("config_LF_USA_Lanker-2_18_T-1.yaml", "usa_lf_casadi", None),
    # FORCESPRO-mode trio (RK4 plant, H=N-1, ramped v_des; the LF configs
    # share weights across frameworks so the mode flip suffices; CA uses the
    # dedicated forcespro weight set, reference config_CA_ZAM_Over-1_1.yaml
    # commented block)
    ("config_LF_ZAM_Over-1_1.yaml", "zam_lf_forcespro", "forcespro"),
    ("config_CA_ZAM_Over-1_1_forcespro_ref.yaml", "zam_ca_forcespro", None),
    ("config_LF_USA_Lanker-2_18_T-1.yaml", "usa_lf_forcespro", "forcespro"),
]


def main():
    out_dir = os.path.join(REPO, "tests", "goldens")
    with jax.enable_x64(True):
        for config_name, tag, framework in CASES:
            c = load_config(os.path.join(CFG, config_name), SCN)
            if framework is not None:
                c = type(c)(**{**c.__dict__, "framework": framework})
            lcfg = cl.make_loop_config(c, noised=False)
            params = cl.make_loop_params(c, lcfg, dtype=jnp.float64)
            res = cl.closed_loop_jit(lcfg, params)
            X = np.asarray(res.X)
            U = np.asarray(res.U)
            np.savetxt(os.path.join(out_dir, f"{tag}_states.txt"), X)
            np.savetxt(os.path.join(out_dir, f"{tag}_inputs.txt"), U)
            print(f"{tag}: T={len(X)} final=({X[-1, 0]:.3f}, {X[-1, 1]:.3f})"
                  f" status_min={int(np.asarray(res.status).min())}")


if __name__ == "__main__":
    main()
