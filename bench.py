"""Benchmark: warm-started receding-horizon NMPC solves/s per GPU at H=30.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", ..., "hard_constrained": {...}}

Workload: the production closed-loop step — exactly what both reference
solvers time in their ``solve time.txt`` series (warm-started per-step
solves): a batch of perturbed overtaking lanes runs ``n_steps`` receding-
horizon iterations on the device (reference windowing + full constraint
stack + plant propagation); solves/s = lanes * steps / wall, timed with
``jax.block_until_ready`` around the whole closed-loop program.

Baseline context (BASELINE.json / SURVEY.md §6):
  * reference FORCESPRO p50 per-solve: 2.35 ms at H=10 => ~426 solves/s
  * reference CasADi/IPOPT p50: ~35-39 ms/solve

The benchmark measures the GPU only: on any other backend it exits
nonzero instead of shrinking the workload.
"""
from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

BATCH = 16384
# True-RTI operating points: ONE warm-started iteration per closed-loop
# solve, applied as the UNGUARDED full step (the reference FORCESPRO
# deployment's 1-QP-per-step semantics: ``maxqps=1``, optimizer.py:237,
# step applied with no merit test), with full-strength cold-start warmup.
# tests/test_robustness.py pins both against their oracle budgets.
SOFT = dict(method="al", al_iters=1, sqp_iters=1, alphas=())
HARD = dict(method="ip", ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
            ip_alphas=())


def run_point(point: dict, batch: int, horizon: int = 30,
              n_steps: int = 100, repeats: int = 8):
    """(solves/s, seconds per closed-loop step, feasible steps, solves)."""
    from mpc_tpu.planner import closed_loop as cl
    from mpc_tpu.utils import synthetic

    lcfg, params = synthetic.make_bench_loop(
        n_steps=n_steps, horizon=horizon, n_lanes=batch, **point)

    def run():
        return jax.block_until_ready(cl.closed_loop_batch_vec(lcfg, params))

    res = run()  # compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = run()
        best = min(best, time.perf_counter() - t0)
    ok = int(jnp.sum(res.status >= 0))
    solves = batch * n_steps
    return solves / best, best / n_steps, ok, solves


def main():
    from mpc_tpu.utils import runtime

    runtime.enable_compile_cache()
    dev = runtime.require_gpu()
    card = runtime.gpu_name_and_power_limit()
    n_dev = len(jax.devices())

    def row(metric, point, budget):
        rate, step_s, ok, total = run_point(point, BATCH)
        return {
            "metric": metric,
            "value": round(rate / n_dev, 1),
            "unit": "solves/s/chip",
            "batch": BATCH,
            "step_latency_ms": round(step_s * 1e3, 4),
            "feasible_steps": ok,
            "total_solves": total,
            "budget": budget,
        }

    result = row("nmpc_solves_per_s_per_chip_h30", SOFT,
                 "al 1x1 unguarded (maxqps=1 parity)")
    result.update(devices=n_dev, platform=dev.platform,
                  device_kind=dev.device_kind, card=card)
    # hard-constrained engine (the reference's flagship mode) on the same
    # harness
    result["hard_constrained"] = row(
        "hard_ip_rti_solves_per_s_per_chip_h30", HARD,
        "ip 1x4 warm unguarded (maxqps=1 parity)")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
