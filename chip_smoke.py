#!/usr/bin/env python3
"""Smoke test of the planner's main path on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # only the sharded closed loop on 4 GPUs

One process; no phase catches another's exception, so any failure exits
nonzero.  Phases (one GPU):

1. device, ``nvidia-smi`` name and power limit, JAX version, and whether
   XLA runs float32 contractions in TF32 by default;
2. the batched soft-constrained engine (``ops.sqp_vec``, lanes-trailing
   XLA) against the plain reference (the vmapped ``sqp.solve`` at full
   float32 matmul precision) at B=16384, H=30 — the hard-constrained path
   is the vmapped reference itself;
3. both benchmark operating points (AL 1x1 unguarded, IP 1x4 warm
   unguarded) through ``closed_loop_batch_vec`` at B=16384, H=30, T=100:
   every step feasible, solves/s printed;
4. ``MPCPlanner`` on the reference forcespro CA scenario (deterministic,
   as in the tests): collision-free and every step feasible;
5. a few ``OnlinePlanner.step`` calls.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(HERE, "mpc_tpu")):
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(mpc_tpu/ not found beside it)")
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mpc_tpu.ops import sqp, sqp_vec  # noqa: E402
from mpc_tpu.planner import closed_loop as cl  # noqa: E402
from mpc_tpu.utils import runtime, synthetic  # noqa: E402

B, H, T = 16384, 30, 100
REPS = 3
# the bench.py operating points
AL_POINT = dict(method="al", al_iters=1, sqp_iters=1, alphas=())
IP_POINT = dict(method="ip", ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
                ip_alphas=())
# tolerances of tests/test_sqp_vec.py: (name, rtol, atol)
TOLS = (("U", 2e-3, 2e-3), ("X", 2e-3, 2e-2), ("viol", 0.0, 1e-3),
        ("cost", 1e-3, 1e-2))


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def tf32_probe() -> None:
    """Max relative error of a batched float32 contraction (the shape of
    ``ipqp``'s J' S J) at default vs highest precision, against float64."""
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    J = jax.random.normal(k0, (B, 14, 7), jnp.float32)
    s = jax.random.uniform(k1, (B, 14), jnp.float32)
    exact = np.einsum("krz,kr,krw->kzw", np.asarray(J, np.float64),
                      np.asarray(s, np.float64), np.asarray(J, np.float64))
    errs = {}
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            got = jax.jit(lambda a, b: jnp.einsum("krz,kr,krw->kzw",
                                                  a, b, a))(J, s)
        errs[prec] = float(np.max(np.abs(np.asarray(got) - exact))
                           / np.max(np.abs(exact)))
    log(f"float32 contraction rel. error vs float64: default "
        f"{errs['default']:.3e}, highest {errs['highest']:.3e} "
        f"({'TF32 by default' if errs['default'] > 1e-5 else 'full f32'})")


def step0_problem(point):
    """(LoopConfig, LoopParams, OcpParams, cold SqpState) of the bench's
    first closed-loop step."""
    lcfg, params = synthetic.make_bench_loop(n_steps=T, horizon=H,
                                             n_lanes=B, **point)
    window, step_obs, make_ocp = cl._batch_helpers(lcfg, params)
    x_ref, _ = window(jnp.asarray(0), params.x_init,
                      jnp.zeros((B,), jnp.int32))
    ocp = make_ocp(params.x_init, x_ref, step_obs(jnp.asarray(0)))
    scfg = lcfg.solver
    state = jax.vmap(lambda _: sqp.init_state(scfg))(jnp.arange(B))
    return lcfg, params, ocp, state


def compare(label: str, got, ref) -> None:
    parts = []
    for name, rtol, atol in TOLS:
        g = np.asarray(getattr(got, name), np.float64)
        r = np.asarray(getattr(ref, name), np.float64)
        err = np.abs(g - r)
        n_out = int(np.sum(err > atol + rtol * np.abs(r)))
        parts.append(f"{name} max|d| {err.max():.3e} ({n_out} out)")
        assert n_out == 0, f"{label}: {name} outside rtol {rtol} atol {atol}"
    same = float(np.mean(np.asarray(got.status) == np.asarray(ref.status)))
    log(f"{label} vs reference: " + ", ".join(parts)
        + f", status agreement {same:.4f}")


def check_engine() -> None:
    """sqp_vec vs the vmapped reference on the AL bench point's first
    closed-loop step."""
    lcfg, _, ocp, state = step0_problem(AL_POINT)
    scfg = lcfg.solver
    with jax.default_matmul_precision("highest"):
        ref, t_ref = timed(sqp.solve_batch, scfg, ocp, state)
    log(f"al reference (vmapped sqp.solve, highest precision): "
        f"compile+run {t_ref:.1f} s")
    f = jax.jit(sqp_vec.solve_batch_vec, static_argnums=0)
    got, t_first = timed(f, scfg, ocp, state)
    _, t_run = timed(f, scfg, ocp, state)
    log(f"al sqp_vec (XLA): compile+first {t_first:.1f} s, one solve of "
        f"{B} lanes {1e3 * t_run:.3f} ms")
    compare("al sqp_vec (XLA)", got, ref)


def run_loop(label, lcfg, params, card):
    res, t_first = timed(cl.closed_loop_batch_vec, lcfg, params)
    best = float("inf")
    for _ in range(REPS):
        res, t = timed(cl.closed_loop_batch_vec, lcfg, params)
        best = min(best, t)
    n = params.x_init.shape[0] * lcfg.n_steps
    feasible = int(jnp.sum(res.status >= 0))
    log(f"{label}: {n / best:.1f} solves/s, {1e3 * best / lcfg.n_steps:.4f} "
        f"ms/step (best of {REPS}, B={params.x_init.shape[0]}, H={H}, "
        f"T={lcfg.n_steps}), compile+first {t_first:.1f} s, feasible "
        f"{feasible}/{n} [{card}]")
    assert feasible == n, f"{label}: {n - feasible} infeasible steps"


def bench_points(card: str) -> None:
    for name, point in (("AL 1x1 unguarded", AL_POINT),
                        ("IP 1x4 warm unguarded", IP_POINT)):
        lcfg, params = synthetic.make_bench_loop(n_steps=T, horizon=H,
                                                 n_lanes=B, **point)
        run_loop(name, lcfg, params, card)


def reference_scenario() -> None:
    from mpc_tpu.io.config import load_config
    from mpc_tpu.planner.planner import MPCPlanner

    cfg = load_config(os.path.join(
        HERE, "configs", "config_CA_ZAM_Over-1_1_forcespro_ref.yaml"),
        os.path.join(HERE, "scenarios"))
    t0 = time.perf_counter()
    res = MPCPlanner(cfg, noised=False).plan()
    feasible = int(np.sum(res.status >= 0))
    log(f"MPCPlanner {cfg.scenario_name} {cfg.framework} {cfg.use_case}: "
        f"{len(res.status)} steps, feasible {feasible}, collided_obstacle "
        f"{res.collided_obstacle}, p50 step "
        f"{1e3 * np.median(res.solve_time):.3f} ms, wall "
        f"{time.perf_counter() - t0:.1f} s")
    assert not res.collided_obstacle, "reference scenario collided"
    assert feasible == len(res.status), "infeasible steps"


def online_steps() -> None:
    from mpc_tpu.io.config import load_config
    from mpc_tpu.models import dynamics as dyn
    from mpc_tpu.planner.online import OnlinePlanner

    cfg = load_config(os.path.join(HERE, "configs",
                                   "config_LF_ZAM_Over-1_1.yaml"),
                      os.path.join(HERE, "scenarios"))
    op = OnlinePlanner(cfg)
    step = jax.jit(dyn.make_step_fn("rk4", cfg.delta_t, cfg.wheelbase))
    x = np.asarray(op.params.x_init)
    for i in range(5):
        t0 = time.perf_counter()
        u, info = op.step(x)
        dt = time.perf_counter() - t0
        log(f"OnlinePlanner.step {i}: u {np.round(u, 4).tolist()}, status "
            f"{info.status}, viol {info.viol:.2e}, {1e3 * dt:.2f} ms")
        assert np.all(np.isfinite(u)) and info.status >= 0
        x = np.asarray(step(jnp.asarray(x), jnp.asarray(u)))


def four_gpus() -> None:
    from mpc_tpu.parallel import batch as pb
    from mpc_tpu.parallel import mesh as pm

    devs = jax.devices()
    assert len(devs) >= 4, f"--four-gpus needs 4 GPUs, found {len(devs)}"
    mesh = pm.make_mesh((4, 1), devices=devs[:4])
    # the AL bench point: its batched engine (sqp_vec) runs under shard_map
    lcfg, params = synthetic.make_bench_loop(n_steps=T, horizon=H,
                                             n_lanes=B, **AL_POINT)
    one = jax.device_put(params, devs[0])
    res_1, t_1 = timed(cl.closed_loop_batch_vec, lcfg, one)
    _, t_1 = timed(cl.closed_loop_batch_vec, lcfg, one)
    res_4, t_4 = timed(pb.closed_loop_batch_sharded, lcfg, params, mesh)
    _, t_4 = timed(pb.closed_loop_batch_sharded, lcfg, params, mesh)
    holders = {s.device for s in res_4.X.addressable_shards}
    dX = float(np.max(np.abs(np.asarray(res_4.X) - np.asarray(res_1.X))))
    same = int(np.sum(np.asarray(res_4.status) == np.asarray(res_1.status)))
    log(f"AL 1x1 unguarded: sharded over {len(holders)} devices "
        f"{sorted(d.id for d in holders)}, max |dX| sharded vs one card "
        f"{dX:.3e}, status equal {same}/{res_1.status.size}, "
        f"{B * T / t_4:.1f} solves/s on 4 cards vs {B * T / t_1:.1f} on one "
        f"(B={B}, H={H}, T={T})")
    assert len(holders) == 4, "result not spread over four devices"
    assert same == res_1.status.size and dX < 5e-2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded closed loop on four GPUs")
    args = ap.parse_args()

    t_start = time.perf_counter()
    runtime.enable_compile_cache()
    dev = runtime.require_gpu()
    card = runtime.gpu_name_and_power_limit()
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    log(f"nvidia-smi: {card}")
    log(f"jax {jax.__version__}")
    if args.four_gpus:
        four_gpus()
        count = 4
    else:
        tf32_probe()
        check_engine()
        bench_points(card)
        reference_scenario()
        online_steps()
        count = len(jax.devices())
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
