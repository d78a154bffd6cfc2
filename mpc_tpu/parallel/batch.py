"""Sharded batch solving over a device mesh.

The chip- and pod-scale entry points: lanes (independent NMPC instances) are
sharded over the mesh's ``dp`` axis; XLA partitions the whole vmapped solver
with zero communication on the hot path.  Cross-lane reductions (convergence
counters, violation maxima — the only quantities that must cross devices,
SURVEY.md §5) use ``shard_map`` + ``psum``/``pmax`` collectives.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mpc_tpu.ops import sqp
from mpc_tpu.planner import closed_loop as cl
from mpc_tpu.parallel import mesh as mesh_mod


class BatchSummary(NamedTuple):
    """Global (all-lane) diagnostics, reduced over the mesh."""

    n_converged: jax.Array   # () int32
    n_infeasible: jax.Array  # () int32
    max_viol: jax.Array      # ()
    mean_cost: jax.Array     # ()


def _lane_specs(pytree):
    return jax.tree.map(
        lambda x: P("dp", *([None] * (max(x.ndim, 1) - 1))), pytree)


@partial(jax.jit, static_argnums=(0,), static_argnames=("mesh",))
def _solve_sharded(cfg: sqp.SolverConfig, params, state, *, mesh: Mesh):
    lane = NamedSharding(mesh, P("dp"))
    f = jax.vmap(lambda p, s: sqp.solve(cfg, p, s))
    with mesh:  # resolve solver-internal stage_axis PartitionSpecs
        out_sh = jax.tree.map(lambda _: lane,
                              jax.eval_shape(f, params, state))
        return jax.jit(f, out_shardings=out_sh)(params, state)


def _engine_sharded(fn, static_arg, inputs, mesh: Mesh):
    """shard_map a batched engine over lane tiles on the dp axis.

    Each device runs the engine (the lanes-trailing XLA path) on its
    local lane shard — the same engine selection as the
    single-device throughput path, composed with the mesh.
    """
    leaves, treedef = jax.tree.flatten(inputs)
    f = _sharded_engine(fn, static_arg, mesh, treedef,
                        tuple((x.shape, x.dtype) for x in leaves))
    with mesh:
        return f(*inputs)


@lru_cache(maxsize=None)
def _sharded_engine(fn, static_arg, mesh: Mesh, treedef, avals):
    """The jitted shard_map of :func:`_engine_sharded`, built once per
    engine, config, mesh and input shapes (a fresh ``jax.jit`` per call
    would re-trace the whole program every call).  ``check_vma=False``:
    outputs are lane-sharded, never replicated."""
    inputs = jax.tree.unflatten(
        treedef, [jax.ShapeDtypeStruct(s, d) for s, d in avals])
    in_specs = tuple(_lane_specs(x) for x in inputs)
    out_specs = _lane_specs(
        jax.eval_shape(lambda *a: fn(static_arg, *a), *inputs))
    return jax.jit(shard_map(lambda *a: fn(static_arg, *a), mesh=mesh,
                             in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def solve_batch_sharded(cfg: sqp.SolverConfig, params: sqp.OcpParams,
                        state: sqp.SqpState, mesh: Mesh) -> sqp.Solution:
    """Batched solve with lanes sharded over the mesh's dp axis.

    Lane count must divide by the dp axis size.  Per-lane status survives:
    no global abort on infeasible lanes (cf. reference ``optimizer.py:330``).

    Engine composition: without stage-axis sharding the solve dispatches
    through the SAME engine selection as ``closed_loop_batch_vec`` via
    shard_map over lane tiles; with ``cfg.stage_axis`` set the GSPMD path
    partitions the solver's stage blocks instead (the two are
    alternatives).
    """
    from mpc_tpu.planner.closed_loop import select_engine

    params = mesh_mod.shard_lanes(params, mesh)
    state = mesh_mod.shard_lanes(state, mesh)
    engine = (None if cfg.stage_axis is not None
              else select_engine(cfg))
    if engine is None:
        return _solve_sharded(cfg, params, state, mesh=mesh)
    return _engine_sharded(engine, cfg, (params, state), mesh)


def closed_loop_batch_sharded(lcfg: cl.LoopConfig, params: cl.LoopParams,
                              mesh: Mesh) -> cl.LoopResult:
    """Batch of full closed-loop rollouts, lanes sharded over dp.

    Without stage-axis sharding, each device runs the full batched closed
    loop (``closed_loop_batch_vec``) on its lane shard via shard_map.
    When ``lcfg.solver.stage_axis`` names a second mesh axis (e.g. 'sp'),
    the GSPMD path is used instead: the solver's Riccati stage blocks shard
    over it (horizon/stage parallelism) — the
    jit runs inside the mesh context so the solver-internal
    ``PartitionSpec`` constraints resolve.
    """
    params = mesh_mod.shard_lanes(params, mesh)
    if lcfg.solver.stage_axis is None:
        return _engine_sharded(cl.closed_loop_batch_vec, lcfg, (params,),
                               mesh)
    f = jax.vmap(lambda p: cl.run_closed_loop(lcfg, p))
    lane = NamedSharding(mesh, P("dp"))
    with mesh:  # resolve solver-internal stage_axis PartitionSpecs
        out_sh = jax.tree.map(lambda _: lane, jax.eval_shape(f, params))
        return jax.jit(f, out_shardings=out_sh)(params)


def summarize(solution: sqp.Solution, mesh: Mesh) -> BatchSummary:
    """Mesh-wide reduction of solver diagnostics via psum/pmax collectives.

    This is the (tiny) cross-lane communication path: a few scalars per
    call cross the devices.
    """
    spec = P("dp")

    def reduce_fn(status, viol, cost):
        conv = jnp.sum((status == 1).astype(jnp.int32))
        infeas = jnp.sum((status < 0).astype(jnp.int32))
        n = status.shape[0]
        return (
            jax.lax.psum(conv, "dp"),
            jax.lax.psum(infeas, "dp"),
            jax.lax.pmax(jnp.max(viol), "dp"),
            jax.lax.psum(jnp.sum(cost), "dp")
            / jax.lax.psum(jnp.asarray(n, cost.dtype), "dp"),
        )

    f = shard_map(reduce_fn, mesh=mesh,
                  in_specs=(spec, spec, spec),
                  out_specs=(P(), P(), P(), P()))
    conv, infeas, mviol, mcost = f(solution.status, solution.viol,
                                   solution.cost)
    return BatchSummary(n_converged=conv, n_infeasible=infeas,
                        max_viol=mviol, mean_cost=mcost)


def summarize_loop(result: cl.LoopResult, mesh: Mesh) -> BatchSummary:
    """Mesh-wide reduction of a batched closed-loop run's diagnostics.

    Counts converged/infeasible (lane, step) solves over all T steps of all
    lanes via shard_map collectives on the 'dp' axis (same communication
    pattern as :func:`summarize`, but for LoopResult's (B, T) fields).
    """
    spec = P("dp")

    def reduce_fn(status, viol, cost):
        conv = jnp.sum((status == 1).astype(jnp.int32))
        infeas = jnp.sum((status < 0).astype(jnp.int32))
        n = status.size
        return (
            jax.lax.psum(conv, "dp"),
            jax.lax.psum(infeas, "dp"),
            jax.lax.pmax(jnp.max(viol), "dp"),
            jax.lax.psum(jnp.sum(cost), "dp")
            / jax.lax.psum(jnp.asarray(n, cost.dtype), "dp"),
        )

    f = shard_map(reduce_fn, mesh=mesh,
                  in_specs=(spec, spec, spec),
                  out_specs=(P(), P(), P(), P()))
    conv, infeas, mviol, mcost = f(result.status, result.viol, result.cost)
    return BatchSummary(n_converged=conv, n_infeasible=infeas,
                        max_viol=mviol, mean_cost=mcost)


def replicate_ocp(params: sqp.OcpParams, n: int) -> sqp.OcpParams:
    """Tile a single-lane OcpParams to n lanes (benchmark/perturbation fan)."""
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), params)


def perturb_x0(params: sqp.OcpParams, key: jax.Array,
               scale: jax.Array | float) -> sqp.OcpParams:
    """Perturb each lane's initial state (pod-scale scenario fan-out)."""
    noise = scale * jax.random.normal(key, params.x0.shape,
                                      dtype=params.x0.dtype)
    return params._replace(x0=params.x0 + noise)
