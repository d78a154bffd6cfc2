"""Streaming online planner — the serving-style per-step API.

The reference's planners only run complete offline simulations (the plant
update is internal, ``optimizer.py:356, 623``).  For deployment the planner
must consume MEASURED states one at a time and return the next control
within a latency budget.  :class:`OnlinePlanner` wraps the warm-started
solver state behind exactly that interface; the underlying compiled step is
the same ``closed_loop_chunk`` program used by checkpoint/resume.

    planner = OnlinePlanner(config)
    u, info = planner.step(x_measured)   # one warm NMPC solve
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mpc_tpu.io.config import PlanningConfig
from mpc_tpu.models import dynamics as dyn_mod
from mpc_tpu.planner import closed_loop as cl


class StepInfo(NamedTuple):
    status: int        # 1 converged / 0 max-iters-or-gated / -7 infeasible.
                       # Under a gate_stages=g preset (e.g. RTI1_CA_SETTINGS)
                       # 0 certifies only the APPLIED PREFIX (stages 0..g) of
                       # the plan feasible, not the full horizon — `viol`
                       # stays the full-plan violation either way.
    viol: float        # max constraint violation of the planned horizon
    cost: float        # objective value
    planned_x: np.ndarray  # the state the solver planned from


class OnlinePlanner:
    """Warm-started receding-horizon planner over measured states.

    Unlike the offline loops, the plant is EXTERNAL: each call to
    :meth:`step` takes the latest measured state and returns the input to
    apply.  The internal loop carry (warm-start trajectory, AL multipliers,
    progress index, PRNG key) persists across calls, so each step is one
    warm real-time-iteration solve — the deployment pattern FORCESPRO's
    generated solver targets (``maxqps=1``, reference ``optimizer.py:237``).
    """

    def __init__(self, config: PlanningConfig,
                 horizon: Optional[int] = None, seed: int = 0,
                 **solver_overrides):
        self.config = config
        self.lcfg = cl.make_loop_config(config, horizon=horizon,
                                        noised=False, **solver_overrides)
        self.params = cl.make_loop_params(config, self.lcfg, seed=seed)
        self._carry = cl.init_carry(self.lcfg, self.params)

    def reset(self) -> None:
        self._carry = cl.init_carry(self.lcfg, self.params)

    def step(self, x_measured) -> Tuple[np.ndarray, StepInfo]:
        """One warm NMPC solve from the measured state.

        x_measured: (5,) KS state ``[x, y, delta, v, psi]`` (lifted
        automatically for the ST model).  Returns ``(u, info)`` with
        ``u = [deltaDot, aLong]`` to apply for the next ``delta_t``.
        """
        x = jnp.asarray(x_measured, self.params.x_init.dtype)
        if self.lcfg.solver.model == "st" and x.shape[-1] == dyn_mod.NX:
            x = dyn_mod.ks_to_st_state(x, self.lcfg.solver.wheelbase,
                                       self.lcfg.solver.vehicle.b)
        step_idx, _, state, key, base = self._carry
        carry = (step_idx, x, state, key, base)
        self._carry, res = cl.closed_loop_chunk(self.lcfg, self.params,
                                                carry, 1)
        u = np.asarray(res.U[0])
        info = StepInfo(status=int(res.status[0]),
                        viol=float(res.viol[0]),
                        cost=float(res.cost[0]),
                        planned_x=np.asarray(res.X[0]))
        return u, info


class BatchedOnlinePlanner:
    """Serve a FLEET of vehicles in lockstep: one warm NMPC solve per
    vehicle per call, batched on the device (``closed_loop.select_engine``).

    The single-stream :class:`OnlinePlanner` is the reference-parity
    deployment shape (one vehicle, one measured state); this is the
    batched serving shape — thousands of independent vehicles on the
    same roadway configuration solved as one compiled batch.  Lanes never
    poison each other: every lane carries its own warm state and per-lane
    status.

        fleet = BatchedOnlinePlanner(config, n_lanes=1024)
        U, info = fleet.step(X_measured)   # (1024, 5) -> (1024, 2)

    Per-lane heterogeneous scenarios (different tracks/obstacles) can be
    served by constructing ``LoopParams`` with ``parallel.multi`` and
    passing them via ``params=``.
    """

    def __init__(self, config: PlanningConfig, n_lanes: int | None = None,
                 horizon: Optional[int] = None, seed: int = 0,
                 params=None, **solver_overrides):
        self.config = config
        self.lane_lengths = None  # set by from_scenarios (heterogeneous)
        self.lcfg = cl.make_loop_config(config, horizon=horizon,
                                        noised=False, **solver_overrides)
        if params is None:
            if n_lanes is None:
                raise ValueError("need n_lanes (replicated scenario) or "
                                 "prebuilt batched params")
            one = cl.make_loop_params(config, self.lcfg, seed=seed)
            params = jax.tree.map(
                lambda x: jnp.broadcast_to(
                    jnp.asarray(x)[None],
                    (n_lanes,) + jnp.asarray(x).shape).copy(), one)
            import jax.random as jrandom
            params = params._replace(
                noise_key=jrandom.split(jrandom.PRNGKey(seed), n_lanes))
        self.params = params
        self.n_lanes = int(self.params.x_init.shape[0])
        self._carry = cl.init_batch_carry(self.lcfg, self.params)

    @classmethod
    def from_scenarios(cls, cfgs, horizon: Optional[int] = None,
                       seeds=None, **solver_overrides):
        """Heterogeneous fleet: one lane per PlanningConfig (different
        tracks/obstacles/boundaries served in one compiled batch, via
        ``parallel.multi.make_multi_scenario_batch``)."""
        from mpc_tpu.parallel import multi as pm

        lcfg, params, lane_lengths = pm.make_multi_scenario_batch(
            cfgs, horizon=horizon, noised=False, seeds=seeds,
            **solver_overrides)
        self = cls.__new__(cls)
        self.config = list(cfgs)
        self.lcfg = lcfg
        self.params = params
        self.lane_lengths = lane_lengths
        self.n_lanes = int(params.x_init.shape[0])
        self._carry = cl.init_batch_carry(lcfg, params)
        return self

    def reset(self) -> None:
        self._carry = cl.init_batch_carry(self.lcfg, self.params)

    def step(self, x_measured) -> Tuple[np.ndarray, "BatchStepInfo"]:
        """One warm batched solve from measured states (B, NX) ->
        applied inputs (B, 2) + per-lane diagnostics."""
        x = jnp.asarray(x_measured, self.params.x_init.dtype)
        if self.lcfg.solver.model == "st" and x.shape[-1] == dyn_mod.NX:
            x = jax.vmap(lambda xl: dyn_mod.ks_to_st_state(
                xl, self.lcfg.solver.wheelbase,
                self.lcfg.solver.vehicle.b))(x)
        self._carry, out = cl.closed_loop_batch_step(
            self.lcfg, self.params, self._carry, x)
        _, u_apply, status, viol, cost, stat = out
        info = BatchStepInfo(status=np.asarray(status),
                             viol=np.asarray(viol),
                             cost=np.asarray(cost))
        return np.asarray(u_apply), info


class BatchStepInfo(NamedTuple):
    status: np.ndarray   # (B,) 1 converged / 0 max-iters-or-gated /
                         # -7 infeasible.  With gate_stages=g presets, 0
                         # certifies the applied prefix (stages 0..g) only;
                         # `viol` stays the FULL-plan violation.
    viol: np.ndarray     # (B,) max planned-stage violation per lane
    cost: np.ndarray     # (B,) objective values
