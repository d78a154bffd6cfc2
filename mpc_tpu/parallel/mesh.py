"""Device mesh construction and sharding helpers.

The reference has NO parallelism (SURVEY.md §2.3: single process, single
core).  This module is new capability: NMPC lanes (scenario x perturbation
instances) scale across the GPUs of a host via ``jax.sharding``.

Axis conventions for this framework (the NMPC analog of transformer
dp/tp/pp/sp/ep):
  * ``dp``   — lane/batch axis: thousands of independent solves, the dominant
               axis (embarrassingly parallel; BASELINE.json north star).
  * ``sp``   — horizon/stage axis: stagewise linearization + constraint
               assembly are per-stage independent; the Riccati recursion is
               parallelized with an associative scan (``ops.pscan``).
  * tensor/pipeline/expert parallelism have no analog here: the per-stage
    state is 5-dimensional — there is no weight matrix to shard, no layer
    pipeline, no experts.  Documented divergence, not a gap.

Multi-host: ``init_distributed`` wraps ``jax.distributed.initialize``; lanes
shard across (hosts x chips) so heavy data stays lane-local and only scalar
diagnostics cross hosts (psum/pmax over DCN), per SURVEY.md §5.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (no-op when single-process).

    Reads the standard env (``JAX_COORDINATOR_ADDRESS`` etc.) when arguments
    are omitted; safe to call unconditionally at program start.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator
        or os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=num_processes,
        process_id=process_id
        if process_id is not None else int(os.environ["JAX_PROCESS_ID"]))


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices=None) -> Mesh:
    """Create a ('dp', 'sp') mesh.

    shape: (dp, sp); defaults to all devices on the dp axis.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    dp, sp = shape
    if dp * sp != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    dev_array = np.asarray(devices).reshape(dp, sp)
    return Mesh(dev_array, axis_names=("dp", "sp"))


def lane_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays with a leading lane axis (replicate the rest)."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_lanes(pytree, mesh: Mesh):
    """Device-put every leaf with its leading (lane) axis sharded over dp."""
    sh = lane_sharding(mesh)

    def put(x):
        spec = P("dp", *([None] * (x.ndim - 1))) if x.ndim > 0 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, pytree)
