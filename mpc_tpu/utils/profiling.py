"""Profiling & tracing utilities.

The reference's only instrumentation is ``time.time()`` wall-clock pairs
around each solve (``MPC_Planner/optimizer.py:283, 360-362, 592-608``),
persisted as ``solve time.txt``.  Here:

  * :func:`trace` wraps ``jax.profiler`` for full XLA traces viewable in
    TensorBoard/Perfetto;
  * :func:`time_jitted` measures the steady-state time of a jitted
    callable: host clock around calls that end in ``block_until_ready``
    (JAX returns before the device finishes, so a timing without it
    measures the enqueue);
  * :func:`solve_time_series` reproduces the reference's per-step
    ``solve time.txt`` semantics from a wall-timed closed-loop run.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """XLA profiler trace context (TensorBoard/Perfetto format).

    Replaces the reference's wall-clock-only instrumentation with real
    per-kernel device timelines::

        with profiling.trace("/tmp/trace"):
            res = cl.closed_loop_batch_vec(lcfg, params)
            jax.block_until_ready(res)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_jitted(fn: Callable, *args, reps: int = 10,
                warmup: int = 1) -> float:
    """Steady-state seconds per call of ``jax.jit(fn)(*args)``.

    Calls are issued back to back and the last result is waited for with
    ``jax.block_until_ready``, so the figure is the device-bound
    throughput of the call (no host transfer of the outputs).
    """
    f = jax.jit(fn)
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(f(*args))  # compile + settle
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def solve_time_series(total_wall_s: float, n_steps: int) -> np.ndarray:
    """Per-step solve-time array in the reference's ``solve time.txt``
    format (one float per closed-loop step, seconds).

    The on-device ``lax.scan`` loop has no per-step host timestamps; the
    honest equivalent is the amortized per-step time, constant across the
    series (the reference's series varies because each step pays Python +
    solver-rebuild overhead we don't have, ``optimizer.py:603-608``).
    """
    return np.full(int(n_steps), float(total_wall_s) / max(int(n_steps), 1))


def breakdown(named_fns: Sequence, reps: int = 10) -> dict:
    """Time a list of ``(name, fn, args)`` triples; returns {name: ms}."""
    out = {}
    for name, fn, args in named_fns:
        out[name] = 1e3 * time_jitted(fn, *args, reps=reps)
    return out
