"""Real multi-process ``jax.distributed`` smoke test (SURVEY §4d).

``parallel.mesh.init_distributed`` is a parallel code path no other test
executes.  This test spawns TWO actual CPU
processes that form a jax.distributed cluster over localhost, run a lane-
sharded batched solve on the global (2-process x 4-device) mesh, and
write their local shards; the parent compares the gathered result against
a single-process reference solve.

Skips (with reason) only if the sandbox forbids localhost sockets.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


WORKER_SRC = r"""
import os, sys, json
sys.path.insert(0, os.environ["MPC_REPO"])
import numpy as np
import jax

from mpc_tpu.parallel import mesh as pm
from mpc_tpu.parallel import batch as pb
from mpc_tpu.ops import sqp
import jax.numpy as jnp

pid = int(os.environ["JAX_PROCESS_ID"])
pm.init_distributed(os.environ["JAX_COORDINATOR_ADDRESS"], 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

H, B = 8, 16
cfg = sqp.SolverConfig(horizon=H, sqp_iters=2, al_iters=2)

xs = 10.0 + 15.0 * 0.1 * np.arange(H + 1)
x_ref = jnp.asarray(np.stack([xs, 0 * xs, 0 * xs,
                              np.full(H + 1, 15.0), 0 * xs], 1), jnp.float32)
base = sqp.OcpParams(
    x0=jnp.asarray([10.0, 0.3, 0.0, 14.0, 0.02], jnp.float32),
    x_ref=x_ref,
    obs_centers=jnp.asarray([[14.0, -1.8]] * 3, jnp.float32),
    min_dist=jnp.asarray(1.5, jnp.float32),
    weights=__import__("mpc_tpu.models.costs", fromlist=["Weights"])
    .Weights.from_dict({
        "weight_x": 2.3, "weight_y": 2.3, "weight_steering_angle": 500.0,
        "weight_velocity": 0.1, "weight_heading_angle": 160.0,
        "weight_velocity_steering_angle": 0.8,
        "weight_long_acceleration": 0.8,
        "weight_x_terminate": 80.0, "weight_y_terminate": 80.0,
        "weight_steering_angle_terminate": 100.0,
        "weight_velocity_terminate": 0.01,
        "weight_heading_angle_terminate": 110.0}, jnp.float32))
params = pb.replicate_ocp(base, B)
params = pb.perturb_x0(params, jax.random.PRNGKey(7),
                       jnp.asarray([0.4, 0.15, 0.0, 0.4, 0.02], jnp.float32))
state = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape),
                     sqp.init_state(cfg))

mesh = pm.make_mesh((8, 1))  # global mesh spanning both processes
sol = pb.solve_batch_sharded(cfg, params, state, mesh)
summ = pb.summarize(sol, mesh)

# gather the globally-sharded U to every host for the parity check
from jax.experimental import multihost_utils
U_global = multihost_utils.process_allgather(sol.U, tiled=True)
out = {"U": np.asarray(U_global).tolist(),
       "n_infeasible": int(summ.n_infeasible),
       "max_viol": float(summ.max_viol)}
if pid == 0:
    with open(os.environ["MPC_OUT"], "w") as f:
        json.dump(out, f)
print("worker", pid, "done", flush=True)
"""


def test_two_process_distributed_solve_matches_single():
    try:
        port = _free_port()
    except OSError as e:  # pragma: no cover
        pytest.skip(f"sandbox forbids sockets: {e}")

    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(WORKER_SRC)
        out_file = os.path.join(td, "out.json")
        env_base = {
            **os.environ,
            "MPC_REPO": REPO,
            "MPC_OUT": out_file,
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        }
        procs = []
        for pid in range(2):
            env = {**env_base, "JAX_PROCESS_ID": str(pid)}
            procs.append(subprocess.Popen(
                [sys.executable, script], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=720)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("distributed workers timed out")
            outs.append(out.decode())
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        with open(out_file) as f:
            got = json.load(f)
        assert got["n_infeasible"] == 0
        assert got["max_viol"] < 0.05

        # single-process reference (same problem, local 8-device mesh)
        ref_env = {**os.environ, "JAX_PLATFORMS": "cpu",
                   "MPC_REPO": REPO, "MPC_OUT": os.path.join(td, "ref.json"),
                   "JAX_PROCESS_ID": "0",
                   "JAX_COORDINATOR_ADDRESS": "",
                   "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
        ref_src = WORKER_SRC.replace(
            'pm.init_distributed(os.environ["JAX_COORDINATOR_ADDRESS"], 2, '
            'pid)', "pass").replace(
            "assert jax.process_count() == 2, jax.process_count()", "")
        ref_script = os.path.join(td, "ref.py")
        with open(ref_script, "w") as f:
            f.write(ref_src)
        r = subprocess.run([sys.executable, ref_script], env=ref_env,
                           capture_output=True, timeout=720)
        assert r.returncode == 0, r.stdout.decode()[-3000:] + \
            r.stderr.decode()[-3000:]
        with open(os.path.join(td, "ref.json")) as f:
            ref = json.load(f)
        np.testing.assert_allclose(np.asarray(got["U"]),
                                   np.asarray(ref["U"]),
                                   rtol=1e-4, atol=1e-4)
