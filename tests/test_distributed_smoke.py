"""2-process jax.distributed smoke test (VERDICT r2 #10): exercises
``parallel.mesh.initialize_distributed`` for real — coordinator bring-up,
global device visibility, a cross-process collective, and a multi-process
sharded solve whose telemetry matches the single-device solver.

Each worker is a real OS process with ONE local CPU device; the 1D block
mesh spans both processes, so every halo ppermute in the solve crosses the
process boundary (the path a multi-host mesh takes, modulo transport)."""

import os
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ.pop("XLA_FLAGS", None)  # exactly one local CPU device
import jax
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, {repo!r})
from levelsetfusion_tpu.parallel.mesh import initialize_distributed, make_mesh

pid = int(sys.argv[1])
initialize_distributed("127.0.0.1:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 2, jax.device_count()
assert jax.local_device_count() == 1

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

mesh = make_mesh()
sharding = NamedSharding(mesh, P("x"))

# Cross-process collective: global sum of per-process constants.
local = np.full((4, 4), float(pid + 1), np.float32)
garr = jax.make_array_from_process_local_data(sharding, local, (8, 4))
total = float(jax.jit(jnp.sum)(garr))
assert total == 16.0 + 32.0, total

# Multi-process sharded solve: mesh spans both processes, halos cross the
# process boundary. Telemetry outputs are replicated => addressable.
from levelsetfusion_tpu.models.params import SolverParams
from levelsetfusion_tpu.models.single_level import solve_single_level
from levelsetfusion_tpu.parallel.sharded import solve_single_level_sharded

rng = np.random.default_rng(3)
shape = (8, 8, 8)
canon_np = rng.uniform(-1, 1, shape).astype(np.float32)
live_np = rng.uniform(-1, 1, shape).astype(np.float32)
params = SolverParams(max_iterations=5, convergence_threshold=0.0,
                      learning_rate=0.2, sobolev_smoothing=True)

rows = shape[0] // 2
canon = jax.make_array_from_process_local_data(
    sharding, canon_np[pid * rows:(pid + 1) * rows], shape)
live = jax.make_array_from_process_local_data(
    sharding, live_np[pid * rows:(pid + 1) * rows], shape)
res = solve_single_level_sharded(canon, live, params, mesh=mesh, live_halo=4)
ref = solve_single_level(jnp.asarray(canon_np), jnp.asarray(live_np), params)
for f in res.telemetry._fields:
    a = np.asarray(getattr(res.telemetry, f))
    b = np.asarray(getattr(ref.telemetry, f))
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=f)
np.testing.assert_allclose(
    np.asarray(res.max_abs_displacement),
    np.asarray(ref.max_abs_displacement), atol=1e-6)
print("DIST_OK", pid, flush=True)
"""


def test_two_process_distributed_solve(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = 29517
    script = _WORKER.replace("{repo!r}", repr(repo)).replace(
        "{port}", str(port)
    )
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for pid in range(2):
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", script, str(pid)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if "DistributedRuntimeClient" in out and p.returncode != 0:
            pytest.skip(f"distributed service unavailable here: {out[-400:]}")
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"DIST_OK {pid}" in out
