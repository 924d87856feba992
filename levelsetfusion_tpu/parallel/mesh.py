"""Device mesh construction (SURVEY.md §5 distributed backend).

The TSDF volume is sharded by voxel blocks along spatial axis 0 over a 1D
mesh ("x"), or along axes 0 and 1 over a 2D mesh. Helpers here keep mesh
plumbing out of the solvers.
"""

from __future__ import annotations

from typing import Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices: int | None = None, axis_name: str = "x") -> Mesh:
    """1D mesh over the first ``num_devices`` devices (default: all)."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    import numpy as np

    return Mesh(np.array(devices), (axis_name,))


def make_mesh_2d(
    shape: Sequence[int], axis_names: Sequence[str] = ("x", "y")
) -> Mesh:
    """2D mesh for voxel-BLOCK (not slab) decomposition: spatial axes 0 and
    1 shard over the two mesh axes. ``shape=(s0, s1)`` uses the first
    ``s0*s1`` devices."""
    import numpy as np

    s0, s1 = shape
    devices = jax.devices()[: s0 * s1]
    if len(devices) < s0 * s1:
        raise ValueError(f"need {s0 * s1} devices, have {len(devices)}")
    return Mesh(np.array(devices).reshape(s0, s1), tuple(axis_names))


def block_sharding(mesh: Mesh, axis_name: str = "x") -> NamedSharding:
    """Sharding that splits spatial axis 0 into voxel blocks."""
    return NamedSharding(mesh, P(axis_name))


def shard_field(field, mesh: Mesh, axis_name: str = "x"):
    return jax.device_put(field, block_sharding(mesh, axis_name))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-process bring-up: ``jax.distributed.initialize`` so a mesh can
    span every process's devices. No-ops on a single process.

    Exercised by ``tests/test_distributed_smoke.py``: two real OS processes
    (one CPU device each) bring up the coordinator, form the global mesh,
    and run a sharded solve whose every halo exchange crosses the process
    boundary, matching single-device telemetry.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def solve_single_level_auto(
    canonical,
    live,
    params=None,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    initial_warp=None,
):
    """GSPMD auto-sharded solve (the pjit/scaling-book recipe, SURVEY.md §2
    parallelism table): run the *single-device* solver under jit with
    sharded inputs and let XLA's SPMD partitioner insert the collectives
    for the stencils and the warp-resample gather.

    This is the zero-new-math path — semantics are identical to
    ``models.single_level.solve_single_level`` by construction. The
    hand-rolled ``parallel.sharded`` solver exists because (a) BASELINE
    config 5 mandates explicit voxel-block halo exchange, and (b) explicit
    neighbor ``ppermute`` of 2–3 ghost rows beats the partitioner's general
    handling of the resample gather (which may all-gather the live volume).
    """
    from levelsetfusion_tpu.models.params import SolverParams
    from levelsetfusion_tpu.models.single_level import solve_single_level

    if params is None:
        params = SolverParams()
    sharding = NamedSharding(mesh, P(axis_name))
    canonical = jax.device_put(canonical, sharding)
    live = jax.device_put(live, sharding)
    if initial_warp is not None:
        initial_warp = jax.device_put(initial_warp, sharding)
    return solve_single_level(canonical, live, params, initial_warp=initial_warp)
