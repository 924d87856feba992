"""BASELINE config 5 at its mandated scale (512³+): acceptance runs.

Modes (the per-commit test suite covers the same machinery at small
shapes; this script is the full-scale demonstration, ~20 min on CPU):

  --cpu-mesh      512³ volume sharded over 8 virtual CPU devices, reduced
                  iterations, warp parity vs the single-device solver.
  --schur-table   Schur vs sync at matched termination.

Results are recorded in BASELINE.md's measured table.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sphere_pair(shape, offset=0.01):
    import numpy as np
    import jax.numpy as jnp

    x = np.linspace(-1, 1, shape[0], dtype=np.float32)[:, None, None]
    y = np.linspace(-1, 1, shape[1], dtype=np.float32)[None, :, None]
    z = np.linspace(-1, 1, shape[2], dtype=np.float32)[None, None, :]
    r = np.sqrt(x * x + y * y + z * z)
    canonical = jnp.asarray(np.clip((r - 0.5) * 8.0, -1, 1))
    r2 = np.sqrt((x - offset) ** 2 + y * y + z * z)
    live = jnp.asarray(np.clip((r2 - 0.5) * 8.0, -1, 1))
    return canonical, live


def cpu_mesh(schur: bool = False, n_iter: int = 10):
    """512³ over 8 virtual CPU devices, FULL energy (Killing + level-set +
    Sobolev), ≥10 iterations (VERDICT r2 #5: 1 iteration does not exercise
    the iterated halo/termination machinery). ``--schur`` additionally runs
    the Schur-style solver on the same problem and records its gap to the
    synchronous fixed point + wall-clock."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from levelsetfusion_tpu.models.params import SmoothingMode, SolverParams
    from levelsetfusion_tpu.models.single_level import solve_single_level
    from levelsetfusion_tpu.parallel.sharded import solve_single_level_sharded

    shape = (512, 512, 512)
    canonical, live = _sphere_pair(shape)
    params = SolverParams(
        max_iterations=n_iter, learning_rate=0.3,
        smoothing_term_weight=0.1, smoothing_mode=SmoothingMode.KILLING,
        level_set_term_weight=0.1, sobolev_smoothing=True,
        convergence_threshold=0.0,
    )

    mesh = Mesh(np.array(jax.devices()), ("x",))
    sh = NamedSharding(mesh, P("x"))
    t0 = time.time()
    res = solve_single_level_sharded(
        jax.device_put(canonical, sh), jax.device_put(live, sh),
        params, mesh=mesh, live_halo=8,
    )
    jax.block_until_ready(res.warp)
    t_sharded = time.time() - t0

    t0 = time.time()
    ref = solve_single_level(canonical, live, params)
    jax.block_until_ready(ref.warp)
    t_single = time.time() - t0

    n = int(res.iterations)
    err = float(np.max(np.abs(np.asarray(res.warp) - np.asarray(ref.warp))))
    tel_err = max(
        float(np.max(np.abs(
            np.asarray(getattr(res.telemetry, f))[:n]
            - np.asarray(getattr(ref.telemetry, f))[:n]
        )))
        for f in res.telemetry._fields
    )
    out = {
        "mode": "cpu_mesh_512_full_energy",
        "shape": shape,
        "devices": 8,
        "iterations": n,
        "warp_parity_max_abs_err": err,
        "telemetry_parity_max_abs_err": tel_err,
        "max_abs_displacement": [float(v) for v in
                                 np.asarray(res.max_abs_displacement)],
        "sharded_seconds": t_sharded,
        "single_seconds": t_single,
        "energies_last": [float(res.telemetry.data_energy[n - 1]),
                          float(res.telemetry.smoothing_energy[n - 1]),
                          float(res.telemetry.level_set_energy[n - 1])],
    }
    print(json.dumps(out))
    # Tolerance note: at 1 iteration the paths are bit-exact (round 2).
    # Over ≥10 iterations they drift by f32 COORDINATE ulp: the
    # single-device resample forms global positions up to 512
    # (ulp ≈ 6.1e-5) while shards use block-local positions (up to
    # n_local + 2·halo), so the two roundings of x+u differ in the last
    # bits and the nonlinear iteration amplifies it. Telemetry agrees to
    # ~3e-6 relative (reduction-order noise), confirming there is no
    # algorithmic divergence. Measured drift at 10 iterations: 2.8e-4.
    assert err < 1e-3, err

    if schur:
        from levelsetfusion_tpu.parallel.schur import solve_single_level_schur

        t0 = time.time()
        sres = solve_single_level_schur(
            jax.device_put(canonical, sh), jax.device_put(live, sh),
            params.replace(max_iterations=max(n_iter, 16)),
            mesh=mesh, live_halo=8, inner_iterations=8,
        )
        jax.block_until_ready(sres.warp)
        t_schur = time.time() - t0
        gap = float(np.max(np.abs(np.asarray(sres.warp) - np.asarray(ref.warp))))
        out2 = {
            "mode": "cpu_mesh_512_schur",
            "outer_steps": int(sres.outer_steps),
            "inner_per_outer": int(sres.inner_per_outer),
            "collective_rounds_per_outer": 3,
            "schur_seconds": t_schur,
            "warp_gap_to_sync_fixed_point": gap,
        }
        print(json.dumps(out2))


def schur_table(shape=(512, 512, 512), budget=32):
    """Sync vs Schur(T=4,8,16) at MATCHED TERMINATION on the same 512³
    problem (VERDICT r3 weak #6): run the synchronous solver for a fixed
    ``budget`` of iterations, take its achieved final max-warp-update as
    the quality gate τ*, then run each Schur variant with
    convergence_threshold = τ* (so every solver stops at the same measured
    quality) and record iterations, collective rounds, wall-clock, and the
    final warp gap to the sync result. Collective-round counts come from
    the statically verified inventory in parallel/scaling.py
    (tests/test_scaling.py checks them against the loop-body jaxprs).

    CPU-mesh wall-clock is a proxy (collectives are shared-memory copies,
    ~free, which UNDERSTATES Schur's advantage on a real interconnect); the
    rounds column is hardware-independent.
    """
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        # The 2-CPU container oversubscribes 8 virtual devices 4x; at the
        # full 512^3 a starved device thread can trail a collective by
        # minutes, and XLA-CPU's default 40 s rendezvous termination
        # timeout kills the process (measured round 5). These are test
        # harness settings, not production knobs.
        + " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
        + " --xla_cpu_collective_call_terminate_timeout_seconds=3600"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from levelsetfusion_tpu.models.params import SmoothingMode, SolverParams
    from levelsetfusion_tpu.parallel.sharded import solve_single_level_sharded
    from levelsetfusion_tpu.parallel.schur import solve_single_level_schur

    canonical, live = _sphere_pair(shape)
    base = SolverParams(
        max_iterations=budget, learning_rate=0.3,
        smoothing_term_weight=0.1, smoothing_mode=SmoothingMode.KILLING,
        level_set_term_weight=0.1, sobolev_smoothing=True,
        convergence_threshold=0.0,
    )
    mesh = Mesh(np.array(jax.devices()), ("x",))
    sh = NamedSharding(mesh, P("x"))
    c_sh = jax.device_put(canonical, sh)
    l_sh = jax.device_put(live, sh)

    t0 = time.time()
    sync_res = solve_single_level_sharded(
        c_sh, l_sh, base, mesh=mesh, live_halo=8
    )
    jax.block_until_ready(sync_res.warp)
    t_sync = time.time() - t0
    n_sync = int(sync_res.iterations)
    tau = float(sync_res.telemetry.max_warp_update[n_sync - 1])
    sync_warp = np.asarray(sync_res.warp)

    rows = [{
        "solver": "sync",
        "iterations": n_sync,
        "ppermute_rounds": 2 * n_sync,  # warp halo + Sobolev gradient halo
        "reduction_rounds": n_sync,
        "wall_s": round(t_sync, 1),
        "final_max_warp_update": tau,
        "warp_gap_to_sync": 0.0,
    }]
    for t_inner in (4, 8, 16):
        p = base.replace(
            convergence_threshold=tau, max_iterations=2 * budget
        )
        t0 = time.time()
        sres = solve_single_level_schur(
            c_sh, l_sh, p, mesh=mesh, live_halo=8,
            inner_iterations=t_inner,
        )
        jax.block_until_ready(sres.warp)
        wall = time.time() - t0
        outers = int(sres.outer_steps)
        rows.append({
            "solver": f"schur_T{t_inner}",
            "iterations": outers * t_inner,
            "outer_steps": outers,
            "ppermute_rounds": 2 * outers,  # warp halo + interface dirs
            "reduction_rounds": outers,
            "wall_s": round(wall, 1),
            "final_max_warp_update": float(
                sres.telemetry.max_warp_update[max(outers - 1, 0)]
            ),
            "warp_gap_to_sync": float(
                np.max(np.abs(np.asarray(sres.warp) - sync_warp))
            ),
        })
    print(json.dumps({
        "mode": "schur_vs_sync_matched_termination",
        "shape": list(shape),
        "devices": 8,
        "quality_gate_tau": tau,
        "rows": rows,
    }))


if __name__ == "__main__":
    if "--cpu-mesh" in sys.argv:
        cpu_mesh(schur="--schur" in sys.argv)
    elif "--schur-table" in sys.argv:
        # The container exposes 2 host CPUs; the 8-virtual-device 512³ mesh
        # is 4× oversubscribed and a full matched-termination table at 512³
        # exceeds the round's CPU budget (measured: >40 min for the sync
        # leg alone). --mid runs the same table at (128, 512, 512) — the
        # production y/z extents at 1/8 the volume.
        shape = (512, 512, 512)
        if "--small" in sys.argv:
            shape = (128, 128, 128)
        elif "--mid" in sys.argv:
            shape = (128, 512, 512)
        budget = 32
        if "--budget" in sys.argv:
            budget = int(sys.argv[sys.argv.index("--budget") + 1])
        schur_table(shape=shape, budget=budget)
    else:
        print(
            "usage: config5_512_acceptance.py"
            " [--cpu-mesh [--schur] | --schur-table [--small | --mid]]"
        )
