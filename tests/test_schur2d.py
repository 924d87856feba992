"""Schur-outer × sync-inner 2D composition (parallel/schur2d): fixed-point
parity with the synchronous 2D solver at matched termination, and the
slow-axis collective-round reduction the composition exists for."""

import re

import numpy as np
import jax
import jax.numpy as jnp

from levelsetfusion_tpu.models.params import SolverParams
from levelsetfusion_tpu.models.single_level import solve_single_level
from levelsetfusion_tpu.parallel.mesh import make_mesh_2d
from levelsetfusion_tpu.parallel.schur2d import solve_single_level_schur2d
from levelsetfusion_tpu.parallel.sharded2d import solve_single_level_sharded2d


def _sphere(shape, center, radius=4.0, band=3.0):
    axes = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in shape],
                       indexing="ij")
    dist = np.sqrt(sum((ax - c) ** 2 for ax, c in zip(axes, center)))
    return jnp.asarray(np.clip((dist - radius) / band, -1.0, 1.0))


def _fields(shape=(16, 16, 16)):
    c = [s / 2.0 for s in shape]
    canonical = _sphere(shape, c)
    live = _sphere(shape, [c[0] + 0.6, c[1] + 0.4, c[2]])
    return canonical, live


PARAMS = SolverParams(
    learning_rate=0.3,
    max_iterations=4000,
    convergence_threshold=5e-4,
    smoothing_term_weight=0.2,
    sobolev_smoothing=True,
)


def test_schur2d_reaches_sync2d_fixed_point():
    """The composition converges to the synchronous solvers' stationary
    point: the warp gap to the single-device solve shrinks with the
    termination threshold, and the endpoint is stationary under the
    synchronous dynamics."""
    canonical, live = _fields()
    mesh = make_mesh_2d((2, 2))
    errs = {}
    for thr in (5e-4, 1e-4):
        p = PARAMS.replace(convergence_threshold=thr)
        ref = solve_single_level(canonical, live, p)
        got = solve_single_level_schur2d(
            canonical, live, p, mesh=mesh, inner_iterations=8
        )
        assert bool(ref.converged) and bool(got.converged)
        errs[thr] = float(jnp.max(jnp.abs(got.warp - ref.warp)))
    scale = float(jnp.max(jnp.abs(ref.warp)))
    assert errs[1e-4] < 0.5 * errs[5e-4], errs
    assert errs[1e-4] < 0.02 * scale, (errs, scale)
    # Stationarity probe under the synchronous dynamics.
    probe = solve_single_level(
        canonical, live,
        PARAMS.replace(max_iterations=3, convergence_threshold=3e-4),
        initial_warp=got.warp,
    )
    assert int(probe.iterations) == 1
    assert float(probe.telemetry.max_warp_update[0]) < 3e-4


def test_schur2d_matches_sync2d_at_matched_termination():
    """Same quality gate, both solvers: the sync-2D solve runs to a
    threshold and the schur2d solve to the same threshold — the two
    converged warps agree to the termination tail."""
    canonical, live = _fields()
    mesh = make_mesh_2d((2, 2))
    p = PARAMS.replace(convergence_threshold=2e-4)
    sync = solve_single_level_sharded2d(
        canonical, live, p, mesh=mesh, live_halo=8
    )
    schur = solve_single_level_schur2d(
        canonical, live, p, mesh=mesh, inner_iterations=8
    )
    assert bool(sync.converged) and bool(schur.converged)
    gap = float(jnp.max(jnp.abs(schur.warp - sync.warp)))
    scale = float(jnp.max(jnp.abs(sync.warp)))
    assert gap < 0.05 * scale, (gap, scale)


def test_schur2d_amortizes_slow_axis_rounds():
    """Executed slow-axis ('x') collective primitives — (primitives in the
    repeated loop body) × (steps taken) — drop several-fold vs the sync 2D
    solver at the SAME convergence gate, while fast-axis ('y') exchanges
    stay per inner iteration. That is the composition: Schur along mesh
    axis 0, sync along axis 1."""
    canonical, live = _fields()
    mesh = make_mesh_2d((2, 2))
    t = 8

    def axis_counts(fn, **kw):
        text = str(
            jax.make_jaxpr(lambda c, l: fn(c, l, PARAMS, mesh=mesh, **kw))(
                canonical, live
            )
        )
        # ppermute carries its mesh axis in the jaxpr params; 2 of the x /
        # y primitives are the once-per-solve live halo (subtracted).
        return {
            "x": len(re.findall(r"ppermute\[[^\]]*axis_name=\('x',\)", text))
            - 2,
            "y": len(re.findall(r"ppermute\[[^\]]*axis_name=\('y',\)", text))
            - 2,
        }

    sync_c = axis_counts(solve_single_level_sharded2d, live_halo=8)
    schur_c = axis_counts(
        solve_single_level_schur2d, inner_iterations=t, live_halo=8
    )
    sync = solve_single_level_sharded2d(
        canonical, live, PARAMS, mesh=mesh, live_halo=8
    )
    schur = solve_single_level_schur2d(
        canonical, live, PARAMS, mesh=mesh, inner_iterations=t, live_halo=8
    )
    assert bool(sync.converged) and bool(schur.converged)
    n_sync = int(sync.iterations)
    n_outer = int(schur.outer_steps)
    # Slow-axis primitives actually executed to reach the same gate: the
    # sync body repeats per iteration, the schur2d body per OUTER step.
    sync_x_total = sync_c["x"] * n_sync
    schur_x_total = schur_c["x"] * n_outer
    assert schur_x_total < sync_x_total / 4, (
        sync_c, n_sync, schur_c, n_outer
    )
    # The fast axis still exchanges per inner iteration: the outer body's
    # y primitives sit INSIDE the fori inner loop, so they execute t times
    # per outer step — t× the slow axis's executed rounds.
    schur_y_total = schur_c["y"] * n_outer * t
    assert schur_y_total == schur_x_total * t, (schur_c, n_outer)


def test_schur2d_contract_observable():
    canonical, live = _fields()
    mesh = make_mesh_2d((2, 2))
    res = solve_single_level_schur2d(
        canonical, live, PARAMS.replace(max_iterations=16), mesh=mesh,
        inner_iterations=4,
    )
    md = np.asarray(res.max_abs_displacement)
    assert md.shape == (3,)
    assert np.isfinite(md).all() and (md >= 0).all()
