"""2D voxel-block sharding (axes 0 AND 1 over a 2D mesh) vs single-device
parity — the same culture as tests/test_parallel.py, one mesh dimension up."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from levelsetfusion_tpu.models import SolverParams, solve_single_level
from levelsetfusion_tpu.models.params import SmoothingMode
from levelsetfusion_tpu.parallel.mesh import make_mesh_2d
from levelsetfusion_tpu.parallel.sharded2d import solve_single_level_sharded2d


def _fields(shape=(16, 16, 12)):
    """Smooth sphere-SDF pair with a sub-voxel offset (displacements stay
    well inside the live-halo contract at every iteration)."""
    from tests.test_schur import _sphere

    c = [s / 2.0 for s in shape]
    canonical = _sphere(shape, c)
    live = _sphere(shape, [c[0] + 0.6, c[1] + 0.4, c[2]])
    return canonical, live


def _parity(params, mesh_shape=(2, 4), live_halo=8, shape=(16, 16, 12)):
    canonical, live = _fields(shape)
    mesh = make_mesh_2d(mesh_shape)
    ref = solve_single_level(canonical, live, params)
    sh = solve_single_level_sharded2d(
        canonical, live, params, mesh=mesh, live_halo=live_halo
    )
    assert int(sh.iterations) == int(ref.iterations)
    np.testing.assert_allclose(
        np.asarray(sh.warp), np.asarray(ref.warp), atol=2e-5, rtol=1e-4
    )
    n = int(ref.iterations)
    for name in ("data_energy", "smoothing_energy", "level_set_energy",
                 "max_warp_update", "mean_warp_update"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh.telemetry, name))[:n],
            np.asarray(getattr(ref.telemetry, name))[:n],
            atol=1e-4, rtol=2e-4, err_msg=name,
        )


def test_parity_tikhonov_2x4():
    _parity(SolverParams(max_iterations=20, learning_rate=0.3))


def test_parity_sobolev_2x4():
    _parity(
        SolverParams(
            max_iterations=15, learning_rate=0.3, sobolev_smoothing=True
        )
    )


def test_parity_killing_levelset_2x4():
    _parity(
        SolverParams(
            max_iterations=15,
            learning_rate=0.3,
            smoothing_mode=SmoothingMode.KILLING,
            level_set_term_weight=0.1,
            sobolev_smoothing=True,
            adaptive_learning_rate=True,
        )
    )


def test_parity_4x2_uneven_blocks():
    _parity(
        SolverParams(max_iterations=10, learning_rate=0.3,
                     sobolev_smoothing=True),
        mesh_shape=(4, 2),
        shape=(16, 8, 12),
    )


def test_gspmd_2d_mesh_matches_single_device():
    """The GSPMD auto path on a 2D mesh (VERDICT: earn or fold)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    canonical, live = _fields()
    params = SolverParams(max_iterations=10, learning_rate=0.3,
                          sobolev_smoothing=True)
    ref = solve_single_level(canonical, live, params)
    mesh = make_mesh_2d((2, 4))
    sharding = NamedSharding(mesh, P("x", "y"))
    auto = solve_single_level(
        jax.device_put(canonical, sharding),
        jax.device_put(live, sharding),
        params,
    )
    assert int(auto.iterations) == int(ref.iterations)
    np.testing.assert_allclose(
        np.asarray(auto.warp), np.asarray(ref.warp), atol=1e-5
    )
    assert len(auto.warp.sharding.device_set) == 8


def test_cli_sharded_mode_2d_mesh(tmp_path):
    """The sharded CLI mode on a 2D voxel-block mesh (config-5 preset
    machinery at test scale)."""
    import dataclasses

    from levelsetfusion_tpu.cli import run_experiment
    from levelsetfusion_tpu.utils.config import PRESETS, ExperimentConfig

    base = PRESETS["config5_sharded"]
    cfg = dataclasses.replace(
        base,
        name="c5_2dmesh",
        grid_shape=(16, 16, 16),
        grid_offset=(-8, -8, 38),
        mesh_shape=(2, 4),
        live_halo=4,
        solver=base.solver.replace(max_iterations=6),
    )
    # JSON round-trip keeps the mesh shape.
    assert ExperimentConfig.from_json(cfg.to_json()) == cfg
    s = run_experiment(cfg, str(tmp_path / "run"))
    assert s["devices"] == 8
    assert s["iterations"] == 6
    assert s["residual_reduction"] > 0


def test_parity_pallas_resample_2x2_interpret():
    """2D-mesh solver on (16, 16, 128) with Sobolev vs the single-device
    solver."""
    params = SolverParams(
        max_iterations=10, learning_rate=0.3, sobolev_smoothing=True,
    )
    _parity(params, mesh_shape=(2, 2), shape=(16, 16, 128))


def test_parity_pallas_resample_killing_levelset_2x2_interpret():
    params = SolverParams(
        max_iterations=8, learning_rate=0.3,
        smoothing_mode=SmoothingMode.KILLING, level_set_term_weight=0.1,
    )
    _parity(params, mesh_shape=(2, 2), shape=(16, 16, 128))


def test_parity_fused_gradient_2x2_interpret():
    """2D-mesh solver with the full energy (Killing + level-set +
    Sobolev) on (16, 16, 128)."""
    params = SolverParams(
        max_iterations=8, learning_rate=0.3,
        smoothing_mode=SmoothingMode.KILLING, level_set_term_weight=0.1,
        sobolev_smoothing=True,
    )
    _parity(params, mesh_shape=(2, 2), shape=(16, 16, 128))


def test_parity_fused_gradient_jnp_resample_2x2_interpret():
    """Tikhonov + Sobolev on a (2, 2) mesh of (16, 16, 128)."""
    params = SolverParams(
        max_iterations=6, learning_rate=0.3, sobolev_smoothing=True,
    )
    _parity(params, mesh_shape=(2, 2), shape=(16, 16, 128))


def test_warp_field_sharded2d_matches_single_device():
    """The 2D-mesh per-shard blend resample equals the single-device
    warp_field, including cross-block and corner-crossing reads."""
    import numpy as np
    import jax.numpy as jnp
    from levelsetfusion_tpu.ops.interpolation import warp_field
    from levelsetfusion_tpu.parallel.mesh import make_mesh_2d
    from levelsetfusion_tpu.parallel.sharded2d import warp_field_sharded2d

    rng = np.random.default_rng(7)
    shape = (32, 16, 128)
    live = jnp.asarray(
        np.tanh(rng.standard_normal(shape).astype(np.float32) * 0.4)
    )
    # Warps up to ±1.9 voxels: cross block faces and corners on the (2, 2)
    # mesh (blocks of 16×8).
    warp = jnp.asarray(
        (rng.standard_normal(shape + (3,)).astype(np.float32) * 0.9).clip(
            -1.9, 1.9
        )
    )
    ref = np.asarray(warp_field(live, warp))
    mesh = make_mesh_2d((2, 2))
    got = warp_field_sharded2d(live, warp, mesh=mesh, live_halo=4)
    np.testing.assert_allclose(np.asarray(got), ref, atol=5e-6)
