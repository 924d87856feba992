"""Sharded-vs-single-device parity tests (SURVEY.md §4: the natural
generalization of the reference's parity-test culture) on a virtual 8-device
CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from levelsetfusion_tpu.models import SolverParams, solve_single_level
from levelsetfusion_tpu.models.params import SmoothingMode
from levelsetfusion_tpu.parallel import make_mesh, solve_single_level_sharded
from tests.test_single_level import make_pair_fields


def _parity(params, num_devices=4, live_halo=8, fields=None):
    if fields is None:
        canonical, live, _ = make_pair_fields()
    else:
        canonical, live = fields
    mesh = make_mesh(num_devices)
    ref = solve_single_level(canonical, live, params)
    sh = solve_single_level_sharded(
        canonical, live, params, mesh=mesh, live_halo=live_halo
    )
    assert int(sh.iterations) == int(ref.iterations), (
        int(sh.iterations),
        int(ref.iterations),
    )
    np.testing.assert_allclose(
        np.asarray(sh.warp), np.asarray(ref.warp), atol=2e-5, rtol=1e-4
    )
    n = int(ref.iterations)
    for name in ("data_energy", "smoothing_energy", "level_set_energy",
                 "max_warp_update", "mean_warp_update"):
        np.testing.assert_allclose(
            np.asarray(getattr(sh.telemetry, name))[:n],
            np.asarray(getattr(ref.telemetry, name))[:n],
            atol=1e-4,
            rtol=2e-4,
            err_msg=name,
        )
    return ref, sh


def test_devices_available():
    assert len(jax.devices()) >= 8


def test_parity_tikhonov():
    _parity(SolverParams(max_iterations=40, learning_rate=1.0))


def test_parity_tikhonov_sobolev():
    _parity(
        SolverParams(max_iterations=30, learning_rate=1.0, sobolev_smoothing=True)
    )


def test_parity_killing_levelset():
    _parity(
        SolverParams(
            max_iterations=25,
            learning_rate=0.5,
            smoothing_mode=SmoothingMode.KILLING,
            level_set_term_weight=0.1,
        )
    )


def test_parity_8_devices():
    _parity(
        SolverParams(max_iterations=30, learning_rate=1.0, sobolev_smoothing=True),
        num_devices=8,
        live_halo=6,
    )


def test_parity_3d():
    from levelsetfusion_tpu.core.grid import GridSpec
    from levelsetfusion_tpu.io import synthetic
    from levelsetfusion_tpu.ops.tsdf import generate_tsdf_3d
    from levelsetfusion_tpu.core.camera import PinholeCamera

    cam = PinholeCamera(fx=48.0, fy=48.0, cx=24.0, cy=24.0, image_width=48, image_height=48)
    grid = GridSpec(shape=(32, 32, 24), voxel_size=0.008, offset=(-16, -16, 42))
    c_depth = synthetic.blob_wall_depth_3d(cam, blob_radius_px=10.0, blob_height=0.06)
    l_depth = synthetic.blob_wall_depth_3d(
        cam, blob_center_px=(26.0, 24.0), blob_radius_px=10.0, blob_height=0.06
    )
    canonical = generate_tsdf_3d(jnp.asarray(c_depth), cam, grid)
    live = generate_tsdf_3d(jnp.asarray(l_depth), cam, grid)
    _parity(
        SolverParams(
            max_iterations=25,
            learning_rate=0.5,
            smoothing_term_weight=0.1,
            smoothing_mode=SmoothingMode.KILLING,
        ),
        num_devices=4,
        live_halo=8,
        fields=(canonical, live),
    )


def test_sharded_result_is_correct_solution():
    canonical, live, _ = make_pair_fields()
    mesh = make_mesh(4)
    params = SolverParams(max_iterations=100, learning_rate=1.0, convergence_threshold=1e-3)
    sh = solve_single_level_sharded(canonical, live, params, mesh=mesh)
    from levelsetfusion_tpu.ops.interpolation import warp_field

    warped = np.asarray(warp_field(live, sh.warp))
    before = np.abs(np.asarray(live) - np.asarray(canonical)).sum()
    after = np.abs(warped - np.asarray(canonical)).sum()
    assert after < 0.5 * before


def test_gspmd_auto_sharding_matches_single_device():
    """The pjit/GSPMD path (sharded inputs, XLA inserts collectives) matches
    the single-device result exactly."""
    from levelsetfusion_tpu.parallel.mesh import solve_single_level_auto

    canonical, live, _ = make_pair_fields()
    params = SolverParams(max_iterations=30, learning_rate=1.0, sobolev_smoothing=True)
    ref = solve_single_level(canonical, live, params)
    mesh = make_mesh(4)
    auto = solve_single_level_auto(canonical, live, params, mesh=mesh)
    assert int(auto.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(auto.warp), np.asarray(ref.warp), atol=1e-5)
    # Output really is sharded over the mesh.
    assert len(auto.warp.sharding.device_set) == 4


def test_gspmd_auto_with_pallas_kernels_interpret():
    """GSPMD on a (16, 16, 128) volume with the full Sobolev-filtered
    energy: the partitioner's handling of the resample gather must still
    give the single-device result (VERDICT r2 weak #5)."""
    import numpy as np_
    from levelsetfusion_tpu.parallel.mesh import solve_single_level_auto

    rng = np_.random.default_rng(2)
    shape = (16, 16, 128)
    canonical = jnp.asarray(np_.tanh(rng.standard_normal(shape)).astype("float32"))
    live = jnp.asarray(np_.tanh(rng.standard_normal(shape)).astype("float32"))
    params = SolverParams(
        max_iterations=5, learning_rate=0.2, sobolev_smoothing=True,
        convergence_threshold=0.0,
    )
    ref = solve_single_level(canonical, live, params)
    auto = solve_single_level_auto(
        canonical, live, params, mesh=make_mesh(4)
    )
    np.testing.assert_allclose(
        np.asarray(auto.warp), np.asarray(ref.warp), atol=2e-5, rtol=1e-4
    )


def test_sharded_pallas_parity_interpret():
    """Sharded solver on (32, 8, 128) slabs with the full energy matches
    the single-device solver — BASELINE config 5's shape family."""
    rng = np.random.default_rng(3)
    shape = (32, 8, 128)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = jnp.asarray(np.tanh(base * 0.3))
    live = jnp.asarray(np.tanh(np.roll(base, 1, axis=0) * 0.3))
    params = SolverParams(
        max_iterations=5,
        learning_rate=0.2,
        smoothing_term_weight=0.1,
        smoothing_mode=SmoothingMode.KILLING,
        level_set_term_weight=0.1,
        sobolev_smoothing=True,
        convergence_threshold=0.0,
    )
    _parity(params, num_devices=4, live_halo=8, fields=(canonical, live))


def test_sharded_pallas_parity_multislab_interpret():
    """Same, with z = 256."""
    rng = np.random.default_rng(4)
    shape = (32, 8, 256)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = jnp.asarray(np.tanh(base * 0.3))
    live = jnp.asarray(np.tanh(np.roll(base, 1, axis=0) * 0.3))
    params = SolverParams(
        max_iterations=3,
        learning_rate=0.2,
        smoothing_term_weight=0.1,
        convergence_threshold=0.0,
    )
    _parity(params, num_devices=4, live_halo=8, fields=(canonical, live))


def test_sharded_fused_gradient_parity_interpret():
    """Sharded solver, Killing + level-set + Sobolev on (32, 8, 128),
    matches the single-device solver (VERDICT r2 #1)."""
    rng = np.random.default_rng(5)
    shape = (32, 8, 128)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = jnp.asarray(np.tanh(base * 0.3))
    live = jnp.asarray(np.tanh(np.roll(base, 1, axis=0) * 0.3))
    params = SolverParams(
        max_iterations=5,
        learning_rate=0.2,
        smoothing_term_weight=0.1,
        smoothing_mode=SmoothingMode.KILLING,
        level_set_term_weight=0.1,
        sobolev_smoothing=True,
        convergence_threshold=0.0,
    )
    _parity(params, num_devices=4, live_halo=8, fields=(canonical, live))


def test_sharded_fused_gradient_jnp_resample_parity_interpret():
    """Tikhonov + level-set + Sobolev on (32, 16, 128) slabs."""
    rng = np.random.default_rng(6)
    shape = (32, 16, 128)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = jnp.asarray(np.tanh(base * 0.3))
    live = jnp.asarray(np.tanh(np.roll(base, 1, axis=0) * 0.3))
    params = SolverParams(
        max_iterations=4,
        learning_rate=0.2,
        smoothing_term_weight=0.1,
        level_set_term_weight=0.1,
        sobolev_smoothing=True,
        convergence_threshold=0.0,
    )
    _parity(params, num_devices=4, live_halo=8, fields=(canonical, live))


def test_sharded_fused_gradient_no_sobolev_parity_interpret():
    """Killing without Sobolev (the 2-row halo contract)."""
    rng = np.random.default_rng(7)
    shape = (32, 8, 128)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = jnp.asarray(np.tanh(base * 0.3))
    live = jnp.asarray(np.tanh(np.roll(base, 1, axis=0) * 0.3))
    params = SolverParams(
        max_iterations=5,
        learning_rate=0.2,
        smoothing_term_weight=0.1,
        smoothing_mode=SmoothingMode.KILLING,
        convergence_threshold=0.0,
    )
    _parity(params, num_devices=4, live_halo=8, fields=(canonical, live))


def test_sharded_per_axis_clamp_matches_single(rng):
    """Sharded solve == single-device solve on (32, 8, 128) with a
    displacement-scale warm start past the old ±2-voxel kernel window."""
    import numpy as np
    import jax.numpy as jnp

    from levelsetfusion_tpu.models import SolverParams, solve_single_level
    from levelsetfusion_tpu.parallel import make_mesh, solve_single_level_sharded

    shape = (32, 8, 128)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = jnp.asarray(np.tanh(base * 0.4))
    live = jnp.asarray(np.tanh(np.roll(base, 1, axis=0) * 0.4))
    params = SolverParams(
        max_iterations=3, convergence_threshold=0.0, learning_rate=0.3,
    )
    # Up to 5 voxels along y and z, 3 along the sharded x (within the
    # live_halo − 2 = 6 contract).
    w0 = np.zeros(shape + (3,), np.float32)
    w0[..., 0] = rng.uniform(-3, 3, shape)
    w0[..., 1:] = rng.uniform(-5, 5, shape + (2,))
    w0 = jnp.asarray(w0)
    sh = solve_single_level_sharded(
        canonical, live, params, mesh=make_mesh(4), live_halo=8,
        initial_warp=w0,
    )
    ref = solve_single_level(canonical, live, params, initial_warp=w0)
    np.testing.assert_allclose(
        np.asarray(sh.warp), np.asarray(ref.warp), rtol=2e-5, atol=2e-5
    )


def test_termination_check_interval_semantics():
    """k>1 amortizes the reduction round: telemetry stays per-iteration
    exact (post-loop reduction), and the solve stops within k−1 iterations
    of where the exact k=1 run stopped."""
    import numpy as np
    import jax.numpy as jnp
    from levelsetfusion_tpu.models.params import SolverParams
    from levelsetfusion_tpu.parallel import make_mesh, solve_single_level_sharded

    rng = np.random.default_rng(3)
    shape = (32, 16, 32)
    c = jnp.asarray(np.tanh(rng.standard_normal(shape).astype(np.float32) * 0.3))
    l = jnp.asarray(np.roll(np.asarray(c), 1, 0))
    mesh = make_mesh(4)
    base = dict(
        max_iterations=24, learning_rate=0.2, smoothing_term_weight=0.1,
        sobolev_smoothing=True, convergence_threshold=3.5e-2,
    )
    r1 = solve_single_level_sharded(
        c, l, SolverParams(**base), mesh=mesh, live_halo=8
    )
    r4 = solve_single_level_sharded(
        c, l, SolverParams(**base, termination_check_interval=4),
        mesh=mesh, live_halo=8,
    )
    n1, n4 = int(r1.iterations), int(r4.iterations)
    assert n4 % 4 == 0
    assert n1 <= n4 < n1 + 4
    # Telemetry is exact per-iteration for the common prefix.
    for f in r1.telemetry._fields:
        a = np.asarray(getattr(r1.telemetry, f))[:n1]
        b = np.asarray(getattr(r4.telemetry, f))[:n1]
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    assert bool(r4.converged)
