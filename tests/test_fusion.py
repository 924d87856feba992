"""Tests for frame-to-canonical fusion (BASELINE config 4, small scale)."""

import numpy as np
import jax.numpy as jnp

from levelsetfusion_tpu.core.grid import GridSpec
from levelsetfusion_tpu.io import synthetic
from levelsetfusion_tpu.models import SolverParams
from levelsetfusion_tpu.models.fusion import (
    FusionPipelineConfig,
    blend,
    fuse_sequence,
    init_state,
)
from levelsetfusion_tpu.models.params import SmoothingMode
from levelsetfusion_tpu.ops.tsdf import generate_tsdf_3d


def test_blend_weighted_average():
    canonical = jnp.asarray(np.array([[0.5, 1.0], [-0.5, 0.2]], np.float32))
    state = init_state(canonical)
    np.testing.assert_allclose(np.asarray(state.weights), [[1, 0], [1, 1]])
    live = jnp.asarray(np.array([[0.0, 0.4], [-0.5, 1.0]], np.float32))
    new = blend(state, live)
    # (1*0.5 + 1*0.0)/2 = 0.25 ; unobserved canonical + observed live = 0.4;
    # both observed equal -0.5; live truncated -> canonical 0.2 kept.
    np.testing.assert_allclose(
        np.asarray(new.canonical), [[0.25, 0.4], [-0.5, 0.2]], atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(new.weights), [[2, 1], [2, 1]])


def _small_sequence_config():
    seq = synthetic.snoopy_style_sequence_3d(
        num_frames=4, width=48, height=48, blob_radius_px=10.0, blob_height=0.05,
        drift_px_per_frame=(1.5, 0.0), pulse_amplitude=0.1,
    )
    # Narrow-fov camera region: grid covers blob + wall ring (see rigid test).
    grid = GridSpec(shape=(32, 32, 24), voxel_size=0.008, offset=(-16, -16, 42))
    cfg = FusionPipelineConfig(
        grid=grid,
        hierarchical=False,
        solver=SolverParams(
            max_iterations=60,
            # 3D stability: explicit GD on the (Killing) smoothing operator
            # needs rate*weight*λmax < 2, λmax ≈ 26 in 3D.
            learning_rate=0.5,
            smoothing_term_weight=0.1,
            convergence_threshold=2e-3,
            smoothing_mode=SmoothingMode.KILLING,
            adaptive_learning_rate=True,
        ),
    )
    return seq, cfg


def test_fuse_sequence_end_to_end():
    seq, cfg = _small_sequence_config()
    result = fuse_sequence(seq.frames, seq.camera, cfg)
    assert len(result.reports) == 3
    canonical = np.asarray(result.state.canonical)
    assert np.isfinite(canonical).all()
    assert canonical.min() >= -1.0 and canonical.max() <= 1.0
    # The fused canonical keeps a populated narrow band.
    frame0 = np.asarray(
        generate_tsdf_3d(jnp.asarray(seq.frames[0]), seq.camera, cfg.grid)
    )
    band0 = (np.abs(frame0) < 1).sum()
    for r in result.reports:
        assert r.band_voxels >= 0.5 * band0
        assert r.solver_iterations > 0
    # Weights accumulate where repeatedly observed.
    assert float(result.state.weights.max()) >= 3.0


def test_fusion_alignment_beats_naive_averaging():
    """Warp-then-fuse must stay closer to frame 0's surface than naive
    (unwarped) averaging, which smears the moving blob."""
    seq, cfg = _small_sequence_config()
    result = fuse_sequence(seq.frames, seq.camera, cfg)

    naive = init_state(
        generate_tsdf_3d(jnp.asarray(seq.frames[0]), seq.camera, cfg.grid)
    )
    for f in seq.frames[1:]:
        naive = blend(naive, generate_tsdf_3d(jnp.asarray(f), seq.camera, cfg.grid))

    frame0 = np.asarray(
        generate_tsdf_3d(jnp.asarray(seq.frames[0]), seq.camera, cfg.grid)
    )
    mask = np.abs(frame0) < 1.0
    err_fused = np.abs(np.asarray(result.state.canonical)[mask] - frame0[mask]).mean()
    err_naive = np.abs(np.asarray(naive.canonical)[mask] - frame0[mask]).mean()
    assert err_fused < err_naive, (err_fused, err_naive)


def test_depth_fused_frame_matches_live_path():
    """The single-dispatch frame program (TSDF gen folded in) produces the
    same fused state/warp/report as the separate gen + live-path frame."""
    import numpy as np
    import jax.numpy as jnp

    from levelsetfusion_tpu.core.grid import GridSpec
    from levelsetfusion_tpu.io import synthetic
    from levelsetfusion_tpu.models.fusion import (
        FusionPipelineConfig,
        fuse_frame,
        init_state,
    )
    from levelsetfusion_tpu.models.params import SolverParams
    from levelsetfusion_tpu.ops.tsdf import generate_tsdf_3d

    seq = synthetic.snoopy_style_sequence_3d(
        2, width=24, height=24, blob_radius_px=6.0, blob_height=0.05,
    )
    grid = GridSpec(shape=(16, 16, 16), voxel_size=0.008, offset=(-8, -8, 50))
    cfg = FusionPipelineConfig(
        grid=grid, hierarchical=False,
        solver=SolverParams(max_iterations=6, learning_rate=0.5,
                            smoothing_term_weight=0.1),
    )

    def gen(d):
        return generate_tsdf_3d(
            jnp.asarray(d), seq.camera, grid,
            narrow_band_width_voxels=cfg.narrow_band_width_voxels,
            method=cfg.generation_method,
        )

    state0 = init_state(gen(seq.frames[0]))
    warp0 = jnp.zeros(grid.shape + (3,), jnp.float32)

    s_live, w_live, r_live = fuse_frame(
        state0, gen(seq.frames[1]), warp0, cfg.solver, cfg, 1
    )
    s_depth, w_depth, r_depth = fuse_frame(
        state0, None, warp0, cfg.solver, cfg, 1,
        depth=jnp.asarray(seq.frames[1]), camera=seq.camera,
    )
    np.testing.assert_allclose(
        np.asarray(s_depth.canonical), np.asarray(s_live.canonical),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(w_depth), np.asarray(w_live), atol=1e-6
    )
    assert r_depth.solver_iterations == r_live.solver_iterations
    assert r_depth.band_voxels == r_live.band_voxels
