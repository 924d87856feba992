"""Sharded multi-frame fusion (config 4 × config 5): the state stays
sharded across frames and the result matches the single-device driver."""

import numpy as np
import jax
import jax.numpy as jnp

from levelsetfusion_tpu.core.grid import GridSpec
from levelsetfusion_tpu.io import synthetic
from levelsetfusion_tpu.models.fusion import (
    FusionPipelineConfig,
    fuse_sequence,
    fuse_sequence_sharded,
)
from levelsetfusion_tpu.models.params import SolverParams
from levelsetfusion_tpu.parallel import make_mesh


def _setup(num_frames=3):
    seq = synthetic.snoopy_style_sequence_3d(
        num_frames, width=32, height=32, blob_radius_px=6.0,
        blob_height=0.05, drift_px_per_frame=(1.0, 0.0),
        pulse_amplitude=0.05,
    )
    grid = GridSpec(shape=(16, 16, 16), voxel_size=0.01, offset=(-8, -8, 30))
    cfg = FusionPipelineConfig(
        grid=grid,
        hierarchical=False,
        solver=SolverParams(
            max_iterations=12, learning_rate=0.3,
            smoothing_term_weight=0.1, convergence_threshold=1e-3,
        ),
    )
    return seq, cfg


def test_sharded_fusion_matches_single_device():
    seq, cfg = _setup()
    mesh = make_mesh(4)
    ref = fuse_sequence(seq.frames, seq.camera, cfg)
    got = fuse_sequence_sharded(
        seq.frames, seq.camera, cfg, mesh=mesh, live_halo=4
    )
    np.testing.assert_allclose(
        np.asarray(got.state.canonical),
        np.asarray(ref.state.canonical),
        atol=2e-5, rtol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(got.state.weights), np.asarray(ref.state.weights),
        atol=1e-5,
    )
    assert [r.solver_iterations for r in got.reports] == [
        r.solver_iterations for r in ref.reports
    ]
    # The state is genuinely sharded across the mesh the whole way through.
    assert len(got.state.canonical.sharding.device_set) == 4
    assert len(got.final_warp.sharding.device_set) == 4


def test_cli_multi_frame_sharded_mode(tmp_path):
    import dataclasses
    import json
    import os

    from levelsetfusion_tpu.cli import run_experiment
    from levelsetfusion_tpu.utils.config import ExperimentConfig

    cfg = ExperimentConfig(
        name="sharded_fusion_smoke",
        mode="multi_frame_sharded_3d",
        grid_shape=(16, 16, 16),
        voxel_size=0.01,
        grid_offset=(-8, -8, 30),
        num_frames=3,
        num_devices=4,
        live_halo=4,
        checkpoint_every=1,
        solver=dataclasses.replace(
            ExperimentConfig("x", "y").solver,
            max_iterations=8, learning_rate=0.3,
            smoothing_term_weight=0.1, convergence_threshold=1e-3,
        ),
        dataset_kwargs={"width": 32, "height": 32, "blob_radius_px": 6.0},
    )
    out = str(tmp_path / "run")
    summary = run_experiment(cfg, out)
    assert summary["frames"] == 3
    assert summary["devices"] == 4
    assert os.path.isdir(os.path.join(out, "checkpoints"))
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f)["frames_per_s"] > 0


def test_warp_field_sharded_pallas_parity_interpret():
    """The fusion gather's per-shard halo path matches the single-device
    warp_field on (16, 16, 128), with axis-0 reads across block faces."""
    from levelsetfusion_tpu.ops.interpolation import warp_field
    from levelsetfusion_tpu.parallel.sharded import warp_field_sharded

    rng = np.random.default_rng(4)
    shape = (16, 16, 128)
    live = jnp.asarray(np.tanh(rng.standard_normal(shape)).astype(np.float32))
    warp = jnp.asarray(
        (rng.uniform(-1.5, 1.5, shape + (3,))).astype(np.float32)
    )
    mesh = make_mesh(4)
    ref = warp_field(live, warp)
    got = warp_field_sharded(live, warp, mesh=mesh, live_halo=8)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-6)


def test_sharded_hierarchical_fusion_matches_single_device():
    """config.hierarchical=True in sharded fusion runs the sharded
    coarse-to-fine solver (previously it silently ran flat)."""
    seq, cfg = _setup()
    import dataclasses

    cfg = dataclasses.replace(cfg, hierarchical=True, levels=2)
    mesh = make_mesh(4)
    ref = fuse_sequence(seq.frames, seq.camera, cfg)
    sh = fuse_sequence_sharded(seq.frames, seq.camera, cfg, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(sh.state.canonical), np.asarray(ref.state.canonical),
        atol=5e-5, rtol=1e-4,
    )
    assert [r.solver_iterations for r in sh.reports] == [
        r.solver_iterations for r in ref.reports
    ]


def test_sharded_fusion_2d_mesh_matches_single_device():
    """Config 4 × the 2D voxel-block mesh (round 4): per-frame solves run
    on parallel.sharded2d, the blend is the exact GSPMD gather, and the
    fused canonical matches the single-device pipeline."""
    from levelsetfusion_tpu.parallel.mesh import make_mesh_2d

    seq, cfg = _setup()
    mesh = make_mesh_2d((2, 2))
    ref = fuse_sequence(seq.frames, seq.camera, cfg)
    got = fuse_sequence_sharded(
        seq.frames, seq.camera, cfg, mesh=mesh, mesh_axes=("x", "y"),
        live_halo=4,
    )
    np.testing.assert_allclose(
        np.asarray(got.state.canonical),
        np.asarray(ref.state.canonical),
        atol=2e-5,
    )
    assert got.reports[0].max_abs_displacement
    import pytest

    from levelsetfusion_tpu.models.fusion import FusionPipelineConfig

    with pytest.raises(ValueError, match="1D mesh"):
        fuse_sequence_sharded(
            seq.frames, seq.camera,
            FusionPipelineConfig(grid=cfg.grid, hierarchical=True,
                                 solver=cfg.solver),
            mesh=mesh, mesh_axes=("x", "y"),
        )
