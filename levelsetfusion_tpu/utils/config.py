"""Typed experiment configuration (SURVEY.md §5 config/flag system).

One dataclass covers every experiment the CLI can run; the five BASELINE.md
acceptance configs ship as named presets. Configs serialize to/from JSON so a
run directory records exactly what produced it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from levelsetfusion_tpu.models.params import HierarchicalParams, SmoothingMode, SolverParams
from levelsetfusion_tpu.ops.tsdf import GenerationMethod


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    # "single_pair_2d" | "hierarchical_2d" | "single_pair_3d" |
    # "multi_frame_3d" | "multi_frame_sharded_3d" | "sharded_3d" |
    # "hierarchical_sharded_3d" | "rigid_2d" | "rigid_3d"
    mode: str
    grid_shape: Tuple[int, ...] = (96, 48)
    voxel_size: float = 0.004
    grid_offset: Tuple[int, ...] = (-48, 85)
    narrow_band_width_voxels: int = 20
    generation_method: GenerationMethod = GenerationMethod.BASIC
    # Multi-frame modes resolve this through io.datasets (SURVEY §2.2):
    # "synthetic" = inline snoopy-style generator with the CLI defaults;
    # "depth_directory" + dataset_kwargs={"path": ...} fuses 16-bit depth
    # PNGs off disk (native threaded decode when the C++ extension builds).
    # 2D/rigid modes pass dataset_kwargs straight to their generators.
    dataset: str = "synthetic"
    dataset_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    solver: SolverParams = SolverParams()
    levels: int = 3
    # Hierarchical modes: how coarse pyramid levels are built (SURVEY §2.10).
    # "block_mean" = 2× block-mean downsample of the finest TSDF;
    # "ewa_depth"  = regenerate each coarse level directly from the depth
    #                image on a coarsened grid with EWA sampling (the coarse
    #                voxel's image footprint is integrated, not aliased).
    pyramid_method: str = "block_mean"
    num_frames: int = 4
    checkpoint_every: int = 0  # frames; 0 = off
    num_devices: Optional[int] = None  # sharded mode: defaults to all
    # Sharded mode mesh: None = 1D (axis-0 slabs over num_devices); a pair
    # (s0, s1) = 2D voxel-block mesh (axes 0 and 1; parallel/sharded2d).
    mesh_shape: Optional[Tuple[int, int]] = None
    live_halo: int = 8
    # Distributed solver structure for sharded_3d:
    # "sync"    = per-iteration halo exchange (parallel.sharded /
    #             parallel.sharded2d with mesh_shape);
    # "schur"   = block-local inner iterations + Schur-style interface
    #             reduction, ~T× fewer collectives (parallel.schur; 1D);
    # "schur2d" = Schur-outer across mesh axis 0 × sync-inner along mesh
    #             axis 1 — requires mesh_shape (parallel.schur2d).
    solver_kind: str = "sync"
    schur_inner_iterations: int = 8

    def to_json(self) -> str:
        def default(o):
            if dataclasses.is_dataclass(o) and not isinstance(o, type):
                return dataclasses.asdict(o)
            if hasattr(o, "value"):
                return o.value
            return str(o)

        return json.dumps(dataclasses.asdict(self), indent=2, default=default)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExperimentConfig":
        d = dict(d)
        if isinstance(d.get("generation_method"), str):
            d["generation_method"] = GenerationMethod(d["generation_method"])
        if isinstance(d.get("solver"), dict):
            s = dict(d["solver"])
            if isinstance(s.get("smoothing_mode"), str):
                s["smoothing_mode"] = SmoothingMode(s["smoothing_mode"])
            d["solver"] = SolverParams(**s)
        for key in ("grid_shape", "grid_offset", "mesh_shape"):
            if d.get(key) is not None:
                d[key] = tuple(d[key])
        return ExperimentConfig(**d)

    @staticmethod
    def from_json(text: str) -> "ExperimentConfig":
        return ExperimentConfig.from_dict(json.loads(text))


def _solver_2d(**kw) -> SolverParams:
    base = dict(learning_rate=1.0, convergence_threshold=1e-3, max_iterations=200)
    base.update(kw)
    return SolverParams(**base)


def _solver_3d(**kw) -> SolverParams:
    # 3D explicit-GD stability: rate*weight*λmax < 2, λmax ≈ 26.
    base = dict(
        learning_rate=0.5,
        smoothing_term_weight=0.1,
        convergence_threshold=1e-3,
        max_iterations=120,
        adaptive_learning_rate=True,
    )
    base.update(kw)
    return SolverParams(**base)


# The five BASELINE.md acceptance configurations.
PRESETS: Dict[str, ExperimentConfig] = {
    # 1. 2D single depth-image-pair, dense grid, plain GD warp solve.
    # Plain (un-preconditioned) GD needs ~450 iterations to pass its own
    # 1e-3 max-warp-update gate on this pair — budgeted so the flagship
    # acceptance case reports converged: True (measured: converges at 442).
    "config1_2d_pair": ExperimentConfig(
        name="config1_2d_pair",
        mode="single_pair_2d",
        grid_shape=(96, 48),
        grid_offset=(-48, 85),
        solver=_solver_2d(max_iterations=600),
    ),
    # 2. 2D hierarchical coarse-to-fine with Sobolev-smoothed gradients.
    # Coarse levels are EWA depth-regenerated (SURVEY §2.10's EWA-aware
    # coarse generation), not block-mean downsampled.
    "config2_2d_hierarchical": ExperimentConfig(
        name="config2_2d_hierarchical",
        mode="hierarchical_2d",
        grid_shape=(96, 64),
        grid_offset=(-48, 75),
        levels=3,
        solver=_solver_2d(max_iterations=60, sobolev_smoothing=True),
        dataset_kwargs={"live_shift_px": 8.0},
        pyramid_method="ewa_depth",
    ),
    # 3. 3D dense 128³ single-pair with the full energy.
    "config3_3d_full_energy": ExperimentConfig(
        name="config3_3d_full_energy",
        mode="single_pair_3d",
        grid_shape=(128, 128, 128),
        voxel_size=0.004,
        grid_offset=(-64, -64, 75),
        solver=_solver_3d(
            smoothing_mode=SmoothingMode.KILLING,
            level_set_term_weight=0.1,
            sobolev_smoothing=True,
            # Plain GD's diffusion tail needs ~1k iterations to pass the
            # 1e-3 max-warp-update gate (measured: 0.0015 at 800).
            max_iterations=1200,
        ),
    ),
    # 4. 3D multi-frame frame-to-canonical fusion, Killing regularization,
    # 8 frames at 128³.
    "config4_3d_fusion": ExperimentConfig(
        name="config4_3d_fusion",
        mode="multi_frame_3d",
        grid_shape=(128, 128, 128),
        voxel_size=0.004,
        grid_offset=(-64, -64, 75),
        num_frames=8,
        checkpoint_every=2,
        solver=_solver_3d(
            smoothing_mode=SmoothingMode.KILLING,
            max_iterations=80,
        ),
        dataset_kwargs={"width": 96, "height": 96},
    ),
    # 5. Sharded 3D volume across a device mesh with halo exchange.
    "config5_sharded": ExperimentConfig(
        name="config5_sharded",
        mode="sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        # Budget covers the measured convergence point: the preset reaches
        # its 1e-3 gate at 302 iterations (experiments/config5_convergence
        # .py, virtual mesh) — converged: True is part of the contract.
        solver=_solver_3d(max_iterations=320),
        live_halo=8,
    ),
    # 5-Schur. Same problem as config5_sharded solved with the BASELINE
    # north_star's mandated distributed structure: block-local inner
    # iterations + Schur-complement-style interface reduction (~8× fewer
    # collective rounds than the sync solver; see parallel/schur.py).
    "config5_sharded_schur": ExperimentConfig(
        name="config5_sharded_schur",
        mode="sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        # Total-inner budget: converges in 38 outer steps x 8 = 304
        # inner iterations at the same gate (config5_convergence.py).
        solver=_solver_3d(max_iterations=320, adaptive_learning_rate=False),
        live_halo=8,
        solver_kind="schur",
        schur_inner_iterations=8,
    ),
    # 5-2D. The same problem on a 2D voxel-block mesh (parallel/sharded2d):
    # axes 0 AND 1 shard, halos exchange along both mesh axes with correct
    # corner fill — block counts beyond shape[0]/min_halo require cutting a
    # second axis. (2, 2) over 4 devices → per-shard blocks of 64×32×128.
    "config5_2dmesh": ExperimentConfig(
        name="config5_2dmesh",
        mode="sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        # Converges at 302 iterations (config5_convergence.py).
        solver=_solver_3d(max_iterations=320),
        live_halo=8,
        mesh_shape=(2, 2),
    ),
    # 5b. BASELINE's mandated scale for config 5: a 512³ volume sharded over
    # the device mesh along axis 0 (the whole volume on one card, or
    # 128×512×512 per card on four).
    "config5_512": ExperimentConfig(
        name="config5_512",
        mode="sharded_3d",
        grid_shape=(512, 512, 512),
        voxel_size=0.004,
        grid_offset=(-256, -256, 38),
        # FULL energy — the workload the 512³ acceptance parity runs
        # validate (experiments/config5_512_acceptance.py: Killing +
        # level-set + Sobolev).
        # termination_check_interval=4 amortizes the fused psum/pmax round
        # 4× (documented semantics: the solve may run up to 3 iterations
        # past the 1e-3 gate; telemetry stays per-iteration exact).
        solver=_solver_3d(max_iterations=32,
                          smoothing_mode=SmoothingMode.KILLING,
                          level_set_term_weight=0.1,
                          sobolev_smoothing=True,
                          termination_check_interval=4),
        live_halo=8,
    ),
    # 5-hier. Coarse-to-fine on the sharded volume (parallel.hierarchical):
    # the supported path when motion exceeds the flat solver's
    # live_halo − 2 contract — coarse levels run replicated and absorb the
    # motion, fine levels run sharded with the halo sized from the measured
    # coarse displacement. The warm-started fine-level warp carries the
    # FULL ~5-voxel motion, so the fine level's halo floor is 11.
    "config5_hierarchical": ExperimentConfig(
        name="config5_hierarchical",
        mode="hierarchical_sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        levels=3,
        dataset_kwargs={"live_shift_px": 10.0},
        # Per-level budget: the levels converge at [115, 159, 43]
        # iterations on their 1e-3 gates (config5_convergence.py).
        solver=_solver_3d(max_iterations=200),
        live_halo=11,
    ),
    # 5-Schur2D. Schur-outer × sync-inner (parallel/schur2d): the volume
    # shards over a 2D mesh; mesh axis 0 runs the Schur outer structure —
    # frozen ghosts, T block-local-in-x inner iterations, closed-form
    # interface reduction — while every inner iteration exchanges axis-1
    # halos sync-style within the block row. Axis-0 collective rounds drop
    # ~T×.
    "config5_schur2d": ExperimentConfig(
        name="config5_schur2d",
        mode="sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        # Converges in 38 outer steps x 8 inner (config5_convergence.py).
        solver=_solver_3d(max_iterations=320, adaptive_learning_rate=False),
        live_halo=8,
        mesh_shape=(2, 2),
        solver_kind="schur2d",
        schur_inner_iterations=8,
    ),
    # Rigid SDF-2-SDF (reference component §2.11).
    "rigid_2d": ExperimentConfig(
        name="rigid_2d",
        mode="rigid_2d",
        grid_shape=(96, 48),
        grid_offset=(-48, 85),
    ),
    "rigid_3d": ExperimentConfig(
        name="rigid_3d",
        mode="rigid_3d",
        grid_shape=(32, 32, 24),
        voxel_size=0.008,
        grid_offset=(-16, -16, 42),
    ),
}
