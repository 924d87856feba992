"""Typed solver parameter objects (SURVEY.md §2.9/§2.10 parameter classes,
rebuilt as hashable frozen dataclasses suitable as static jit arguments).

Defaults mirror the reference's typical settings [MED]: learning rate 0.1,
max 100 iterations, smoothing weight 0.2, Sobolev kernel size 7 / strength
0.1, Killing rigidity factor 0.1, termination on max warp-update length.
"""

from __future__ import annotations

import dataclasses

from levelsetfusion_tpu.ops.gradient import SmoothingMode

__all__ = ["SmoothingMode", "SolverParams", "HierarchicalParams"]


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Single-level non-rigid warp-solver parameters (§2.9)."""

    learning_rate: float = 0.1
    max_iterations: int = 100
    # Terminate when the longest per-voxel warp update (voxel units) drops
    # below this.
    convergence_threshold: float = 0.01
    data_term_weight: float = 1.0
    smoothing_term_weight: float = 0.2
    level_set_term_weight: float = 0.0
    smoothing_mode: SmoothingMode = SmoothingMode.TIKHONOV
    rigidity_enforcement_factor: float = 0.1
    sobolev_smoothing: bool = False
    sobolev_kernel_size: int = 7
    sobolev_strength: float = 0.1
    band_union_only: bool = True
    # Adaptive learning rate (reference's optional switch [MED]): halve the
    # rate whenever total energy increases between iterations.
    adaptive_learning_rate: bool = False
    # Distributed solvers: evaluate the global termination reduction (and
    # the adaptive-rate energy comparison) every k-th iteration instead of
    # every iteration, amortizing the fused psum/pmax round k×. k = 1 is
    # the exact per-iteration semantics; k > 1 may run up to k−1 extra
    # iterations past the convergence gate (and rounds max_iterations up
    # to a multiple of k). Per-iteration TELEMETRY stays exact for any k:
    # local per-iteration values are reduced once after the loop.
    termination_check_interval: int = 1

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)

    @property
    def sobolev_radius(self) -> int:
        """Sobolev filter radius (0 when the filter is off)."""
        return self.sobolev_kernel_size // 2 if self.sobolev_smoothing else 0


@dataclasses.dataclass(frozen=True)
class HierarchicalParams:
    """Coarse-to-fine solver parameters (§2.10)."""

    levels: int = 3
    # Per-level solve settings; max_iterations applies at every level.
    base: SolverParams = SolverParams(
        max_iterations=50, convergence_threshold=0.001, sobolev_smoothing=True
    )

    def replace(self, **kw) -> "HierarchicalParams":
        return dataclasses.replace(self, **kw)
