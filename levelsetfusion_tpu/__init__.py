"""levelsetfusion_tpu — dense non-rigid reconstruction engine in JAX.

A from-scratch JAX/XLA implementation of the capabilities of the reference
research codebase ``Algomorph/LevelSetFusion-Python`` (KillingFusion /
SobolevFusion / SDF-2-SDF level-set fusion pipelines), as fused device
programs on an accelerator (an NVIDIA GPU):

- ``core``     — grid specs, camera models, field containers (pure pytrees)
- ``ops``      — TSDF generation, energy-term gradients, Sobolev filtering,
                 interpolation/warping, pyramids; plain jnp that XLA fuses
- ``models``   — the algorithm families: single-level non-rigid warp solver
                 (KillingFusion/SobolevFusion modes), hierarchical
                 coarse-to-fine solver, rigid SDF-2-SDF Gauss-Newton solver,
                 frame-to-canonical fusion pipeline
- ``parallel`` — voxel-block sharding over a ``jax.sharding.Mesh``, halo
                 exchange via collectives, distributed warp solve
- ``io``       — datasets (synthetic + Snoopy-style depth sequences), depth
                 image IO (native C++ fast path)
- ``utils``    — telemetry, visualization, typed configs

Reference provenance: at build time ``/root/reference`` was an empty mount
(see SURVEY.md provenance note); behavior is specified by SURVEY.md,
BASELINE.json and the published papers (Slavcheva et al., SDF-2-SDF ECCV'16,
KillingFusion CVPR'17, SobolevFusion CVPR'18). No reference code was copied.
"""

__version__ = "0.1.0"

from levelsetfusion_tpu.core.grid import GridSpec  # noqa: F401
