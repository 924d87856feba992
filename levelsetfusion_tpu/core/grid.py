"""Voxel grid specification and coordinate helpers.

Conventions (this framework's canonical spec — see SURVEY.md §2.3/§7; the
reference mount was empty, so these are defined here and pinned by tests):

- A *field* is a plain ``jnp.ndarray`` of shape ``(*spatial,)`` (scalar TSDF)
  or ``(*spatial, D)`` (vector field, e.g. a warp), ``float32`` by default.
- Spatial rank ``D`` is 2 or 3. Index axis ``d`` of the array maps directly to
  world axis ``d``:  ``world[d] = (offset[d] + index[d]) * voxel_size``.
  - 2D fields live in the camera's x–z plane: axis 0 = lateral ``x``,
    axis 1 = depth ``z`` (contiguous dimension).
  - 3D fields: axis 0 = ``x``, axis 1 = ``y``, axis 2 = ``z`` (depth,
    contiguous dimension).
- Warp fields store displacements in **voxel units** along the corresponding
  array axes; world displacement = warp * voxel_size.
- TSDF values are truncated to [-1, 1]; voxels with no depth measurement
  (invalid/out-of-view/behind camera) hold +1.0.

``GridSpec`` is a hashable, frozen dataclass intended to be passed as a
*static* argument to jitted functions (shapes/offsets must be concrete at
trace time).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a regular voxel grid.

    Attributes:
      shape: spatial extents, length 2 or 3.
      voxel_size: edge length of one voxel in meters.
      offset: integer voxel offset of array index (0,...,0) from the world
        origin; world position of voxel ``idx`` is
        ``(offset + idx) * voxel_size`` (voxel centers).
    """

    shape: Tuple[int, ...]
    voxel_size: float = 0.004
    offset: Tuple[int, ...] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.offset is None:
            object.__setattr__(self, "offset", (0,) * len(self.shape))
        if len(self.offset) != len(self.shape):
            raise ValueError(
                f"offset rank {len(self.offset)} != shape rank {len(self.shape)}"
            )
        if len(self.shape) not in (2, 3):
            raise ValueError(f"only 2D/3D grids supported, got shape {self.shape}")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.shape))

    def world_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.asarray(self.offset, np.float32) * self.voxel_size
        hi = (np.asarray(self.offset, np.float32) + np.asarray(self.shape) - 1) * (
            self.voxel_size
        )
        return lo, hi

    def with_shape(self, shape: Tuple[int, ...]) -> "GridSpec":
        return dataclasses.replace(self, shape=tuple(shape))

    def coarsened(self, factor: int = 2) -> "GridSpec":
        """Grid covering the same region at ``factor``-times coarser resolution.

        Used by the hierarchical optimizer's pyramid (SURVEY.md §2.10): shape
        is divided (must divide evenly), voxel size multiplied, offset scaled
        so that world extents are preserved.
        """
        if any(s % factor for s in self.shape):
            raise ValueError(f"shape {self.shape} not divisible by {factor}")
        return GridSpec(
            shape=tuple(s // factor for s in self.shape),
            voxel_size=self.voxel_size * factor,
            # Voxel center of a merged block sits at the mean of its children;
            # offset in coarse-voxel units that preserves world placement:
            offset=tuple((o + (factor - 1) / 2.0) / factor for o in self.offset),
        )


def voxel_center_coordinates(grid: GridSpec, dtype=jnp.float32) -> jnp.ndarray:
    """World coordinates of every voxel center.

    Returns an array of shape ``(*grid.shape, D)`` where the last axis holds
    the world-space position ``(offset + idx) * voxel_size``.
    """
    axes = [
        (jnp.arange(n, dtype=dtype) + o) * grid.voxel_size
        for n, o in zip(grid.shape, grid.offset)
    ]
    mesh = jnp.meshgrid(*axes, indexing="ij")
    return jnp.stack(mesh, axis=-1)
