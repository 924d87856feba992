"""Camera models (SURVEY.md §2.1).

The reference drives 2D experiments with a single scanline of a depth camera
(an x–z planar slice) and 3D with a full pinhole depth camera. Both are
re-implemented here as frozen dataclasses with pure-jnp project/unproject
helpers so they can be closed over by jitted TSDF-generation ops.

Extrinsics are passed separately as homogeneous camera-from-world matrices
(3x3 for 2D — rotation in the x–z plane — and 4x4 for 3D).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera2d:
    """1D-image pinhole camera for x–z planar (scanline) experiments.

    ``fx``/``cx`` are the intrinsics of the horizontal image axis of the
    underlying depth camera; images are 1D depth rows of ``image_width``
    pixels, depths in meters.
    """

    fx: float
    cx: float
    image_width: int

    def project(self, points_xz: jnp.ndarray) -> jnp.ndarray:
        """(..., 2) camera-space (x, z) points -> (...,) pixel u coordinates."""
        x, z = points_xz[..., 0], points_xz[..., 1]
        return self.fx * x / z + self.cx


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Standard pinhole depth camera (3D), depths in meters."""

    fx: float
    fy: float
    cx: float
    cy: float
    image_width: int
    image_height: int

    def project(self, points_xyz: jnp.ndarray) -> jnp.ndarray:
        """(..., 3) camera-space points -> (..., 2) pixel (u, v) coordinates."""
        x, y, z = points_xyz[..., 0], points_xyz[..., 1], points_xyz[..., 2]
        u = self.fx * x / z + self.cx
        v = self.fy * y / z + self.cy
        return jnp.stack([u, v], axis=-1)

    def scanline(self) -> Camera2d:
        """The x–z planar camera of this camera's central scanline."""
        return Camera2d(fx=self.fx, cx=self.cx, image_width=self.image_width)


def identity_extrinsic(dim: int) -> jnp.ndarray:
    """Homogeneous identity camera-from-world matrix (3x3 for 2D, 4x4 for 3D)."""
    return jnp.eye(dim + 1, dtype=jnp.float32)


def se2_matrix(angle: float, tx: float, tz: float) -> np.ndarray:
    """Homogeneous 3x3 rigid transform in the x–z plane."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array(
        [[c, -s, tx], [s, c, tz], [0.0, 0.0, 1.0]], dtype=np.float32
    )


def transform_points(matrix: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply a homogeneous (D+1)x(D+1) transform to (..., D) points.

    The matmul must run at full f32: at default precision a GPU may run an
    f32 matmul in TF32, which keeps ~3 significant digits of the world
    coordinates — enough to shift depth-image sample positions by a
    fraction of a pixel and spoil SDF-2-SDF pose recovery.
    """
    import jax

    d = points.shape[-1]
    return (
        jnp.matmul(
            points, matrix[:d, :d].T, precision=jax.lax.Precision.HIGHEST
        )
        + matrix[:d, d]
    )
