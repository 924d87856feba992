"""TSDF generation from depth images (SURVEY.md §2.3).

Depth image → truncated signed distance field on a regular voxel grid, 2D
(single camera scanline → x–z planar field) and 3D. Variants mirror the
reference's generation-method enum [MED on exact upstream names]:

- ``BASIC``              — point-sample the depth image at the voxel's
                           projection (nearest pixel).
- ``EWA_IMAGE``          — elliptical-weighted-average of *depth* samples in
                           a Gaussian footprint of the voxel projected into
                           the image (used for coarse/downsampled grids).
- ``EWA_TSDF``           — EWA of per-sample *TSDF* contributions, invalid
                           samples excluded.
- ``EWA_TSDF_INCLUSIVE`` — EWA of per-sample TSDF contributions with invalid
                           samples contributing the truncation value (+1).

Conventions (pinned by tests/test_tsdf.py):
- depths are meters, ``<= 0`` marks an invalid measurement;
- signed distance = (measured depth − voxel camera-space depth), scaled by
  the half band width ``(narrow_band_width_voxels / 2) * voxel_size`` and
  clipped to [-1, 1];
- voxels that are out of view, behind the camera, or see an invalid depth
  get +1.0 (unobserved/empty convention).

Everything is fully vectorized over voxels (one projection + a static
Gaussian-footprint gather window), jit-friendly with static grid specs —
this is HOT LOOP #1 of SURVEY.md §3.1, mapped to the device as dense
elementwise work.
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp

from levelsetfusion_tpu.core.camera import Camera2d, PinholeCamera, transform_points
from levelsetfusion_tpu.core.grid import GridSpec, voxel_center_coordinates


class GenerationMethod(enum.Enum):
    BASIC = "basic"
    EWA_IMAGE = "ewa_image"
    EWA_TSDF = "ewa_tsdf"
    EWA_TSDF_INCLUSIVE = "ewa_tsdf_inclusive"


NEAR_CLIP = 1e-4
# Static half-width (in pixels) of the EWA gather window.
EWA_WINDOW_RADIUS = 3
# Screen-space antialiasing variance added to the projected voxel footprint.
EWA_SCREEN_VARIANCE = 0.25


def _finalize(sdf_scaled: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(valid, jnp.clip(sdf_scaled, -1.0, 1.0), 1.0)


@partial(jax.jit, static_argnames=("camera", "grid", "method", "narrow_band_width_voxels"))
def generate_tsdf_2d(
    depth_row: jnp.ndarray,
    camera: Camera2d,
    grid: GridSpec,
    extrinsic: jnp.ndarray | None = None,
    narrow_band_width_voxels: int = 20,
    method: GenerationMethod = GenerationMethod.BASIC,
) -> jnp.ndarray:
    """Generate a 2D x–z planar TSDF field from one depth scanline.

    Args:
      depth_row: ``(image_width,)`` depths in meters, <=0 invalid.
      camera: scanline camera intrinsics.
      grid: 2D grid spec (axis 0 = x, axis 1 = z).
      extrinsic: optional 3x3 homogeneous camera-from-world transform.
    """
    assert grid.dim == 2
    band = 0.5 * narrow_band_width_voxels * grid.voxel_size
    # optimization_barrier: the voxel centers are compile-time constants
    # and XLA would constant-fold the whole projection chain over every
    # voxel on the host — measured 54 s of compile at 128³ (1.1 s with the
    # barrier, bit-identical output; the EWA window multiplies the folded
    # work 49×). The coordinates are trivial iota math at runtime.
    points = jax.lax.optimization_barrier(
        voxel_center_coordinates(grid)
    )  # (X, Z, 2) world
    if extrinsic is not None:
        points = transform_points(extrinsic, points)
    x, z = points[..., 0], points[..., 1]
    in_front = z > NEAR_CLIP
    z_safe = jnp.where(in_front, z, 1.0)
    u = camera.fx * x / z_safe + camera.cx  # fractional pixel coordinate

    def sample_depth(px):
        inb = (px >= 0) & (px < camera.image_width)
        d = depth_row[jnp.clip(px, 0, camera.image_width - 1)]
        return d, inb & (d > 0.0)

    if method is GenerationMethod.BASIC:
        px = jnp.round(u).astype(jnp.int32)
        depth, dvalid = sample_depth(px)
        sdf = (depth - z) / band
        return _finalize(sdf, in_front & dvalid)

    # EWA variants: Gaussian footprint of the voxel projected into the image.
    # du/dx = fx/z, voxel world sigma = voxel_size/2 =>
    # var_u = (fx/z)^2 * (vs/2)^2 + screen antialias variance.
    var_u = (camera.fx / z_safe) ** 2 * (0.5 * grid.voxel_size) ** 2 + (
        EWA_SCREEN_VARIANCE
    )
    center = jnp.round(u).astype(jnp.int32)
    offsets = jnp.arange(-EWA_WINDOW_RADIUS, EWA_WINDOW_RADIUS + 1)

    num_acc = jnp.zeros_like(z)
    weight_acc = jnp.zeros_like(z)
    full_weight_acc = jnp.zeros_like(z)
    for k in range(offsets.shape[0]):
        px = center + offsets[k]
        w = jnp.exp(-0.5 * (px.astype(jnp.float32) - u) ** 2 / var_u)
        depth, dvalid = sample_depth(px)
        wv = jnp.where(dvalid, w, 0.0)
        full_weight_acc = full_weight_acc + w
        weight_acc = weight_acc + wv
        if method is GenerationMethod.EWA_IMAGE:
            num_acc = num_acc + wv * depth
        else:
            tsdf_k = jnp.clip((depth - z) / band, -1.0, 1.0)
            contrib = jnp.where(dvalid, tsdf_k, 1.0)
            if method is GenerationMethod.EWA_TSDF_INCLUSIVE:
                num_acc = num_acc + w * contrib
            else:
                num_acc = num_acc + wv * tsdf_k

    any_valid = weight_acc > 0.0
    if method is GenerationMethod.EWA_IMAGE:
        depth_avg = num_acc / jnp.maximum(weight_acc, 1e-12)
        sdf = (depth_avg - z) / band
        return _finalize(sdf, in_front & any_valid)
    if method is GenerationMethod.EWA_TSDF:
        tsdf = num_acc / jnp.maximum(weight_acc, 1e-12)
        return jnp.where(in_front & any_valid, jnp.clip(tsdf, -1.0, 1.0), 1.0)
    # EWA_TSDF_INCLUSIVE: normalize by the full window weight.
    tsdf = num_acc / jnp.maximum(full_weight_acc, 1e-12)
    return jnp.where(in_front, jnp.clip(tsdf, -1.0, 1.0), 1.0)


@partial(jax.jit, static_argnames=("camera", "grid", "method", "narrow_band_width_voxels"))
def generate_tsdf_3d(
    depth_image: jnp.ndarray,
    camera: PinholeCamera,
    grid: GridSpec,
    extrinsic: jnp.ndarray | None = None,
    narrow_band_width_voxels: int = 20,
    method: GenerationMethod = GenerationMethod.BASIC,
) -> jnp.ndarray:
    """Generate a 3D TSDF volume from a depth image.

    Args:
      depth_image: ``(image_height, image_width)`` depths in meters, <=0 invalid.
      grid: 3D grid spec (axes = x, y, z; z is the camera depth axis for the
        identity extrinsic).
    """
    assert grid.dim == 3
    band = 0.5 * narrow_band_width_voxels * grid.voxel_size
    # See the 2D generator: barrier against XLA host-side constant folding
    # of the per-voxel projection (54 s → 1.1 s of compile at 128³).
    points = jax.lax.optimization_barrier(
        voxel_center_coordinates(grid)
    )  # (X, Y, Z, 3) world
    if extrinsic is not None:
        points = transform_points(extrinsic, points)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    in_front = z > NEAR_CLIP
    z_safe = jnp.where(in_front, z, 1.0)
    u = camera.fx * x / z_safe + camera.cx
    v = camera.fy * y / z_safe + camera.cy

    def sample_depth(pu, pv):
        inb = (
            (pu >= 0)
            & (pu < camera.image_width)
            & (pv >= 0)
            & (pv < camera.image_height)
        )
        d = depth_image[
            jnp.clip(pv, 0, camera.image_height - 1),
            jnp.clip(pu, 0, camera.image_width - 1),
        ]
        return d, inb & (d > 0.0)

    if method is GenerationMethod.BASIC:
        pu = jnp.round(u).astype(jnp.int32)
        pv = jnp.round(v).astype(jnp.int32)
        depth, dvalid = sample_depth(pu, pv)
        sdf = (depth - z) / band
        return _finalize(sdf, in_front & dvalid)

    # EWA: projected 2x2 covariance J Σ_voxel Jᵀ + antialias I. With
    # Σ_voxel = (vs/2)² I₃ and J = [[fx/z, 0, -fx x/z²], [0, fy/z, -fy y/z²]].
    svox = (0.5 * grid.voxel_size) ** 2
    j00 = camera.fx / z_safe
    j02 = -camera.fx * x / z_safe**2
    j11 = camera.fy / z_safe
    j12 = -camera.fy * y / z_safe**2
    c00 = svox * (j00 * j00 + j02 * j02) + EWA_SCREEN_VARIANCE
    c01 = svox * (j02 * j12)
    c11 = svox * (j11 * j11 + j12 * j12) + EWA_SCREEN_VARIANCE
    det = c00 * c11 - c01 * c01
    i00 = c11 / det
    i01 = -c01 / det
    i11 = c00 / det

    cu = jnp.round(u).astype(jnp.int32)
    cv = jnp.round(v).astype(jnp.int32)
    r = EWA_WINDOW_RADIUS

    num_acc = jnp.zeros_like(z)
    weight_acc = jnp.zeros_like(z)
    full_weight_acc = jnp.zeros_like(z)
    for du in range(-r, r + 1):
        for dv in range(-r, r + 1):
            pu = cu + du
            pv = cv + dv
            eu = pu.astype(jnp.float32) - u
            ev = pv.astype(jnp.float32) - v
            w = jnp.exp(-0.5 * (i00 * eu * eu + 2.0 * i01 * eu * ev + i11 * ev * ev))
            depth, dvalid = sample_depth(pu, pv)
            wv = jnp.where(dvalid, w, 0.0)
            full_weight_acc = full_weight_acc + w
            weight_acc = weight_acc + wv
            if method is GenerationMethod.EWA_IMAGE:
                num_acc = num_acc + wv * depth
            else:
                tsdf_k = jnp.clip((depth - z) / band, -1.0, 1.0)
                if method is GenerationMethod.EWA_TSDF_INCLUSIVE:
                    num_acc = num_acc + w * jnp.where(dvalid, tsdf_k, 1.0)
                else:
                    num_acc = num_acc + wv * tsdf_k

    any_valid = weight_acc > 0.0
    if method is GenerationMethod.EWA_IMAGE:
        depth_avg = num_acc / jnp.maximum(weight_acc, 1e-12)
        sdf = (depth_avg - z) / band
        return _finalize(sdf, in_front & any_valid)
    if method is GenerationMethod.EWA_TSDF:
        tsdf = num_acc / jnp.maximum(weight_acc, 1e-12)
        return jnp.where(in_front & any_valid, jnp.clip(tsdf, -1.0, 1.0), 1.0)
    tsdf = num_acc / jnp.maximum(full_weight_acc, 1e-12)
    return jnp.where(in_front, jnp.clip(tsdf, -1.0, 1.0), 1.0)
