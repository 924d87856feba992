"""Rigid SDF-2-SDF registration (SURVEY.md §2.11, §3.4; Slavcheva ECCV'16).

Gauss-Newton on twist coordinates, minimizing the direct voxel-wise TSDF
difference  E(ξ) = ½ Σ_v m_v (Φ_live(v; ξ) − Φ_canonical(v))²  where the
live TSDF is *regenerated from the depth image* under the current pose each
iteration (the reference's approach — pose enters the voxel→camera
transform) and m_v masks to the union narrow band.

Per iteration (all on device, fixed iteration count in a ``lax.fori_loop``):
  1. live field Φ(v) = tsdf(depth, extrinsic=T) on the canonical grid;
  2. per-voxel Jacobian J_v = (∇_q Φ)ᵀ ∂q/∂ξ with ∇_q Φ = R ∇_p Φ (array
     central differences, converted to meters) and
       2D (ξ = δtx, δtz, δθ):  ∂q/∂ξ = [I₂ | dR/dθ · p]
       3D (ξ = δt, δω):        ∂q/∂ξ = [I₃ | −[q]×]  (left-multiplied
     small-twist increment, q = current camera-frame point);
  3. normal equations  (Σ m J Jᵀ + λI) δ = −Σ m J e  solved with a tiny
     damped linear solve; pose update T ← exp(δ̂) ∘ T (small-angle exp).

The per-voxel work is dense elementwise math over the whole grid — the
3×3/6×6 reduction is a trivial ``jnp.sum``; there are no gathers beyond the
depth-image sampling inside TSDF generation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from levelsetfusion_tpu.core.camera import Camera2d, PinholeCamera
from levelsetfusion_tpu.core.grid import GridSpec, voxel_center_coordinates
from levelsetfusion_tpu.ops import derivatives
from levelsetfusion_tpu.ops.tsdf import GenerationMethod, generate_tsdf_2d, generate_tsdf_3d


# Full f32 for every contraction here: at default precision a GPU may run
# an f32 matmul in TF32.
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    """Small pose matmul at full f32 (not TF32)."""
    return jnp.matmul(a, b, precision=_HIGHEST)


class Sdf2SdfResult(NamedTuple):
    extrinsic: jnp.ndarray  # final camera-from-world matrix (3x3 / 4x4)
    energies: jnp.ndarray  # per-iteration masked energy
    final_live: jnp.ndarray  # live TSDF under the final pose


def _band_mask(canonical, live, eps=1e-5):
    return ((jnp.abs(canonical) < 1.0 - eps) | (jnp.abs(live) < 1.0 - eps)).astype(
        canonical.dtype
    )


@partial(jax.jit, static_argnames=("camera", "grid", "iterations", "narrow_band_width_voxels", "method"))
def solve_rigid_2d(
    canonical: jnp.ndarray,
    live_depth: jnp.ndarray,
    camera: Camera2d,
    grid: GridSpec,
    initial_extrinsic: jnp.ndarray | None = None,
    iterations: int = 30,
    damping: float = 1e-6,
    narrow_band_width_voxels: int = 20,
    method: GenerationMethod = GenerationMethod.BASIC,
) -> Sdf2SdfResult:
    """2D (3-DoF: tx, tz, θ) SDF-2-SDF registration."""
    assert grid.dim == 2
    if initial_extrinsic is None:
        initial_extrinsic = jnp.eye(3, dtype=canonical.dtype)
    points = voxel_center_coordinates(grid)  # (X, Z, 2) world

    def body(_, carry):
        ext, energies, it = carry
        live = generate_tsdf_2d(
            live_depth,
            camera,
            grid,
            extrinsic=ext,
            narrow_band_width_voxels=narrow_band_width_voxels,
            method=method,
        )
        mask = _band_mask(canonical, live)
        e = live - canonical
        energy = 0.5 * jnp.sum(mask * e * e)

        # ∇_p Φ in world units (1/m): array grads are per-voxel.
        grad_p = derivatives.gradient(live) / grid.voxel_size  # (X, Z, 2)
        r = ext[:2, :2]
        # ∇_q Φ, (X, Z, 2)
        grad_q = jnp.einsum("ij,...j->...i", r, grad_p, precision=_HIGHEST)

        # q = R p + t; dq/dθ = dR/dθ p with R(θ)=[[c,-s],[s,c]]:
        # dR/dθ = [[-s,-c],[c,-s]] = S R where S = [[0,-1],[1,0]].
        q = (
            jnp.einsum("ij,...j->...i", r, points, precision=_HIGHEST)
            + ext[:2, 2]
        )
        dq_dtheta = jnp.stack([-q[..., 1], q[..., 0]], axis=-1)

        j = jnp.concatenate([grad_q, jnp.sum(grad_q * dq_dtheta, -1, keepdims=True)], -1)  # (X, Z, 3)
        jtj = jnp.einsum("...i,...j->ij", mask[..., None] * j, j,
                         precision=_HIGHEST)
        jte = jnp.einsum("...i,...->i", j, mask * e,
                         precision=_HIGHEST)
        delta = jnp.linalg.solve(
            jtj + damping * jnp.eye(3, dtype=canonical.dtype), -jte
        )

        # Left-compose the increment: T ← exp(δ̂) T.
        c, s = jnp.cos(delta[2]), jnp.sin(delta[2])
        inc = jnp.array(
            [[c, -s, delta[0]], [s, c, delta[1]], [0.0, 0.0, 1.0]],
            canonical.dtype,
        )
        return _mm(inc, ext), energies.at[it].set(energy), it + 1

    energies0 = jnp.zeros((iterations,), canonical.dtype)
    ext, energies, _ = jax.lax.fori_loop(
        0, iterations, body, (initial_extrinsic.astype(canonical.dtype), energies0, 0)
    )
    final_live = generate_tsdf_2d(
        live_depth,
        camera,
        grid,
        extrinsic=ext,
        narrow_band_width_voxels=narrow_band_width_voxels,
        method=method,
    )
    return Sdf2SdfResult(extrinsic=ext, energies=energies, final_live=final_live)


def _hat3(w):
    z = jnp.zeros((), w.dtype)
    return jnp.array(
        [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]], w.dtype
    )


@partial(jax.jit, static_argnames=("camera", "grid", "iterations", "narrow_band_width_voxels", "method"))
def solve_rigid_3d(
    canonical: jnp.ndarray,
    live_depth: jnp.ndarray,
    camera: PinholeCamera,
    grid: GridSpec,
    initial_extrinsic: jnp.ndarray | None = None,
    iterations: int = 30,
    damping: float = 1e-6,
    narrow_band_width_voxels: int = 20,
    method: GenerationMethod = GenerationMethod.BASIC,
) -> Sdf2SdfResult:
    """3D (6-DoF) SDF-2-SDF registration."""
    assert grid.dim == 3
    if initial_extrinsic is None:
        initial_extrinsic = jnp.eye(4, dtype=canonical.dtype)
    points = voxel_center_coordinates(grid)  # (X, Y, Z, 3) world

    def body(_, carry):
        ext, energies, it = carry
        live = generate_tsdf_3d(
            live_depth,
            camera,
            grid,
            extrinsic=ext,
            narrow_band_width_voxels=narrow_band_width_voxels,
            method=method,
        )
        mask = _band_mask(canonical, live)
        e = live - canonical
        energy = 0.5 * jnp.sum(mask * e * e)

        grad_p = derivatives.gradient(live) / grid.voxel_size  # (..., 3)
        r = ext[:3, :3]
        grad_q = jnp.einsum("ij,...j->...i", r, grad_p, precision=_HIGHEST)
        q = (
            jnp.einsum("ij,...j->...i", r, points, precision=_HIGHEST)
            + ext[:3, 3]
        )

        # J = [∇_qΦ | ∇_qΦ · (−[q]×)] = [∇_qΦ | q × ∇_qΦ].
        j_rot = jnp.cross(q, grad_q)
        j = jnp.concatenate([grad_q, j_rot], axis=-1)  # (..., 6)
        jtj = jnp.einsum("...i,...j->ij", mask[..., None] * j, j,
                         precision=_HIGHEST)
        jte = jnp.einsum("...i,...->i", j, mask * e,
                         precision=_HIGHEST)
        delta = jnp.linalg.solve(
            jtj + damping * jnp.eye(6, dtype=canonical.dtype), -jte
        )

        # exp of the small twist (Rodrigues on δω, first-order coupling ok
        # for GN increments).
        w = delta[3:]
        theta = jnp.sqrt(jnp.sum(w * w) + 1e-24)
        k = _hat3(w / theta)
        rot = (
            jnp.eye(3, dtype=canonical.dtype)
            + jnp.sin(theta) * k
            + (1.0 - jnp.cos(theta)) * _mm(k, k)
        )
        inc = jnp.eye(4, dtype=canonical.dtype)
        inc = inc.at[:3, :3].set(rot).at[:3, 3].set(delta[:3])
        return _mm(inc, ext), energies.at[it].set(energy), it + 1

    energies0 = jnp.zeros((iterations,), canonical.dtype)
    ext, energies, _ = jax.lax.fori_loop(
        0, iterations, body, (initial_extrinsic.astype(canonical.dtype), energies0, 0)
    )
    final_live = generate_tsdf_3d(
        live_depth,
        camera,
        grid,
        extrinsic=ext,
        narrow_band_width_voxels=narrow_band_width_voxels,
        method=method,
    )
    return Sdf2SdfResult(extrinsic=ext, energies=energies, final_live=final_live)
