"""Finite-difference derivative operators (SURVEY.md §2.4–§2.6 machinery).

Canonical numerical spec of this framework (pinned by tests/test_derivatives.py;
the reference uses ``np.gradient``-style differences for field gradients and
Hessians, and stencil Laplacians for the smoothing terms — SURVEY.md §2.4/2.5):

- ``gradient(f)``      — np.gradient convention: second-order central
  differences in the interior, first-order one-sided at the array edges.
  Unit spacing (voxel units). Returns shape ``(*spatial, D)``.
- ``hessian(f)``       — gradient applied to each component of gradient(f);
  shape ``(*spatial, D, D)``.
- ``laplacian(v)``     — per-component 1-3-1 second-difference stencil with
  *replicated* (Neumann) edges: at the boundary the outside neighbor equals
  the edge value. Applies to scalar or trailing-channel vector fields.
- ``vector_jacobian(u)`` — J[..., c, d] = d u_c / d x_d (np.gradient edges).
- ``gradient_of_divergence(u)`` — ∇(∇·u) with np.gradient edges, used by the
  Killing smoothing term.

All operators are dimension-generic (2D/3D), pure jnp, jit/vmap-safe, and run
as fused elementwise stencils under XLA. Everything is unit-spacing: callers
convert to metric units with the grid's voxel size if needed (the reference's
energy formulation is likewise expressed in voxel units).
"""

from __future__ import annotations

import jax.numpy as jnp


def _diff_axis(f: jnp.ndarray, axis: int) -> jnp.ndarray:
    """np.gradient along one axis: central interior, one-sided edges."""
    n = f.shape[axis]
    if n < 2:
        return jnp.zeros_like(f)
    sl = [slice(None)] * f.ndim

    def ax_slice(s):
        sl2 = list(sl)
        sl2[axis] = s
        return tuple(sl2)

    center = (f[ax_slice(slice(2, None))] - f[ax_slice(slice(None, -2))]) * 0.5
    first = f[ax_slice(slice(1, 2))] - f[ax_slice(slice(0, 1))]
    last = f[ax_slice(slice(-1, None))] - f[ax_slice(slice(-2, -1))]
    return jnp.concatenate([first, center, last], axis=axis)


def gradient(field: jnp.ndarray, num_spatial_dims: int | None = None) -> jnp.ndarray:
    """Spatial gradient, np.gradient convention, unit spacing.

    ``field`` may have trailing non-spatial axes; pass ``num_spatial_dims`` to
    restrict differentiation to the leading axes (defaults to ``field.ndim``).
    Returns ``field.shape + (num_spatial_dims,)``.
    """
    d = field.ndim if num_spatial_dims is None else num_spatial_dims
    return jnp.stack([_diff_axis(field, ax) for ax in range(d)], axis=-1)


def hessian(field: jnp.ndarray) -> jnp.ndarray:
    """Hessian of a scalar field: shape ``(*spatial, D, D)``.

    H[..., i, j] = d²f / (dx_i dx_j), computed as gradient(gradient(f))
    (np.gradient convention both times, matching the reference's level-set
    term machinery, SURVEY.md §2.6).
    """
    g = gradient(field)  # (*s, D)
    d = field.ndim
    return jnp.stack(
        [gradient(g[..., i], num_spatial_dims=d) for i in range(d)], axis=-2
    )


def _second_diff_axis(f: jnp.ndarray, axis: int) -> jnp.ndarray:
    """1-(-2)-1 stencil with replicated (Neumann) edges along ``axis``."""
    fp = jnp.concatenate(
        [jnp.take(f, jnp.array([0]), axis=axis), f, jnp.take(f, jnp.array([f.shape[axis] - 1]), axis=axis)],
        axis=axis,
    )
    sl = [slice(None)] * f.ndim

    def ax_slice(s):
        sl2 = list(sl)
        sl2[axis] = s
        return tuple(sl2)

    return (
        fp[ax_slice(slice(2, None))]
        - 2.0 * f
        + fp[ax_slice(slice(None, -2))]
    )


def laplacian(field: jnp.ndarray, num_spatial_dims: int | None = None) -> jnp.ndarray:
    """Per-component Laplacian with replicated edges; same shape as input."""
    d = field.ndim if num_spatial_dims is None else num_spatial_dims
    out = _second_diff_axis(field, 0)
    for ax in range(1, d):
        out = out + _second_diff_axis(field, ax)
    return out


def vector_jacobian(warp: jnp.ndarray) -> jnp.ndarray:
    """Jacobian of a vector field ``(*spatial, D)`` -> ``(*spatial, D, D)``.

    J[..., c, d] = d warp_c / d x_d (np.gradient convention).
    """
    d = warp.shape[-1]
    return jnp.stack(
        [gradient(warp[..., c], num_spatial_dims=warp.ndim - 1) for c in range(d)],
        axis=-2,
    )


def divergence(warp: jnp.ndarray) -> jnp.ndarray:
    """∇·u of a vector field ``(*spatial, D)`` (np.gradient convention)."""
    d = warp.shape[-1]
    out = _diff_axis(warp[..., 0], 0)
    for c in range(1, d):
        out = out + _diff_axis(warp[..., c], c)
    return out


def gradient_of_divergence(warp: jnp.ndarray) -> jnp.ndarray:
    """∇(∇·u): shape ``(*spatial, D)`` (np.gradient convention twice)."""
    div = divergence(warp)
    return gradient(div, num_spatial_dims=warp.ndim - 1)
