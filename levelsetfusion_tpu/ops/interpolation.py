"""Field warping / interpolation (SURVEY.md §2.8).

The single most-used primitive of the pipeline: resample a (TSDF) field at
``x + u(x)`` with multi-linear interpolation. Conventions (pinned by tests):

- Sample positions are in **voxel/index units** of the same grid.
- Out-of-bounds reads return the truncation value ``+1.0`` (empty space);
  interpolation near the border blends with that fill value, i.e. the field
  behaves as if padded with +1 outside (matching the reference's convention
  that unobserved space is +1 — SURVEY.md §2.8 [MED]).
- ``warp`` holds per-voxel displacements in voxel units, component ``d``
  along array axis ``d``.

Implemented dimension-generically with ``2**D`` corner gathers, which XLA
fuses into one gather loop under jit.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp

TRUNCATION_FILL = 1.0


def sample_at(
    field: jnp.ndarray,
    positions: jnp.ndarray,
    fill_value: float = TRUNCATION_FILL,
) -> jnp.ndarray:
    """Multi-linear interpolation of ``field`` at fractional index positions.

    Args:
      field: scalar field ``(*spatial,)``.
      positions: ``(..., D)`` fractional index coordinates.
      fill_value: value assumed outside the grid.

    Returns array of shape ``positions.shape[:-1]``.
    """
    d = field.ndim
    assert positions.shape[-1] == d, (positions.shape, d)
    floor = jnp.floor(positions)
    frac = positions - floor
    base = floor.astype(jnp.int32)

    out = None
    for corner in itertools.product((0, 1), repeat=d):
        idx = [base[..., ax] + corner[ax] for ax in range(d)]
        weight = None
        for ax in range(d):
            w_ax = frac[..., ax] if corner[ax] else 1.0 - frac[..., ax]
            weight = w_ax if weight is None else weight * w_ax
        in_bounds = None
        for ax in range(d):
            ok = (idx[ax] >= 0) & (idx[ax] < field.shape[ax])
            in_bounds = ok if in_bounds is None else in_bounds & ok
        clipped = tuple(
            jnp.clip(idx[ax], 0, field.shape[ax] - 1) for ax in range(d)
        )
        value = jnp.where(in_bounds, field[clipped], fill_value)
        contrib = weight * value
        out = contrib if out is None else out + contrib
    return out


def identity_positions(shape, dtype=jnp.float32) -> jnp.ndarray:
    """Index-coordinate grid ``(*shape, D)``: position of every voxel."""
    axes = [jnp.arange(n, dtype=dtype) for n in shape]
    return jnp.stack(jnp.meshgrid(*axes, indexing="ij"), axis=-1)


def warp_field(
    field: jnp.ndarray,
    warp: jnp.ndarray,
    fill_value: float = TRUNCATION_FILL,
) -> jnp.ndarray:
    """Resample ``field`` at ``x + warp(x)`` (the live-field warp of §3.1)."""
    pos = identity_positions(field.shape, warp.dtype) + warp
    return sample_at(field, pos, fill_value=fill_value)


def warp_field_with_gradient(
    field: jnp.ndarray,
    warp: jnp.ndarray,
    fill_value: float = TRUNCATION_FILL,
):
    """Warped field and its np.gradient-style spatial gradient.

    Matches the reference's vectorized data-term pipeline: the gradient is
    taken of the *resampled* field (SURVEY.md §3.1 inner loop), not resampled
    from a precomputed gradient.
    """
    from levelsetfusion_tpu.ops.derivatives import gradient

    warped = warp_field(field, warp, fill_value=fill_value)
    return warped, gradient(warped)


def advect_field(
    field: jnp.ndarray,
    warp: jnp.ndarray,
    fill_value: float = TRUNCATION_FILL,
    eps: float = 1e-8,
) -> jnp.ndarray:
    """Forward-warp ("field advected", SURVEY.md §2.8 [MED]): push each
    voxel's value to ``x + u(x)``, splatting with multi-linear weights and
    normalizing by the accumulated weight; target voxels no source reaches
    get ``fill_value``.

    The backward flavor (``warp_field``) asks "what was at the place this
    voxel came from"; this one asks "where does this voxel's value go" —
    the reference uses it when updating a field under a warp defined on the
    SOURCE grid. Scatter-add lowers to XLA scatters under jit.
    """
    d = field.ndim
    assert warp.shape == field.shape + (d,), (field.shape, warp.shape)
    pos = identity_positions(field.shape, warp.dtype) + warp
    base = jnp.floor(pos)
    frac = pos - base
    base_i = base.astype(jnp.int32)

    values = jnp.zeros(field.shape, field.dtype)
    weights = jnp.zeros(field.shape, field.dtype)
    flat_field = field.reshape(-1)

    for corner in range(2**d):
        offs = [(corner >> k) & 1 for k in range(d)]
        idx = [base_i[..., k] + offs[k] for k in range(d)]
        w = jnp.ones(field.shape, field.dtype)
        for k in range(d):
            w = w * jnp.where(offs[k] == 1, frac[..., k], 1.0 - frac[..., k])
        inb = jnp.ones(field.shape, bool)
        for k in range(d):
            inb = inb & (idx[k] >= 0) & (idx[k] < field.shape[k])
        w = jnp.where(inb, w, 0.0)
        idx_c = tuple(
            jnp.clip(idx[k], 0, field.shape[k] - 1) for k in range(d)
        )
        values = values.at[idx_c].add(w * field)
        weights = weights.at[idx_c].add(w)

    return jnp.where(
        weights > eps, values / jnp.maximum(weights, eps), fill_value
    )
