"""Fused warp-energy gradient assembly (SURVEY.md §3.1 inner-loop body).

One function computes everything a solver iteration needs from
``(canonical, live, warp)``: the combined descent direction

    g = w_data * ∇E_data + w_smooth * ∇E_smooth + w_ls * ∇E_ls
    (optionally Sobolev-filtered)

plus the individual term energies for telemetry. Plain jnp: XLA fuses the
stencils, term math and update into a few loop fusions per iteration.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import jax.numpy as jnp

from levelsetfusion_tpu.ops import interpolation, sobolev, terms


class SmoothingMode(enum.Enum):
    TIKHONOV = "tikhonov"
    KILLING = "killing"


class EnergyBreakdown(NamedTuple):
    data: jnp.ndarray
    smoothing: jnp.ndarray
    level_set: jnp.ndarray

    @property
    def total(self) -> jnp.ndarray:
        return self.data + self.smoothing + self.level_set


class GradientResult(NamedTuple):
    gradient: jnp.ndarray  # (*spatial, D) combined (possibly filtered) descent dir
    energies: EnergyBreakdown
    warped_live: jnp.ndarray


def warp_energy_gradient(
    canonical: jnp.ndarray,
    live: jnp.ndarray,
    warp: jnp.ndarray,
    data_term_weight: float = 1.0,
    smoothing_term_weight: float = 0.2,
    level_set_term_weight: float = 0.0,
    smoothing_mode: SmoothingMode = SmoothingMode.TIKHONOV,
    rigidity_enforcement_factor: float = 0.1,
    band_union_only: bool = True,
    sobolev_kernel: jnp.ndarray | None = None,
) -> GradientResult:
    """Combined energy gradient at the current warp. Weights/modes are static."""
    warped, warped_grad = interpolation.warp_field_with_gradient(live, warp)

    g_data, e_data = terms.data_term(
        warped, canonical, warped_grad, band_union_only=band_union_only
    )
    total = data_term_weight * g_data
    e_data = data_term_weight * e_data

    if smoothing_term_weight != 0.0:
        if smoothing_mode is SmoothingMode.TIKHONOV:
            g_smooth, e_smooth = terms.tikhonov_term(warp)
        else:
            g_smooth, e_smooth = terms.killing_term(
                warp, rigidity_enforcement_factor
            )
        total = total + smoothing_term_weight * g_smooth
        e_smooth = smoothing_term_weight * e_smooth
    else:
        e_smooth = jnp.zeros(())

    if level_set_term_weight != 0.0:
        g_ls, e_ls = terms.level_set_term(
            warped, warped_grad, canonical, band_union_only=band_union_only
        )
        total = total + level_set_term_weight * g_ls
        e_ls = level_set_term_weight * e_ls
    else:
        e_ls = jnp.zeros(())

    if sobolev_kernel is not None:
        total = sobolev.convolve_with_sobolev_kernel(
            total, sobolev_kernel, num_spatial_dims=warp.ndim - 1
        )

    return GradientResult(
        gradient=total,
        energies=EnergyBreakdown(e_data, e_smooth, e_ls),
        warped_live=warped,
    )
