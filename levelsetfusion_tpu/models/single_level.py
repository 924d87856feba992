"""Single-level non-rigid warp solver (SURVEY.md §2.9, §3.1 inner loop).

The KillingFusion/SobolevFusion gradient-descent warp optimization as one
jitted ``lax.while_loop`` — fully on-device: per-iteration energies and
warp-update statistics are written into preallocated telemetry buffers with
dynamic-index updates, and termination (max per-voxel warp-update length
below threshold, or iteration cap) is decided on device. No host round
trips inside the loop.

The whole iteration body (resample gather + stencils + updates) compiles to
one XLA program; under sharding the same body runs per voxel
block with halo exchange (see ``parallel/``), and the termination reduction
becomes a ``psum``/``pmax`` — semantics identical to this single-device
version, which the parity tests assert.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from levelsetfusion_tpu.models.params import SolverParams
from levelsetfusion_tpu.ops import sobolev as sobolev_ops
from levelsetfusion_tpu.ops.gradient import warp_energy_gradient


class SolveTelemetry(NamedTuple):
    """Per-iteration log, reference schema (SURVEY.md §2.12/§5): energy
    components + warp-update statistics; entries past ``iterations`` are 0."""

    data_energy: jnp.ndarray
    smoothing_energy: jnp.ndarray
    level_set_energy: jnp.ndarray
    max_warp_update: jnp.ndarray
    mean_warp_update: jnp.ndarray


class SolveResult(NamedTuple):
    warp: jnp.ndarray
    iterations: jnp.ndarray  # scalar int32: iterations actually run
    converged: jnp.ndarray  # scalar bool
    telemetry: SolveTelemetry
    # Per-axis running max of |u| (voxel units) over every warp the solve
    # resampled with (incl. the warm start) — the displacement-contract
    # observable: the sharded solvers read truncation fill beyond
    # ``live_halo − 2`` rows of a block edge, silently; this scalar per
    # axis is what ``utils.debug.check_displacement_contract`` compares
    # against that limit.
    max_abs_displacement: jnp.ndarray | None = None


class _LoopState(NamedTuple):
    warp: jnp.ndarray
    iteration: jnp.ndarray
    max_update: jnp.ndarray
    learning_rate: jnp.ndarray
    prev_energy: jnp.ndarray
    telemetry: SolveTelemetry
    max_disp: jnp.ndarray  # (D,) running max |u| per axis


def _axis_max_abs(warp):
    """Per-axis max |u| of a ``(*spatial, D)`` warp."""
    return jnp.max(jnp.abs(warp), axis=tuple(range(warp.ndim - 1)))


def _solver_step(canonical, live, warp, params: SolverParams, kernel):
    return warp_energy_gradient(
        canonical,
        live,
        warp,
        data_term_weight=params.data_term_weight,
        smoothing_term_weight=params.smoothing_term_weight,
        level_set_term_weight=params.level_set_term_weight,
        smoothing_mode=params.smoothing_mode,
        rigidity_enforcement_factor=params.rigidity_enforcement_factor,
        band_union_only=params.band_union_only,
        sobolev_kernel=kernel,
    )


@partial(jax.jit, static_argnames=("params",))
def solve_single_level(
    canonical: jnp.ndarray,
    live: jnp.ndarray,
    params: SolverParams = SolverParams(),
    initial_warp: jnp.ndarray | None = None,
) -> SolveResult:
    """Optimize the warp aligning ``live`` to ``canonical``.

    Args:
      canonical: scalar TSDF field ``(*spatial,)``.
      live: scalar TSDF field, same shape.
      params: static solver parameters.
      initial_warp: optional warm start ``(*spatial, D)`` (multi-frame fusion
        and hierarchical prolongation use this), else zeros.
    """
    d = canonical.ndim
    if initial_warp is None:
        initial_warp = jnp.zeros(canonical.shape + (d,), canonical.dtype)

    kernel = (
        jnp.asarray(
            sobolev_ops.generate_1d_sobolev_kernel(
                params.sobolev_kernel_size, params.sobolev_strength
            )
        )
        if params.sobolev_smoothing
        else None
    )

    n = params.max_iterations
    zeros = jnp.zeros((n,), canonical.dtype)
    init = _LoopState(
        warp=initial_warp,
        iteration=jnp.zeros((), jnp.int32),
        max_update=jnp.full((), jnp.inf, canonical.dtype),
        learning_rate=jnp.asarray(params.learning_rate, canonical.dtype),
        prev_energy=jnp.full((), jnp.inf, canonical.dtype),
        telemetry=SolveTelemetry(zeros, zeros, zeros, zeros, zeros),
        max_disp=jnp.zeros((d,), canonical.dtype),
    )

    def cond(state: _LoopState):
        return (state.iteration < n) & (
            state.max_update >= params.convergence_threshold
        )

    def body(state: _LoopState):
        # The warp entering this body is what the resample gathers with —
        # exactly the value the displacement contract constrains.
        max_disp = jnp.maximum(state.max_disp, _axis_max_abs(state.warp))
        res = _solver_step(canonical, live, state.warp, params, kernel)
        update = -state.learning_rate * res.gradient
        new_warp = state.warp + update
        update_len = jnp.sqrt(jnp.sum(update * update, axis=-1))
        max_update = jnp.max(update_len)
        mean_update = jnp.mean(update_len)
        energies = res.energies

        energy = energies.total
        if params.adaptive_learning_rate:
            new_rate = jnp.where(
                energy > state.prev_energy,
                state.learning_rate * 0.5,
                state.learning_rate,
            )
        else:
            new_rate = state.learning_rate

        it = state.iteration
        tel = state.telemetry
        tel = SolveTelemetry(
            data_energy=tel.data_energy.at[it].set(energies.data),
            smoothing_energy=tel.smoothing_energy.at[it].set(energies.smoothing),
            level_set_energy=tel.level_set_energy.at[it].set(energies.level_set),
            max_warp_update=tel.max_warp_update.at[it].set(max_update),
            mean_warp_update=tel.mean_warp_update.at[it].set(mean_update),
        )
        return _LoopState(
            warp=new_warp,
            iteration=it + 1,
            max_update=max_update,
            learning_rate=new_rate,
            prev_energy=energy,
            telemetry=tel,
            max_disp=max_disp,
        )

    final = jax.lax.while_loop(cond, body, init)
    return SolveResult(
        warp=final.warp,
        iterations=final.iteration,
        converged=final.max_update < params.convergence_threshold,
        telemetry=final.telemetry,
        max_abs_displacement=jnp.maximum(
            final.max_disp, _axis_max_abs(final.warp)
        ),
    )
