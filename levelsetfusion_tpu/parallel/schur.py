"""Distributed warp solve with block-local inner iterations and a
Schur-complement-style reduction of the boundary (interface) unknowns —
the BASELINE north_star's mandated distributed structure ("solve the
distributed warp-field update via block-local iterations with
Schur-complement-style reduction of boundary unknowns across hosts").

Formulation
-----------

The volume is partitioned into contiguous voxel blocks along axis 0, one per
device. Write the warp unknowns as ``u = (u_I, u_Γ)``: interior unknowns per
block and the interface unknowns Γ (the two rows straddling each block cut).
One **outer step** is:

1. **Halo exchange** (1 neighbor ``ppermute`` round): each block receives 2
   fresh warp ghost rows per side — the only place neighbor state enters.
2. **Block-local inner iterations** (``T`` of them, ZERO collectives): plain
   gradient descent on the full energy restricted to the block, with the
   ghost rows *frozen* — an additive-Schwarz sweep. The Sobolev filter runs
   block-locally (zero ghosts). The resample reads the block's wide live
   halo, exchanged once per solve exactly as in ``parallel.sharded``.
3. **Interface reduction** (1 ``ppermute`` round): with the interiors held
   at their inner-iterated values (i.e. eliminated from the update system —
   the Schur reduction onto Γ), the update for each cut's row pair
   ``(u_L, u_R)`` solves the *implicit* coupled system

       (I + a·A₂) δ = d,      A₂ = [[2, −1], [−1, 2]],

   per voxel column and warp component, where ``d`` is the explicit descent
   direction ``−η·g`` each side computed locally, ``a = η·w_smooth·κ_c``
   is the smoothing operator's cut-coupling strength (κ_c = 1 for Tikhonov;
   (1+γ) + [c==0] for the damped Killing operator, whose ∇(∇·u) adds an
   extra ∂ₓₓ coupling on the x component), and A₂ is the interface block of
   the (negated) 1D second-difference operator — exactly what remains of
   the smoothing coupling across the cut after interior elimination. The
   2×2 solve is closed-form:

       δ_own = ((1+2a)·d_own + a·d_nbr) / ((1+2a)² − a²)

   Each side solves the same system redundantly from the exchanged edge
   directions, so no second round trip is needed. The explicit update the
   edge rows took in the last inner iteration is replaced by δ.
4. **Global reduction** (1 fused ``psum``/``pmax`` round): term energies and
   the max/mean warp-update statistics → outer convergence test (same
   criterion as the synchronous solver: global max per-voxel update below
   the threshold).

Fixed point
-----------

At a joint fixed point the halo exchange is a no-op and the raw gradient is
zero on every block *including* the rows adjacent to cuts (their gradient is
evaluated with the true neighbor values delivered in step 1), any linear
filter of it is zero, and δ solves (I+aA₂)δ = 0 ⇒ δ = 0 — i.e. the scheme's
fixed points are exactly the synchronous solver's stationary points. The
parity test asserts convergence to the synchronous fixed point within float
tolerance on smooth cases.

Collectives
-----------

Per outer step: 2 neighbor ppermute rounds + 1 fused psum/pmax round,
amortized over ``T`` inner iterations — vs the synchronous solver's
per-iteration warp-halo ppermute + Sobolev-halo ppermute + psum×3 + pmax.
``tests/test_schur.py`` counts the collective primitives in both solvers'
loop-body jaxprs and asserts the ≥T×/3-ish reduction; telemetry records
inner/outer iteration counts.

Why this solver is 1D
---------------------

The Schur reduction pays off where neighbor-exchange LATENCY, not bytes,
limits the sync solver: it cuts exchange rounds per unit of convergence
~T×, which matters when a round is long relative to per-iteration compute
(small shards, or a slow link). Along a second mesh axis
``parallel/schur2d`` composes this outer structure with sync inner
iterations. A full 2D Schur (both cut families reduced) would add a corner
system coupling the four blocks at each mesh vertex through the Killing
term's mixed ∂ₓ∂_y divergence coupling; it is not implemented.

Reference anchor: BASELINE.json north_star; SURVEY.md §5 long-context row.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from levelsetfusion_tpu.models.params import SolverParams
from levelsetfusion_tpu.models.single_level import _axis_max_abs
from levelsetfusion_tpu.ops import sobolev as sobolev_ops
from levelsetfusion_tpu.ops.gradient import SmoothingMode
from levelsetfusion_tpu.parallel.halo import (
    halo_exchange,
    pmax_axis,
    psum_axis,
)
from levelsetfusion_tpu.parallel.sharded import _block_gradient


# Neighbor-exchange (ppermute) rounds issued per outer step, by construction.
PPERMUTE_ROUNDS_PER_OUTER = 2  # warp halo + interface directions
REDUCTION_ROUNDS_PER_OUTER = 1  # fused psum/pmax for stats + termination


class SchurTelemetry(NamedTuple):
    """Per-OUTER-step log (entries past ``outer_steps`` are 0)."""

    data_energy: jnp.ndarray
    smoothing_energy: jnp.ndarray
    level_set_energy: jnp.ndarray
    max_warp_update: jnp.ndarray
    mean_warp_update: jnp.ndarray


class SchurResult(NamedTuple):
    warp: jnp.ndarray
    outer_steps: jnp.ndarray  # scalar int32
    inner_per_outer: int
    converged: jnp.ndarray
    telemetry: SchurTelemetry
    # Per-axis running max |u| over every warp any inner iteration resampled
    # with (pmax'd across shards) — the displacement-contract observable;
    # same semantics as SolveResult.max_abs_displacement so
    # utils.debug.check_displacement_contract covers this solver too.
    max_abs_displacement: jnp.ndarray | None = None

    @property
    def iterations(self):
        """Alias: telemetry rows are per OUTER step (logger/CLI compat)."""
        return self.outer_steps


@partial(
    jax.jit,
    static_argnames=(
        "params", "mesh", "axis_name", "live_halo", "inner_iterations",
    ),
)
def solve_single_level_schur(
    canonical: jnp.ndarray,
    live: jnp.ndarray,
    params: SolverParams = SolverParams(),
    *,
    mesh: Mesh,
    axis_name: str = "x",
    live_halo: int = 8,
    inner_iterations: int = 8,
    initial_warp: jnp.ndarray | None = None,
) -> SchurResult:
    """Schur-style distributed twin of ``solve_single_level_sharded``.

    ``params.max_iterations`` is the TOTAL inner-iteration budget; the outer
    loop runs at most ``ceil(max_iterations / inner_iterations)`` steps and
    terminates early once the global max warp update of an outer step's last
    inner iteration drops below ``params.convergence_threshold``.

    Adaptive learning-rate, if enabled, adapts once per outer step (on the
    globally reduced energy) — inner iterations see a constant rate.
    """
    nd = mesh.shape[axis_name]
    if canonical.shape[0] % nd:
        raise ValueError(
            f"axis 0 ({canonical.shape[0]}) must divide over {nd} devices"
        )
    n_local = canonical.shape[0] // nd
    live_halo = min(live_halo, n_local)
    min_halo = 3 if params.sobolev_smoothing else 2
    if n_local < min_halo:
        raise ValueError(
            f"local block of {n_local} rows too small for stencil halos"
        )
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

    t_inner = inner_iterations
    n_outer = -(-params.max_iterations // t_inner)
    num_voxels = float(canonical.size)

    # Interface coupling strength per warp component (see module docstring).
    gamma = params.rigidity_enforcement_factor
    if params.smoothing_mode is SmoothingMode.KILLING:
        kappa = [(1.0 + gamma) + (1.0 if c == 0 else 0.0) for c in range(d)]
    else:
        kappa = [1.0] * d
    w_s = params.smoothing_term_weight

    fwd = [(i, (i + 1) % nd) for i in range(nd)]
    bwd = [(i, (i - 1) % nd) for i in range(nd)]

    def run(canon_blk, live_blk, warp0_blk):
        live_ext = halo_exchange(
            live_blk, live_halo, axis_name, nd, fill="truncation"
        )
        idx = lax.axis_index(axis_name)

        zeros = jnp.zeros((n_outer,), canon_blk.dtype)
        init = (
            warp0_blk,
            jnp.zeros((), jnp.int32),  # outer step
            jnp.full((), jnp.inf, canon_blk.dtype),  # last global max update
            jnp.asarray(params.learning_rate, canon_blk.dtype),
            jnp.full((), jnp.inf, canon_blk.dtype),  # prev outer energy
            SchurTelemetry(zeros, zeros, zeros, zeros, zeros),
            jnp.zeros((d,), canon_blk.dtype),  # running per-axis max |u|
        )

        def cond(state):
            _, s, max_up, _, _, _, _ = state
            return (s < n_outer) & (max_up >= params.convergence_threshold)

        def outer_body(state):
            warp, s, _, rate, prev_e, tel, max_disp = state

            # (1) one warp halo exchange; ghosts stay frozen through the
            # inner sweep.
            warp_ext = halo_exchange(
                warp, 2, axis_name, nd, fill="replicate"
            )
            ghosts = (warp_ext[:2], warp_ext[-2:])

            # (2) block-local inner iterations — no collectives.
            def inner(_, carry):
                w, _, _, md = carry
                md = jnp.maximum(md, _axis_max_abs(w))
                # Neighbor ghosts stay frozen (that is the scheme), but
                # GLOBAL-boundary ghosts are locally computable: refresh
                # the replicate fill from the current edge row so the
                # one-sided global-edge forms track the iterate.
                lo = jnp.where(
                    idx == 0, jnp.broadcast_to(w[:1], ghosts[0].shape),
                    ghosts[0],
                )
                hi = jnp.where(
                    idx == nd - 1,
                    jnp.broadcast_to(w[-1:], ghosts[1].shape),
                    ghosts[1],
                )
                grad, energies = _block_gradient(
                    canon_blk, live_ext, w, params, kernel, axis_name,
                    nd, live_halo, warp_ghosts=(lo, hi), local_only=True,
                )
                direction = -rate * grad
                return (w + direction, direction, energies, md)

            dir0 = jnp.zeros_like(warp)
            e0 = (jnp.zeros((), canon_blk.dtype),) * 3
            warp, direction, (e_d, e_s, e_l), max_disp = lax.fori_loop(
                0, t_inner, inner, (warp, dir0, e0, max_disp)
            )

            # (3) interface reduction: exchange edge directions (one
            # ppermute round), solve the per-cut implicit 2×2 system, and
            # replace the edge rows' last explicit update with δ.
            d_first = direction[:1]
            d_last = direction[-1:]
            if nd == 1:
                # No cuts on a mesh-of-1 axis: the interface solve is
                # bypassed below (idx==0 and idx==nd-1 both hold), so skip
                # the self-ppermute round entirely.
                nbr_last, nbr_first = d_last, d_first
            else:
                nbr_last = lax.ppermute(d_last, axis_name, fwd)
                nbr_first = lax.ppermute(d_first, axis_name, bwd)

            def solve2(d_own, d_nbr):
                # per-component closed-form (I + a·A₂)⁻¹ applied to (d_own,
                # d_nbr), returning δ_own.
                parts = []
                for c in range(d):
                    a = rate * w_s * kappa[c]
                    det = (1.0 + 2.0 * a) ** 2 - a * a
                    parts.append(
                        ((1.0 + 2.0 * a) * d_own[..., c] + a * d_nbr[..., c])
                        / det
                    )
                return jnp.stack(parts, axis=-1)

            delta_first = solve2(d_first, nbr_last)
            delta_last = solve2(d_last, nbr_first)
            # Global edges have no cut: keep the explicit update there.
            delta_first = jnp.where(idx == 0, d_first, delta_first)
            delta_last = jnp.where(idx == nd - 1, d_last, delta_last)
            warp = warp.at[:1].add(delta_first - d_first)
            warp = warp.at[-1:].add(delta_last - d_last)
            direction = direction.at[:1].set(delta_first)
            direction = direction.at[-1:].set(delta_last)

            # (4) one fused global reduction: energies + update stats.
            ulen = jnp.sqrt(jnp.sum(direction * direction, axis=-1))
            max_up = pmax_axis(jnp.max(ulen), axis_name, nd)
            mean_up = psum_axis(jnp.sum(ulen), axis_name, nd) / num_voxels
            e_d = psum_axis(e_d, axis_name, nd)
            e_s = psum_axis(e_s, axis_name, nd)
            e_l = psum_axis(e_l, axis_name, nd)

            energy = e_d + e_s + e_l
            if params.adaptive_learning_rate:
                rate = jnp.where(energy > prev_e, rate * 0.5, rate)

            tel = SchurTelemetry(
                data_energy=tel.data_energy.at[s].set(e_d),
                smoothing_energy=tel.smoothing_energy.at[s].set(e_s),
                level_set_energy=tel.level_set_energy.at[s].set(e_l),
                max_warp_update=tel.max_warp_update.at[s].set(max_up),
                mean_warp_update=tel.mean_warp_update.at[s].set(mean_up),
            )
            return (warp, s + 1, max_up, rate, energy, tel, max_disp)

        warp, s, max_up, _, _, tel, max_disp = lax.while_loop(
            cond, outer_body, init
        )
        max_disp = pmax_axis(
            jnp.maximum(max_disp, _axis_max_abs(warp)), axis_name, nd
        )
        return warp, s, max_up < params.convergence_threshold, tel, max_disp

    spec = P(axis_name)
    rep = P()
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(
            spec,
            rep,
            rep,
            SchurTelemetry(rep, rep, rep, rep, rep),
            rep,
        ),
        check_vma=False,
    )
    warp, outer_steps, converged, telemetry, max_disp = fn(
        canonical, live, initial_warp
    )
    return SchurResult(
        warp=warp,
        outer_steps=outer_steps,
        inner_per_outer=t_inner,
        converged=converged,
        telemetry=telemetry,
        max_abs_displacement=max_disp,
    )
