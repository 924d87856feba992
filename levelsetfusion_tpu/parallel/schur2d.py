"""Schur-outer × sync-inner warp solve on a 2D mesh — the 1D Schur
solver's outer structure (``parallel/schur.py``) along mesh axis 0,
composed with sync inner iterations along mesh axis 1.

Structure
---------

The volume shards over BOTH spatial axes 0 and 1 (true voxel blocks, as
``parallel/sharded2d``). Mesh axis 0 is the axis whose exchange rounds the
composition economises (the "slow" axis); mesh axis 1 runs the ordinary
sync structure. One **outer step** is:

1. **Axis-0 warp halo exchange** (1 axis-0 ``ppermute`` round): each
   block receives 2 frozen ghost x-rows per side — the only place axis-0
   neighbor state enters the sweep.
2. **T sync inner iterations**: plain gradient descent on the energy
   restricted to the block row, with the x ghosts *frozen* (additive
   Schwarz along axis 0) but the y ghosts exchanged LIVE every iteration
   (1 axis-1 ``ppermute`` round each — the ordinary sync structure of
   ``parallel/sharded2d``). The Sobolev filter runs block-locally in x
   (zero-padded at x block edges — exact at the fixed point, as the 1D
   Schur solver) and globally in y (zero-filled halo exchange, exact).
3. **Axis-0 interface reduction** (1 axis-0 ``ppermute`` round): the
   per-cut implicit 2×2 system of ``parallel/schur.py`` — the closed-form
   Schur reduction of the smoothing operator's cut coupling onto the two
   rows straddling each x cut:

       δ_own = ((1+2a)·d_own + a·d_nbr) / ((1+2a)² − a²),
       a = η·w_smooth·κ_c   (κ_c as in parallel/schur.py)

   applied per y-column and warp component; the edge rows' last explicit
   update is replaced by δ. Global x edges keep the explicit update.
4. **Global reduction** (1 fused ``psum``/``pmax`` round over BOTH axes):
   term energies + warp-update stats → outer convergence test.

Fixed point: at a joint fixed point the x halo exchange is a no-op, every
inner iteration sees zero gradient everywhere (y ghosts are live, x ghosts
refreshed at global edges), any linear filter of zero is zero, and
δ solves (I+aA₂)δ = 0 ⇒ δ = 0 — the composition's fixed points are exactly
the synchronous 2D solver's stationary points. ``tests/test_schur2d.py``
asserts convergence to the sync-2D fixed point at matched termination.

Collectives per outer step:

    axis 0:  2 ppermute rounds + 1 reduction round, amortized /T
    axis 1:  T ppermute rounds (one per inner iteration)

vs the sync 2D solver's T axis-0 ppermute rounds + T reductions for the
same T iterations. ``parallel/scaling.py::predict_efficiency_2d`` prices
both structures with per-axis link parameters.

Reference anchor: BASELINE.json north_star; SURVEY.md §5 long-context row.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from levelsetfusion_tpu.models.params import SolverParams
from levelsetfusion_tpu.models.single_level import _axis_max_abs
from levelsetfusion_tpu.ops import sobolev as sobolev_ops
from levelsetfusion_tpu.ops.derivatives import _diff_axis, _second_diff_axis
from levelsetfusion_tpu.ops.gradient import SmoothingMode
from levelsetfusion_tpu.ops.interpolation import sample_at
from levelsetfusion_tpu.ops.terms import TRUNCATION_EPS
from levelsetfusion_tpu.parallel.halo import (
    convolve_zero_edges,
    d_edge_fixed,
    halo_exchange,
    pmax_axis,
    psum_axis,
    second_diff,
)
from levelsetfusion_tpu.parallel.schur import SchurResult, SchurTelemetry
from levelsetfusion_tpu.parallel.sharded2d import (
    _band_mask,
    _crop,
    _replicate_global_ghosts,
)


@partial(
    jax.jit,
    static_argnames=(
        "params", "mesh", "axis_names", "live_halo", "inner_iterations",
    ),
)
def solve_single_level_schur2d(
    canonical: jnp.ndarray,
    live: jnp.ndarray,
    params: SolverParams = SolverParams(),
    *,
    mesh: Mesh,
    axis_names: tuple = ("x", "y"),
    live_halo: int = 8,
    inner_iterations: int = 8,
    initial_warp: jnp.ndarray | None = None,
) -> SchurResult:
    """Schur-outer (mesh axis 0) × sync-inner (mesh axis 1) warp solve.

    ``params.max_iterations`` is the TOTAL inner-iteration budget; the
    outer loop runs at most ``ceil(max_iterations / inner_iterations)``
    steps and terminates once the global max warp update of an outer
    step's last inner iteration drops below the threshold. The adaptive
    learning rate (if enabled) adapts once per outer step on the globally
    reduced energy.
    """
    an0, an1 = axis_names
    nd0, nd1 = mesh.shape[an0], mesh.shape[an1]
    if canonical.ndim < 3:
        raise ValueError("schur2d shards 3D+ volumes over a 2D mesh")
    if canonical.shape[0] % nd0 or canonical.shape[1] % nd1:
        raise ValueError(
            f"axes 0/1 {canonical.shape[:2]} must divide over mesh "
            f"{nd0}x{nd1}"
        )
    n0 = canonical.shape[0] // nd0
    n1 = canonical.shape[1] // nd1
    live_halo = min(live_halo, n0, n1)
    min_halo = 3 if params.sobolev_smoothing else 2
    if n0 < min_halo or n1 < min_halo:
        raise ValueError(f"local block {n0}x{n1} too small for stencils")
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

    # Interface coupling per warp component (see parallel/schur.py): the
    # cuts are along spatial axis 0, so the Killing operator's ∇(∇·u) adds
    # its extra ∂₀₀ coupling on component 0.
    gamma = params.rigidity_enforcement_factor
    if params.smoothing_mode is SmoothingMode.KILLING:
        kappa = [(1.0 + gamma) + (1.0 if c == 0 else 0.0) for c in range(d)]
    else:
        kappa = [1.0] * d
    w_s = params.smoothing_term_weight

    fwd0 = [(i, (i + 1) % nd0) for i in range(nd0)]
    bwd0 = [(i, (i - 1) % nd0) for i in range(nd0)]

    def run(canon_blk, live_blk, warp0_blk):
        idx0 = lax.axis_index(an0)
        idx1 = lax.axis_index(an1)
        start0 = idx0 * n0
        start1 = idx1 * n1

        # Live field: one wide two-axis halo exchange per solve
        # (sequential — corners come from the diagonal neighbor).
        live_ext = halo_exchange(
            live_blk, live_halo, an0, nd0, fill="truncation", axis=0
        )
        live_ext = halo_exchange(
            live_ext, live_halo, an1, nd1, fill="truncation", axis=1
        )

        def gradient(warp, x_ghosts):
            """Energy gradient on the block: axis-0 stencils use the FROZEN
            x ghosts (with the global-edge replicate refreshed from the
            live iterate, matching the single-device edge conventions),
            axis-1 stencils exchange live y ghosts — one axis-1 round."""
            lo2, hi2 = x_ghosts
            lo2 = jnp.where(
                idx0 == 0, jnp.broadcast_to(warp[:1], lo2.shape), lo2
            )
            hi2 = jnp.where(
                idx0 == nd0 - 1,
                jnp.broadcast_to(warp[-1:], hi2.shape),
                hi2,
            )
            warp_x = jnp.concatenate([lo2, warp, hi2], axis=0)
            # The ONE live axis-1 exchange of the iteration (the x-ghost
            # rows ride along so corners stay consistent).
            warp_ext = halo_exchange(
                warp_x, 2, an1, nd1, fill="replicate", axis=1
            )

            # ---- warped live on block + 2 ghosts per axis ----------------
            shape_ext = (n0 + 4, n1 + 4) + canon_blk.shape[2:]
            pos0 = (
                start0 - 2
                + lax.broadcasted_iota(jnp.int32, shape_ext, 0)
            ).astype(warp.dtype)
            pos1 = (
                start1 - 2
                + lax.broadcasted_iota(jnp.int32, shape_ext, 1)
            ).astype(warp.dtype)
            coords = [
                pos0 - (start0 - live_halo) + warp_ext[..., 0],
                pos1 - (start1 - live_halo) + warp_ext[..., 1],
            ]
            for ax in range(2, d):
                ident = lax.broadcasted_iota(
                    jnp.int32, shape_ext, ax
                ).astype(warp.dtype)
                coords.append(ident + warp_ext[..., ax])
            we = sample_at(live_ext, jnp.stack(coords, axis=-1))
            we = _replicate_global_ghosts(we, 2, an0, nd0, axis=0)
            we = _replicate_global_ghosts(we, 2, an1, nd1, axis=1)
            warped = _crop(we, 2, 2)

            # ---- data term ----------------------------------------------
            g0_e = d_edge_fixed(we, 2, an0, nd0, axis=0)  # ghosts (1, 2)
            g1_e = d_edge_fixed(we, 2, an1, nd1, axis=1)  # ghosts (2, 1)
            g2_e = _diff_axis(we, 2)  # ghosts (2, 2)
            warped_grad = jnp.stack(
                [_crop(g0_e, 1, 2), _crop(g1_e, 2, 1), _crop(g2_e, 2, 2)],
                axis=-1,
            )
            diff = warped - canon_blk
            if params.band_union_only:
                diff = jnp.where(_band_mask(canon_blk, warped), diff, 0.0)
            total = params.data_term_weight * (diff[..., None] * warped_grad)
            e_data = params.data_term_weight * 0.5 * jnp.sum(diff * diff)

            # ---- smoothing term -----------------------------------------
            if params.smoothing_term_weight != 0.0:
                u = [warp_ext[..., c] for c in range(d)]
                lap_parts = []
                jac_cols = []
                for c in range(d):
                    l0 = second_diff(_crop(u[c], 1, 2), axis=0)
                    l1 = second_diff(_crop(u[c], 2, 1), axis=1)
                    lc = l0 + l1
                    for ax in range(2, d):
                        lc = lc + _second_diff_axis(_crop(u[c], 2, 2), ax)
                    lap_parts.append(lc)
                    jc = [
                        _crop(d_edge_fixed(u[c], 2, an0, nd0, axis=0), 1, 2),
                        _crop(d_edge_fixed(u[c], 2, an1, nd1, axis=1), 2, 1),
                    ] + [
                        _diff_axis(_crop(u[c], 2, 2), ax)
                        for ax in range(2, d)
                    ]
                    jac_cols.append(jnp.stack(jc, axis=-1))
                lap = jnp.stack(lap_parts, axis=-1)
                jac = jnp.stack(jac_cols, axis=-2)

                if params.smoothing_mode is SmoothingMode.TIKHONOV:
                    g_smooth = -lap
                    e_smooth = 0.5 * jnp.sum(jac * jac)
                else:
                    div_e = (
                        _crop(d_edge_fixed(u[0], 2, an0, nd0, axis=0), 0, 1)
                        + _crop(d_edge_fixed(u[1], 2, an1, nd1, axis=1), 1, 0)
                    )
                    for ax in range(2, d):
                        div_e = div_e + _diff_axis(_crop(u[ax], 1, 1), ax)
                    gdiv = jnp.stack(
                        [
                            _crop(
                                d_edge_fixed(div_e, 1, an0, nd0, axis=0),
                                0, 1,
                            ),
                            _crop(
                                d_edge_fixed(div_e, 1, an1, nd1, axis=1),
                                1, 0,
                            ),
                        ]
                        + [
                            _diff_axis(_crop(div_e, 1, 1), ax)
                            for ax in range(2, d)
                        ],
                        axis=-1,
                    )
                    g_smooth = -(1.0 + gamma) * lap - gdiv
                    sym = jac + jnp.swapaxes(jac, -1, -2)
                    e_smooth = 0.5 * (
                        0.5 * jnp.sum(sym * sym)
                        + gamma * jnp.sum(jac * jac)
                    )
                total = total + params.smoothing_term_weight * g_smooth
                e_smooth = params.smoothing_term_weight * e_smooth
            else:
                e_smooth = jnp.zeros((), canon_blk.dtype)

            # ---- level-set term -----------------------------------------
            if params.level_set_term_weight != 0.0:
                h_rows = [
                    jnp.stack(
                        [
                            _crop(
                                d_edge_fixed(g0_e, 1, an0, nd0, axis=0),
                                0, 2,
                            ),
                            _crop(
                                d_edge_fixed(g0_e, 2, an1, nd1, axis=1),
                                1, 1,
                            ),
                            _crop(_diff_axis(g0_e, 2), 1, 2),
                        ],
                        axis=-1,
                    ),
                    jnp.stack(
                        [
                            _crop(
                                d_edge_fixed(g1_e, 2, an0, nd0, axis=0),
                                1, 1,
                            ),
                            _crop(
                                d_edge_fixed(g1_e, 1, an1, nd1, axis=1),
                                2, 0,
                            ),
                            _crop(_diff_axis(g1_e, 2), 2, 1),
                        ],
                        axis=-1,
                    ),
                    jnp.stack(
                        [
                            _crop(
                                d_edge_fixed(g2_e, 2, an0, nd0, axis=0),
                                1, 2,
                            ),
                            _crop(
                                d_edge_fixed(g2_e, 2, an1, nd1, axis=1),
                                2, 1,
                            ),
                            _crop(_diff_axis(g2_e, 2), 2, 2),
                        ],
                        axis=-1,
                    ),
                ]
                hess = jnp.stack(h_rows, axis=-2)
                g = warped_grad
                norm = jnp.sqrt(jnp.sum(g * g, axis=-1))
                scale = (norm - 1.0) / (norm + 1e-5)
                if params.band_union_only:
                    mask = _band_mask(canon_blk, warped)
                    scale = jnp.where(mask, scale, 0.0)
                    e_terms = jnp.where(mask, (norm - 1.0) ** 2, 0.0)
                else:
                    e_terms = (norm - 1.0) ** 2
                g_ls = scale[..., None] * jnp.sum(
                    hess * g[..., None, :], axis=-1
                )
                total = total + params.level_set_term_weight * g_ls
                e_ls = params.level_set_term_weight * 0.5 * jnp.sum(e_terms)
            else:
                e_ls = jnp.zeros((), canon_blk.dtype)

            # ---- Sobolev: block-local in x, global (sync) in y ----------
            if kernel is not None:
                total = sobolev_ops._convolve_axis(total, kernel, 0)
                total = convolve_zero_edges(
                    total, kernel, an1, nd1, axis=1
                )
                for ax in range(2, d):
                    total = sobolev_ops._convolve_axis(total, kernel, ax)

            return total, (e_data, e_smooth, e_ls)

        zeros = jnp.zeros((n_outer,), canon_blk.dtype)
        init = (
            warp0_blk,
            jnp.zeros((), jnp.int32),
            jnp.full((), jnp.inf, canon_blk.dtype),
            jnp.asarray(params.learning_rate, canon_blk.dtype),
            jnp.full((), jnp.inf, canon_blk.dtype),
            SchurTelemetry(zeros, zeros, zeros, zeros, zeros),
            jnp.zeros((d,), canon_blk.dtype),
        )

        def cond(state):
            _, s, max_up, _, _, _, _ = state
            return (s < n_outer) & (max_up >= params.convergence_threshold)

        def outer_body(state):
            warp, s, _, rate, prev_e, tel, max_disp = state

            # (1) ONE axis-0 round: the frozen x ghost rows.
            warp_x = halo_exchange(warp, 2, an0, nd0, fill="replicate")
            x_ghosts = (warp_x[:2], warp_x[-2:])

            # (2) sync inner sweep: one axis-1 round per iteration,
            # zero axis-0 collectives.
            def inner(_, carry):
                w, _, _, md = carry
                md = jnp.maximum(md, _axis_max_abs(w))
                grad, energies = gradient(w, x_ghosts)
                direction = -rate * grad
                return (w + direction, direction, energies, md)

            dir0 = jnp.zeros_like(warp)
            e0 = (jnp.zeros((), canon_blk.dtype),) * 3
            warp, direction, (e_d, e_s, e_l), max_disp = lax.fori_loop(
                0, t_inner, inner, (warp, dir0, e0, max_disp)
            )

            # (3) axis-0 interface reduction (1 round): closed-form
            # 2×2 solve per x cut (see parallel/schur.py).
            d_first = direction[:1]
            d_last = direction[-1:]
            if nd0 == 1:
                nbr_last, nbr_first = d_last, d_first
            else:
                nbr_last = lax.ppermute(d_last, an0, fwd0)
                nbr_first = lax.ppermute(d_first, an0, bwd0)

            def solve2(d_own, d_nbr):
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
            delta_first = jnp.where(idx0 == 0, d_first, delta_first)
            delta_last = jnp.where(idx0 == nd0 - 1, d_last, delta_last)
            warp = warp.at[:1].add(delta_first - d_first)
            warp = warp.at[-1:].add(delta_last - d_last)
            direction = direction.at[:1].set(delta_first)
            direction = direction.at[-1:].set(delta_last)

            # (4) ONE fused global reduction over both axes.
            ulen = jnp.sqrt(jnp.sum(direction * direction, axis=-1))
            max_up = pmax_axis(
                pmax_axis(jnp.max(ulen), an0, nd0), an1, nd1
            )
            mean_up = (
                psum_axis(
                    psum_axis(jnp.sum(ulen), an0, nd0), an1, nd1
                )
                / num_voxels
            )
            e_d = psum_axis(psum_axis(e_d, an0, nd0), an1, nd1)
            e_s = psum_axis(psum_axis(e_s, an0, nd0), an1, nd1)
            e_l = psum_axis(psum_axis(e_l, an0, nd0), an1, nd1)

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
            pmax_axis(
                jnp.maximum(max_disp, _axis_max_abs(warp)),
                an0, nd0,
            ),
            an1, nd1,
        )
        return warp, s, max_up < params.convergence_threshold, tel, max_disp

    spec = P(an0, an1)
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
