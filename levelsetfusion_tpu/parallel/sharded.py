"""Distributed warp solve over voxel-block shards (BASELINE config 5).

``solve_single_level_sharded`` runs the exact semantics of
``models.single_level.solve_single_level`` with the volume partitioned into
contiguous voxel blocks along spatial axis 0 across a 1D device mesh:

- The **live** field is exchanged once per solve with a wide halo
  (``live_halo`` rows, +1-filled at the global boundary): the live field is
  constant during a solve, so the per-iteration warp resample can gather
  from the local haloed copy as long as per-voxel displacements stay within
  ``live_halo - 2`` rows of a block edge. Hierarchical solving keeps
  displacements small at fine (sharded) levels; the coarse levels that absorb
  large motion are tiny and run replicated.
- Per iteration, only the **warp** (2 ghost rows, ``ppermute``) and — when
  Sobolev filtering is on — the **combined gradient** (kernel-radius ghost
  rows) are exchanged. Stencils at global boundaries reproduce the
  single-device edge conventions exactly (see ``parallel.halo``).
- Termination and telemetry use ``pmax``/``psum`` inside the on-device
  ``while_loop`` — global max-warp-update semantics identical to the
  single-device solver, which the parity tests assert to float tolerance.

This is the hand-rolled halo path. ``parallel.mesh.solve_single_level_auto``
offers the GSPMD alternative (jit + sharding annotations, XLA inserts the
collectives); both
solve BASELINE config 5's "voxel-block partitioning, halo exchange,
distributed warp solve".
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
from levelsetfusion_tpu.models.single_level import (
    SolveResult,
    SolveTelemetry,
    _axis_max_abs,
)
from levelsetfusion_tpu.ops import sobolev as sobolev_ops
from levelsetfusion_tpu.ops.derivatives import _diff_axis, _second_diff_axis
from levelsetfusion_tpu.ops.gradient import SmoothingMode
from levelsetfusion_tpu.ops.interpolation import sample_at
from levelsetfusion_tpu.ops.terms import TRUNCATION_EPS
from levelsetfusion_tpu.parallel.halo import (
    convolve0_zero_edges,
    d0_edge_fixed,
    halo_exchange,
    pmax_axis,
    psum_axis,
    second_diff0,
)


def _replicate_global_ghosts(x_ext, halo, axis_name, num_devices):
    """Overwrite out-of-domain ghost rows with the global edge row."""
    idx = lax.axis_index(axis_name)
    m = x_ext.shape[0]
    rows = lax.broadcasted_iota(jnp.int32, (m,) + (1,) * (x_ext.ndim - 1), 0)
    start_row = lax.dynamic_slice_in_dim(x_ext, halo, 1, axis=0)
    end_row = lax.dynamic_slice_in_dim(x_ext, m - halo - 1, 1, axis=0)
    x_ext = jnp.where((idx == 0) & (rows < halo), start_row, x_ext)
    x_ext = jnp.where(
        (idx == num_devices - 1) & (rows >= m - halo), end_row, x_ext
    )
    return x_ext


def _band_mask(canonical, warped):
    return (jnp.abs(canonical) < 1.0 - TRUNCATION_EPS) | (
        jnp.abs(warped) < 1.0 - TRUNCATION_EPS
    )


def _block_gradient(
    canon_blk,
    live_ext,
    warp,
    params: SolverParams,
    kernel,
    axis_name: str,
    nd: int,
    live_halo: int,
    warp_ghosts=None,
    local_only=False,
    reduce_energies=True,
):
    """Combined energy gradient + energies on one voxel block.

    Mirrors ops.gradient.warp_energy_gradient term by term; every axis-0
    stencil goes through the halo-exact primitives, other axes use the
    ordinary single-device ops (they are unsharded).

    ``warp_ghosts``: optional ``(lo2, hi2)`` frozen ghost rows — used by the
    Schur solver's block-local inner iterations instead of a live
    ``ppermute`` exchange. ``local_only``: skip every collective (the Sobolev
    filter zero-pads at block edges, energies return unreduced) — the
    caller reduces once per outer step.
    """
    d = warp.shape[-1]
    n = warp.shape[0]
    idx = lax.axis_index(axis_name)
    start = idx * n

    # ---- warped live on block + 2 ghost rows --------------------------------
    if warp_ghosts is not None:
        lo2, hi2 = warp_ghosts
        warp_ext = jnp.concatenate([lo2, warp, hi2], axis=0)
    else:
        warp_ext = halo_exchange(warp, 2, axis_name, nd, fill="replicate")
    m = n + 4
    shape_ext = (m,) + canon_blk.shape[1:]
    pos0 = (
        start
        - 2
        + lax.broadcasted_iota(jnp.int32, shape_ext, 0)
    ).astype(warp.dtype)
    coords = [pos0 - (start - live_halo) + warp_ext[..., 0]]
    for ax in range(1, d):
        ident = lax.broadcasted_iota(jnp.int32, shape_ext, ax).astype(
            warp.dtype
        )
        coords.append(ident + warp_ext[..., ax])
    warped_ext = sample_at(live_ext, jnp.stack(coords, axis=-1))
    warped_ext = _replicate_global_ghosts(warped_ext, 2, axis_name, nd)
    warped = warped_ext[2:-2]

    # ---- data term ----------------------------------------------------------
    g0_ext = d0_edge_fixed(warped_ext, 2, axis_name, nd)  # n+2 rows, 1 ghost
    grads = [g0_ext[1:-1]] + [_diff_axis(warped, ax) for ax in range(1, d)]
    warped_grad = jnp.stack(grads, axis=-1)

    diff = warped - canon_blk
    if params.band_union_only:
        diff = jnp.where(_band_mask(canon_blk, warped), diff, 0.0)
    total = params.data_term_weight * (diff[..., None] * warped_grad)
    e_data = params.data_term_weight * 0.5 * jnp.sum(diff * diff)

    # ---- smoothing term -----------------------------------------------------
    if params.smoothing_term_weight != 0.0:
        lap = second_diff0(warp_ext[1:-1])
        for ax in range(1, d):
            lap = lap + _second_diff_axis(warp, ax)

        jac_cols = []
        for c in range(d):
            jc0 = d0_edge_fixed(warp_ext[..., c], 2, axis_name, nd)[1:-1]
            jc = [jc0] + [_diff_axis(warp[..., c], ax) for ax in range(1, d)]
            jac_cols.append(jnp.stack(jc, axis=-1))
        jac = jnp.stack(jac_cols, axis=-2)  # (*local, c, ax)

        if params.smoothing_mode is SmoothingMode.TIKHONOV:
            g_smooth = -lap
            e_smooth = 0.5 * jnp.sum(jac * jac)
        else:
            gamma = params.rigidity_enforcement_factor
            div_ext = d0_edge_fixed(warp_ext[..., 0], 2, axis_name, nd)
            for ax in range(1, d):
                div_ext = div_ext + _diff_axis(warp_ext[1:-1][..., ax], ax)
            gdiv = [d0_edge_fixed(div_ext, 1, axis_name, nd)] + [
                _diff_axis(div_ext[1:-1], ax) for ax in range(1, d)
            ]
            gdiv = jnp.stack(gdiv, axis=-1)
            g_smooth = -(1.0 + gamma) * lap - gdiv
            sym = jac + jnp.swapaxes(jac, -1, -2)
            e_smooth = 0.5 * (
                0.5 * jnp.sum(sym * sym) + gamma * jnp.sum(jac * jac)
            )
        total = total + params.smoothing_term_weight * g_smooth
        e_smooth = params.smoothing_term_weight * e_smooth
    else:
        e_smooth = jnp.zeros((), canon_blk.dtype)

    # ---- level-set term -----------------------------------------------------
    if params.level_set_term_weight != 0.0:
        # Hessian rows H[i, j] = d_j(d_i Φw), np.gradient composition.
        hess_rows = []
        # i = 0: reuse g0_ext (1 ghost row, global ghosts fixed).
        h00 = d0_edge_fixed(g0_ext, 1, axis_name, nd)
        h0 = [h00] + [_diff_axis(g0_ext[1:-1], ax) for ax in range(1, d)]
        hess_rows.append(jnp.stack(h0, axis=-1))
        for i in range(1, d):
            di_ext = _diff_axis(warped_ext, i)  # local-axis diff on ext rows
            hi0 = d0_edge_fixed(di_ext, 2, axis_name, nd)[1:-1]
            hi = [hi0] + [
                _diff_axis(di_ext[2:-2], ax) for ax in range(1, d)
            ]
            hess_rows.append(jnp.stack(hi, axis=-1))
        hess = jnp.stack(hess_rows, axis=-2)  # (*local, i, j)

        g = warped_grad
        norm = jnp.sqrt(jnp.sum(g * g, axis=-1))
        scale = (norm - 1.0) / (norm + 1e-5)
        if params.band_union_only:
            mask = _band_mask(canon_blk, warped)
            scale = jnp.where(mask, scale, 0.0)
            e_terms = jnp.where(mask, (norm - 1.0) ** 2, 0.0)
        else:
            e_terms = (norm - 1.0) ** 2
        g_ls = scale[..., None] * jnp.sum(hess * g[..., None, :], axis=-1)
        total = total + params.level_set_term_weight * g_ls
        e_ls = params.level_set_term_weight * 0.5 * jnp.sum(e_terms)
    else:
        e_ls = jnp.zeros((), canon_blk.dtype)

    # ---- Sobolev filtering --------------------------------------------------
    if kernel is not None:
        if local_only:
            # Block-local filter: zero padding at the block edges (exact at
            # the fixed point, where the raw gradient is zero everywhere).
            total = sobolev_ops._convolve_axis(total, kernel, 0)
        else:
            total = convolve0_zero_edges(total, kernel, axis_name, nd)
        for ax in range(1, d):
            total = sobolev_ops._convolve_axis(total, kernel, ax)

    if local_only or not reduce_energies:
        return total, (e_data, e_smooth, e_ls)
    energies = (
        lax.psum(e_data, axis_name),
        lax.psum(e_smooth, axis_name),
        lax.psum(e_ls, axis_name),
    )
    return total, energies


@partial(jax.jit, static_argnames=("mesh", "axis_name", "live_halo"))
def warp_field_sharded(
    live: jnp.ndarray,
    warp: jnp.ndarray,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    live_halo: int = 8,
) -> jnp.ndarray:
    """Resample ``live`` at ``x + warp(x)`` with both arrays voxel-block
    sharded along axis 0 — the fusion step's gather, done with one explicit
    halo exchange instead of a partitioner-chosen all-gather.

    Same contract as the sharded solver: per-voxel axis-0 displacements
    beyond ``live_halo`` read the +1 truncation fill.
    """
    nd = mesh.shape[axis_name]
    if live.shape[0] % nd:
        raise ValueError(
            f"axis 0 ({live.shape[0]}) must divide over {nd} devices"
        )
    n_local = live.shape[0] // nd
    lh = min(live_halo, n_local)
    d = live.ndim

    def run(live_blk, warp_blk):
        live_ext = halo_exchange(
            live_blk, lh, axis_name, nd, fill="truncation"
        )
        shape = live_blk.shape
        # Coordinates in the extended frame: local row i sits at ext row
        # i + lh; global out-of-bounds beyond the halo hits sample_at's fill.
        coords = [
            lax.broadcasted_iota(jnp.int32, shape, 0).astype(warp_blk.dtype)
            + lh
            + warp_blk[..., 0]
        ]
        for ax in range(1, d):
            ident = lax.broadcasted_iota(jnp.int32, shape, ax).astype(
                warp_blk.dtype
            )
            coords.append(ident + warp_blk[..., ax])
        return sample_at(live_ext, jnp.stack(coords, axis=-1))

    spec = P(axis_name)
    fn = shard_map(
        run, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False,
    )
    return fn(live, warp)


@partial(
    jax.jit,
    static_argnames=("params", "mesh", "axis_name", "live_halo"),
)
def solve_single_level_sharded(
    canonical: jnp.ndarray,
    live: jnp.ndarray,
    params: SolverParams = SolverParams(),
    *,
    mesh: Mesh,
    axis_name: str = "x",
    live_halo: int = 8,
    initial_warp: jnp.ndarray | None = None,
) -> SolveResult:
    """Sharded twin of ``solve_single_level`` (see module docstring)."""
    nd = mesh.shape[axis_name]
    if canonical.shape[0] % nd:
        raise ValueError(
            f"axis 0 ({canonical.shape[0]}) must divide over {nd} devices"
        )
    n_local = canonical.shape[0] // nd
    # Neighbor-only ppermute halos cannot exceed one block.
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

    # Termination-check amortization (VERDICT r4 next #2b): the loop runs
    # in rounds of k iterations with ZERO reduction collectives inside a
    # round; the fused psum/pmax termination round fires once per round.
    # k = 1 reproduces the exact per-iteration semantics; k > 1 may run up
    # to k−1 iterations past the gate and rounds max_iterations up to a
    # multiple of k. Telemetry stays exact for any k (see post-loop
    # reduction below).
    k_int = max(1, params.termination_check_interval)
    n_rounds = -(-params.max_iterations // k_int)
    n_iter = n_rounds * k_int
    num_voxels = float(canonical.size)

    def run(canon_blk, live_blk, warp0_blk):
        live_ext = halo_exchange(
            live_blk, live_halo, axis_name, nd, fill="truncation"
        )
        zeros = jnp.zeros((n_iter,), canon_blk.dtype)
        init = (
            warp0_blk,
            jnp.zeros((), jnp.int32),
            jnp.full((), jnp.inf, canon_blk.dtype),
            jnp.asarray(params.learning_rate, canon_blk.dtype),
            jnp.full((), jnp.inf, canon_blk.dtype),
            SolveTelemetry(zeros, zeros, zeros, zeros, zeros),
            jnp.zeros((d,), canon_blk.dtype),
        )

        def cond(state):
            _, it, max_up, _, _, _, _ = state
            return (it < n_iter) & (max_up >= params.convergence_threshold)

        def one_iteration(j, carry):
            """One solver iteration with NO reduction collectives: telemetry
            entries get the LOCAL per-shard values (reduced exactly, once,
            after the loop); the chunk's last local stats feed the round's
            single fused reduction."""
            warp, it, rate, tel, max_disp, _ = carry
            max_disp = jnp.maximum(max_disp, _axis_max_abs(warp))
            grad, (e_data, e_smooth, e_ls) = _block_gradient(
                canon_blk, live_ext, warp, params, kernel, axis_name, nd,
                live_halo, reduce_energies=False,
            )
            update = -rate * grad
            new_warp = warp + update
            ulen = jnp.sqrt(jnp.sum(update * update, axis=-1))
            max_up_l = jnp.max(ulen)
            sum_up_l = jnp.sum(ulen)

            tel = SolveTelemetry(
                data_energy=tel.data_energy.at[it].set(e_data),
                smoothing_energy=tel.smoothing_energy.at[it].set(e_smooth),
                level_set_energy=tel.level_set_energy.at[it].set(e_ls),
                max_warp_update=tel.max_warp_update.at[it].set(max_up_l),
                mean_warp_update=tel.mean_warp_update.at[it].set(sum_up_l),
            )
            locals_ = (e_data + e_smooth + e_ls, max_up_l)
            return (new_warp, it + 1, rate, tel, max_disp, locals_)

        def round_body(state):
            warp, it, _, rate, prev_e, tel, max_disp = state
            zero = jnp.zeros((), canon_blk.dtype)
            warp, it, rate, tel, max_disp, (e_loc, max_up_l) = lax.fori_loop(
                0, k_int, one_iteration,
                (warp, it, rate, tel, max_disp, (zero, zero)),
            )
            # The round's ONE fused reduction: termination max + (when the
            # adaptive rate needs it) the global energy of the round's last
            # iteration.
            max_up = pmax_axis(max_up_l, axis_name, nd)
            if params.adaptive_learning_rate:
                energy = psum_axis(e_loc, axis_name, nd)
                rate = jnp.where(energy > prev_e, rate * 0.5, rate)
            else:
                energy = e_loc
            return (warp, it, max_up, rate, energy, tel, max_disp)

        warp, it, max_up, _, _, tel, max_disp = lax.while_loop(
            cond, round_body, init
        )
        max_disp = pmax_axis(
            jnp.maximum(max_disp, _axis_max_abs(warp)), axis_name, nd
        )
        # Post-loop telemetry reduction: per-iteration psums/pmaxes of the
        # locally recorded values — EXACTLY the per-iteration global
        # telemetry of the k=1 path, at 2 collective rounds per solve
        # instead of 1 per iteration.
        tel = SolveTelemetry(
            data_energy=psum_axis(tel.data_energy, axis_name, nd),
            smoothing_energy=psum_axis(tel.smoothing_energy, axis_name, nd),
            level_set_energy=psum_axis(tel.level_set_energy, axis_name, nd),
            max_warp_update=pmax_axis(tel.max_warp_update, axis_name, nd),
            mean_warp_update=psum_axis(tel.mean_warp_update, axis_name, nd)
            / num_voxels,
        )
        return warp, it, max_up < params.convergence_threshold, tel, max_disp

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
            SolveTelemetry(rep, rep, rep, rep, rep),
            rep,
        ),
        check_vma=False,
    )
    warp, iterations, converged, telemetry, max_disp = fn(
        canonical, live, initial_warp
    )
    return SolveResult(
        warp=warp, iterations=iterations, converged=converged,
        telemetry=telemetry, max_abs_displacement=max_disp,
    )
