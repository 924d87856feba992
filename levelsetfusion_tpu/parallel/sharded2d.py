"""Distributed warp solve over TRUE voxel blocks: spatial axes 0 and 1
sharded over a 2D device mesh (SURVEY.md §2 parallelism table — "voxel
blocks", not slabs; the ≥80% scaling north_star needs block counts that
scale past ``shape[0] / min_halo``).

Same semantics as ``models.single_level.solve_single_level`` — the parity
tests assert it to float tolerance — with the 1D solver's halo machinery
applied along BOTH sharded axes:

- The **live** field is exchanged once per solve with a wide halo along
  axis 0 then axis 1; the sequential exchange fills the corner ghosts with
  the diagonal neighbor's data (the axis-1 exchange forwards the axis-0
  ghosts it just received).
- Per iteration the **warp** exchanges 2 ghost slices per sharded axis
  (4 ``ppermute``s), and the Sobolev filter exchanges kernel-radius ghosts
  per sharded axis. All np.gradient/Laplacian edge conventions are
  reproduced exactly at global boundaries via ``parallel.halo``'s
  axis-parametric primitives; stencil compositions (Hessian, ∇(∇·u)) track
  ghost margins per axis explicitly (the ``crop`` bookkeeping below).
- Termination and telemetry reduce over BOTH mesh axes (``psum``/``pmax``
  with a tuple of axis names) — global max-warp-update semantics identical
  to the single-device solver.

All per-shard work is plain jnp (the resample is ``ops.interpolation``'s
gather on the haloed live block); parity-tested against the single-device
solver in tests/test_parallel2d.py.

Reference anchor: BASELINE config 5; SURVEY.md §5 long-context row.
"""

from __future__ import annotations

from functools import partial

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
    convolve_zero_edges,
    d_edge_fixed,
    halo_exchange,
    pmax_axis,
    psum_axis,
    second_diff,
)


def _crop(a, g0, g1):
    """Strip ``g0``/``g1`` ghost slices from each side of axes 0/1."""
    sl = [slice(None)] * a.ndim
    if g0:
        sl[0] = slice(g0, -g0)
    if g1:
        sl[1] = slice(g1, -g1)
    return a[tuple(sl)]


def _replicate_global_ghosts(x_ext, halo, axis_name, num_devices, axis):
    """Overwrite out-of-domain ghost slices with the global edge slice."""
    idx = lax.axis_index(axis_name)
    m = x_ext.shape[axis]
    shape = [1] * x_ext.ndim
    shape[axis] = m
    rows = lax.broadcasted_iota(jnp.int32, tuple(shape), axis)
    start = lax.dynamic_slice_in_dim(x_ext, halo, 1, axis=axis)
    end = lax.dynamic_slice_in_dim(x_ext, m - halo - 1, 1, axis=axis)
    x_ext = jnp.where((idx == 0) & (rows < halo), start, x_ext)
    x_ext = jnp.where(
        (idx == num_devices - 1) & (rows >= m - halo), end, x_ext
    )
    return x_ext


def _band_mask(canonical, warped):
    return (jnp.abs(canonical) < 1.0 - TRUNCATION_EPS) | (
        jnp.abs(warped) < 1.0 - TRUNCATION_EPS
    )


@partial(
    jax.jit,
    static_argnames=("params", "mesh", "axis_names", "live_halo"),
)
def solve_single_level_sharded2d(
    canonical: jnp.ndarray,
    live: jnp.ndarray,
    params: SolverParams = SolverParams(),
    *,
    mesh: Mesh,
    axis_names: tuple = ("x", "y"),
    live_halo: int = 8,
    initial_warp: jnp.ndarray | None = None,
) -> SolveResult:
    """2D voxel-block twin of ``solve_single_level`` (see module docstring)."""
    an0, an1 = axis_names
    nd0, nd1 = mesh.shape[an0], mesh.shape[an1]
    if canonical.ndim < 3:
        raise ValueError(
            "2D-mesh block sharding applies to 3D+ volumes; 2D experiments "
            "fit one device (use the 1D sharded solver if needed)"
        )
    if canonical.shape[0] % nd0 or canonical.shape[1] % nd1:
        raise ValueError(
            f"axes 0/1 {canonical.shape[:2]} must divide over mesh {nd0}x{nd1}"
        )
    n0 = canonical.shape[0] // nd0
    n1 = canonical.shape[1] // nd1
    live_halo = min(live_halo, n0, n1)
    min_halo = 3 if params.sobolev_smoothing else 2
    if n0 < min_halo or n1 < min_halo:
        raise ValueError(
            f"local block {n0}x{n1} too small for stencil halos"
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
    n_iter = params.max_iterations
    num_voxels = float(canonical.size)
    names = (an0, an1)

    def exch2(x, width, fill):
        """Sequential both-axis halo exchange (fills corners correctly)."""
        x = halo_exchange(x, width, an0, nd0, fill=fill, axis=0)
        return halo_exchange(x, width, an1, nd1, fill=fill, axis=1)

    def block_gradient(canon_blk, live_ext, warp, reduce_energies=True):
        idx0 = lax.axis_index(an0)
        idx1 = lax.axis_index(an1)
        start0 = idx0 * n0
        start1 = idx1 * n1

        # ---- warped live on block + 2 ghosts per sharded axis ------------
        warp_ext = exch2(warp, 2, "replicate")
        shape_ext = (n0 + 4, n1 + 4) + canon_blk.shape[2:]
        pos0 = (
            start0 - 2 + lax.broadcasted_iota(jnp.int32, shape_ext, 0)
        ).astype(warp.dtype)
        pos1 = (
            start1 - 2 + lax.broadcasted_iota(jnp.int32, shape_ext, 1)
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

        # ---- data term ----------------------------------------------------
        # g_i on ghost margins for the Hessian composition; margins per axis
        # tracked explicitly: (a0, a1) = ghost slices remaining.
        g0_e = d_edge_fixed(we, 2, an0, nd0, axis=0)  # (1, 2)
        g1_e = d_edge_fixed(we, 2, an1, nd1, axis=1)  # (2, 1)
        g2_e = _diff_axis(we, 2)  # (2, 2)
        warped_grad = jnp.stack(
            [_crop(g0_e, 1, 2), _crop(g1_e, 2, 1), _crop(g2_e, 2, 2)],
            axis=-1,
        )

        diff = warped - canon_blk
        if params.band_union_only:
            diff = jnp.where(_band_mask(canon_blk, warped), diff, 0.0)
        total = params.data_term_weight * (diff[..., None] * warped_grad)
        e_data = params.data_term_weight * 0.5 * jnp.sum(diff * diff)

        # ---- smoothing term -------------------------------------------------
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
                    _diff_axis(_crop(u[c], 2, 2), ax) for ax in range(2, d)
                ]
                jac_cols.append(jnp.stack(jc, axis=-1))
            lap = jnp.stack(lap_parts, axis=-1)
            jac = jnp.stack(jac_cols, axis=-2)  # (*local, c, ax)

            if params.smoothing_mode is SmoothingMode.TIKHONOV:
                g_smooth = -lap
                e_smooth = 0.5 * jnp.sum(jac * jac)
            else:
                gamma = params.rigidity_enforcement_factor
                div_e = (
                    _crop(d_edge_fixed(u[0], 2, an0, nd0, axis=0), 0, 1)
                    + _crop(d_edge_fixed(u[1], 2, an1, nd1, axis=1), 1, 0)
                )  # ghosts (1, 1)
                for ax in range(2, d):
                    div_e = div_e + _diff_axis(_crop(u[ax], 1, 1), ax)
                gdiv = jnp.stack(
                    [
                        _crop(d_edge_fixed(div_e, 1, an0, nd0, axis=0), 0, 1),
                        _crop(d_edge_fixed(div_e, 1, an1, nd1, axis=1), 1, 0),
                    ]
                    + [_diff_axis(_crop(div_e, 1, 1), ax) for ax in range(2, d)],
                    axis=-1,
                )
                g_smooth = -(1.0 + gamma) * lap - gdiv
                sym = jac + jnp.swapaxes(jac, -1, -2)
                e_smooth = 0.5 * (
                    0.5 * jnp.sum(sym * sym) + gamma * jnp.sum(jac * jac)
                )
            total = total + params.smoothing_term_weight * g_smooth
            e_smooth = params.smoothing_term_weight * e_smooth
        else:
            e_smooth = jnp.zeros((), canon_blk.dtype)

        # ---- level-set term ---------------------------------------------------
        if params.level_set_term_weight != 0.0:
            # H[i][j] = d_j(g_i); margins: g0_e (1,2), g1_e (2,1), g2_e (2,2).
            h_rows = [
                jnp.stack(
                    [
                        _crop(d_edge_fixed(g0_e, 1, an0, nd0, axis=0), 0, 2),
                        _crop(d_edge_fixed(g0_e, 2, an1, nd1, axis=1), 1, 1),
                        _crop(_diff_axis(g0_e, 2), 1, 2),
                    ],
                    axis=-1,
                ),
                jnp.stack(
                    [
                        _crop(d_edge_fixed(g1_e, 2, an0, nd0, axis=0), 1, 1),
                        _crop(d_edge_fixed(g1_e, 1, an1, nd1, axis=1), 2, 0),
                        _crop(_diff_axis(g1_e, 2), 2, 1),
                    ],
                    axis=-1,
                ),
                jnp.stack(
                    [
                        _crop(d_edge_fixed(g2_e, 2, an0, nd0, axis=0), 1, 2),
                        _crop(d_edge_fixed(g2_e, 2, an1, nd1, axis=1), 2, 1),
                        _crop(_diff_axis(g2_e, 2), 2, 2),
                    ],
                    axis=-1,
                ),
            ]
            hess = jnp.stack(h_rows, axis=-2)  # (*local, i, j)

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

        # ---- Sobolev filtering ------------------------------------------------
        if kernel is not None:
            total = convolve_zero_edges(total, kernel, an0, nd0, axis=0)
            total = convolve_zero_edges(total, kernel, an1, nd1, axis=1)
            for ax in range(2, d):
                total = sobolev_ops._convolve_axis(total, kernel, ax)

        if not reduce_energies:
            return total, (e_data, e_smooth, e_ls)
        energies = (
            lax.psum(e_data, names),
            lax.psum(e_smooth, names),
            lax.psum(e_ls, names),
        )
        return total, energies

    k_int = max(1, params.termination_check_interval)
    n_rounds = -(-n_iter // k_int)
    n_iter = n_rounds * k_int

    def run(canon_blk, live_blk, warp0_blk):
        live_ext = exch2(live_blk, live_halo, "truncation")
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

        def _pmax2(x):
            return pmax_axis(pmax_axis(x, an0, nd0), an1, nd1)

        def _psum2(x):
            return psum_axis(psum_axis(x, an0, nd0), an1, nd1)

        def one_iteration(j, carry):
            """One iteration with NO reduction collectives (telemetry gets
            local values, reduced exactly once after the loop)."""
            warp, it, rate, tel, max_disp, _ = carry
            max_disp = jnp.maximum(max_disp, _axis_max_abs(warp))
            grad, (e_data, e_smooth, e_ls) = block_gradient(
                canon_blk, live_ext, warp, reduce_energies=False
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
            max_up = _pmax2(max_up_l)
            if params.adaptive_learning_rate:
                energy = _psum2(e_loc)
                rate = jnp.where(energy > prev_e, rate * 0.5, rate)
            else:
                energy = e_loc
            return (warp, it, max_up, rate, energy, tel, max_disp)

        warp, it, max_up, _, _, tel, max_disp = lax.while_loop(
            cond, round_body, init
        )
        max_disp = _pmax2(jnp.maximum(max_disp, _axis_max_abs(warp)))
        tel = SolveTelemetry(
            data_energy=_psum2(tel.data_energy),
            smoothing_energy=_psum2(tel.smoothing_energy),
            level_set_energy=_psum2(tel.level_set_energy),
            max_warp_update=_pmax2(tel.max_warp_update),
            mean_warp_update=_psum2(tel.mean_warp_update) / num_voxels,
        )
        return warp, it, max_up < params.convergence_threshold, tel, max_disp

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


@partial(jax.jit, static_argnames=("mesh", "axis_names", "live_halo"))
def warp_field_sharded2d(
    live: jnp.ndarray,
    warp: jnp.ndarray,
    *,
    mesh: Mesh,
    axis_names: tuple = ("x", "y"),
    live_halo: int = 8,
) -> jnp.ndarray:
    """Resample ``live`` at ``x + warp(x)`` with both arrays sharded as 2D
    voxel blocks — the fusion blend's gather done with one two-axis halo
    exchange (corner-correct sequential ppermute) instead of the
    partitioner-chosen all-gather of the live volume.

    Contract: per-voxel displacements beyond ``live_halo − 1`` on either
    sharded axis read the +1 truncation fill (the fusion driver sizes the
    halo from the frame's measured max |u| and falls back to the exact
    GSPMD gather when a one-block halo cannot cover it).
    """
    an0, an1 = axis_names
    nd0, nd1 = mesh.shape[an0], mesh.shape[an1]
    if live.shape[0] % nd0 or live.shape[1] % nd1:
        raise ValueError(
            f"axes 0/1 {live.shape[:2]} must divide over mesh {nd0}x{nd1}"
        )
    n0 = live.shape[0] // nd0
    n1 = live.shape[1] // nd1
    lh = min(live_halo, n0, n1)
    d = live.ndim

    def run(live_blk, warp_blk):
        live_ext = halo_exchange(
            live_blk, lh, an0, nd0, fill="truncation", axis=0
        )
        live_ext = halo_exchange(
            live_ext, lh, an1, nd1, fill="truncation", axis=1
        )
        shape = live_blk.shape
        i0 = lax.broadcasted_iota(jnp.int32, shape, 0).astype(
            warp_blk.dtype
        )
        i1 = lax.broadcasted_iota(jnp.int32, shape, 1).astype(
            warp_blk.dtype
        )
        coords = [i0 + lh + warp_blk[..., 0], i1 + lh + warp_blk[..., 1]]
        for ax in range(2, d):
            ident = lax.broadcasted_iota(jnp.int32, shape, ax).astype(
                warp_blk.dtype
            )
            coords.append(ident + warp_blk[..., ax])
        return sample_at(live_ext, jnp.stack(coords, axis=-1))

    spec = P(an0, an1)
    fn = shard_map(
        run, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False,
    )
    return fn(live, warp)
