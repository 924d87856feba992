"""Static communication accounting + a link-priced scaling model for the
sharded warp solvers, on any mesh.

The sharded solvers' communication volume is *statically knowable*: every
collective in ``parallel.sharded`` / ``parallel.schur`` moves a fixed
number of ghost planes per iteration, set by the stencil/filter radii and
the solver structure — there is no data-dependent communication anywhere.
This module computes those volumes exactly and combines them with a
measured single-device iteration time and caller-supplied link parameters
(bandwidth per direction, latency per collective round) into a predicted
N-device efficiency. Nothing here assumes a particular interconnect: the
link parameters are required arguments.

Collective inventory (1D mesh, per device, per solver iteration; verified
against the loop-body jaxprs by tests/test_scaling.py):

- sync solver: warp halo (2 rows) + with Sobolev a combined-gradient halo
  (r rows), 3 components each.
- Schur solver, per OUTER step (amortized over T inner iterations): warp
  halo (2 rows) + interface directions (1 row), 3 components.
- Once per solve: live-field halo (``live_halo`` rows, 1 scalar channel) —
  amortized to zero over a long solve; included in per-solve totals.
- Termination/adaptive-rate reduction: ONE fused psum/pmax round per
  ``termination_check_interval`` iterations (telemetry values are
  recorded per-shard inside the loop and reduced in 2 rounds once per
  solve, so the per-iteration round carries only the termination max
  and, with the adaptive rate, one energy scalar).

The 2D mesh doubles the story along axis 1 with Y×(X_local)×Z ghost planes;
``comm_bytes_per_iteration`` handles both.
"""

from __future__ import annotations

import dataclasses
import math

from levelsetfusion_tpu.models.params import SolverParams

F32 = 4


@dataclasses.dataclass(frozen=True)
class CommBudget:
    """Per-device communication volume, bytes, send direction only (links
    are full-duplex; the matching receive rides the opposite direction of
    the neighbor's link)."""

    bytes_per_iteration: int  # neighbor ppermute traffic, steady-state
    bytes_once_per_solve: int  # live-field halo exchange
    ppermute_rounds_per_iteration: float  # may be fractional (Schur: 2/T)
    reduction_rounds_per_iteration: float

    def total_bytes(self, iterations: int) -> int:
        return self.bytes_per_iteration * iterations + self.bytes_once_per_solve


def comm_bytes_per_iteration(
    shape,
    mesh_shape,
    params: SolverParams,
    *,
    live_halo: int = 8,
    solver_kind: str = "sync",
    inner_iterations: int = 8,
    dtype_bytes: int = F32,
) -> CommBudget:
    """Exact per-device neighbor-exchange volume for one solver iteration.

    Args:
      shape: global (X, Y, Z) voxel volume.
      mesh_shape: (n0,) for the 1D mesh or (n0, n1) for the 2D mesh.
      solver_kind: "sync" | "schur" (1D mesh only) | "schur2d" (2D mesh).
    """
    d = len(shape)
    if len(mesh_shape) == 1:
        n0, n1 = mesh_shape[0], 1
    else:
        n0, n1 = mesh_shape
    x_local = shape[0] // n0
    y_local = (shape[1] // n1) if d > 1 else 1
    z = shape[2] if d > 2 else 1
    plane0 = y_local * z  # voxels in one axis-0 ghost plane
    plane1 = x_local * z  # voxels in one axis-1 ghost plane (2D mesh)

    def _warp_rows(rows: int) -> int:
        # ghost rows × 2 sides × d warp components, both mesh axes if 2D.
        v = rows * 2 * d * plane0
        if n1 > 1:
            v += rows * 2 * d * plane1
        return v * dtype_bytes

    live_once = live_halo * 2 * plane0 * dtype_bytes
    if n1 > 1:
        live_once += live_halo * 2 * plane1 * dtype_bytes

    if solver_kind == "schur":
        if n1 > 1:
            raise ValueError(
                "the 1D Schur solver runs on the 1D mesh; use "
                "solver_kind='schur2d' for the Schur-outer × sync-inner "
                "composition on a 2D mesh"
            )
        per_outer = _warp_rows(2) + _warp_rows(1)  # halo + interface dirs
        return CommBudget(
            bytes_per_iteration=math.ceil(per_outer / inner_iterations),
            bytes_once_per_solve=live_once,
            ppermute_rounds_per_iteration=2.0 / inner_iterations,
            reduction_rounds_per_iteration=1.0 / inner_iterations,
        )

    if solver_kind == "schur2d":
        if n1 == 1:
            raise ValueError("schur2d needs a 2D mesh")
        # Axis 0: frozen warp halo (2 rows) + interface directions (1 row)
        # per OUTER step, amortized over T inner iterations. Axis 1: one
        # live 2-column warp-ghost exchange per INNER iteration, carried on
        # the x-extended block (n0+4 rows).
        axis0_outer = (2 + 1) * 2 * d * plane0 * dtype_bytes
        axis1_iter = 2 * 2 * d * (x_local + 4) * z * dtype_bytes
        return CommBudget(
            bytes_per_iteration=(
                math.ceil(axis0_outer / inner_iterations) + axis1_iter
            ),
            bytes_once_per_solve=live_once,
            ppermute_rounds_per_iteration=1.0 + 2.0 / inner_iterations,
            reduction_rounds_per_iteration=1.0 / inner_iterations,
        )

    k_int = max(1, params.termination_check_interval)
    per_iter = _warp_rows(2)
    rounds = 1.0 if n1 == 1 else 2.0
    if params.sobolev_smoothing:
        per_iter += _warp_rows(params.sobolev_radius)
        rounds += 1.0 if n1 == 1 else 2.0
    return CommBudget(
        bytes_per_iteration=per_iter,
        bytes_once_per_solve=live_once,
        ppermute_rounds_per_iteration=rounds,
        reduction_rounds_per_iteration=1.0 / k_int,
    )


@dataclasses.dataclass(frozen=True)
class ScalingPrediction:
    n_devices: int
    compute_s_per_iteration: float
    comm_s_per_iteration: float
    latency_s_per_iteration: float
    efficiency: float
    assumptions: dict


def predict_efficiency(
    shape,
    mesh_shape,
    params: SolverParams,
    compute_s_per_iteration: float,
    *,
    link_bytes_per_s: float,
    round_latency_s: float,
    live_halo: int = 8,
    solver_kind: str = "sync",
    inner_iterations: int = 8,
) -> ScalingPrediction:
    """Predicted N-device efficiency for the sharded warp solve.

    Model: per iteration each device sends its ghost planes to both
    neighbors at ``link_bytes_per_s`` per direction; the two sides of an
    axis use the two directions, so the serialized transfer time is the
    one-side volume over one link. Every ppermute or reduction round costs
    ``round_latency_s``. Transfers are priced serialized with compute (no
    overlap credit).

    Efficiency = t_compute / (t_compute + t_comm + t_latency): per-device
    compute is constant in N (the volume shards), so the only deviation
    from linear weak scaling is the (N-independent) halo traffic. The
    model is per-iteration steady state; the once-per-solve live halo is
    excluded.
    """
    if solver_kind == "schur2d":
        raise ValueError("use predict_efficiency_2d for schur2d")
    b = comm_bytes_per_iteration(
        shape, mesh_shape, params, live_halo=live_halo,
        solver_kind=solver_kind, inner_iterations=inner_iterations,
    )
    t_comm = b.bytes_per_iteration / 2.0 / link_bytes_per_s
    t_lat = (
        b.ppermute_rounds_per_iteration + b.reduction_rounds_per_iteration
    ) * round_latency_s
    denom = compute_s_per_iteration + t_comm + t_lat
    n = 1
    for m in mesh_shape:
        n *= m
    return ScalingPrediction(
        n_devices=n,
        compute_s_per_iteration=compute_s_per_iteration,
        comm_s_per_iteration=t_comm,
        latency_s_per_iteration=t_lat,
        efficiency=compute_s_per_iteration / denom,
        assumptions={
            "link_bytes_per_s": link_bytes_per_s,
            "round_latency_s": round_latency_s,
            "bytes_per_iteration_send": b.bytes_per_iteration,
            "ppermute_rounds": b.ppermute_rounds_per_iteration,
        },
    )


def predict_efficiency_2d(
    shape,
    mesh_shape,
    params: SolverParams,
    compute_s_per_iteration: float,
    *,
    link0_bytes_per_s: float,
    round0_latency_s: float,
    link1_bytes_per_s: float,
    round1_latency_s: float,
    solver_kind: str = "sync",
    inner_iterations: int = 8,
) -> ScalingPrediction:
    """Efficiency on a 2D mesh whose two axes may be priced differently
    (per-axis bandwidth and round latency). Per INNER iteration:

    - ``sync``: one axis-0 halo round + one axis-1 halo round (each with a
      second round for the Sobolev halo) + the nested psum/pmax reduction
      crossing BOTH axes every ``termination_check_interval`` iterations.
    - ``schur2d``: axis 0 pays (2 halo+interface rounds + 1 reduction
      round) / T; axis 1 pays one live halo round per inner iteration —
      the axis-0 round count drops ~T×, which pays off when
      ``round0_latency_s`` dominates.
    """
    d = len(shape)
    n0, n1 = mesh_shape
    x_local = shape[0] // n0
    y_local = shape[1] // n1
    z = shape[2] if d > 2 else 1
    plane0 = y_local * z
    plane1 = x_local * z
    k_int = max(1, params.termination_check_interval)

    if solver_kind == "sync":
        b0 = 2 * 2 * d * plane0 * F32
        b1 = 2 * 2 * d * plane1 * F32
        rounds0 = rounds1 = 1.0
        if params.sobolev_smoothing:
            r = params.sobolev_radius
            b0 += r * 2 * d * plane0 * F32
            b1 += r * 2 * d * plane1 * F32
            rounds0 += 1.0
            rounds1 += 1.0
        red0 = red1 = 1.0 / k_int
    elif solver_kind == "schur2d":
        t = inner_iterations
        b0 = (2 + 1) * 2 * d * plane0 * F32 / t
        b1 = 2 * 2 * d * (x_local + 4) * z * F32
        rounds0 = 2.0 / t
        rounds1 = 1.0
        red0 = red1 = 1.0 / t
    else:
        raise ValueError(f"unknown 2D solver kind {solver_kind!r}")

    t_comm = b0 / 2.0 / link0_bytes_per_s + b1 / 2.0 / link1_bytes_per_s
    t_lat = (rounds0 + red0) * round0_latency_s + (
        rounds1 + red1
    ) * round1_latency_s
    denom = compute_s_per_iteration + t_comm + t_lat
    return ScalingPrediction(
        n_devices=n0 * n1,
        compute_s_per_iteration=compute_s_per_iteration,
        comm_s_per_iteration=t_comm,
        latency_s_per_iteration=t_lat,
        efficiency=compute_s_per_iteration / denom,
        assumptions={
            "solver_kind": solver_kind,
            "inner_iterations": inner_iterations,
            "link0_bytes_per_s": link0_bytes_per_s,
            "round0_latency_s": round0_latency_s,
            "link1_bytes_per_s": link1_bytes_per_s,
            "round1_latency_s": round1_latency_s,
            "slow_axis_rounds_per_iteration": rounds0 + red0,
            "fast_axis_rounds_per_iteration": rounds1 + red1,
        },
    )
