"""Frame-to-canonical fusion (SURVEY.md §2.14, §3.3; BASELINE config 4).

The "fusion" in LevelSetFusion: after the non-rigid solve aligns live frame t
to the canonical frame, the warped live TSDF is blended into the canonical
field with truncation-aware running weighted averaging:

    w_t(v)   = 1  where |Φ_w(v)| < 1 (inside the observed narrow band)
    Φ_c(v)  ←  (W(v) Φ_c(v) + w_t(v) Φ_w(v)) / (W(v) + w_t(v))
    W(v)    ←  W(v) + w_t(v)

The per-frame loop is a host loop (frame count is dynamic, IO per frame);
each step — TSDF generation, warp solve, resample, blend — is a jitted
on-device program, with the warp warm-started from the previous frame.

Every frame records the solve's measured per-axis max |u|
(``FrameReport.max_abs_displacement``); the sharded loop checks it against
the halo contract of ``parallel.sharded`` (``utils.debug``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
import math
from typing import Callable, List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from levelsetfusion_tpu.core.camera import PinholeCamera
from levelsetfusion_tpu.core.grid import GridSpec
from levelsetfusion_tpu.models.hierarchical import solve_hierarchical
from levelsetfusion_tpu.models.params import HierarchicalParams, SolverParams
from levelsetfusion_tpu.models.single_level import solve_single_level
from levelsetfusion_tpu.ops.interpolation import warp_field
from levelsetfusion_tpu.ops.tsdf import GenerationMethod, generate_tsdf_3d
from levelsetfusion_tpu.utils.debug import check_displacement_contract

TRUNCATION_EPS = 1e-5


class FusionState(NamedTuple):
    canonical: jnp.ndarray  # (*spatial,) running fused TSDF
    weights: jnp.ndarray  # (*spatial,) accumulated observation weights


class FrameReport(NamedTuple):
    frame_index: int
    solver_iterations: int
    final_data_energy: float
    band_voxels: int  # |Φ_c| < 1 count after fusion
    # Measured per-axis max |u| over every warp the frame's solve/blend
    # resampled with (voxel units) — the displacement-contract observable.
    max_abs_displacement: Tuple[float, ...] = ()
    # Sharded-halo contract violations (empty = clean).
    contract_violations: Tuple[str, ...] = ()


class FusionResult(NamedTuple):
    state: FusionState
    reports: List[FrameReport]
    final_warp: jnp.ndarray


@jax.jit
def blend(state: FusionState, warped_live: jnp.ndarray) -> FusionState:
    """One truncation-aware weighted-average fusion update."""
    w_live = (jnp.abs(warped_live) < 1.0 - TRUNCATION_EPS).astype(
        warped_live.dtype
    )
    w_total = state.weights + w_live
    fused = jnp.where(
        w_total > 0.0,
        (state.weights * state.canonical + w_live * warped_live)
        / jnp.maximum(w_total, 1e-12),
        state.canonical,
    )
    return FusionState(canonical=fused, weights=w_total)


def init_state(first_field: jnp.ndarray) -> FusionState:
    w = (jnp.abs(first_field) < 1.0 - TRUNCATION_EPS).astype(first_field.dtype)
    return FusionState(canonical=first_field, weights=w)


@dataclasses.dataclass(frozen=True)
class FusionPipelineConfig:
    """Config for the multi-frame frame-to-canonical driver."""

    grid: GridSpec
    narrow_band_width_voxels: int = 20
    generation_method: GenerationMethod = GenerationMethod.BASIC
    hierarchical: bool = True
    solver: SolverParams = SolverParams(learning_rate=1.0, convergence_threshold=1e-3)
    levels: int = 3
    warm_start: bool = True


def _call_frame_callback(cb, t, state, warp, report) -> None:
    """Invoke a frame callback, passing the frame's ``report`` keyword when
    the callback accepts it; plain ``(t, state, warp)`` callbacks keep
    working."""
    import inspect

    try:
        params = inspect.signature(cb).parameters
        extended = "report" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
        )
    except (TypeError, ValueError):
        extended = False
    if extended:
        cb(t, state, warp, report=report)
    else:
        cb(t, state, warp)


def _pack_stats(res, state: FusionState):
    """The frame's host-side stats, as device arrays for ONE fetch: int32
    (iterations, band count) — band counts at 512³ overflow f32's 2^24
    integer range — and f32 (final data energy, per-axis max |u|)."""
    ints = jnp.stack(
        [
            res.iterations.astype(jnp.int32),
            jnp.count_nonzero(
                jnp.abs(state.canonical) < 1.0 - TRUNCATION_EPS
            ).astype(jnp.int32),
        ]
    )
    floats = jnp.concatenate(
        [
            jnp.take(
                res.telemetry.data_energy, jnp.maximum(res.iterations - 1, 0)
            )[None],
            jnp.asarray(res.max_abs_displacement),
        ]
    )
    return ints, floats


@partial(
    jax.jit,
    static_argnames=("solver", "camera", "grid", "nb_width", "method"),
)
def _flat_frame_core_from_depth(
    depth, canonical, weights, init_warp, solver: SolverParams,
    camera, grid, nb_width: int, method,
):
    """TSDF generation + solve + resample + blend + stats-pack as ONE
    device program: the whole flat fusion frame is a single dispatch
    round trip (plus the one stats fetch)."""
    live = generate_tsdf_3d(
        depth, camera, grid,
        narrow_band_width_voxels=nb_width, method=method,
    )
    state, warp, packed = _flat_frame_body(
        canonical, weights, live, init_warp, solver
    )
    return state, warp, packed


@partial(jax.jit, static_argnames=("solver",))
def _flat_frame_core(
    canonical, weights, live, init_warp, solver: SolverParams
):
    """Solve + resample + blend + stats-pack as ONE device program — one
    dispatch per frame instead of three."""
    return _flat_frame_body(canonical, weights, live, init_warp, solver)


def _flat_frame_body(canonical, weights, live, init_warp, solver):
    res = solve_single_level(
        canonical, live, solver, initial_warp=init_warp
    )
    warped = warp_field(live, res.warp)
    state = blend(FusionState(canonical=canonical, weights=weights), warped)
    return state, res.warp, _pack_stats(res, state)


def _frame_report(packed, frame_index: int) -> FrameReport:
    """The frame's report from ``_pack_stats``' arrays (the one fetch)."""
    ints, floats = (np.asarray(a) for a in jax.device_get(packed))
    return FrameReport(
        frame_index=frame_index,
        solver_iterations=int(ints[0]),
        final_data_energy=float(floats[0]),
        band_voxels=int(ints[1]),
        max_abs_displacement=tuple(float(v) for v in floats[1:]),
    )


def fuse_frame(
    state: FusionState,
    live: jnp.ndarray,
    init_warp: jnp.ndarray,
    solver: SolverParams,
    config: FusionPipelineConfig,
    frame_index: int,
    depth=None,
    camera=None,
):
    """One single-device fusion frame: solve → resample → blend → stats
    fetch. Returns ``(state, warp, report)``.

    When ``depth``/``camera`` are given (and the pipeline is flat), TSDF
    generation folds into the same device program as the solve — the frame
    is ONE dispatch + ONE stats fetch; ``live`` may be None then.

    Shared by ``fuse_sequence`` and the CLI's checkpoint-resume loop.
    """
    if not config.hierarchical:
        if depth is not None:
            out = _flat_frame_core_from_depth(
                depth, state.canonical, state.weights, init_warp, solver,
                camera, config.grid, config.narrow_band_width_voxels,
                config.generation_method,
            )
        else:
            out = _flat_frame_core(
                state.canonical, state.weights, live, init_warp, solver
            )
        state, warp, packed = out
        return state, warp, _frame_report(packed, frame_index)

    hres = solve_hierarchical(
        state.canonical,
        live,
        HierarchicalParams(levels=config.levels, base=solver),
        initial_warp=init_warp,
    )
    warp = hres.warp
    state = blend(state, warp_field(live, warp))
    packed = _pack_stats(hres.level_results[-1], state)
    return state, warp, _frame_report(packed, frame_index)


def fuse_sequence_sharded(
    frames: Sequence[np.ndarray],
    camera: PinholeCamera,
    config: FusionPipelineConfig,
    *,
    mesh,
    axis_name: str = "x",
    mesh_axes: tuple | None = None,
    live_halo: int = 8,
    frame_callback: Callable[[int, FusionState, jnp.ndarray], None] | None = None,
) -> FusionResult:
    """Sharded twin of ``fuse_sequence`` (BASELINE configs 4 × 5): the
    canonical/weights state, the per-frame live TSDF, the warp, and every
    step — TSDF generation, the voxel-block-sharded warp solve, the
    resample, the blend — stay sharded across the whole sequence; nothing
    is ever gathered to one device.

    - TSDF generation runs under jit with a sharded output layout (GSPMD
      shards the per-voxel projection; the depth image is replicated).
    - The warp solve is ``parallel.sharded.solve_single_level_sharded``
      (ppermute halos, psum/pmax termination), warm-started per frame;
      with ``hierarchical=True`` the coarse-to-fine
      ``parallel.hierarchical.solve_hierarchical_sharded`` whose fine-level
      halos are sized from the measured coarse motion.
    - The fusion resample is ``parallel.sharded.warp_field_sharded`` with
      its halo sized from the frame's MEASURED max |u| (not the config's
      flat ``live_halo`` — the hierarchical path exists precisely for
      motion beyond it); when even a one-block halo cannot cover the
      motion, the blend falls back to the GSPMD gather, which is exact.
    - The blend is elementwise and keeps the state's sharding.

    ``mesh_axes``: pass ``("x", "y")`` with a 2D mesh to shard spatial axes
    0 AND 1 as true voxel blocks (parallel.sharded2d does the solve; the
    blend resample is the per-shard ``warp_field_sharded2d`` with its halo
    sized from the measured per-axis |u|, GSPMD gather only as the
    beyond-one-block fallback; per-frame contract checks cover both
    sharded axes). The 2D mesh composes with flat per-frame solves;
    coarse-to-fine stays on the 1D mesh (``hierarchical=True`` with a 2D
    mesh raises).

    Parity: tests/test_fusion_sharded.py asserts the final canonical equals
    the single-device ``fuse_sequence`` to float tolerance on both mesh
    shapes.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from levelsetfusion_tpu.parallel.sharded import (
        solve_single_level_sharded,
        warp_field_sharded,
    )

    if mesh_axes is None:
        mesh_axes = (axis_name,)
    two_d = len(mesh_axes) == 2
    if two_d and config.hierarchical:
        raise ValueError(
            "hierarchical sharded fusion runs on the 1D mesh; set "
            "hierarchical=False for the 2D voxel-block mesh"
        )
    grid = config.grid
    sharding = NamedSharding(mesh, P(*mesh_axes))
    nd = mesh.shape[mesh_axes[0]]
    n_local = grid.shape[0] // nd
    solver = config.solver

    def _gen(depth):
        return generate_tsdf_3d(
            depth,
            camera,
            grid,
            narrow_band_width_voxels=config.narrow_band_width_voxels,
            method=config.generation_method,
        )

    gen = jax.jit(_gen, out_shardings=sharding)

    frame_iter = iter(frames)
    state = init_state(gen(jnp.asarray(next(frame_iter))))
    d = grid.dim
    warp = jax.device_put(
        jnp.zeros(grid.shape + (d,), state.canonical.dtype), sharding
    )
    reports: List[FrameReport] = []

    for t, frame in enumerate(frame_iter, start=1):
        live = gen(jnp.asarray(frame))
        init_warp = warp if config.warm_start else jnp.zeros_like(warp)
        level_halos = None
        if config.hierarchical:
            # Coarse-to-fine on the sharded volume: replicated coarse
            # levels absorb large inter-frame motion, the fine level runs
            # sharded with an adaptively sized live halo
            # (parallel.hierarchical).
            from levelsetfusion_tpu.parallel.hierarchical import (
                solve_hierarchical_sharded,
            )

            hres = solve_hierarchical_sharded(
                state.canonical,
                live,
                HierarchicalParams(levels=config.levels, base=solver),
                mesh=mesh,
                axis_name=axis_name,
                min_live_halo=live_halo,
                initial_warp=init_warp,
            )
            warp = jax.device_put(hres.warp, sharding)
            res = hres.level_results[-1]
            level_halos = hres.level_halos
        elif two_d:
            from levelsetfusion_tpu.parallel.sharded2d import (
                solve_single_level_sharded2d,
            )

            res = solve_single_level_sharded2d(
                state.canonical,
                live,
                solver,
                mesh=mesh,
                axis_names=mesh_axes,
                live_halo=live_halo,
                initial_warp=init_warp,
            )
            warp = res.warp
        else:
            res = solve_single_level_sharded(
                state.canonical,
                live,
                solver,
                mesh=mesh,
                axis_name=axis_name,
                live_halo=live_halo,
                initial_warp=init_warp,
            )
            warp = res.warp

        # Small pre-blend fetch: iterations + final energy + measured
        # max |u| — md sizes the blend's halo below.
        ints = res.iterations.astype(jnp.int32)[None]
        floats = jnp.concatenate(
            [
                jnp.take(
                    res.telemetry.data_energy,
                    jnp.maximum(res.iterations - 1, 0),
                )[None],
                jnp.asarray(res.max_abs_displacement),
            ]
        )
        ints, floats = (np.asarray(a) for a in jax.device_get((ints, floats)))
        md = floats[1:]

        # Blend-resample halo sized from the MEASURED warp (ADVICE r3): the
        # gather reads up to ceil(|u|)+1 slices past a block face per
        # sharded axis. Quantize up to multiples of 4 so a drifting
        # sequence doesn't recompile the blend every frame; past one
        # block, fall back to the GSPMD gather (exact, slow).
        need_axes = [0, 1] if two_d else [0]
        need = max(int(math.ceil(float(md[a]))) + 2 for a in need_axes)
        blend_halo = max(live_halo, ((need + 3) // 4) * 4)
        if two_d:
            # Per-shard 2D blend (VERDICT r4 weak #3): one corner-correct
            # two-axis halo exchange instead of the GSPMD general gather.
            from levelsetfusion_tpu.parallel.sharded2d import (
                warp_field_sharded2d,
            )

            n0 = grid.shape[0] // mesh.shape[mesh_axes[0]]
            n1 = grid.shape[1] // mesh.shape[mesh_axes[1]]
            if blend_halo > min(n0, n1):
                warped = jax.jit(warp_field)(live, warp)  # GSPMD, exact
            else:
                warped = warp_field_sharded2d(
                    live, warp, mesh=mesh, axis_names=mesh_axes,
                    live_halo=blend_halo,
                )
        elif blend_halo > n_local:
            warped = jax.jit(warp_field)(live, warp)  # GSPMD gather, exact
        else:
            warped = warp_field_sharded(
                live, warp, mesh=mesh, axis_name=axis_name,
                live_halo=blend_halo,
            )
        state = blend(state, warped)
        band = int(
            np.asarray(
                jnp.count_nonzero(
                    jnp.abs(state.canonical) < 1.0 - TRUNCATION_EPS
                ).astype(jnp.int32)
            )
        )

        # Contract check: flat solves against the flat halo; hierarchical
        # solves per level against the halo each level actually used
        # (None = replicated, no contract).
        violations: list = []
        if level_halos is not None:
            for li, (lres, lh) in enumerate(
                zip(hres.level_results, level_halos)
            ):
                if lh is not None:
                    violations += check_displacement_contract(
                        lres, live_halo=lh,
                        name=f"sharded fusion frame {t} level {li}",
                    )
        else:
            violations = check_displacement_contract(
                res, live_halo=live_halo,
                sharded_axes=(0, 1) if two_d else (0,),
                name=f"sharded fusion frame {t}",
            )

        reports.append(
            FrameReport(
                frame_index=t,
                solver_iterations=int(ints[0]),
                final_data_energy=float(floats[0]),
                band_voxels=band,
                max_abs_displacement=tuple(float(v) for v in md),
                contract_violations=tuple(violations),
            )
        )
        if frame_callback is not None:
            _call_frame_callback(frame_callback, t, state, warp, reports[-1])

    return FusionResult(state=state, reports=reports, final_warp=warp)


def fuse_sequence(
    frames,
    camera: PinholeCamera,
    config: FusionPipelineConfig,
    frame_callback: Callable[[int, FusionState, jnp.ndarray], None] | None = None,
) -> FusionResult:
    """Fuse a depth sequence into a canonical TSDF (SURVEY.md §3.3 loop).

    ``frames`` is any iterable of depth images — a list, or a lazy source
    such as ``io.native_loader.DepthPrefetcher`` (the PP-analogue from
    SURVEY §2's parallelism table: frames are decoded ahead by native
    threads while the device solves the current frame, so host IO rides
    under device compute). Frames are consumed strictly in order, once.

    ``frame_callback(t, state, warp)`` is invoked after each frame for
    telemetry/visualization/checkpointing hooks; callbacks that accept a
    ``report`` keyword also receive the frame's FrameReport.

    The flat path runs PIPELINED (frame t dispatches before frame t−1's
    stats fetch — see the loop below); the hierarchical path is serial.
    The sharded driver (``fuse_sequence_sharded``) is not pipelined: its
    blend halo is sized from the frame's fetched measured |u|, so the
    fetch is load-bearing there.
    """
    grid = config.grid

    def gen(depth):
        return generate_tsdf_3d(
            jnp.asarray(depth),
            camera,
            grid,
            narrow_band_width_voxels=config.narrow_band_width_voxels,
            method=config.generation_method,
        )

    frame_iter = iter(frames)
    state = init_state(gen(next(frame_iter)))
    d = grid.dim
    warp = jnp.zeros(grid.shape + (d,), state.canonical.dtype)
    reports: List[FrameReport] = []
    solver = config.solver

    def _emit(t, f_state, f_warp, packed):
        report = _frame_report(packed, t)
        reports.append(report)
        if frame_callback is not None:
            _call_frame_callback(frame_callback, t, f_state, f_warp, report)

    if config.hierarchical:
        for t, frame in enumerate(frame_iter, start=1):
            init_warp = warp if config.warm_start else jnp.zeros_like(warp)
            state, warp, report = fuse_frame(
                state, gen(frame), init_warp, solver, config, t
            )
            reports.append(report)
            if frame_callback is not None:
                _call_frame_callback(frame_callback, t, state, warp, report)
        return FusionResult(state=state, reports=reports, final_warp=warp)

    # Flat path, PIPELINED: frame t's all-in-one device program (gen +
    # solve + resample + blend + stats pack) is dispatched from frame
    # t−1's device outputs BEFORE t−1's stats are fetched, so the one host
    # round trip per frame rides under the next frame's compute.
    pending = None
    for t, frame in enumerate(frame_iter, start=1):
        init_warp = warp if config.warm_start else jnp.zeros_like(warp)
        out = _flat_frame_core_from_depth(
            jnp.asarray(frame), state.canonical, state.weights, init_warp,
            solver, camera, grid, config.narrow_band_width_voxels,
            config.generation_method,
        )
        if pending is not None:
            _emit(*pending)
        state, warp, packed = out
        pending = (t, state, warp, packed)
    if pending is not None:
        _emit(*pending)

    return FusionResult(state=state, reports=reports, final_warp=warp)
