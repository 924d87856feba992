"""Experiment drivers + CLI (SURVEY.md §2.13, §3.1–3.4 entry points).

Usage:
    python -m levelsetfusion_tpu.cli --preset config1_2d_pair --out runs/c1
    python -m levelsetfusion_tpu.cli --config my_config.json --out runs/x
    python -m levelsetfusion_tpu.cli --list

Each run writes: config.json, telemetry.csv, events.jsonl, summary.json,
energy/field/warp plots, and (multi-frame mode) checkpoints + an evolution
video. Multi-frame runs resume from the latest checkpoint with ``--resume``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Optional

import numpy as np

import jax.numpy as jnp

from levelsetfusion_tpu.core.camera import se2_matrix
from levelsetfusion_tpu.core.grid import GridSpec
from levelsetfusion_tpu.io import synthetic
from levelsetfusion_tpu.models import (
    HierarchicalParams,
    solve_hierarchical,
    solve_single_level,
)
from levelsetfusion_tpu.models.fusion import (
    FusionPipelineConfig,
    blend,
    fuse_sequence,
    init_state,
)
from levelsetfusion_tpu.models.rigid import solve_rigid_2d
from levelsetfusion_tpu.ops.interpolation import warp_field
from levelsetfusion_tpu.ops.tsdf import generate_tsdf_2d, generate_tsdf_3d
from levelsetfusion_tpu.utils import checkpoint as ckpt
from levelsetfusion_tpu.utils.config import PRESETS, ExperimentConfig
from levelsetfusion_tpu.utils.telemetry import RunLogger, telemetry_to_rows
from levelsetfusion_tpu.utils.visualization import (
    FieldEvolutionVideo,
    write_run_artifacts,
)


def _write_artifacts(logger, out_dir, *args, **kwargs) -> None:
    """write_run_artifacts, recording in the summary what it skipped."""
    skipped = write_run_artifacts(out_dir, *args, **kwargs)
    if skipped:
        logger.summary.setdefault("artifacts_skipped", []).extend(skipped)


def _grid(cfg: ExperimentConfig) -> GridSpec:
    return GridSpec(
        shape=cfg.grid_shape, voxel_size=cfg.voxel_size, offset=cfg.grid_offset
    )


def _residual_metrics(canonical, live, warped) -> dict:
    """Accuracy gate for preset runs: mean |Φ − Φ_c| over the narrow-band
    union, before (live) vs after (warped live) the solve — the build's
    stand-in for 'TSDF error vs reference at convergence' while the
    reference mount is empty (BASELINE.md error row).

    Computed as ON-DEVICE reductions under jit (VERDICT r4 weak #7: at
    512³ a full-volume host fetch moves 512 MB; sharded inputs reduce under
    their existing sharding via GSPMD and only two scalars come back)."""
    import jax

    @jax.jit
    def _reduce(c, l, w):
        band = (jnp.abs(c) < 1.0 - 1e-5) | (jnp.abs(l) < 1.0 - 1e-5)
        n = jnp.maximum(jnp.sum(band), 1).astype(c.dtype)
        r0 = jnp.sum(jnp.where(band, jnp.abs(l - c), 0.0)) / n
        r1 = jnp.sum(jnp.where(band, jnp.abs(w - c), 0.0)) / n
        return jnp.stack([r0, r1])

    r0, r1 = (float(v) for v in np.asarray(_reduce(canonical, live, warped)))
    return {
        "residual_before": r0,
        "residual_after": r1,
        "residual_reduction": r0 / max(r1, 1e-12),
    }


def _pair_2d(cfg: ExperimentConfig, grid: GridSpec):
    kwargs = dict(width=128, bump_height=0.04, bump_radius_px=20.0, live_shift_px=4.0)
    kwargs.update(cfg.dataset_kwargs)
    pair = synthetic.bump_wall_pair_2d(**kwargs)
    gen = lambda d: generate_tsdf_2d(  # noqa: E731
        jnp.asarray(d), pair.camera, grid,
        narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        method=cfg.generation_method,
    )
    return gen(pair.canonical_depth), gen(pair.live_depth), pair


def _pair_3d(cfg: ExperimentConfig, grid: GridSpec):
    kwargs = dict(blob_height=0.06, blob_radius_px=18.0)
    kwargs.update(cfg.dataset_kwargs)
    shift = kwargs.pop("live_shift_px", 4.0)
    cam = synthetic.default_camera_3d(128, 128)
    canonical_depth = synthetic.blob_wall_depth_3d(cam, **kwargs)
    live_depth = synthetic.blob_wall_depth_3d(
        cam,
        blob_center_px=(64.0 + shift, 64.0),
        **kwargs,
    )
    gen = lambda d: generate_tsdf_3d(  # noqa: E731
        jnp.asarray(d), cam, grid,
        narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        method=cfg.generation_method,
    )
    return gen(canonical_depth), gen(live_depth), (canonical_depth, live_depth, cam)


def _contract_summary(res, cfg, *, live_halo=None,
                      sharded_axes: tuple | None = None) -> dict:
    """Displacement-contract entries for summary.json: the measured per-axis
    max |u|, plus — for a sharded solve (``live_halo`` given) — any
    violations of the halo contract (logged as warnings by
    check_displacement_contract). ``sharded_axes`` defaults to (0,) for the
    1D mesh, (0, 1) when cfg.mesh_shape selects the 2D voxel-block mesh.
    """
    from levelsetfusion_tpu.utils.debug import check_displacement_contract

    out = {
        "max_abs_displacement": [
            float(v) for v in np.asarray(res.max_abs_displacement)
        ]
    }
    if live_halo is not None:
        if sharded_axes is None:
            sharded_axes = (0, 1) if cfg.mesh_shape is not None else (0,)
        out["contract_violations"] = check_displacement_contract(
            res, live_halo=live_halo, sharded_axes=sharded_axes,
            name=cfg.name,
        )
    return out


def _log_focus(logger, canonical, live, warped, warp) -> None:
    """Reference-style focus-coordinate deep dive (SURVEY §2.12), emitted
    on ``--verbose`` runs: every logged field at the voxel with the largest
    post-solve band residual — the single most informative voxel when a
    solve underperforms.

    The argmax and the per-field values at it are computed on device
    (VERDICT r4 weak #7 — no full-volume host gather); only the
    coordinates and one scalar per field come back."""
    import jax

    d = canonical.ndim

    @jax.jit
    def _focus(c, l, w, u):
        band = (jnp.abs(c) < 1 - 1e-5) | (jnp.abs(l) < 1 - 1e-5)
        resid = jnp.where(band, jnp.abs(w - c), 0.0)
        coords = jnp.unravel_index(jnp.argmax(resid), c.shape)
        vals = [c[coords], l[coords], w[coords]] + [
            u[..., a][coords] for a in range(d)
        ]
        return jnp.stack([x.astype(c.dtype) for x in coords]), jnp.stack(
            vals
        )

    coords_dev, vals_dev = _focus(canonical, live, warped, warp)
    coords = tuple(int(v) for v in np.asarray(coords_dev))
    vals = np.asarray(vals_dev)
    fields = {
        "canonical": float(vals[0]),
        "live": float(vals[1]),
        "warped_live": float(vals[2]),
    }
    for ax in range(d):
        fields[f"warp_u{ax}"] = float(vals[3 + ax])
    logger.focus_voxel("max_band_residual", coords, **fields)


def _device_summary() -> dict:
    """The devices the run executed on, as JAX reports them."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def _reports_contract_summary(reports) -> dict:
    """Sequence-wide displacement-contract entries from per-frame reports
    (the multi-frame modes' analogue of _contract_summary)."""
    mds = [r.max_abs_displacement for r in reports if r.max_abs_displacement]
    violations = [v for r in reports for v in r.contract_violations]
    if not mds:
        return {"contract_violations": violations}
    return {
        "max_abs_displacement": [
            float(v) for v in np.max(np.asarray(mds), axis=0)
        ],
        "contract_violations": violations,
    }


def _sequence_dataset(cfg: ExperimentConfig):
    """Resolve cfg.dataset through the registry (SURVEY §2.2): returns a
    SequenceDataset. "synthetic" keeps the historical inline generator with
    its CLI defaults; any other name (e.g. "depth_directory" with
    dataset_kwargs={"path": ...}) comes from io.datasets."""
    from levelsetfusion_tpu.io import datasets

    if cfg.dataset in ("synthetic", "synthetic_snoopy"):
        seq_kwargs = dict(width=48, height=48, blob_radius_px=10.0,
                          blob_height=0.05, drift_px_per_frame=(1.5, 0.0),
                          pulse_amplitude=0.1)
        seq_kwargs.update(cfg.dataset_kwargs)
        seq = synthetic.snoopy_style_sequence_3d(cfg.num_frames, **seq_kwargs)
        return datasets.SequenceDataset(
            "synthetic_snoopy", seq.camera, list(seq.frames)
        )
    return datasets.get(cfg.dataset, **cfg.dataset_kwargs)


def run_experiment(
    cfg: ExperimentConfig, out_dir: str, resume: bool = False, verbose: bool = False
) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    logger = RunLogger(out_dir, verbose=verbose)
    grid = _grid(cfg)

    if cfg.mode in ("single_pair_2d", "single_pair_3d"):
        if cfg.mode == "single_pair_2d":
            canonical, live, _ = _pair_2d(cfg, grid)
        else:
            canonical, live, _ = _pair_3d(cfg, grid)
        res = solve_single_level(canonical, live, cfg.solver)
        logger.log_solve(res)
        warped = warp_field(live, res.warp)
        if verbose:
            _log_focus(logger, canonical, live, warped, res.warp)
        rows = telemetry_to_rows(res.telemetry, res.iterations)
        _write_artifacts(
            logger, out_dir, rows, canonical, live, warped, res.warp
        )
        return logger.finish(
            iterations=int(res.iterations),
            converged=bool(res.converged),
            final_data_energy=rows[-1]["data_energy"] if rows else None,
            device=_device_summary(),
            **_residual_metrics(canonical, live, warped),
            **_contract_summary(res, cfg),
        )

    if cfg.mode == "hierarchical_2d":
        canonical, live, pair = _pair_2d(cfg, grid)
        hp = HierarchicalParams(levels=cfg.levels, base=cfg.solver)
        if cfg.pyramid_method == "ewa_depth":
            # SURVEY §2.10: coarse levels regenerated from depth with EWA
            # sampling on coarsened grids, not block-mean downsampled.
            from levelsetfusion_tpu.models.hierarchical import (
                solve_hierarchical_from_depth,
            )

            res = solve_hierarchical_from_depth(
                jnp.asarray(pair.canonical_depth),
                jnp.asarray(pair.live_depth),
                pair.camera,
                grid,
                hp,
                narrow_band_width_voxels=cfg.narrow_band_width_voxels,
            )
        else:
            res = solve_hierarchical(canonical, live, hp)
        all_rows = []
        for level, lr in enumerate(res.level_results):
            logger.log_solve(lr, level=level)
            all_rows += telemetry_to_rows(lr.telemetry, lr.iterations)
        warped = warp_field(live, res.warp)
        _write_artifacts(
            logger, out_dir, all_rows, canonical, live, warped, res.warp
        )
        return logger.finish(
            levels=cfg.levels,
            iterations_per_level=[int(r.iterations) for r in res.level_results],
            converged=bool(res.level_results[-1].converged),
            **_residual_metrics(canonical, live, warped),
            **_contract_summary(res.level_results[-1], cfg),
        )

    if cfg.mode == "multi_frame_3d":
        ds = _sequence_dataset(cfg)
        n_frames = len(ds)
        pipeline_cfg = FusionPipelineConfig(
            grid=grid,
            narrow_band_width_voxels=cfg.narrow_band_width_voxels,
            generation_method=cfg.generation_method,
            hierarchical=False,
            solver=cfg.solver,
        )
        ckpt_root = os.path.join(out_dir, "checkpoints")
        video = FieldEvolutionVideo(os.path.join(out_dir, "canonical_evolution.mp4"))

        start_frame = 0
        if resume:
            latest = ckpt.latest_frame(ckpt_root)
            if latest is not None:
                if latest >= n_frames - 1:
                    # Nothing left to fuse — still (re)write the final
                    # artifacts from the checkpoint so an interrupted run
                    # can be completed.
                    logger.event("resume_noop", frame=latest)
                    state, warp, _ = ckpt.load(ckpt_root, latest)
                    video.close()
                    _write_artifacts(
                        logger, out_dir, [], canonical=state.canonical,
                        warp=warp,
                    )
                    return logger.finish(
                        frames=0, resumed_from=latest,
                        note="checkpoint already covers the full sequence",
                    )
                start_frame = latest
                logger.event("resumed", frame=latest)

        frame_times = []

        def on_frame(t, state, warp, report=None):
            frame_times.append(time.perf_counter())
            video.add_frame(state.canonical)
            logger.event(
                "frame_fused", frame=t,
                # The report carries band_voxels from the frame's single
                # packed fetch — no second full-volume gather.
                band_voxels=(
                    report.band_voxels
                    if report is not None
                    else int(
                        (np.abs(np.asarray(state.canonical)) < 1).sum()
                    )
                ),
            )
            if cfg.checkpoint_every and t % cfg.checkpoint_every == 0:
                ckpt.save(ckpt_root, t, state, warp, {"config": cfg.name})

        if start_frame > 0:
            state, warp, _ = ckpt.load(ckpt_root, start_frame)
            # Continue the fusion loop manually from the checkpointed
            # state over the remaining frames (frame start_frame is the
            # checkpoint's own live frame, so the source re-reads from it
            # as the loop's reference point).
            result = _resume_fusion(
                state, warp, ds.frame_source(start_frame), ds.camera,
                pipeline_cfg, on_frame, start_frame,
            )
        else:
            result = fuse_sequence(
                ds.frame_source(), ds.camera, pipeline_cfg,
                frame_callback=on_frame,
            )
        video.close()
        if video.skipped:
            logger.summary.setdefault("artifacts_skipped", []).append(
                video.skipped
            )
        _write_artifacts(
            logger, out_dir, [], canonical=result.state.canonical,
            warp=result.final_warp,
        )
        if cfg.checkpoint_every:
            ckpt.save(
                ckpt_root, n_frames - 1, result.state, result.final_warp,
                {"config": cfg.name, "final": True},
            )
        # frames/s is BASELINE's north-star throughput metric (includes TSDF
        # generation, the warp solves, and the fusion blends). Count only the
        # frames THIS run processed so resumed runs don't inflate it, and
        # measure steady state from the second processed frame on — the first
        # frame carries the XLA compile, which on short sequences would
        # otherwise dominate the metric.
        processed = n_frames - start_frame
        if len(frame_times) >= 2:
            fps = (len(frame_times) - 1) / max(
                frame_times[-1] - frame_times[0], 1e-9
            )
        else:
            fps = processed / max(logger.elapsed(), 1e-9)
        return logger.finish(
            frames=n_frames,
            dataset=ds.name,
            frames_processed=processed,
            frames_per_s=round(fps, 3),
            frames_per_s_incl_compile=round(
                processed / max(logger.elapsed(), 1e-9), 3
            ),
            device=_device_summary(),
            reports=[r._asdict() for r in result.reports],
            **_reports_contract_summary(result.reports),
        )

    if cfg.mode == "sharded_3d":
        from levelsetfusion_tpu.parallel import make_mesh, solve_single_level_sharded

        canonical, live, _ = _pair_3d(cfg, grid)
        if cfg.mesh_shape is not None and cfg.solver_kind == "schur2d":
            # Schur-outer (mesh axis 0) × sync-inner (mesh axis 1) —
            # parallel/schur2d.
            from levelsetfusion_tpu.parallel.mesh import make_mesh_2d
            from levelsetfusion_tpu.parallel.schur2d import (
                solve_single_level_schur2d,
            )

            mesh = make_mesh_2d(cfg.mesh_shape)
            res = solve_single_level_schur2d(
                canonical, live, cfg.solver, mesh=mesh,
                live_halo=cfg.live_halo,
                inner_iterations=cfg.schur_inner_iterations,
            )
        elif cfg.mesh_shape is not None:
            # 2D voxel-block mesh: spatial axes 0 and 1 shard.
            from levelsetfusion_tpu.parallel.mesh import make_mesh_2d
            from levelsetfusion_tpu.parallel.sharded2d import (
                solve_single_level_sharded2d,
            )

            mesh = make_mesh_2d(cfg.mesh_shape)
            res = solve_single_level_sharded2d(
                canonical, live, cfg.solver, mesh=mesh,
                live_halo=cfg.live_halo,
            )
        elif cfg.solver_kind == "schur":
            from levelsetfusion_tpu.parallel import solve_single_level_schur

            mesh = make_mesh(cfg.num_devices)
            res = solve_single_level_schur(
                canonical, live, cfg.solver, mesh=mesh,
                live_halo=cfg.live_halo,
                inner_iterations=cfg.schur_inner_iterations,
            )
        else:
            mesh = make_mesh(cfg.num_devices)
            res = solve_single_level_sharded(
                canonical, live, cfg.solver, mesh=mesh, live_halo=cfg.live_halo
            )
        logger.log_solve(res)
        rows = telemetry_to_rows(res.telemetry, res.iterations)
        _write_artifacts(logger, out_dir, rows, canonical, live, warp=res.warp)
        if cfg.mesh_shape is not None:
            warped = warp_field(live, res.warp)  # GSPMD shards the gather
        else:
            from levelsetfusion_tpu.parallel.sharded import warp_field_sharded

            warped = warp_field_sharded(
                live, res.warp, mesh=mesh, live_halo=cfg.live_halo
            )
        if verbose:
            _log_focus(logger, canonical, live, warped, res.warp)
        extra = {}
        if cfg.solver_kind in ("schur", "schur2d"):
            extra = {
                "solver_kind": cfg.solver_kind,
                "outer_steps": int(res.outer_steps),
                "inner_per_outer": int(res.inner_per_outer),
                "total_inner_iterations": int(res.outer_steps)
                * int(res.inner_per_outer),
            }
        return logger.finish(
            devices=int(np.prod(list(mesh.shape.values()))),
            iterations=int(res.iterations),
            converged=bool(res.converged),
            device=_device_summary(),
            **_residual_metrics(canonical, live, warped),
            **_contract_summary(res, cfg, live_halo=cfg.live_halo),
            **extra,
        )

    if cfg.mode == "hierarchical_sharded_3d":
        # Config 5 × §3.2: coarse-to-fine on a sharded volume — the path
        # for motions larger than the flat sharded solver's halo contract.
        from levelsetfusion_tpu.parallel import make_mesh
        from levelsetfusion_tpu.parallel.hierarchical import (
            solve_hierarchical_sharded,
        )

        canonical, live, (cdepth, ldepth, cam3) = _pair_3d(cfg, grid)
        mesh_axes = None
        if cfg.mesh_shape is not None:
            from levelsetfusion_tpu.parallel.mesh import make_mesh_2d

            mesh = make_mesh_2d(cfg.mesh_shape)
            mesh_axes = ("x", "y")
        else:
            mesh = make_mesh(cfg.num_devices)
        hp = HierarchicalParams(levels=cfg.levels, base=cfg.solver)
        pyramids = None
        if cfg.pyramid_method == "ewa_depth":
            from levelsetfusion_tpu.models.hierarchical import (
                build_pyramid_from_depth,
            )

            canon_pyr, _ = build_pyramid_from_depth(
                jnp.asarray(cdepth), cam3, grid, cfg.levels,
                cfg.narrow_band_width_voxels,
            )
            live_pyr, _ = build_pyramid_from_depth(
                jnp.asarray(ldepth), cam3, grid, cfg.levels,
                cfg.narrow_band_width_voxels,
            )
            pyramids = (canon_pyr, live_pyr)
        res = solve_hierarchical_sharded(
            canonical, live, hp, mesh=mesh, mesh_axes=mesh_axes,
            min_live_halo=cfg.live_halo, pyramids=pyramids,
        )
        all_rows = []
        for level, lr in enumerate(res.level_results):
            logger.log_solve(lr, level=level)
            all_rows += telemetry_to_rows(lr.telemetry, lr.iterations)
        warped = warp_field(live, res.warp)  # GSPMD shards the gather
        _write_artifacts(
            logger, out_dir, all_rows, canonical, live, warped, res.warp
        )
        # Per-level contract checks against the halo each level ACTUALLY
        # used (adaptively sized by the driver; None = replicated level, no
        # halo contract) — checking the finest level against cfg.live_halo
        # would report bogus violations on exactly the large-motion runs
        # this mode exists for (VERDICT r3 weak #3).
        finest = res.level_results[-1]
        halos = res.level_halos or (None,) * cfg.levels
        level_violations = []
        for li, (lr, lh) in enumerate(zip(res.level_results, halos)):
            if lh is None:
                continue
            c = _contract_summary(lr, cfg, live_halo=lh)
            level_violations += [
                f"level {li}: {v}" for v in c["contract_violations"]
            ]
        return logger.finish(
            devices=int(np.prod(list(mesh.shape.values()))),
            levels=cfg.levels,
            iterations_per_level=[
                int(r.iterations) for r in res.level_results
            ],
            level_live_halos=list(halos),
            converged=bool(finest.converged),
            device=_device_summary(),
            **_residual_metrics(canonical, live, warped),
            max_abs_displacement=[
                float(v) for v in np.asarray(finest.max_abs_displacement)
            ],
            contract_violations=level_violations,
        )

    if cfg.mode == "multi_frame_sharded_3d":
        # Config 4 × config 5: the fusion state stays voxel-block sharded
        # across the whole sequence (see models.fusion.fuse_sequence_sharded).
        from levelsetfusion_tpu.models.fusion import fuse_sequence_sharded
        from levelsetfusion_tpu.parallel import make_mesh

        ds = _sequence_dataset(cfg)
        mesh_axes = None
        if cfg.mesh_shape is not None:
            # Config 4 × the 2D voxel-block mesh: axes 0 AND 1 shard.
            from levelsetfusion_tpu.parallel.mesh import make_mesh_2d

            mesh = make_mesh_2d(cfg.mesh_shape)
            mesh_axes = ("x", "y")
        else:
            mesh = make_mesh(cfg.num_devices)
        pipeline_cfg = FusionPipelineConfig(
            grid=grid,
            narrow_band_width_voxels=cfg.narrow_band_width_voxels,
            generation_method=cfg.generation_method,
            hierarchical=False,
            solver=cfg.solver,
        )
        ckpt_root = os.path.join(out_dir, "checkpoints")
        frame_times = []

        def on_frame(t, state, warp, report=None):
            frame_times.append(time.perf_counter())
            logger.event(
                "frame_fused", frame=t,
                band_voxels=(
                    report.band_voxels
                    if report is not None
                    else int(
                        (np.abs(np.asarray(state.canonical)) < 1).sum()
                    )
                ),
            )
            if cfg.checkpoint_every and t % cfg.checkpoint_every == 0:
                # Sharded arrays snapshot shard-wise (utils.checkpoint).
                ckpt.save(ckpt_root, t, state, warp, {"config": cfg.name})

        result = fuse_sequence_sharded(
            ds.frame_source(), ds.camera, pipeline_cfg, mesh=mesh,
            mesh_axes=mesh_axes, live_halo=cfg.live_halo,
            frame_callback=on_frame,
        )
        _write_artifacts(
            logger, out_dir, [], canonical=result.state.canonical,
            warp=result.final_warp,
        )
        processed = len(ds)
        if len(frame_times) >= 2:
            fps = (len(frame_times) - 1) / max(
                frame_times[-1] - frame_times[0], 1e-9
            )
        else:
            fps = processed / max(logger.elapsed(), 1e-9)
        return logger.finish(
            frames=processed,
            devices=int(np.prod(list(mesh.shape.values()))),
            frames_per_s=round(fps, 3),
            device=_device_summary(),
            reports=[r._asdict() for r in result.reports],
            **_reports_contract_summary(result.reports),
        )

    if cfg.mode == "rigid_2d":
        kwargs = dict(width=128, bump_height=0.04, live_shift_px=0.0)
        kwargs.update(cfg.dataset_kwargs)
        pair = synthetic.bump_wall_pair_2d(**kwargs)
        true_ext = jnp.asarray(se2_matrix(0.02, 0.008, 0.004))
        canonical = generate_tsdf_2d(
            jnp.asarray(pair.canonical_depth), pair.camera, grid, extrinsic=true_ext
        )
        res = solve_rigid_2d(canonical, jnp.asarray(pair.canonical_depth), pair.camera, grid)
        e = np.asarray(res.energies)
        _write_artifacts(
            logger, out_dir, [], canonical=canonical, live=res.final_live
        )
        return logger.finish(
            true_extrinsic=np.asarray(true_ext).tolist(),
            estimated_extrinsic=np.asarray(res.extrinsic).tolist(),
            pose_error=float(
                np.max(np.abs(np.asarray(res.extrinsic) - np.asarray(true_ext)))
            ),
            initial_energy=float(e[0]),
            final_energy=float(e[-1]),
        )

    if cfg.mode == "rigid_3d":
        # 6-DoF SDF-2-SDF (SURVEY.md §2.11/§3.4): the canonical is generated
        # under a known ground-truth extrinsic; the solver must recover it
        # from the identity start. Pose error vs ground truth goes into the
        # summary.
        from levelsetfusion_tpu.models.rigid import solve_rigid_3d

        from levelsetfusion_tpu.core.camera import PinholeCamera

        kwargs = dict(wall_depth=0.4, blob_radius_px=10.0, blob_height=0.06)
        kwargs.update(cfg.dataset_kwargs)
        # Narrow fov so the grid laterally covers blob + surrounding wall.
        cam = PinholeCamera(
            fx=48.0, fy=48.0, cx=24.0, cy=24.0,
            image_width=48, image_height=48,
        )
        # TWO blobs: a single circular blob on a flat wall is rotationally
        # symmetric about the blob's axis, leaving one rotational DoF as a
        # zero-energy gauge direction — the pose is then not identifiable
        # and platform-specific rounding walks a converged solve along that
        # valley. The second, smaller, off-center blob pins all six DoF.
        depth = jnp.minimum(
            jnp.asarray(synthetic.blob_wall_depth_3d(cam, **kwargs)),
            jnp.asarray(
                synthetic.blob_wall_depth_3d(
                    cam,
                    **{**kwargs,
                       "blob_radius_px": kwargs["blob_radius_px"] * 0.6,
                       "blob_height": kwargs["blob_height"] * 0.7,
                       "blob_center_px": (14.0, 31.0)},
                )
            ),
        )
        true_ext = jnp.eye(4).at[0, 3].set(0.012).at[2, 3].set(-0.008)
        canonical = generate_tsdf_3d(
            jnp.asarray(depth), cam, grid, extrinsic=true_ext,
            narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        )
        res = solve_rigid_3d(
            canonical, jnp.asarray(depth), cam, grid,
            narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        )
        e = np.asarray(res.energies)
        _write_artifacts(
            logger, out_dir, [], canonical=canonical, live=res.final_live
        )
        return logger.finish(
            true_extrinsic=np.asarray(true_ext).tolist(),
            estimated_extrinsic=np.asarray(res.extrinsic).tolist(),
            pose_error=float(
                np.max(np.abs(np.asarray(res.extrinsic) - np.asarray(true_ext)))
            ),
            initial_energy=float(e[0]),
            final_energy=float(e[-1]),
        )

    raise ValueError(f"unknown mode {cfg.mode!r}")


def _resume_fusion(state, warp, frames, camera, pipeline_cfg, on_frame, frame_offset):
    """Continue a fusion run from checkpointed state over remaining frames.

    ``frames`` is a frame source starting AT the checkpointed frame (whose
    TSDF is already blended into ``state``), so the first yielded frame is
    skipped and fusion continues from the one after it.
    """
    from levelsetfusion_tpu.models.fusion import FusionResult, fuse_frame
    from levelsetfusion_tpu.ops.tsdf import generate_tsdf_3d as _gen

    frame_iter = iter(frames)
    next(frame_iter, None)  # the checkpointed frame itself
    reports = []
    solver = pipeline_cfg.solver
    for j, frame in enumerate(frame_iter, start=1):
        t = frame_offset + j
        # Same frame step as fuse_sequence, so resume stays equivalent to
        # an uninterrupted run. Flat path: the depth rides into the
        # all-in-one frame program (one dispatch per frame).
        if pipeline_cfg.hierarchical:
            live = _gen(
                jnp.asarray(frame), camera, pipeline_cfg.grid,
                narrow_band_width_voxels=(
                    pipeline_cfg.narrow_band_width_voxels
                ),
                method=pipeline_cfg.generation_method,
            )
            state, warp, report = fuse_frame(
                state, live, warp, solver, pipeline_cfg, t
            )
        else:
            state, warp, report = fuse_frame(
                state, None, warp, solver, pipeline_cfg, t,
                depth=jnp.asarray(frame), camera=camera,
            )
        reports.append(report)
        on_frame(t, state, warp, report=report)
    return FusionResult(state=state, reports=reports, final_warp=warp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=sorted(PRESETS), help="named BASELINE config")
    ap.add_argument("--config", help="path to an ExperimentConfig JSON file")
    ap.add_argument("--out", default=None, help="output run directory")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--list", action="store_true", help="list presets and exit")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument(
        "--profile",
        action="store_true",
        help="capture a jax.profiler trace of the run under <out>/trace/",
    )
    ap.add_argument(
        "--check-nans",
        action="store_true",
        help="run under XLA NaN checking (jax_debug_nans; slow, for "
        "debugging diverging solves)",
    )
    args = ap.parse_args(argv)

    if args.list:
        for name, cfg in sorted(PRESETS.items()):
            print(f"{name:28s} mode={cfg.mode:18s} grid={cfg.grid_shape}")
        return 0

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from levelsetfusion_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    elif args.preset:
        cfg = PRESETS[args.preset]
    else:
        ap.error("need --preset or --config")
    out = args.out or os.path.join("runs", cfg.name)
    ctx = contextlib.nullcontext()
    if args.check_nans:
        from levelsetfusion_tpu.utils.debug import nan_checks

        ctx = nan_checks()
    with ctx:
        if args.profile:
            from levelsetfusion_tpu.utils.profiling import trace

            with trace(os.path.join(out, "trace")):
                summary = run_experiment(
                    cfg, out, resume=args.resume, verbose=args.verbose
                )
        else:
            summary = run_experiment(
                cfg, out, resume=args.resume, verbose=args.verbose
            )
    print(f"run complete -> {out}")
    for k, v in summary.items():
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
