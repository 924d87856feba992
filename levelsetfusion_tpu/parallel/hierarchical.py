"""Sharded hierarchical (coarse-to-fine) warp solve — SURVEY.md §3.2
composed with BASELINE config 5.

``parallel.sharded``'s halo contract (per-voxel displacements must stay
within ``live_halo − 2`` rows of a block edge) is honored here by
construction, which is what makes large motions solvable on a sharded
volume at all:

- **Coarse levels run replicated.** They are tiny (a 512³ volume's level-3
  field is 64³ = 1 MB) and absorb the large motion; every device computes
  them redundantly with the exact single-device ``solve_single_level``
  semantics — no halos, no contract.
- **Fine levels run sharded**, warm-started by the prolongated coarse warp.
  Warm-starting does NOT shrink the *total* displacement the resample must
  gather across (a 10-voxel motion is a 10-voxel warp at every level), so
  the fine-level ``live_halo`` is sized from the measured max displacement
  of the coarser solve (one small host sync per level) plus the update
  headroom, clamped to the one-block ppermute limit. If even a full-block
  halo cannot cover the motion, the level falls back to replicated rather
  than silently violating the contract.

The cross-sharding glue — pyramid build and warp prolongation — is plain
jnp on global arrays: under jit, GSPMD inserts the (tiny, once-per-level)
collectives. The per-level solves are the parity-tested
``solve_single_level`` / ``solve_single_level_sharded``; sharded-vs-single
hierarchical parity is asserted in ``tests/test_hierarchical_sharded.py``.
"""

from __future__ import annotations

import math
from typing import List

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from levelsetfusion_tpu.models.hierarchical import HierarchicalResult
from levelsetfusion_tpu.models.params import HierarchicalParams
from levelsetfusion_tpu.models.single_level import SolveResult, solve_single_level
from levelsetfusion_tpu.ops import pyramid
from levelsetfusion_tpu.parallel.sharded import solve_single_level_sharded


def _max_displacement_rows(warp, axes=(0,)) -> float:
    """Host-side max |u| over the sharded axis components, voxels."""
    return float(
        max(float(jnp.max(jnp.abs(warp[..., a]))) for a in axes)
    )


def _level_can_shard(shape, n_devices: int, min_rows: int) -> bool:
    return shape[0] % n_devices == 0 and shape[0] // n_devices >= min_rows


def _level_can_shard2d(shape, nd0: int, nd1: int, min_rows: int) -> bool:
    return (
        shape[0] % nd0 == 0 and shape[0] // nd0 >= min_rows
        and shape[1] % nd1 == 0 and shape[1] // nd1 >= min_rows
    )


def solve_hierarchical_sharded(
    canonical: jnp.ndarray,
    live: jnp.ndarray,
    params: HierarchicalParams = HierarchicalParams(),
    *,
    mesh: Mesh,
    axis_name: str = "x",
    mesh_axes: tuple | None = None,
    initial_warp: jnp.ndarray | None = None,
    min_live_halo: int = 8,
    halo_margin: int = 2,
    pyramids=None,
) -> HierarchicalResult:
    """Coarse-to-fine solve of a volume sharded along axis 0 of ``mesh``.

    Args:
      canonical / live: finest-level fields (any current sharding; each
        level is explicitly placed before its solve).
      initial_warp: optional finest-level warm start (multi-frame fusion).
      min_live_halo: floor for the fine-level live-field halo width.
      halo_margin: extra halo rows beyond the measured coarse displacement
        (headroom for the fine level's own updates).
      pyramids: optional pre-built ``(canon_pyr, live_pyr)`` lists,
        coarsest first — e.g. EWA depth-regenerated coarse levels from
        ``models.hierarchical.build_pyramid_from_depth`` (SURVEY §2.10);
        default is 2× block-mean downsampling of ``canonical``/``live``.
      mesh_axes: pass ``("x", "y")`` with a 2D mesh to run shardable
        levels as true voxel blocks (parallel.sharded2d) — the halo is
        sized from the measured displacement over BOTH sharded axes; a
        level that cannot cover the motion on either axis runs replicated.
    """
    two_d = mesh_axes is not None and len(mesh_axes) == 2
    if two_d:
        an0, an1 = mesh_axes
        nd0, nd1 = mesh.shape[an0], mesh.shape[an1]
        shard = NamedSharding(mesh, P(an0, an1))
        disp_axes = (0, 1)
    else:
        nd = mesh.shape[axis_name]
        shard = NamedSharding(mesh, P(axis_name))
        disp_axes = (0,)
    rep = NamedSharding(mesh, P())
    min_rows = 3 if params.base.sobolev_smoothing else 2

    if pyramids is not None:
        canon_pyr, live_pyr = pyramids
    else:
        canon_pyr = pyramid.build_pyramid(canonical, params.levels)
        live_pyr = pyramid.build_pyramid(live, params.levels)

    warp = None
    if initial_warp is not None:
        warp = initial_warp
        for _ in range(params.levels - 1):
            warp = (
                jnp.stack(
                    [
                        pyramid.downsample2x_mean(warp[..., c])
                        for c in range(warp.shape[-1])
                    ],
                    axis=-1,
                )
                * 0.5
            )

    results: List[SolveResult] = []
    level_halos: List[int | None] = []
    for level in range(params.levels):
        canon_l, live_l = canon_pyr[level], live_pyr[level]

        # Halo needed to cover the warm start's reach across block edges
        # (contract: |u| <= live_halo − 2 on every sharded axis), plus
        # update headroom.
        need = 0
        if warp is not None:
            need = int(
                math.ceil(_max_displacement_rows(warp, disp_axes))
            ) + 2
        live_halo = max(min_live_halo, need + halo_margin)

        if two_d:
            n_local = min(
                canon_l.shape[0] // nd0 if canon_l.shape[0] % nd0 == 0 else 0,
                canon_l.shape[1] // nd1 if canon_l.shape[1] % nd1 == 0 else 0,
            )
            use_shard = (
                _level_can_shard2d(canon_l.shape, nd0, nd1, min_rows)
                and live_halo <= n_local
            )
        else:
            n_local = (
                canon_l.shape[0] // nd if canon_l.shape[0] % nd == 0 else 0
            )
            use_shard = (
                _level_can_shard(canon_l.shape, nd, min_rows)
                and live_halo <= n_local
            )
        level_halos.append(live_halo if use_shard else None)
        if use_shard and two_d:
            from levelsetfusion_tpu.parallel.sharded2d import (
                solve_single_level_sharded2d,
            )

            res = solve_single_level_sharded2d(
                jax.device_put(canon_l, shard),
                jax.device_put(live_l, shard),
                params.base,
                mesh=mesh,
                axis_names=mesh_axes,
                live_halo=live_halo,
                initial_warp=(
                    jax.device_put(warp, shard) if warp is not None else None
                ),
            )
        elif use_shard:
            res = solve_single_level_sharded(
                jax.device_put(canon_l, shard),
                jax.device_put(live_l, shard),
                params.base,
                mesh=mesh,
                axis_name=axis_name,
                live_halo=live_halo,
                initial_warp=(
                    jax.device_put(warp, shard) if warp is not None else None
                ),
            )
        else:
            # Too small to shard, or the motion exceeds a one-block halo:
            # run this level replicated (exact single-device semantics).
            res = solve_single_level(
                jax.device_put(canon_l, rep),
                jax.device_put(live_l, rep),
                params.base,
                initial_warp=(
                    jax.device_put(warp, rep) if warp is not None else None
                ),
            )
        results.append(res)
        if level + 1 < params.levels:
            warp = pyramid.prolongate_warp(
                res.warp, target_shape=canon_pyr[level + 1].shape
            )
        else:
            warp = res.warp

    return HierarchicalResult(
        warp=warp, level_results=results, level_halos=tuple(level_halos)
    )
