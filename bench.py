"""Headline benchmark: BASELINE config 3 — 3D dense 128³ single-pair
non-rigid alignment with the full data+Killing+level-set energy and Sobolev
preconditioning — plus the other two BASELINE throughput metrics
(config-4 fusion frames/s, config-5 per-shard rate) in ``details``.

Prints one line naming the device and card, then ONE JSON line:
  {"metric": "voxel_warp_updates_per_s_per_chip", "value": N, "unit": "voxel·iter/s",
   "vs_baseline": R, ...}

``vs_baseline`` is measured against the reference-architecture stand-in: the
SAME 128³ solve run on the host CPU (the reference is single-process CPU
numpy; its repo publishes no numbers and the mount is empty — see
BASELINE.md — so the CPU run of our own math is the closest measurable
proxy, and is itself vectorized + multi-core XLA, i.e. a *conservative*
baseline). Same shape, fewer iterations (per-iteration cost is constant).
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_ITER = 300
SHAPE = (128, 128, 128)
CPU_ITER = 3  # same 128³ shape as the device run; cost is linear in it

SHARD_SHAPE = (64, 512, 512)  # per-device block of 512³ over 8 (config 5)
SHARD_ITER = 32  # multiple of config5_512's termination_check_interval=4

FUSE_FRAMES = 8  # steady-state fps from 7 intervals (r3 used 4 → noisy)
# Fixed-budget variant kept alongside the preset-budget run for
# cross-round comparability (r3/r4 recorded 40-iteration frames).
FUSE_SOLVE_ITER = 40


def _preset_solver(name):
    """The EXACT solver params a named CLI preset runs (VERDICT r4 weak
    #1: recorded headline numbers must use the preset settings, not
    bench-local choices)."""
    from levelsetfusion_tpu.utils.config import PRESETS

    return PRESETS[name].solver


def _build_fields(shape):
    import numpy as np
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = np.tanh(base * 0.3)
    live = np.tanh(np.roll(base, 1, axis=0) * 0.3)
    return jnp.asarray(canonical), jnp.asarray(live)


def _params(preset="config3_3d_full_energy", **kw):
    """Preset solver with bench overrides: fixed iteration budget (the
    throughput metric needs a constant denominator) and threshold 0.
    Everything else — weights, rates, adaptive setting — is the preset's
    own."""
    base = dict(
        max_iterations=N_ITER,
        convergence_threshold=0.0,  # run exactly max_iterations
    )
    base.update(kw)
    return _preset_solver(preset).replace(**base)


def measure(shape, n_iter, repeats=3, preset="config3_3d_full_energy"):
    from levelsetfusion_tpu.models.single_level import solve_single_level
    from levelsetfusion_tpu.utils.profiling import device_time

    params = _params(preset, max_iterations=n_iter)
    canonical, live = _build_fields(shape)
    best = device_time(
        lambda c, l: solve_single_level(c, l, params), canonical, live,
        repeats=repeats,
    )
    voxels = 1
    for s in shape:
        voxels *= s
    return voxels * n_iter / best, best


def measure_fusion_fps():
    """Config-4 frames/s (BASELINE north-star throughput): synthetic
    Snoopy-style sequence fused frame-to-canonical at 128³; steady-state
    rate measured from the second fused frame (first carries compile)."""
    from levelsetfusion_tpu.core.grid import GridSpec
    from levelsetfusion_tpu.io import synthetic
    from levelsetfusion_tpu.models.fusion import (
        FusionPipelineConfig,
        fuse_sequence,
    )

    seq = synthetic.snoopy_style_sequence_3d(
        FUSE_FRAMES, width=96, height=96, blob_radius_px=18.0,
        blob_height=0.06, drift_px_per_frame=(1.5, 0.0),
        pulse_amplitude=0.1,
    )
    grid = GridSpec(
        shape=SHAPE, voxel_size=0.004, offset=(-64, -64, 75)
    )

    def run(solver):
        cfg = FusionPipelineConfig(
            grid=grid,
            narrow_band_width_voxels=20,
            # Flat per-frame solves, matching the config4 CLI preset.
            hierarchical=False,
            solver=solver,
        )
        times = []

        def cb(t, state, warp):
            # No extra sync: fuse_sequence's pipelined loop fetches each
            # frame's stats (which depend on the blended canonical) before
            # invoking this callback, so the frame is complete here.
            times.append(time.perf_counter())

        fuse_sequence(seq.frames, seq.camera, cfg, frame_callback=cb)
        if len(times) < 3:
            return None
        return (len(times) - 1) / (times[-1] - times[0])

    # PRIMARY: the config4 preset's OWN budget — max_iterations=80 with
    # its 1e-3 convergence gate (VERDICT r4 weak #1: the recorded fps must
    # be the preset's convergence-gated number).
    preset_fps = run(_preset_solver("config4_3d_fusion"))
    # Labeled fixed-budget variant (40 iterations/frame, threshold 0).
    fixed_fps = run(
        _preset_solver("config4_3d_fusion").replace(
            max_iterations=FUSE_SOLVE_ITER, convergence_threshold=0.0,
        )
    )
    return preset_fps, fixed_fps


def measure_config5_shard():
    """Config-5 per-shard rate: the per-device (64, 512, 512) block of a
    512³/8 volume, full energy."""
    rate, secs = measure(
        SHARD_SHAPE, SHARD_ITER, repeats=3, preset="config5_512"
    )
    return rate, secs


def measure_config5_shard_scene():
    """Per-shard rate on a SCENE-LIKE field (sphere-shell TSDF, mostly
    truncated), unlike the in-band random fields above."""
    import numpy as np
    import jax.numpy as jnp

    from levelsetfusion_tpu.models.single_level import solve_single_level
    from levelsetfusion_tpu.utils.profiling import device_time

    shape = SHARD_SHAPE
    x = np.linspace(-1, 1, shape[0], dtype=np.float32)[:, None, None]
    y = np.linspace(-1, 1, shape[1], dtype=np.float32)[None, :, None]
    z = np.linspace(-1, 1, shape[2], dtype=np.float32)[None, None, :]
    r = np.sqrt(x * x + y * y + z * z)
    canonical = jnp.asarray(np.clip((r - 0.5) * 8.0, -1, 1))
    r2 = np.sqrt((x - 0.01) ** 2 + y * y + z * z)
    live = jnp.asarray(np.clip((r2 - 0.5) * 8.0, -1, 1))
    params = _params("config5_512", max_iterations=SHARD_ITER)
    best = device_time(
        lambda c, l: solve_single_level(c, l, params), canonical, live,
        repeats=3,
    )
    voxels = shape[0] * shape[1] * shape[2]
    return voxels * SHARD_ITER / best


def measure_config5_sharded1():
    """The same per-shard block run through solve_single_level_sharded on a
    ONE-device mesh: the full shard_map program (halo self-ppermutes,
    psum/pmax termination) with zero neighbor traffic — prices the
    structural overhead a multi-device run pays on top of compute."""
    from levelsetfusion_tpu.parallel import make_mesh, solve_single_level_sharded
    from levelsetfusion_tpu.utils.profiling import device_time

    params = _params("config5_512", max_iterations=SHARD_ITER)
    canonical, live = _build_fields(SHARD_SHAPE)
    mesh1 = make_mesh(1)
    best = device_time(
        lambda c, l: solve_single_level_sharded(
            c, l, params, mesh=mesh1, live_halo=8
        ),
        canonical, live, repeats=3,
    )
    voxels = SHARD_SHAPE[0] * SHARD_SHAPE[1] * SHARD_SHAPE[2]
    return voxels * SHARD_ITER / best, best


def _cpu_baseline_rate():
    """Measure the CPU stand-in rate in a subprocess held to the CPU
    (JAX_PLATFORMS=cpu, so it never opens the accelerator) — SAME 128³
    shape, fewer iterations. A failure raises."""
    code = (
        "import sys; sys.path.insert(0, %r);"
        "import bench; r,_ = bench.measure(bench.SHAPE, bench.CPU_ITER, repeats=1);"
        "print('CPU_RATE', r)" % REPO
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=1200, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, check=True,
    )
    for line in out.stdout.splitlines():
        if line.startswith("CPU_RATE"):
            return float(line.split()[1])
    raise RuntimeError(f"CPU baseline printed no rate:\n{out.stdout}")


def _card_info():
    """nvidia-smi's name and power limit of the card(s), or None."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def main():
    import jax

    from levelsetfusion_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = jax.devices()[0]
    card = _card_info()
    print(f"device: {device.device_kind} x {len(jax.devices())}; "
          f"card: {card or 'no nvidia-smi'}", flush=True)
    rate, secs = measure(SHAPE, N_ITER)
    cpu_rate = _cpu_baseline_rate()
    vs = rate / cpu_rate
    shard_rate = shard_secs = shard1_rate = scene_rate = None
    fps = fixed_fps = None
    if "--quick" not in sys.argv:
        shard_rate, shard_secs = measure_config5_shard()
        scene_rate = measure_config5_shard_scene()
        shard1_rate, _ = measure_config5_sharded1()
        fps, fixed_fps = measure_fusion_fps()

    print(
        json.dumps(
            {
                "metric": "voxel_warp_updates_per_s_per_chip",
                "value": rate,
                "unit": "voxel·iter/s",
                "vs_baseline": vs,
                "details": {
                    "config": "3D 128^3 single-pair, data+Killing+level-set+Sobolev",
                    "iterations": N_ITER,
                    "best_solve_seconds": secs,
                    "platform": device.platform,
                    "device_kind": device.device_kind,
                    "device_count": len(jax.devices()),
                    "card": card,
                    "cpu_baseline_rate_same_shape": cpu_rate,
                    # Preset-exact settings per metric (VERDICT r4 weak #1).
                    "headline_solver_preset": "config3_3d_full_energy",
                    "config4_frames_per_s": fps,
                    "config4_fps_budget": "preset: max_iterations=80, gate 1e-3",
                    "config4_frames_per_s_fixed40": fixed_fps,
                    "config5_solver_preset": "config5_512 (full energy)",
                    "config5_per_shard_voxel_iter_per_s": shard_rate,
                    "config5_per_shard_shape": list(SHARD_SHAPE),
                    "config5_per_shard_iterations": SHARD_ITER,
                    "config5_per_shard_seconds": shard_secs,
                    "config5_sharded_1dev_mesh_voxel_iter_per_s": shard1_rate,
                    "config5_termination_check_interval": (
                        _preset_solver("config5_512").termination_check_interval
                    ),
                    "config5_per_shard_scene_voxel_iter_per_s": scene_rate,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
