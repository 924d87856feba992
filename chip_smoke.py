"""Smoke test of the fusion pipeline on one NVIDIA GPU.

    python3 chip_smoke.py                # phases (a)-(e) on one card
    python3 chip_smoke.py --four-cards   # 512³ on a 4-card mesh vs 1 card

Phases (one process, one card):

(a) environment: device kind and count, and the card's name and power
    limit from ``nvidia-smi``;
(b) config3_3d_full_energy (128³, data + Killing + level-set + Sobolev)
    through ``cli.main`` to its own 1e-3 gate: converged, band residual
    falls;
(c) the same 128³ solve for 20 fixed iterations on the GPU and on the CPU
    in this process, compared (tolerance in ``compare_gpu_cpu``);
(d) config4_3d_fusion (8 frames at 128³, checkpoints) through
    ``cli.main``: 8 fused frames, finite canonical;
(e) config5_512 (512³ full energy, 32 iterations) through ``cli.main`` on
    a 1-device ``sharded_3d`` mesh, with the card's peak memory.

``--four-cards`` runs only config5_512's solve on a 4-card 1D mesh and the
same solve on one card, and compares warps, telemetry and per-card peak
memory.

Run outputs go under ``runs/chip_smoke/`` in the checkout. The last line of
standard output is one JSON object; it is printed only when every phase
passed. Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time

import numpy as np

from levelsetfusion_tpu.utils.compile_cache import enable_compile_cache

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "runs", "chip_smoke")


def result_line(devices) -> str:
    """The final JSON line: the device as JAX reports it."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }
    )


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _peak_bytes(device) -> int:
    return device.memory_stats()["peak_bytes_in_use"]


def _run_cli(args) -> dict:
    from levelsetfusion_tpu import cli

    out = args[args.index("--out") + 1]
    t0 = time.perf_counter()
    rc = cli.main(args)
    if rc != 0:
        raise RuntimeError(f"cli.main{args} returned {rc}")
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    summary["_wall_s"] = time.perf_counter() - t0
    return summary


def _telemetry(out: str) -> list:
    with open(os.path.join(out, "telemetry.csv")) as f:
        return list(csv.DictReader(f))


def phase_config3() -> None:
    out = os.path.join(OUT, "config3")
    s = _run_cli(["--preset", "config3_3d_full_energy", "--out", out])
    _log(
        f"(b) config3: {s['iterations']} iterations, converged "
        f"{s['converged']}, band residual {s['residual_before']:.6f} -> "
        f"{s['residual_after']:.6f}, wall {s['_wall_s']:.1f} s "
        "(compile included)"
    )
    assert s["converged"] is True, s
    assert s["residual_after"] < s["residual_before"], s
    assert len(_telemetry(out)) == s["iterations"]


def compare_gpu_cpu(n_iter: int = 20) -> None:
    """config3's 128³ solve, ``n_iter`` fixed iterations, on the GPU and on
    the host CPU, compared.

    Tolerances: everything is f32 and no matmul is involved (the per-voxel
    3×3 products are explicit multiply-adds, so TF32 never enters). The
    warp update is local to each voxel, so the warps agree to rounding:
    1e-5 voxel. Each energy is a sum over N = 128³ voxels taken in a
    different order on each device; f32 summation error grows like
    sqrt(N)·2⁻²⁴ ≈ 8.6e-5 relative, so energies must agree to 10× that.
    """
    import jax

    from levelsetfusion_tpu import cli
    from levelsetfusion_tpu.models import solve_single_level
    from levelsetfusion_tpu.utils.config import PRESETS

    cfg = PRESETS["config3_3d_full_energy"]
    params = cfg.solver.replace(
        max_iterations=n_iter, convergence_threshold=0.0
    )
    results = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        # XLA:CPU executables are built for this host's CPU; keep them out
        # of the persistent cache, which may be reused on another host.
        cached = jax.config.jax_enable_compilation_cache
        jax.config.update(
            "jax_enable_compilation_cache", cached and dev.platform != "cpu"
        )
        try:
            with jax.default_device(dev):
                canonical, live, _ = cli._pair_3d(cfg, cli._grid(cfg))
                res = solve_single_level(canonical, live, params)
                results.append(jax.device_get(res))
        finally:
            jax.config.update("jax_enable_compilation_cache", cached)
    g, c = results
    assert int(g.iterations) == int(c.iterations) == n_iter
    dwarp = float(np.max(np.abs(np.asarray(g.warp) - np.asarray(c.warp))))
    worst = 0.0
    for name in ("data_energy", "smoothing_energy", "level_set_energy"):
        a = np.asarray(getattr(g.telemetry, name), np.float64)
        b = np.asarray(getattr(c.telemetry, name), np.float64)
        rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
        worst = max(worst, float(rel))
    e_tol = 10 * np.sqrt(canonical.size) * 2.0**-24
    _log(
        f"(c) GPU vs CPU, 128³ x {n_iter} iterations: max|dwarp| "
        f"{dwarp:.3e} voxel (limit 1e-5), worst energy rel diff "
        f"{worst:.3e} (limit {e_tol:.2e})"
    )
    assert dwarp <= 1e-5, dwarp
    assert worst <= e_tol, worst


def phase_config4() -> None:
    from levelsetfusion_tpu.utils import checkpoint as ckpt

    out = os.path.join(OUT, "config4")
    s = _run_cli(["--preset", "config4_3d_fusion", "--out", out])
    state, warp, _ = ckpt.load(os.path.join(out, "checkpoints"))
    canonical = np.asarray(state.canonical)
    _log(
        f"(d) config4: {s['frames']} frames, {len(s['reports'])} fused "
        f"after the first, {s['frames_per_s']} frames/s steady state, "
        f"wall {s['_wall_s']:.1f} s (compile included)"
    )
    assert s["frames"] == 8 and len(s["reports"]) == 7, s
    assert canonical.shape == (128, 128, 128)
    assert np.isfinite(canonical).all() and np.isfinite(np.asarray(warp)).all()


def phase_config5_512() -> None:
    import jax

    out = os.path.join(OUT, "config5_512")
    s = _run_cli(["--preset", "config5_512", "--out", out])
    peak = _peak_bytes(jax.devices()[0])
    _log(
        f"(e) config5_512 on {s['devices']} device(s): {s['iterations']} "
        f"iterations, band residual {s['residual_before']:.6f} -> "
        f"{s['residual_after']:.6f}, peak_bytes_in_use {peak} "
        f"({peak / 2**30:.2f} GiB), wall {s['_wall_s']:.1f} s "
        "(compile included)"
    )
    assert s["devices"] == 1 and s["iterations"] == 32, s
    assert s["residual_after"] < s["residual_before"], s
    assert not s["contract_violations"], s


def four_cards() -> None:
    """config5_512's sharded solve on a 4-card mesh vs the same solve on
    one card. The 4-card run goes first, so each card's peak memory is its
    4-card share; card 0's peak afterwards is the 1-card solve's."""
    import jax
    import jax.numpy as jnp

    from levelsetfusion_tpu import cli
    from levelsetfusion_tpu.parallel import make_mesh, solve_single_level_sharded
    from levelsetfusion_tpu.utils.config import PRESETS

    cfg = PRESETS["config5_512"]
    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, have {jax.devices()}")
    canonical, live, _ = cli._pair_3d(cfg, cli._grid(cfg))

    def solve(n):
        t0 = time.perf_counter()
        res = solve_single_level_sharded(
            canonical, live, cfg.solver, mesh=make_mesh(n),
            live_halo=cfg.live_halo,
        )
        jax.block_until_ready(res)
        return res, time.perf_counter() - t0

    r4, t4 = solve(4)
    peaks4 = [_peak_bytes(d) for d in jax.devices()[:4]]
    r1, t1 = solve(1)
    peak1 = _peak_bytes(jax.devices()[0])
    w1 = jax.device_put(r1.warp, jax.devices()[0])
    w4 = jax.device_put(r4.warp, jax.devices()[0])
    dw = jnp.abs(w1 - w4)
    dwarp = float(jnp.max(dw))
    dmean = float(jnp.mean(dw))
    frac = float(jnp.mean(jnp.max(dw, axis=-1) > 1e-3))
    tel1, tel4 = jax.device_get((r1.telemetry, r4.telemetry))
    worst = 0.0
    for name in tel1._fields:
        a = np.asarray(getattr(tel4, name), np.float64)
        b = np.asarray(getattr(tel1, name), np.float64)
        rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
        worst = max(worst, float(rel))
    # Tolerances: the per-voxel math is the same, but each block is
    # compiled on its own, so rounding differs from the 1-card program. The
    # band masks (|Φ| < 1 − 1e-5) are thresholds: a rounding-level change
    # can move a voxel in or out of the band and change its gradient by a
    # finite amount, which the Sobolev filter spreads to its neighbours. So
    # the mean difference must stay at rounding level (1e-5 voxel), at
    # most 1e-4 of the voxels may differ by more than 1e-3, and no voxel by
    # more than 0.05. Telemetry sums inherit the same flips: 1e-2
    # relative.
    w_mean_tol, w_max_tol, frac_tol, e_tol = 1e-5, 0.05, 1e-4, 1e-2
    ratio = max(peaks4) / peak1
    _log(
        f"four cards: iterations {int(r4.iterations)} vs {int(r1.iterations)}"
        f"; |dwarp| mean {dmean:.3e} (limit {w_mean_tol:g}), max "
        f"{dwarp:.3e} (limit {w_max_tol:g}) voxel, {frac:.2e} of voxels "
        f"> 1e-3 (limit {frac_tol:g}); worst telemetry rel diff "
        f"{worst:.3e} (limit {e_tol:g}); per-card peak {peaks4} vs 1-card "
        f"{peak1} (ratio {ratio:.3f}); solve wall (compile included) "
        f"4-card {t4:.1f} s, 1-card {t1:.1f} s"
    )
    assert int(r4.iterations) == int(r1.iterations)
    assert dmean <= w_mean_tol and dwarp <= w_max_tol, (dmean, dwarp)
    assert frac <= frac_tol, frac
    assert worst <= e_tol, worst
    assert 0.15 <= ratio <= 0.4, ratio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only config5_512 on a 4-card mesh against one card",
    )
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU (JAX reports {devices[0].platform}); "
            "refusing to run on another backend", file=sys.stderr,
        )
        return 2
    enable_compile_cache()
    _log(f"(a) {devices[0].device_kind} x {len(devices)}")
    _log(f"card: {_card_info()}")
    if args.four_cards:
        four_cards()
    else:
        phase_config3()
        compare_gpu_cpu()
        phase_config4()
        phase_config5_512()
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
