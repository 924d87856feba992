"""Per-layer times of the plain-jnp solver on the GPU against their byte
bounds — the numbers behind PERF.md's bring-up findings.

    python experiments/layer_roofline.py [--sizes 128 512] [--out FILE]

For each cubic size it times, with ``jax.block_until_ready`` (min of 5 after
a warm-up):

- ``warp_field`` (trilinear resample of the live field under a smooth warp
  of a few voxels), against 20 B/voxel: warp 12, result 4, corner reads ≈4
  after cache hits;
- the stencil half of one iteration — gradient of the warped field, data +
  Killing + level-set terms, Sobolev filter, update and its statistics, as
  config3 runs them — against 32 B/voxel: warped 4, canonical 4, warp 12,
  new warp 12;
- one whole solver iteration (``solve_single_level``, config3 energy),
  with XLA's byte estimate for one pass of the loop body.

It also reports the loop fusions XLA emits (kernels in the stencil program
and in the solver's while body, from the optimized HLO), XLA's own
``bytes accessed`` estimate, and a plain elementwise copy's bandwidth on the
same card for calibration. With ``--trace DIR`` it also records a profiler
trace of the solver and of the standalone stencil program at each size and
reduces it to device time per kernel (``device_kernel_times``). Needs a
GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# Device-memory bandwidth by device_kind (NVIDIA data sheets). A card not
# listed here is an error, not a default.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _count_kernels(hlo: str, computation: str | None) -> dict:
    """Fusion / custom-call / other-op counts in one computation of an
    optimized HLO module (the entry when ``computation`` is None)."""
    blocks = re.split(r"\n(?=\S)", hlo)
    body = None
    for b in blocks:
        head = b.split("\n", 1)[0]
        if computation is None and head.startswith("ENTRY"):
            body = b
        elif computation is not None and re.match(
            rf"%?{re.escape(computation)}\b", head.strip()
        ):
            body = b
    if body is None:
        return {}
    lines = body.split("\n")[1:]
    return {
        "fusions": sum(" fusion(" in ln for ln in lines),
        "custom_calls": sum(" custom-call(" in ln for ln in lines),
        "instructions": sum(" = " in ln for ln in lines),
    }


def device_kernel_times(trace_dir: str, top: int = 12) -> dict:
    """Device time per kernel name in the newest profiler trace under
    ``trace_dir``: for every device plane and line, the summed event
    durations, the line's busy time (union of its events) and window, and
    the ``top`` kernels by total time."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    pd = ProfileData.from_file(paths[-1])
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = sorted(
                ((e.start_ns, e.end_ns, e.name) for e in line.events),
                key=lambda e: e[0],
            )
            if not evs:
                continue
            busy, cur_s, cur_e, per = 0.0, None, None, {}
            for s0, e0, name in evs:
                per[name] = per.get(name, 0.0) + (e0 - s0)
                if cur_e is None or s0 > cur_e:
                    if cur_e is not None:
                        busy += cur_e - cur_s
                    cur_s, cur_e = s0, e0
                else:
                    cur_e = max(cur_e, e0)
            busy += cur_e - cur_s
            ranked = sorted(per.items(), key=lambda kv: -kv[1])
            out[f"{plane.name} | {line.name}"] = {
                "events": len(evs),
                "sum_ns": sum(per.values()),
                "busy_ns": busy,
                "window_ns": evs[-1][1] - evs[0][0],
                "top": [[k, v] for k, v in ranked[:top]],
            }
    return out


def _while_body_name(hlo: str) -> str | None:
    m = re.search(r"while\(.*?\), condition=%?([\w.\-]+), body=%?([\w.\-]+)", hlo)
    return m.group(2) if m else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--trace", default=None,
                    help="directory for profiler traces (one per program)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from levelsetfusion_tpu.models.single_level import solve_single_level
    from levelsetfusion_tpu.ops import sobolev, terms
    from levelsetfusion_tpu.ops.derivatives import gradient
    from levelsetfusion_tpu.ops.gradient import SmoothingMode
    from levelsetfusion_tpu.ops.interpolation import warp_field
    from levelsetfusion_tpu.utils.compile_cache import enable_compile_cache
    from levelsetfusion_tpu.utils.config import PRESETS
    from levelsetfusion_tpu.utils.profiling import device_time

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, JAX reports {dev.platform}", file=sys.stderr)
        return 2
    if dev.device_kind not in HBM_BYTES_PER_S:
        print(f"no bandwidth entry for {dev.device_kind!r}", file=sys.stderr)
        return 2
    hbm = HBM_BYTES_PER_S[dev.device_kind]
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    p = PRESETS["config3_3d_full_energy"].solver
    kernel = jnp.asarray(
        sobolev.generate_1d_sobolev_kernel(p.sobolev_kernel_size, p.sobolev_strength)
    )
    assert p.smoothing_mode is SmoothingMode.KILLING

    def stencil_step(warped, canonical, warp, rate):
        wg = gradient(warped)
        g, e_d = terms.data_term(warped, canonical, wg)
        g_s, e_s = terms.killing_term(warp, p.rigidity_enforcement_factor)
        g_l, e_l = terms.level_set_term(warped, wg, canonical)
        total = (
            p.data_term_weight * g
            + p.smoothing_term_weight * g_s
            + p.level_set_term_weight * g_l
        )
        total = sobolev.convolve_with_sobolev_kernel(total, kernel, 3)
        upd = -rate * total
        ulen = jnp.sqrt(jnp.sum(upd * upd, axis=-1))
        return warp + upd, (e_d, e_s, e_l, jnp.max(ulen), jnp.mean(ulen))

    # Calibration: an elementwise pass over 1 GiB in, 1 GiB out.
    big = jnp.ones((2**28,), jnp.float32)
    t_copy = device_time(jax.jit(lambda x: x * 1.5 + 0.5), big)
    copy_bps = 2 * big.nbytes / t_copy
    del big
    report = {
        "card": card,
        "device_kind": dev.device_kind,
        "hbm_bytes_per_s": hbm,
        "copy_bytes_per_s": copy_bps,
        "sizes": {},
    }
    print(f"card: {card}; elementwise copy {copy_bps / 1e12:.3f} TB/s", flush=True)

    rng = np.random.default_rng(0)
    for n in args.sizes:
        shape = (n, n, n)
        vox = n**3
        base = rng.standard_normal(shape, dtype=np.float32)
        canonical = jnp.tanh(jnp.asarray(base) * 0.3)
        live = jnp.roll(canonical, 1, axis=0)
        del base
        ax = jnp.arange(n, dtype=jnp.float32) * (2 * np.pi / n)
        wave = 2.0 * jnp.sin(ax)[:, None, None] * jnp.cos(ax)[None, :, None]
        warp = jnp.stack(
            [jnp.broadcast_to(c, shape) for c in (
                wave + 0.3,
                jnp.transpose(wave, (1, 0, 2)) - 0.2,
                1.5 * jnp.sin(ax)[None, None, :],
            )],
            axis=-1,
        )
        warped = jax.jit(warp_field)(live, warp)
        rate = jnp.float32(p.learning_rate)

        wf = jax.jit(warp_field)
        t_wf = device_time(wf, live, warp)
        st = jax.jit(stencil_step)
        t_st = device_time(st, warped, canonical, warp, rate)
        st_compiled = st.lower(warped, canonical, warp, rate).compile()
        wf_compiled = wf.lower(live, warp).compile()

        n_it = 100 if n <= 256 else 10
        solve_p = p.replace(max_iterations=n_it, convergence_threshold=0.0)
        solve = jax.jit(lambda c, l: solve_single_level(c, l, solve_p))
        t0 = time.perf_counter()
        solve_compiled = solve.lower(canonical, live).compile()
        t_compile = time.perf_counter() - t0
        t_solve = device_time(solve_compiled, canonical, live, repeats=3)
        ran = int(solve_compiled(canonical, live).iterations)
        hlo = solve_compiled.as_text()
        body = _while_body_name(hlo)

        def _bytes(c):
            ca = c.cost_analysis()
            ca = ca[0] if isinstance(ca, (list, tuple)) else ca
            return float(ca.get("bytes accessed", float("nan")))

        r = {
            "warp_field_s": t_wf,
            "warp_field_bound_s": 20 * vox / hbm,
            "warp_field_xla_bytes": _bytes(wf_compiled),
            "stencil_s": t_st,
            "stencil_bound_s": 32 * vox / hbm,
            "stencil_xla_bytes": _bytes(st_compiled),
            "stencil_kernels": _count_kernels(st_compiled.as_text(), None),
            "iteration_s": t_solve / n_it,
            "solve_iterations_timed": n_it,
            "solve_iterations_run": ran,
            # XLA's cost analysis counts a while body once: this is one
            # loop-body pass plus the setup outside the loop.
            "solve_xla_bytes": _bytes(solve_compiled),
            "solve_compile_s": t_compile,
            "loop_body": body,
            "loop_body_kernels": _count_kernels(hlo, body) if body else {},
            "peak_bytes_in_use": dev.memory_stats()["peak_bytes_in_use"],
        }
        for k in ("warp_field", "stencil"):
            r[f"{k}_share_of_bound"] = r[f"{k}_bound_s"] / r[f"{k}_s"]
            r[f"{k}_xla_bytes_per_s"] = r[f"{k}_xla_bytes"] / r[f"{k}_s"]
        r["iteration_xla_bytes_per_s"] = r["solve_xla_bytes"] / r["iteration_s"]
        if args.trace:
            for name, fn, fargs in (
                ("solve", solve_compiled, (canonical, live)),
                ("stencil", st, (warped, canonical, warp, rate)),
            ):
                tdir = os.path.join(args.trace, f"{name}_{n}")
                jax.profiler.start_trace(tdir)
                for _ in range(1 if name == "solve" else 3):
                    jax.block_until_ready(fn(*fargs))
                jax.profiler.stop_trace()
                r[f"trace_{name}"] = device_kernel_times(tdir)
        report["sizes"][str(n)] = r
        print(json.dumps({str(n): r}), flush=True)
        del canonical, live, warp, warped

    print(json.dumps(report), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
