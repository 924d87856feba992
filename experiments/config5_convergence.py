"""Run the config-5 presets to their OWN convergence gates on the virtual
8-device CPU mesh and record converged/iterations/residual metrics —
BASELINE.md's converged-artifact rows (VERDICT r4 missing #4: the presets
previously ran fixed 30-60 iteration budgets and no summary recording
``converged: True`` existed for the sharded family).

The iteration BUDGET is raised (the gate stays the preset's 1e-3); the
energy, mesh, halos, and solver structure are the preset's own. Run
directories go under ``runs/c5_convergence/`` in the checkout.

Usage: python experiments/config5_convergence.py [--budget N] [--only NAME]
Prints one JSON line per preset; provenance for BASELINE.md.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

PRESET_NAMES = [
    "config5_sharded",
    "config5_sharded_schur",
    "config5_2dmesh",
    "config5_schur2d",
    "config5_hierarchical",
]


def main():
    from levelsetfusion_tpu.cli import run_experiment
    from levelsetfusion_tpu.utils.config import PRESETS

    budget = 4000
    if "--budget" in sys.argv:
        budget = int(sys.argv[sys.argv.index("--budget") + 1])
    names = PRESET_NAMES
    if "--only" in sys.argv:
        names = [sys.argv[sys.argv.index("--only") + 1]]

    for name in names:
        cfg = PRESETS[name]
        # Hierarchical presets iterate per level — a smaller per-level
        # budget reaches the same gate via the coarse-to-fine structure.
        max_it = budget if cfg.mode == "sharded_3d" else max(budget // 8, 200)
        cfg = dataclasses.replace(
            cfg,
            solver=cfg.solver.replace(max_iterations=max_it),
        )
        out = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "runs", "c5_convergence", name,
        )
        t0 = time.time()
        summary = run_experiment(cfg, out)
        row = {
            "preset": name,
            "budget": max_it,
            "gate": cfg.solver.convergence_threshold,
            "converged": summary.get("converged"),
            "iterations": summary.get(
                "iterations", summary.get("iterations_per_level")
            ),
            "residual_before": summary.get("residual_before"),
            "residual_after": summary.get("residual_after"),
            "residual_reduction": summary.get("residual_reduction"),
            "outer_steps": summary.get("outer_steps"),
            "contract_violations": summary.get("contract_violations"),
            "wall_s": round(time.time() - t0, 1),
        }
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
