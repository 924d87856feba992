"""Entry-point plumbing: the compile-cache location, chip_smoke.py's refusal
to run without a GPU and its result line, runs on hosts without matplotlib
or cv2, and the Schur solver's degenerate one-device mesh."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_default_is_fixed_inside_checkout(
    monkeypatch, restore_cache_dir
):
    from levelsetfusion_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert compile_cache.enable_compile_cache() == got  # same every call
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_honours_env_var(
    monkeypatch, tmp_path, restore_cache_dir
):
    from levelsetfusion_tpu.utils import compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # Nothing is set in code: JAX reads the variable itself.
    assert jax.config.jax_compilation_cache_dir is None


def _run_smoke(cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_without_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        },
    }
    assert json.loads(chip_smoke.result_line([Dev()] * 4))["device"][
        "count"
    ] == 4


def _small(name, **kw):
    import dataclasses

    from levelsetfusion_tpu.utils.config import PRESETS

    cfg = PRESETS[name]
    return dataclasses.replace(
        cfg, solver=cfg.solver.replace(max_iterations=4), **kw
    )


@pytest.mark.parametrize("mode", ["single_pair_3d", "multi_frame_3d"])
def test_runs_without_matplotlib_or_cv2(monkeypatch, tmp_path, mode):
    """With matplotlib and cv2 unimportable the run completes, writes no
    plots or video, and says so in summary.json."""
    from levelsetfusion_tpu.cli import run_experiment

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    name = "config3_3d_full_energy" if mode == "single_pair_3d" else (
        "config4_3d_fusion"
    )
    cfg = _small(
        name, grid_shape=(16, 16, 12), voxel_size=0.016,
        grid_offset=(-8, -8, 21), num_frames=3, checkpoint_every=0,
        dataset_kwargs={"width": 24, "height": 24} if mode != (
            "single_pair_3d") else {},
    )
    out = tmp_path / "run"
    s = run_experiment(cfg, str(out))
    with open(out / "summary.json") as f:
        assert json.load(f)["artifacts_skipped"] == s["artifacts_skipped"]
    assert "plots: matplotlib not installed" in s["artifacts_skipped"]
    assert not any(p.suffix in (".png", ".mp4") for p in out.iterdir())
    if mode == "multi_frame_3d":
        assert "video: matplotlib not installed" in s["artifacts_skipped"]
        assert len(s["reports"]) == 2
    else:
        assert s["iterations"] == 4


def test_schur_on_one_device_is_plain_gradient_descent():
    """On a one-device mesh there are no cuts: T inner iterations per outer
    step are T plain single-device iterations (fixed rate)."""
    from levelsetfusion_tpu.models import SolverParams, solve_single_level
    from levelsetfusion_tpu.parallel import make_mesh, solve_single_level_schur

    rng = np.random.default_rng(1)
    shape = (12, 10, 8)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = jnp.asarray(np.tanh(base * 0.4))
    live = jnp.asarray(np.tanh(np.roll(base, 1, axis=0) * 0.4))
    p = SolverParams(
        max_iterations=12, learning_rate=0.3, convergence_threshold=0.0,
        smoothing_term_weight=0.1, level_set_term_weight=0.1,
        sobolev_smoothing=True,
    )
    ref = solve_single_level(canonical, live, p)
    got = solve_single_level_schur(
        canonical, live, p, mesh=make_mesh(1), inner_iterations=4
    )
    assert int(got.outer_steps) == 3
    np.testing.assert_allclose(
        np.asarray(got.warp), np.asarray(ref.warp), rtol=1e-5, atol=1e-6
    )
    # Outer-step telemetry is the last inner iteration of each step.
    np.testing.assert_allclose(
        np.asarray(got.telemetry.max_warp_update)[:3],
        np.asarray(ref.telemetry.max_warp_update)[3::4],
        rtol=1e-5,
    )
