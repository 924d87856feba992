"""Numerics sanitizers (SURVEY.md §5: the reference is single-threaded so
race detection is n/a; the analogue for an XLA pipeline is NaN/Inf
detection on the hot paths — "XLA nan-checking + jax.debug paths").

Three layers, cheapest first:

- ``validate_solve(result)`` — post-hoc: checks a SolveResult's warp and
  telemetry for non-finite values and raises with the first offending
  iteration (telemetry is per-iteration, so the blow-up point is named).
- ``nan_checks()`` — context manager enabling ``jax_debug_nans``: XLA
  re-runs the offending op un-jitted and raises at the exact primitive.
  Slow; for debugging runs only (the CLI exposes it as ``--check-nans``).
- ``tap_finite(x, name)`` — in-jit probe via ``jax.debug.callback``: logs
  (never raises — callbacks are async) when a traced intermediate goes
  non-finite; usable inside ``lax.while_loop`` bodies.
"""

from __future__ import annotations

import contextlib
import logging

import jax
import jax.numpy as jnp
import numpy as np

_log = logging.getLogger("levelsetfusion_tpu.debug")


class NonFiniteError(RuntimeError):
    pass


def validate_solve(result, name: str = "solve") -> None:
    """Raise NonFiniteError if a solve produced NaN/Inf anywhere, naming the
    first non-finite telemetry iteration."""
    tel = result.telemetry
    n = int(result.iterations) if hasattr(result, "iterations") else None
    for field in tel._fields:
        arr = np.asarray(getattr(tel, field))
        arr = arr[:n] if n is not None else arr
        bad = ~np.isfinite(arr)
        if bad.any():
            it = int(np.argmax(bad))
            raise NonFiniteError(
                f"{name}: telemetry '{field}' non-finite from iteration {it}"
                " — learning rate too high for the energy's stiffness?"
            )
    if not np.isfinite(np.asarray(result.warp)).all():
        raise NonFiniteError(f"{name}: warp field contains non-finite values")


@contextlib.contextmanager
def nan_checks():
    """Enable XLA NaN checking for the scope (jax_debug_nans)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def tap_finite(x: jnp.ndarray, name: str) -> jnp.ndarray:
    """In-jit finite probe: logs asynchronously if ``x`` has NaN/Inf.
    Returns ``x`` so it can be inserted inline in traced code."""

    def _check(ok, worst):
        if not ok:
            _log.error("non-finite values in %s (max |finite part| %s)",
                       name, worst)

    finite = jnp.isfinite(x)
    jax.debug.callback(
        _check,
        jnp.all(finite),
        jnp.max(jnp.where(finite, jnp.abs(x), 0.0)),
    )
    return x


class DisplacementContractError(RuntimeError):
    pass


def check_displacement_contract(
    result,
    *,
    live_halo: int,
    sharded_axes: tuple = (0,),
    name: str = "solve",
    error: bool = False,
) -> list[str]:
    """Compare a sharded solve's measured per-axis max |u| against the halo
    contract (VERDICT r2 weak #3): the sharded solvers read truncation fill
    beyond ``live_halo − 2`` rows of a block edge, silently by design; this
    guard makes a violation loud. Returns the list of violation messages
    (also logged as warnings); raises DisplacementContractError instead
    when ``error=True``.
    """
    md = np.asarray(result.max_abs_displacement)
    limit = live_halo - 2
    violations = [
        f"{name}: max |u[{ax}]| = {md[ax]:.3f} exceeds the sharded halo "
        f"contract live_halo−2 = {limit} — cross-block resample reads "
        "returned truncation fill. Raise live_halo or use "
        "solve_hierarchical_sharded."
        for ax in sharded_axes
        if md[ax] > limit
    ]
    for v in violations:
        _log.warning(v)
    if violations and error:
        raise DisplacementContractError("; ".join(violations))
    return violations
