"""Tracing / profiling hooks (SURVEY.md §5: absent in the reference; here:
jax.profiler traces and a wall-clock timer that waits for the device)."""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


def device_time(fn: Callable, *args, repeats: int = 5) -> float:
    """Min wall time of ``fn(*args)`` after one warm-up call, each call
    ended by ``jax.block_until_ready`` so the device work is inside the
    timed region."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
