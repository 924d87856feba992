"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache (listed in .gitignore). A fixed path: the cache
# directory is part of what a later process must find again, so it never
# depends on a temp dir, the pid or the time.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here; otherwise the cache goes to ``DEFAULT_CACHE_DIR``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
